"""Device time a step, in ms, of the operations launched inside
``conv.mix`` (a conv layer's in_proj, gates, causal depthwise conv and
out_proj), over the LFM2 driver's own phase window; nothing where the
program emits no such span."""


def read(run):
    got = run.extra.get("lfm2_phases")
    if not got:
        return None
    return got["ms_per_step"].get("conv.mix")

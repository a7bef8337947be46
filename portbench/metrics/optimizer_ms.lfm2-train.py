"""Device time a step, in ms, of the operations launched inside
``train.optimizer`` (the gradient norm, fused AdamW and the expert-bias
update), over the LFM2 driver's own phase window; nothing where the
program emits no such span."""


def read(run):
    got = run.extra.get("lfm2_phases")
    return None if not got else got["ms_per_step"].get("optimizer")

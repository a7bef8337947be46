"""Device time a step, in ms, of the operations launched inside the MoE's
spans (``moe.route``, ``moe.experts``, ``moe.combine``: the router through
the sort and gather, the grouped products and SwiGLU, the weighted sum),
over the LFM2 driver's own phase window; nothing where the program emits
no such span."""


def read(run):
    got = run.extra.get("lfm2_phases")
    if not got:
        return None
    ms = got["ms_per_step"]
    parts = [ms[k] for k in ("moe.route", "moe.experts", "moe.combine")
             if k in ms]
    return sum(parts) if parts else None

"""The largest held expert's load over the mean load (assignments a step
over every routed expert), averaged over the MoE layers and then over the
window's steps, from the program's counters (``lfm2.moe_stats``): 1 is a
perfectly even share, and the slowest group of the grouped products grows
with it."""


def read(run):
    x = run.extra.get("lfm2")
    return None if x is None else x["load_max"]

"""K1-K3's share of their roofline: the least time of the window's flash
calls (``roofline.flash_bound_s`` at the step's shapes, once a launch) over
their device time in the trace."""

from portbench import roofline, trace


def read(run):
    w = run.trace_window
    if w is None:
        return None
    spent = w.device_seconds(trace.FLASH)
    if spent <= 0:
        return None
    cfg, x = run.cfg, run.extra
    H = cfg["n_head"]
    D = cfg["n_embd"] // H
    bound = sum(n * roofline.flash_bound_s(k, x["batch"], x["seq"], H, D)[0]
                for k, n in x["launches"].items())
    return 100.0 * bound / spent

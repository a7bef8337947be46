"""K1-K3's share of their roofline in the LFM2 cell: the least time of the
window's flash calls (``roofline.flash_bound_s`` at [batch, seq, query
heads, head_dim], the shape the kernels are given: K and V expanded to the
query heads; once a launch) over their device time in the trace."""

from portbench import roofline, trace


def read(run):
    w, x = run.trace_window, run.extra
    if w is None or "lfm2" not in x:
        return None
    spent = w.device_seconds(trace.FLASH)
    if spent <= 0:
        return None
    H = run.cfg["num_attention_heads"]
    D = run.cfg["hidden_size"] // H
    bound = sum(n * roofline.flash_bound_s(k, x["batch"], x["seq"], H, D)[0]
                for k, n in x["launches"].items())
    return 100.0 * bound / spent

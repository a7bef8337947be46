"""K4's share of its roofline: the least time of the attention the
window's served tokens needed (``work.served``: a decode token reads its
context's K and V once a layer, a prefill only its uncached suffix's
share) over K4's device time in the trace, both routes together."""

from portbench import trace, work


def read(run):
    w = run.trace_window
    if w is None:
        return None
    spent = w.device_seconds(trace.K4)
    if spent <= 0:
        return None
    return 100.0 * work.served(run)["k4_bound_s"] / spent

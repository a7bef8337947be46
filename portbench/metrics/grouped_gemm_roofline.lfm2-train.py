"""The grouped expert products' share of their roofline: the least time of
the window's grouped products (``lfm2_counts.grouped_bound_s``: each
launch's bytes and flops for the assignments held that the program
counted, the forward under remat twice and the backward's two products a
forward product) over the device time of the grouped GEMM kernels in the
trace, matched by name."""

import re

from portbench import lfm2_counts

# The grouped GEMM kernels torch._grouped_mm launches on the H100 (CUTLASS
# over a grouped problem shape).
GROUPED = re.compile(r"GroupProblemShape|grouped_mm|grouped_gemm", re.I)


def read(run):
    w, x = run.trace_window, run.extra
    if w is None or "lfm2" not in x:
        return None
    spent = w.device_seconds(GROUPED)
    if spent <= 0 or not x["steps"]:
        return None
    layers = x["lfm2"]["moe_layers"]
    rows = x["lfm2"]["held_assignments"] / (x["steps"] * layers)
    forwards = x["lfm2"]["topk_calls"] / (x["steps"] * layers)
    bound = x["steps"] * lfm2_counts.grouped_bound_s(run.cfg, rows, forwards)
    return 100.0 * bound / spent

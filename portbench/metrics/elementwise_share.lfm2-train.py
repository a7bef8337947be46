"""Share of the traced window's device time in operations that are neither
GEMMs (cuBLAS, CUTLASS, the grouped products among them) nor the flash
kernels K1-K3: the LFM2 step's eager elementwise and reduction ops, the
MoE's routing and gathers, the conv, the loss, the optimizer, and copies."""

from portbench import trace


def read(run):
    w = run.trace_window
    if w is None or not w.ops:
        return None
    total = w.device_seconds()
    rest = total - w.device_seconds(trace.GEMM) - w.device_seconds(trace.FLASH)
    return 100.0 * rest / total

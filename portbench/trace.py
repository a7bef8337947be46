"""The traced window: a ``torch.profiler`` recording of the device over the
measured window, reduced to kernel intervals.

Only device activity is recorded (no host operators), which keeps the
recording's own cost on the host small. The reduction reads the profiler's
raw events, not its per-operator tables: busy time is the union of every
device operation's interval (kernels, copies and fills), so it stays right
if work ever runs on two streams at once; the idle share is the rest of the
window.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Dict, List, Tuple

# cuBLAS and CUTLASS GEMM kernels as the H100's libraries name them.
GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I)
FLASH = re.compile(r"flash_(fwd|dq|dkv)")
K4 = re.compile(r"paged_(prefill_wgmma|decode_split)_kernel")


class Window:
    """Device operations recorded between :meth:`start` and :meth:`stop`."""

    def __init__(self, torch):
        self._torch = torch
        self._prof = None
        self.ops: List[Tuple[str, int, int]] = []   # (name, start ns, end ns)
        self.window_s = 0.0
        self.busy_s = 0.0
        self._gaps: List[Tuple[str, float]] = []

    def start(self) -> None:
        torch = self._torch
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch = self._torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            s = e.start_ns()
            ops.append((e.name(), s, s + max(e.duration_ns(), 0)))
        self._prof = None
        ops.sort(key=lambda o: o[1])
        self.ops = ops
        self._reduce()

    def _reduce(self) -> None:
        busy, gaps = 0, []
        cur_s = cur_e = None
        for name, s, e in self.ops:
            if cur_e is None:
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((f"before {name[:100]}", (s - cur_e) / 1e9))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s = busy / 1e9
        self._gaps = gaps

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_seconds(self, pattern=None) -> float:
        """Summed device time of the operations whose name matches
        ``pattern`` (all of them with None)."""
        return sum(e - s for n, s, e in self.ops
                   if pattern is None or pattern.search(n)) / 1e9

    def breakdown(self) -> Dict[str, List]:
        """The ten device operations that took the most time, and the ten
        kinds of idle gap that lasted longest in all, each gap named by the
        operation the host launched to end it."""
        by_op = defaultdict(float)
        for n, s, e in self.ops:
            by_op[n[:120]] += (e - s) / 1e9
        by_gap = defaultdict(float)
        for n, d in self._gaps:
            by_gap[n] += d
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}

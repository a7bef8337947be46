"""A training cell's device time split by the phase of the step that
launched it: the port's spans (``train.step`` ⊃ ``lm.forward``,
``lm.loss``, ``train.backward``, ``train.optimizer``) joined to a
``torch.profiler`` recording.

The spans carry ``start_ns``/``end_ns`` on the clock the profiler stamps
host events with (``ray_tpu_torch/util/tracing.py``), and the recording
(device activity only, as ``portbench/trace.py`` records it) holds, beside
each device operation, the CUDA runtime call that launched it, joined by
its correlation id. Each operation goes to the innermost span open when its
launch was made, ``(no span)`` where none was (the feed between steps); an
operation with no launch record goes to ``(no launch)``. Each idle gap of
the device is named by the innermost span open at the gap's start: what
the host was doing while the card waited.

The cell's own traced window is recorded by ``portbench/drivers/train.py``,
which installs no span sink; so the phase window is its own: after the
cell's window and its check, in the same process (the kernels built, the
allocator warm), the step is built again as that module builds it, run
``WARM`` steps, then ``STEPS`` steps inside a root span (the step's spans
open only inside a trace, ``tracing.step_span``), under a sink and the
recording. The per-layer readers ``portbench/metrics/*_ms.train.py`` read
it through :func:`of`, which prints it on standard error as one line,
``phases {...}``: per-phase device ms a step, the launch records' coverage,
the ten longest tagged operations and idle gaps, and the five longest
operations of each phase. With a program whose spans are not on that clock
(before they were), or tracing gated off (``RAY_TPU_TRACE_ENABLED=0``), or
no card, it reads nothing.
"""

from __future__ import annotations

import bisect
import gc
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

WARM = 1
STEPS = 3

# A span's short tag, which leads the names in the breakdown.
TAGS = {"train.step": "step", "lm.forward": "forward", "lm.loss": "loss",
        "train.backward": "backward", "train.optimizer": "optimizer"}
NO_SPAN = "(no span)"
NO_LAUNCH = "(no launch)"

# (name, device start ns, device end ns, correlation id)
Op = Tuple[str, int, int, int]


class Timeline:
    """The innermost span open at each instant of the host's clock, from
    spans' half-open ``[start_ns, end_ns)`` (innermost: the latest to
    start; spans of one thread nest)."""

    def __init__(self, spans: Sequence[Dict]):
        marks = sorted({s["start_ns"] for s in spans}
                       | {s["end_ns"] for s in spans})
        self._marks = marks
        self._inner = []
        for t in marks:
            open_ = [s for s in spans if s["start_ns"] <= t < s["end_ns"]]
            self._inner.append(max(
                open_, key=lambda s: (s["start_ns"], -s["end_ns"]),
                default=None))

    def at(self, t: int) -> Optional[Dict]:
        i = bisect.bisect_right(self._marks, t) - 1
        return self._inner[i] if i >= 0 else None


def tag(span: Optional[Dict]) -> str:
    if span is None:
        return NO_SPAN
    return TAGS.get(span["name"], span["name"])


def split_events(events, cuda) -> Tuple[List[Op], Dict[int, int]]:
    """Kineto events into the device operations, as ``trace.Window``
    keeps them plus their correlation ids, sorted by start, and the host
    start of each launch record (the runtime call on the host that
    launched a device operation) by correlation id."""
    ops, host = [], {}
    for e in events:
        corr = e.correlation_id()
        if e.device_type() == cuda:
            s = e.start_ns()
            ops.append((e.name(), s, s + max(e.duration_ns(), 0), corr))
        elif corr:
            t = e.start_ns()
            host[corr] = min(t, host.get(corr, t))
    ops.sort(key=lambda o: o[1])
    wanted = {o[3] for o in ops}
    return ops, {c: t for c, t in host.items() if c in wanted}


def attribute(ops: Sequence[Op], launches: Dict[int, int],
              spans: Sequence[Dict]) -> Dict:
    """Per-phase device time of ``ops`` (each to the innermost span open at
    its launch), the busy time and idle gaps as ``trace.Window`` reduces
    them, each gap named by the span open at its start, and the checks:
    the share of device time with a launch record, and the operations
    that start on the device before the span that launched them. Spans
    other than the step's phases (the root the window opens) are left
    out: what they launch is ``(no span)``."""
    spans = [s for s in spans if s["name"] in TAGS]   # not the window's root
    line = Timeline(spans)
    steps = sum(1 for s in spans if s["name"] == "train.step")
    device = defaultdict(int)
    by_op = defaultdict(float)
    in_phase = defaultdict(lambda: defaultdict(float))
    launched = early = 0
    for name, s, e, corr in ops:
        t = launches.get(corr)
        if t is None:
            phase = NO_LAUNCH
        else:
            span = line.at(t)
            phase = tag(span)
            launched += e - s
            if span is not None and s < span["start_ns"]:
                early += 1
        device[phase] += e - s
        by_op[f"{phase}| {name}"[:120]] += (e - s) / 1e9
        in_phase[phase][name[:120]] += (e - s) / 1e9
    busy, gaps = 0, defaultdict(float)
    cur_s = cur_e = None
    for name, s, e, _ in ops:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps[f"{tag(line.at(cur_e))}| before {name[:100]}"] += \
                (s - cur_e) / 1e9
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    total = sum(device.values())

    def top(d, n=10):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:n]]

    return {
        "steps": steps,
        "ms_per_step": ({p: v / 1e6 / steps for p, v in device.items()}
                        if steps else {}),
        "device_s": {p: v / 1e9 for p, v in device.items()},
        "busy_s": busy / 1e9,
        "launch_coverage": launched / total if total else 0.0,
        "early_ops": early,
        "breakdown": {"device_ops": top(by_op), "idle_gaps": top(gaps)},
        "top_by_phase": {p: top(d, 5) for p, d in in_phase.items()},
    }


def _spans_on_the_clock(tracing) -> bool:
    """Whether the program emits spans stamped with ``start_ns`` (tracing
    on, and a program that stamps them)."""
    got = []
    tracing.set_sink(got.append)
    try:
        with tracing.span("portbench.probe"):
            pass
    finally:
        tracing.set_sink(None)
    return bool(got) and "start_ns" in got[0]


def measure(run) -> Optional[Dict]:
    """The phase window of training cell ``run`` (a ``portbench.run.Run``
    whose cell has run), or None where it has nothing to read."""
    import torch
    from ray_tpu_torch.models import training, transformer
    from ray_tpu_torch.util import tracing

    from portbench import weights
    from portbench.drivers import port_config
    from portbench.drivers import train as train_cell
    from portbench.traffic import train as traffic

    if run.device != "cuda" or not _spans_on_the_clock(tracing):
        return None
    cfg, mix, dev = run.cfg, run.mix, run.device
    tcfg = port_config(cfg, torch, remat=mix["remat"])
    opt = train_cell.optimizer(mix)
    made = weights.make(cfg, run.seed, dev, tcfg.param_dtype)
    bundle = training.make_train_step(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, tcfg),
        init_params_fn=lambda seed: made,
        optimizer=training.adamw(opt["lr"], b1=opt["b1"], b2=opt["b2"],
                                 eps=opt["eps"],
                                 weight_decay=opt["weight_decay"]),
        device=dev)
    params, state = bundle.init(run.seed)
    del made

    def feed(i):
        return {"tokens": traffic.batch(mix, run.seed, i, dev)}

    for i in range(WARM):
        params, state, _ = bundle.step(params, state, feed(i))
    torch.cuda.synchronize()
    spans: List[Dict] = []
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    tracing.set_sink(spans.append)
    prof.__enter__()
    try:
        with tracing.span("portbench.phases"):
            for i in range(STEPS):
                params, state, _ = bundle.step(params, state,
                                               feed(WARM + i))
            torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
        tracing.set_sink(None)
    ops, launches = split_events(prof.profiler.kineto_results.events(),
                                 torch.autograd.DeviceType.CUDA)
    del prof, params, state, bundle
    gc.collect()
    torch.cuda.empty_cache()
    got = attribute(ops, launches, spans)
    return got if got["steps"] else None


def of(run) -> Optional[Dict]:
    """:func:`measure` once a run (the readers share it), in traced runs
    only; printed on standard error where it read something."""
    if run.trace_window is None:
        return None
    if "phases" not in run.extra:
        got = run.extra["phases"] = measure(run)
        if got is not None:
            print(f"phases {json.dumps(got)}", file=sys.stderr, flush=True)
    return run.extra["phases"]

"""The phase attribution (``portbench/phases.py``) on synthetic operations,
launch records and spans, and its readers where there is nothing to read."""

from __future__ import annotations

import contextlib
import importlib.util
import json

import pytest

from portbench import phases
from portbench import run as bench_run
from portbench.trace import Window

READERS = ["forward_ms.train", "loss_ms.train", "backward_ms.train",
           "optimizer_ms.train"]


def _span(name, s, e, sid=None, parent=None):
    return {"name": name, "start_ns": s, "end_ns": e, "task_id": sid or name,
            "parent_span_id": parent}


def _step(t0):
    """One step's spans at ``t0``: forward [10, 40), loss [40, 50),
    backward [50, 90), optimizer [90, 98), inside the step [5, 100)."""
    sid = f"step{t0}"
    return [_span("lm.forward", t0 + 10, t0 + 40, parent=sid),
            _span("lm.loss", t0 + 40, t0 + 50, parent=sid),
            _span("train.backward", t0 + 50, t0 + 90, parent=sid),
            _span("train.optimizer", t0 + 90, t0 + 98, parent=sid),
            _span("train.step", t0 + 5, t0 + 100, sid=sid)]


# Two steps at 1000 and 2000. Each op: (name, device start, end, corr) and
# its launch's host time. Device lags the host; the card idles twice.
OPS = [
    ("feed", 1001, 1006, 1, 1000),           # before the step: no span
    ("gemm_f", 1020, 1060, 2, 1015),         # forward
    ("ln_f", 1060, 1070, 3, 1030),           # forward
    ("xent", 1080, 1090, 4, 1045),           # loss, after a 10 ns gap
    ("add", 1090, 1150, 5, 1055),            # backward
    ("fill", 1150, 1160, 6, 1089),           # backward
    ("adam", 1160, 1170, 7, 1092),           # optimizer
    ("seven", 1170, 1171, 8, 1099),          # the step itself
    ("gemm_f", 2020, 2060, 12, 2015),        # second step's forward
    ("add", 2060, 2100, 15, 2060),           # backward
    ("lost", 2100, 2105, 99, None),          # no launch record
]


def _inputs():
    ops = [o[:4] for o in OPS]
    launches = {o[3]: o[4] for o in OPS if o[4] is not None}
    return ops, launches, _step(1000) + _step(2000)


def test_timeline_finds_the_innermost_open_span():
    line = phases.Timeline(_step(0))
    assert line.at(-1) is None
    assert line.at(5)["name"] == "train.step"
    assert line.at(9)["name"] == "train.step"
    assert line.at(10)["name"] == "lm.forward"
    assert line.at(39)["name"] == "lm.forward"
    assert line.at(40)["name"] == "lm.loss"
    assert line.at(98)["name"] == "train.step"
    assert line.at(100) is None
    assert phases.tag(line.at(60)) == "backward"
    assert phases.tag(None) == phases.NO_SPAN


def test_per_phase_sums():
    got = phases.attribute(*_inputs())
    assert got["steps"] == 2
    assert got["device_s"] == pytest.approx(
        {k: v / 1e9 for k, v in {
            "forward": 40 + 10 + 40, "loss": 10, "backward": 60 + 10 + 40,
            "optimizer": 10, "step": 1, phases.NO_SPAN: 5,
            phases.NO_LAUNCH: 5}.items()})
    assert got["ms_per_step"]["backward"] == pytest.approx(110 / 1e6 / 2)
    assert got["ms_per_step"]["forward"] == pytest.approx(90 / 1e6 / 2)
    total = sum(o[2] - o[1] for o in OPS)
    assert sum(got["device_s"].values()) == pytest.approx(total / 1e9)
    assert got["launch_coverage"] == pytest.approx((total - 5) / total)
    assert got["early_ops"] == 0


def test_ops_launched_outside_every_span_are_no_span():
    ops, launches, spans = _inputs()
    got = phases.attribute(ops, launches, [])
    assert got["steps"] == 0 and got["ms_per_step"] == {}
    assert set(got["device_s"]) == {phases.NO_SPAN, phases.NO_LAUNCH}


def test_the_windows_root_span_is_left_out():
    """The root span the window opens around its steps changes nothing:
    what it launches outside the steps stays ``(no span)``."""
    ops, launches, spans = _inputs()
    root = _span("portbench.phases", 0, 3000)
    assert phases.attribute(ops, launches, spans + [root]) == \
        phases.attribute(ops, launches, spans)


def test_an_op_starting_before_its_span_is_counted():
    ops, launches, spans = _inputs()
    ops[1] = ("gemm_f", 1009, 1060, 2)      # before lm.forward's 1010
    assert phases.attribute(ops, launches, spans)["early_ops"] == 1


def test_gaps_named_by_the_span_open_at_their_start():
    got = phases.attribute(*_inputs())
    gaps = dict(got["breakdown"]["idle_gaps"])
    # 1006 -> 1020: the host was in the step, before lm.forward opened
    assert gaps["step| before gemm_f"] == pytest.approx(14e-9)
    # 1070 -> 1080: the host had moved on into backward
    assert gaps["backward| before xent"] == pytest.approx(10e-9)
    # 1171 -> 2020: between steps, then 2020's forward
    assert gaps[f"{phases.NO_SPAN}| before gemm_f"] == pytest.approx(849e-9)
    ops = dict(got["breakdown"]["device_ops"])
    assert ops["backward| add"] == pytest.approx(100e-9)
    assert ops["forward| gemm_f"] == pytest.approx(80e-9)
    assert all("| " in k for k in list(gaps) + list(ops))
    assert got["top_by_phase"]["backward"] == [["add", pytest.approx(100e-9)],
                                               ["fill", pytest.approx(10e-9)]]


def _window(ops):
    w = Window(None)
    w.ops = [o[:3] for o in ops]
    w.window_s = 2e-6
    w._reduce()
    return w


def test_attribution_leaves_the_window_as_it_was():
    """Busy time as the window reduces it, and the window's operations,
    busy time and idle share untouched by the attribution."""
    ops, launches, spans = _inputs()
    w = _window(ops)
    before = (list(w.ops), w.busy_s, w.idle_share(), w.breakdown())
    got = phases.attribute(ops, launches, spans)
    assert got["busy_s"] == pytest.approx(w.busy_s)
    assert (list(w.ops), w.busy_s, w.idle_share(), w.breakdown()) == before
    # the tagged names keep the window's own text after the tag
    untagged = {k.split("| ", 1)[1] for k, _ in got["breakdown"]["idle_gaps"]}
    assert untagged == {k for k, _ in w.breakdown()["idle_gaps"]}


class _Event:
    def __init__(self, name, dev, s, d, corr):
        self._v = (name, dev, s, d, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_split_events_joins_launches_by_correlation():
    CPU, CUDA = "cpu", "cuda"
    events = [_Event("k2", CUDA, 50, 5, 2), _Event("k1", CUDA, 30, 10, 1),
              _Event("cudaLaunchKernel", CPU, 10, 3, 1),
              _Event("cuLaunchKernel", CPU, 11, 1, 1),
              _Event("cudaMemcpyAsync", CPU, 20, 2, 2),
              _Event("cudaDeviceSynchronize", CPU, 60, 9, 7),
              _Event("no corr", CPU, 5, 1, 0)]
    ops, launches = phases.split_events(events, CUDA)
    assert ops == [("k1", 30, 40, 1), ("k2", 50, 55, 2)]
    assert launches == {1: 10, 2: 20}


def _reader(root, name):
    spec = importlib.util.spec_from_file_location(
        name, root / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Run:
    def __init__(self, window, device="cuda"):
        self.trace_window = window
        self.device = device
        self.extra = {}


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_a_window_or_card(checkout, name):
    read = _reader(checkout, name)
    assert read(_Run(None)) is None
    run = _Run(_window(_inputs()[0]), device="cpu")
    assert read(run) is None
    assert run.extra["phases"] is None


def test_no_spans_on_the_clock_reads_nothing(monkeypatch):
    """A program whose spans carry no ``start_ns`` (as before they did), or
    tracing gated off, gives the readers nothing."""
    from ray_tpu_torch.core import config as cfg_mod
    from ray_tpu_torch.util import tracing

    monkeypatch.setattr(cfg_mod, "_global", None)
    monkeypatch.delenv("RAY_TPU_TRACE_ENABLED", raising=False)
    assert phases._spans_on_the_clock(tracing)

    class Old:
        _sink = None

        @classmethod
        def set_sink(cls, sink):
            cls._sink = sink

        @classmethod
        @contextlib.contextmanager
        def span(cls, name):
            yield ("t", "s")
            cls._sink({"name": name, "time": 1.0, "duration": 0.0})

    assert not phases._spans_on_the_clock(Old)
    monkeypatch.setenv("RAY_TPU_TRACE_ENABLED", "0")
    assert not phases._spans_on_the_clock(tracing)


def test_traced_cpu_train_run_leaves_the_phase_metrics_out(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench_run.metrics_of(
        bench, bench_run._cell(bench, "tiny.train"), True)}
    assert set(READERS) <= names
    r, line = bench_run.run_cell(checkout, bench, "tiny.train", 2**33 + 9,
                                 0.5, True, "cpu")
    assert line["correct"]
    assert not set(READERS) & set(line["metrics"])

"""The port's train-step phase spans (``models/training.py`` and
``models/transformer.py`` over ``util/tracing.py``): what one step emits
inside a trace, how the spans nest, that a step outside a trace someone
asked for emits nothing (into a sink or into a runtime's GCS), that the
gate turns them off, that they change nothing the step computes, and that
their clock is the one ``torch.profiler`` stamps host events with.
"""

import time

import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test process)

from ray_tpu_torch.core import config as cfg_mod
from ray_tpu_torch.models import training, transformer
from ray_tpu_torch.util import tracing

PHASES = ["lm.forward", "lm.loss", "train.backward", "train.optimizer"]
B, L = 2, 32


@pytest.fixture
def no_runtime_config(monkeypatch):
    """Knobs from the environment alone (no table installed)."""
    monkeypatch.setattr(cfg_mod, "_global", None)
    monkeypatch.delenv("RAY_TPU_TRACE_ENABLED", raising=False)
    monkeypatch.delenv("RAY_TPU_TRACE_SAMPLE_RATE", raising=False)
    return monkeypatch


@pytest.fixture
def sink():
    spans = []
    tracing.set_sink(spans.append)
    yield spans
    tracing.set_sink(None)


def _bundle(remat=False):
    cfg = transformer.tiny(max_seq_len=L, remat=remat)
    return training.make_train_step(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg),
        init_params_fn=lambda seed: transformer.init_params(cfg, seed,
                                                            device="cpu"),
        optimizer=training.adamw(1e-3, weight_decay=0.1), device="cpu"), cfg


def _batch(cfg, i):
    g = torch.Generator().manual_seed(100 + i)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, L), generator=g)}


def _traced(steps, remat=False):
    """``_train`` inside a root span: a trace someone asked for."""
    with tracing.span("fit"):
        return _train(steps, remat)


def _train(steps, remat=False):
    bundle, cfg = _bundle(remat)
    params, opt = bundle.init(0)
    losses = []
    for i in range(steps):
        params, opt, m = bundle.step(params, opt, _batch(cfg, i))
        losses.append(m["loss"].detach().clone())
    return losses, _flat(params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().clone()
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_step_emits_nested_phase_spans(no_runtime_config, sink, remat):
    steps = 2
    _traced(steps, remat)
    fit = sink.pop()
    assert fit["name"] == "fit"
    assert [s["name"] for s in sink] == (PHASES + ["train.step"]) * steps
    for k in range(steps):
        group = sink[5 * k:5 * k + 5]
        step = group[-1]
        assert step["parent_span_id"] == fit["task_id"]
        assert step["attrs"] == {"tokens": B * L}
        children = group[:-1]
        assert all(c["parent_span_id"] == step["task_id"]
                   and c["trace_id"] == step["trace_id"] for c in children)
        assert all("attrs" not in c for c in children)
        for s in group:
            assert isinstance(s["start_ns"], int)
            assert s["start_ns"] <= s["end_ns"]
            assert s["time"] == s["end_ns"] / 1e9
            assert s["duration"] == (s["end_ns"] - s["start_ns"]) / 1e9
        for c in children:
            assert step["start_ns"] <= c["start_ns"] <= c["end_ns"] \
                <= step["end_ns"]
        # in the step's order, one after the other
        for a, b in zip(children, children[1:]):
            assert a["end_ns"] <= b["start_ns"]


def test_step_spans_nest_under_the_active_context(no_runtime_config, sink):
    with tracing.span("worker") as (trace_id, worker_id):
        _train(1)
    step = next(s for s in sink if s["name"] == "train.step")
    assert step["parent_span_id"] == worker_id
    assert {s["trace_id"] for s in sink} == {trace_id}


def test_step_outside_a_trace_emits_nothing(no_runtime_config, sink):
    _train(2)
    assert sink == []


def test_gate_off_emits_nothing(no_runtime_config, sink):
    no_runtime_config.setenv("RAY_TPU_TRACE_ENABLED", "0")
    _traced(2)
    assert sink == []


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_spans_change_nothing_the_step_computes(no_runtime_config, sink,
                                                remat):
    losses_on, params_on = _traced(3, remat)
    assert len(sink) == 16
    no_runtime_config.setenv("RAY_TPU_TRACE_ENABLED", "0")
    losses_off, params_off = _traced(3, remat)
    assert len(sink) == 16
    for a, b in zip(losses_on, losses_off):
        assert torch.equal(a, b)
    assert params_on.keys() == params_off.keys()
    for k in params_on:
        assert torch.equal(params_on[k], params_off[k]), k


def test_emit_lays_the_duration_back_from_the_end(no_runtime_config, sink):
    ctx = tracing.new_root_context()
    tracing.emit("e", ctx, duration=0.25, end_time=1000.5)
    (e,) = sink
    assert e["end_ns"] == 1000_500_000_000
    assert e["start_ns"] == 1000_250_000_000
    assert e["time"] == 1000.5 and e["duration"] == 0.25
    before = time.time_ns()
    tracing.emit("now", ctx, duration=0.001)
    assert before <= sink[1]["end_ns"] <= time.time_ns()
    assert sink[1]["end_ns"] - sink[1]["start_ns"] == 1_000_000


def test_span_clock_is_the_profilers(no_runtime_config, sink):
    """A ``record_function`` range inside a span lies inside the span's
    ``[start_ns, end_ns]`` as Kineto stamps it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with record_function("inside_span"):
                (x @ x).sum()
    (span,) = sink
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "inside_span"]
    assert len(events) == 1
    e = events[0]
    start, end = e.start_ns(), e.start_ns() + e.duration_ns()
    assert span["start_ns"] <= start <= end <= span["end_ns"], \
        (span["start_ns"], start, end, span["end_ns"])


# -- with a runtime up: what reaches its GCS ------------------------------------

@pytest.fixture
def runtime():
    import ray_tpu_torch

    ray_tpu_torch.init(resources={"CPU": 2})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _gcs_phases(rt):
    """The phase spans the runtime's GCS holds, after a flush."""
    from ray_tpu_torch.core import runtime as runtime_mod

    tracing.flush()
    names = set(PHASES) | {"train.step"}
    return [e for e in runtime_mod.get_runtime().gcs.task_events()
            if e.get("name") in names]


def _steps_in_a_task(steps):
    _train(steps)
    return steps


def test_untraced_steps_ship_nothing_to_the_gcs(no_runtime_config, runtime):
    """Neither a loop in the driver nor one inside a task that no caller
    traced (which runs as a trace of its own) ships a phase span."""
    _train(2)
    task = runtime.remote(_steps_in_a_task)
    assert runtime.get(task.remote(2)) == 2
    assert _gcs_phases(runtime) == []


def test_traced_steps_ship_under_their_trace(no_runtime_config, runtime):
    """Inside a span, and inside a task its traced caller submitted, each
    step ships its five spans, in the caller's trace, the task's steps under
    the task's span."""
    with tracing.span("fit") as (trace_id, _):
        _train(2)
        task = runtime.remote(_steps_in_a_task)
        assert runtime.get(task.remote(3)) == 3
    got = _gcs_phases(runtime)
    assert len(got) == 5 * (2 + 3)
    assert {e["trace_id"] for e in got} == {trace_id}
    steps = [e for e in got if e["name"] == "train.step"]
    (task_event,) = [e for e in _trace_events(trace_id)
                     if e.get("name") == "_steps_in_a_task"]
    assert sum(s["parent_span_id"] == task_event["span_id"]
               for s in steps) == 3


def _trace_events(trace_id):
    from ray_tpu_torch.core import runtime as runtime_mod

    return runtime_mod.get_runtime().gcs.trace(trace_id)

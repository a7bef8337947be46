"""The check catches a broken timed path, and the lower-precision control.

Each test drives a whole run of a tiny cell on the CPU (the harness's look
for a chip skipped) with one fault planted under the timed path, and sees
``correct`` come out false: a training step that returns its state
unchanged; half of every batch left out, the mean taken over the rest; a
served token altered where it is produced. (The cells run on one chip: no
exchange between chips to leave out.) The control, the plain reference in
float8 put in the program's place, fails the same limits."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import calibrate, check, weights
from portbench import run as bench_run
from portbench.reference import gpt2
from portbench.tests.conftest import TINY


def _run(root, cell, **kw):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return bench_run.run_cell(root, bench, cell, 2**34 + 9, 0.5, False,
                              "cpu", driver_kw=kw or None)


def _faulty_step(fault):
    from ray_tpu_torch.models import training

    def make(**kw):
        bundle = training.make_train_step(**kw)
        real = bundle.step

        def step(params, state, batch):
            if fault == "unchanged":
                loss = kw["loss_fn"](params, batch).detach()
                return params, state, {"loss": loss, "grad_norm": loss * 0}
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return real(params, state, half)

        bundle.step = step
        return bundle

    return make


@pytest.mark.parametrize("fault,number", [("unchanged", "update_gap"),
                                          ("half_batch", "grad_gap")])
def test_training_fault_is_not_correct(checkout, fault, number):
    r, line = _run(checkout, "tiny.train", make_step=_faulty_step(fault))
    assert line["correct"] is False
    c = line["check"][number]
    assert c["value"] > c["limit"], line["check"]


def test_altered_token_is_not_correct(checkout, monkeypatch):
    from ray_tpu_torch.serve import llm

    real = llm.PagedLLMEngine.drive

    def drive(self, req):
        for i, tok in enumerate(real(self, req)):
            yield (tok + 1) % self.config.vocab_size if i == 2 else tok

    monkeypatch.setattr(llm.PagedLLMEngine, "drive", drive)
    r, line = _run(checkout, "tiny.serve")
    assert line["correct"] is False
    c = line["check"]["widest_gap"]
    assert c["value"] > c["limit"]


def test_serving_control_reads_above_the_limit(checkout):
    """The driver reads the control and the altered token on its own
    sample; at this size the sample's near ties depend on the threads'
    timing, so the control's reading is held here over fixed sequences:
    at each position of the same tokens, the gap of the token the float8
    reference puts first."""
    r, line = _run(checkout, "tiny.serve", control=True)
    assert line["correct"]
    assert set(r.extra["calibration"]) == {"control_gap", "altered_token_gap"}
    limit = line["check"]["widest_gap"]["limit"]
    params = weights.make(TINY, 21, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(5)
    worst = 0.0
    for _ in range(6):
        seq = torch.randint(0, TINY["vocab_size"], (48,), generator=gen)
        ref = gpt2.next_token_logits(params, seq.tolist(), 8, TINY)
        low = gpt2.next_token_logits(params, seq.tolist(), 8, TINY, fp8=True)
        worst = max(worst, check.widest_gap(ref, low.argmax(-1).tolist())[0])
        assert check.widest_gap(ref, ref.argmax(-1).tolist())[0] == 0.0
    assert worst > limit


def test_training_control_fails_the_cell(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cell = bench_run._cell(bench, "tiny.train")
    run = bench_run.Run(checkout, cell, 2**34 + 11, 1, False, "cpu")
    out = calibrate._train_readings(run, run.seed)
    ok, _ = check.judge(out["control_fp8"], run.limits)
    assert not ok
    for fault in ("fault_half_batch", "fault_state_unchanged"):
        assert not check.judge(out[fault], run.limits)[0]
    assert out["fault_state_unchanged"]["update_gap"] == 1.0

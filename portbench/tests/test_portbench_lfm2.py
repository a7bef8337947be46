"""The LFM2 training cell's files: a tiny ``train_lfm2`` cell run end to end
on the CPU through the harness (correct, its readers silent where there is
no card), its control and faults failing the cell's limits, the traffic,
the weights, the counting functions, and the import audit of the new
modules."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import check, lfm2_counts, roofline, weights_lfm2
from portbench import run as bench_run
from portbench.tests.conftest import REPO, make_checkout
from portbench.traffic import train_lfm2 as traffic

CELL = "lfm2-8b-a1b.train-8k"
TINY_CELL = "tiny-lfm2.train"
METRICS = ["mfu.lfm2-train", "moe_ms.lfm2-train", "conv_ms.lfm2-train",
           "grouped_gemm_roofline.lfm2-train", "flash_roofline.lfm2-train",
           "expert_load_max.lfm2-train", "forward_ms.lfm2-train",
           "loss_ms.lfm2-train", "backward_ms.lfm2-train",
           "optimizer_ms.lfm2-train", "elementwise_share.lfm2-train",
           "device_idle_share.lfm2-train"]
# The benchmark's configuration, cut to a CPU test: every kind of layer and
# FFN, 8 routed experts of which 4 are held.
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=4,
            layer_types=["conv", "full_attention", "conv", "full_attention"],
            num_experts=4, experts_held=[0, 4], published={"num_experts": 8},
            num_experts_per_tok=2, num_dense_layers=1, vocab_size=512,
            dtype="float32", max_position_embeddings=64)


def _checkout(tmp_path):
    root = make_checkout(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "lfm2-8b-a1b.json").read_text())
    cfg.update(TINY)
    (pb / "configs" / "tiny-lfm2.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "packed-4x8192.json").read_text())
    mix.update(batch=4, seq=64, doc_median=20, doc_min=4, doc_max=200,
               reference_rows=2)
    (pb / "traffic" / "tiny-lfm2.json").write_text(json.dumps(mix))
    (pb / "workloads" / f"{TINY_CELL}.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-3,
                    "route_gap": 1e-3}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny-lfm2",
                               "traffic": "tiny-lfm2", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


@pytest.fixture
def lfm2_checkout(tmp_path):
    return _checkout(tmp_path)


def test_the_cell_and_its_metrics_are_declared():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = bench_run._cell(bench, CELL)
    assert cell["chips"] == 1 and cell["config"] == "lfm2-8b-a1b"
    assert {m["name"] for m in bench_run.metrics_of(bench, cell, False)} \
        == {"setup_s", "train_tokens_per_s"}
    assert [m["name"] for m in bench_run.metrics_of(bench, cell, True)] \
        == METRICS
    mix = json.loads((REPO / "portbench" / "traffic" / "packed-4x8192.json")
                     .read_text())
    assert mix["kind"] == "train_lfm2"
    assert (REPO / "portbench" / "drivers" / "train_lfm2.py").exists()


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_and_is_correct(lfm2_checkout, trace):
    root, bench = lfm2_checkout
    r, line = bench_run.run_cell(root, bench, TINY_CELL, 2**40 + 7, 0.5,
                                 trace, "cpu")
    assert line["correct"], line["check"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    detail = r.extra["check_detail"]
    assert detail["route_agreement"] == 1.0 and detail["bias_gap"] == 0.0
    assert set(line["check"]) == {"loss_gap", "grad_gap", "update_gap",
                                  "route_gap"}
    assert line["check"]["route_gap"]["value"] == 0.0
    if not trace:
        assert set(line["metrics"]) == {"setup_s", "train_tokens_per_s"}
    else:
        # On the CPU: the counters and the host clock, no device metric.
        assert set(line["metrics"]) == {"mfu.lfm2-train",
                                        "expert_load_max.lfm2-train"}
        assert line["metrics"]["expert_load_max.lfm2-train"]["value"] >= 1
    x = r.extra["lfm2"]
    assert x["topk_calls"] == r.extra["steps"] * x["moe_layers"] * 2  # remat


def test_control_and_faults_fail_the_tiny_cell(lfm2_checkout):
    root, bench = lfm2_checkout
    r, line = bench_run.run_cell(root, bench, TINY_CELL, 2**34 + 11, 0.3,
                                 False, "cpu", driver_kw={"control": True})
    assert line["correct"]
    cal = r.extra["calibration"]
    for name in ("control_fp8", "fault_half_batch", "fault_state_unchanged"):
        assert not check.judge(cal[name], r.limits)[0], name
    assert cal["fault_state_unchanged"]["update_gap"] == 1.0
    # Step 1's picks: the program's and the faults' are the reference's.
    assert cal["program"]["route_gap"] == 0.0
    assert cal["fault_half_batch"]["route_gap"] == 0.0
    assert 0.0 <= cal["control_fp8"]["route_gap"] <= 1.0


def test_a_routing_fault_fails_the_route_gap(lfm2_checkout, monkeypatch):
    """A program whose router picks the lowest-scored experts: its top-k
    sets differ from the reference's almost everywhere."""
    from ray_tpu_torch.ops import moe

    route = moe.route_topk
    monkeypatch.setattr(moe, "route_topk", lambda x, router, *a, **kw:
                        route(x, -router, *a, **kw))
    root, bench = lfm2_checkout
    r, line = bench_run.run_cell(root, bench, TINY_CELL, 2**36 + 5, 0.3,
                                 False, "cpu")
    assert not line["correct"]
    assert line["check"]["route_gap"]["value"] > 0.5


def test_the_cells_limits_hold_the_route_gap():
    limits = json.loads((REPO / "portbench" / "workloads" / f"{CELL}.json")
                        .read_text())["limits"]
    assert set(limits) == {"grad_gap", "update_gap", "route_gap"}


def test_readers_are_silent_on_other_cells(checkout):
    """The GPT-2 tiny cell, traced: the LFM2 readers read nothing."""
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    r, line = bench_run.run_cell(checkout, bench, "tiny.train", 2**33 + 3,
                                 0.3, True, "cpu")
    for name in METRICS:
        assert bench_run._reader(checkout, name)(r) is None


def test_traffic_packs_documents_and_never_draws_eos():
    mix = {"batch": 3, "seq": 256, "doc_median": 20, "doc_sigma": 1.0,
           "doc_min": 4, "doc_max": 200, "eos": 7}
    a = traffic.batch(mix, 512, 2**41 + 3, 0, "cpu")
    assert a.shape == (3, 256) and a.dtype == torch.int64
    assert torch.equal(a, traffic.batch(mix, 512, 2**41 + 3, 0, "cpu"))
    assert not torch.equal(a, traffic.batch(mix, 512, 2**41 + 3, 1, "cpu"))
    assert 0 <= int(a.min()) and int(a.max()) < 512
    eos = (a == 7).sum(dim=1)
    assert (eos >= 1).all() and (eos < 256 // 4).all()
    ids = a[a != 7]
    assert (ids < 7).any() and (ids > 7).any()


def test_weights_follow_the_configuration():
    cfg = json.loads((REPO / "portbench" / "configs" / "lfm2-8b-a1b.json")
                     .read_text())
    cfg.update(TINY)
    w = weights_lfm2.make(cfg, 2**45 + 1, "cpu", torch.float32)
    assert w["conv"]["in_proj"].shape == (2, 64, 192)
    assert w["conv"]["conv"].shape == (2, 64, 3)
    assert w["attn"]["wk"].shape == (2, 64, 32)
    assert w["moe"]["router"].shape == (3, 64, 8)
    assert w["moe"]["w13"].shape == (3, 4, 64, 64)
    assert w["dense"]["w2"].shape == (1, 96, 64)
    assert torch.equal(w["moe"]["w2"], weights_lfm2.make(
        cfg, 2**45 + 1, "cpu", torch.float32)["moe"]["w2"])
    assert (w["attn"]["q_norm"] == 1).all()


def test_counts_at_the_published_sizes():
    cfg = json.loads((REPO / "portbench" / "configs" / "lfm2-8b-a1b.json")
                     .read_text())
    D, V = 2048, 65536
    conv, attn = 18 * 4 * D * D, 6 * (2 * D * D + 2 * D * 512)
    assert lfm2_counts.matmul_params(cfg) == (
        conv + attn + 2 * 3 * D * 7168 + 22 * D * 32 + D * V)
    assert lfm2_counts.expert_flops(cfg, 10) == 6 * 3 * D * 1792 * 10
    assert lfm2_counts.attention_flops(cfg, 4, 8192) == (
        3 * 6 * 4 * D * roofline.causal_pairs(8192) * 4)
    held = 22 * 32768 * 4 * 8 // 32
    step = lfm2_counts.train_step_flops(cfg, 4, 8192, held)
    assert 1.80e14 < step < 1.86e14
    (b1, f1), (b2, f2) = lfm2_counts.grouped_launches(cfg, 4096)
    assert f1 == 2 * 4096 * D * 2 * 1792 and f2 == 2 * 4096 * 1792 * D
    assert b1 == (4096 * D + 8 * D * 3584 + 4096 * 3584) * 2
    one = roofline.bound_s(b1, f1) + roofline.bound_s(b2, f2)
    assert lfm2_counts.grouped_bound_s(cfg, 4096, 2) == pytest.approx(
        22 * 4 * one)


def test_the_new_modules_load_nothing_of_the_port_or_jax():
    code = textwrap.dedent(f"""
        import json, sys
        for name in ("jax", "jaxlib", "flax", "ray_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {str(REPO)!r})
        import portbench.reference.lfm2_moe, portbench.lfm2_counts
        import portbench.weights_lfm2, portbench.traffic.train_lfm2
        print(json.dumps(sorted({{m.split(".")[0]
                                  for m, v in sys.modules.items() if v}})))
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "ray_tpu", "ray_tpu_torch"}


def test_a_whole_lfm2_run_loads_no_jax(tmp_path):
    code = textwrap.dedent(f"""
        import json, sys
        for name in ("jax", "jaxlib", "flax", "ray_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from portbench.tests import test_portbench_lfm2 as t
        from portbench import run
        root, bench = t._checkout(Path({str(tmp_path)!r}))
        r, line = run.run_cell(root, bench, t.TINY_CELL, 2**35 + 1, 0.3,
                               True, "cpu")
        assert line["correct"], line
        assert run.loaded_forbidden() == [], run.loaded_forbidden()
        print("ok")
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("ok")

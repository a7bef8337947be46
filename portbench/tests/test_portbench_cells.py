"""Tiny cells run end to end on the CPU through the harness, and a cell, a
configuration and a metric added as files alone."""

from __future__ import annotations

import json

import pytest

from portbench import run as bench_run


def _run(root, name, trace=False, seconds=1.0, seed=2**33 + 5, **kw):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return bench_run.run_cell(root, bench, name, seed, seconds, trace, "cpu",
                              driver_kw=kw or None)


def _contract_shaped(line, names):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert set(line["metrics"]) == set(names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    json.loads(json.dumps(line))


def test_train_cell_runs_and_is_correct(checkout):
    r, line = _run(checkout, "tiny.train")
    assert line["correct"], line["check"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    _contract_shaped(line, {"setup_s", "train_tokens_per_s"})
    assert set(line["check"]) == {"loss_gap", "grad_gap", "update_gap"}
    assert r.extra["check_detail"]["still_leaves"] == ["blocks.bk"]


def test_serve_cell_runs_and_is_correct(checkout):
    r, line = _run(checkout, "tiny.serve")
    assert line["correct"], line["check"]
    assert line["failed"] == 0
    _contract_shaped(line, {"setup_s", "serve_output_tokens_per_s"})
    assert r.extra["check_sample"]["tokens"] > 0
    assert r.extra["stats1"]["kv_hit_tokens"] > 0


def test_traced_cpu_run_reports_no_device_numbers(checkout):
    """On the CPU nothing is traced: the counter and clock metrics are
    read, the device ones are left out, never written as 0."""
    r, line = _run(checkout, "tiny.serve", trace=True)
    assert line["correct"]
    assert {"prefix_hit_share.serve", "decode_step_ms.serve",
            "mfu.serve"} <= set(line["metrics"])
    for name in ("k4_roofline.serve", "device_idle_share.serve"):
        assert name not in line["metrics"]


def test_a_new_cell_is_files_alone(checkout):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and entries run without a change to any existing file."""
    pb = checkout / "portbench"
    cfg = json.loads((pb / "configs" / "tiny.json").read_text())
    cfg.update(n_layer=1)
    (pb / "configs" / "tiny1.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "tiny-sessions.json").read_text())
    mix.update(share=False)
    (pb / "traffic" / "tiny-fresh.json").write_text(json.dumps(mix))
    (pb / "workloads" / "tiny1.fresh.json").write_text(json.dumps(
        {"limits": {"widest_gap": 1e-3}}))
    (pb / "metrics" / "requests_done.serve.py").write_text(
        "def read(run):\n"
        "    return float(sum(q.finished is not None\n"
        "                     for q in run.extra['requests']))\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny1.fresh", "config": "tiny1",
                               "traffic": "tiny-fresh", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("setup_s", "serve_output_tokens_per_s"):
            m.setdefault("workloads", []).append("tiny1.fresh")
    bench["per_layer"].append({
        "name": "requests_done.serve", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "serve/llm.py scheduler",
        "moves": "serve_output_tokens_per_s", "workloads": ["tiny1.fresh"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    r, line = _run(checkout, "tiny1.fresh", trace=True)
    assert line["correct"]
    assert line["metrics"]["requests_done.serve"]["value"] >= 1
    assert r.extra["stats1"]["kv_hit_tokens"] == 0


@pytest.mark.parametrize("cell,trace", [("tiny.train", False),
                                        ("tiny.serve", True)])
def test_metrics_of_follow_the_lists(checkout, cell, trace):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cellspec = next(w for w in bench["workloads"] if w["name"] == cell)
    names = {m["name"] for m in bench_run.metrics_of(bench, cellspec, trace)}
    kind = cell.split(".")[1]
    if trace:
        assert names == {m["name"] for m in bench["per_layer"]
                         if m["name"].endswith("." + kind)}
    else:
        assert names == {"setup_s", f"{kind}_tokens_per_s"
                         if kind == "train" else "serve_output_tokens_per_s"}

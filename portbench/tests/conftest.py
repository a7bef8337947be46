"""Shared fixtures: a checkout-shaped directory holding the benchmark's
files plus tiny cells that run on the CPU in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# A random GPT-2 as narrow as this one, with few layers, mostly predicts the
# token it was given, by a wide margin (the tied embedding's self-product);
# 256 wide over 4096 tokens leaves near ties, which the float8 control flips.
TINY = {
    "model": "tiny GPT-2 for CPU tests", "source": "tests",
    "n_embd": 256, "n_layer": 2, "n_head": 4, "n_positions": 64, "n_ctx": 64,
    "vocab_size": 4096, "n_inner": 1024, "activation_function": "gelu_new",
    "layer_norm_epsilon": 1e-05, "initializer_range": 0.02,
    "tie_word_embeddings": True, "reduced": [], "dtype": "float32",
    "param_dtype": "float32", "padded_vocab": 4096,
}
TRAIN_MIX = {
    "kind": "train", "batch": 4, "seq": 64, "doc_median": 20,
    "doc_sigma": 1.0, "doc_min": 4, "doc_max": 200, "eos": 4095,
    "remat": "full", "lr": 3e-4, "weight_decay": 0.1, "check_steps": 3,
    "reference_rows": 2,
}
SERVE_MIX = {
    "kind": "serve", "mode": "sessions", "share": True, "clients": 4,
    "slots": 4, "pool_blocks": 0, "prefill_tokens": 128, "sizes_seed": 0,
    "pool": 64,
    "system_prompts": 2, "system_len": [16, 24], "user_len": [2, 6],
    "output_len": [4, 8], "max_len": 64, "check_tokens": 80,
    "check_requests": 12, "ramp_timeout_s": 60, "stop_timeout_s": 60,
}
# The serving metrics: their readers are in portbench/metrics/; no cell of
# BENCHMARK.json serves yet (PERF.md says why), so the tests list them.
SERVE_E2E = [{"name": "serve_output_tokens_per_s", "unit": "tokens/s",
              "better": "higher", "bound": 0.25, "source": "host_clock",
              "workloads": []}]
SERVE_LAYERS = [
    {"name": n, "unit": u, "better": b, "source": src, "layer": layer,
     "moves": "serve_output_tokens_per_s", "workloads": []}
    for n, u, b, src, layer in [
        ("ttft_p95_ms.serve", "ms", "lower", "host_clock", "scheduler"),
        ("prefix_hit_share.serve", "%", "higher", "program_counter",
         "KVBlockManager"),
        ("decode_step_ms.serve", "ms", "lower", "program_counter",
         "PagedGenerator"),
        ("k4_roofline.serve", "%", "higher", "device_trace", "K4"),
        ("device_idle_share.serve", "%", "lower", "device_trace", "device"),
        ("mfu.serve", "%", "higher", "host_clock", "whole serving step")]]
CELLS = [
    {"name": "tiny.train", "config": "tiny", "traffic": "tiny-train",
     "chips": 1, "why": "CPU test"},
    {"name": "tiny.serve", "config": "tiny", "traffic": "tiny-sessions",
     "chips": 1, "why": "CPU test"},
]


def make_checkout(tmp_path: Path) -> Path:
    """A root with ``BENCHMARK.json`` (the repo's, plus the tiny cells) and
    a copy of ``portbench/`` holding the tiny cells' files."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (pb / "traffic" / "tiny-train.json").write_text(json.dumps(TRAIN_MIX))
    (pb / "traffic" / "tiny-sessions.json").write_text(json.dumps(SERVE_MIX))
    (pb / "workloads" / "tiny.train.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}}))
    (pb / "workloads" / "tiny.serve.json").write_text(json.dumps(
        {"limits": {"widest_gap": 1e-3}}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] += CELLS
    bench["end_to_end"] += SERVE_E2E
    bench["per_layer"] += SERVE_LAYERS
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "train" if "train" in m["name"] else "serve"
            m["workloads"].append(f"tiny.{kind}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path)

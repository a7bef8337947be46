"""The port's engine spans and serve metrics against the JAX package's.

Both packages run ``tiny(max_seq_len=64)`` in f32 on the CPU with the same
weights, one engine each under the same name, and capture spans through
``tracing.set_sink`` under a sampled root context. For one sequential
request the span names, parent links, attributes (keys and values; the
durations differ) and the number of ``llm.decode_chunk`` spans equal JAX's —
for the plain paged engine, the speculative one at k = 3 (its ``llm.spec``
spans), the slotted engine and the disaggregated one. The serve metrics'
deltas over the same requests equal JAX's: tokens delivered, the TTFT
histogram's observation counts by phase, prefix-hit tokens and the shed
counter. Both registries are process-wide, so every check reads a delta
under a deployment name no other test uses.
"""

import collections

import jax
import numpy as np
import pytest
import torch

from ray_tpu.core import metrics_export as jme
from ray_tpu.models import transformer as jtf
from ray_tpu.serve import llm as jllm
from ray_tpu.util import tracing as jtr
from ray_tpu_torch.core import metrics_export as tme
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.errors import Saturated
from ray_tpu_torch.util import tracing as ttr

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

GEOM = dict(prompt_buckets=(16, 32), chunk=4, slots=2, max_queue=0)
PAGED = dict(GEOM, block_tokens=8, pool_blocks=65)
PROMPT = [5, 9, 3, 77, 21, 8, 8, 1, 40, 2, 6]   # 11 tokens: 1 full block
PHASES = ("total", "queued", "prefill", "decode", "spec")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg = jtf.tiny(max_seq_len=64)
    params = jax.tree.map(lambda p: p * 3.0,   # varied greedy output
                          jtf.init_params(cfg, jax.random.key(2)))
    return (cfg, params, ttf.tiny(max_seq_len=64),
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))


def _engines(models, kind, name):
    """(JAX engine, port engine) of ``kind`` on the same weights."""
    jcfg, jp, tcfg, tp = models
    if kind == "paged":
        return (jllm.PagedLLMEngine(jp, jcfg, attention_kernel="gather",
                                    name=name, **PAGED),
                tllm.PagedLLMEngine(tp, tcfg, device="cpu", name=name,
                                    **PAGED))
    if kind == "spec":
        return (jllm.PagedLLMEngine(jp, jcfg, attention_kernel="gather",
                                    draft_params=jp, draft_config=jcfg,
                                    spec_tokens=3, name=name, **PAGED),
                tllm.PagedLLMEngine(tp, tcfg, device="cpu", draft_params=tp,
                                    draft_config=tcfg, spec_tokens=3,
                                    name=name, **PAGED))
    if kind == "slotted":
        return (jllm.LLMEngine(jp, jcfg, name=name, **GEOM),
                tllm.LLMEngine(tp, tcfg, device="cpu", name=name, **GEOM))
    return (jllm.DisaggregatedLLMEngine(jp, jcfg, name=name, **PAGED),
            tllm.DisaggregatedLLMEngine(tp, tcfg, device="cpu", name=name,
                                        **PAGED))


def _traced(tr, eng, prompt, n):
    """Run one request under a fresh sampled root; return (tokens, spans as
    (name, parented to the root, attrs))."""
    spans = []
    tr.set_sink(spans.append)
    root = tr.new_root_context()
    assert root is not None and root[2]
    tr.set_context(root)
    try:
        toks = eng.generate(prompt, max_new_tokens=n)
    finally:
        tr.set_context(None)
        tr.set_sink(None)
    for s in spans:
        assert s["trace_id"] == root[0] and s["kind"] == "span"
        assert s["duration"] >= 0
    return toks, [(s["name"], s["parent_span_id"] == root[1],
                   s.get("attrs")) for s in spans]


def _hist_counts(hist, name):
    counts = collections.Counter()
    for tags, (_, _, total) in hist._snapshot()["samples"]:
        tags = dict(tags)
        if tags.get("deployment") == name:
            counts[tags["phase"]] += total
    return counts


def _metrics(me, name):
    tags = {"deployment": name}
    return {"tokens": me.serve_tokens_total().get(tags),
            "hits": me.serve_kv_hit_tokens_total().get(tags),
            "ttft": _hist_counts(me.serve_ttft_hist(), name)}


def _delta(after, before):
    return {"tokens": after["tokens"] - before["tokens"],
            "hits": after["hits"] - before["hits"],
            "ttft": {p: after["ttft"][p] - before["ttft"][p]
                     for p in PHASES}}


@pytest.mark.parametrize("kind", ["paged", "spec", "slotted", "disagg"])
def test_spans_and_metrics_equal_jax(models, kind):
    name = f"obs-{kind}"
    jeng, teng = _engines(models, kind, name)
    try:
        jm0, tm0 = _metrics(jme, name), _metrics(tme, name)
        # A cold request, then a warm repeat that hits the prefix cache.
        for _ in range(2):
            jtoks, jspans = _traced(jtr, jeng, PROMPT, 10)
            ttoks, tspans = _traced(ttr, teng, PROMPT, 10)
            assert ttoks == jtoks
            assert tspans == jspans
        names = collections.Counter(s[0] for s in tspans)
        # 10 tokens: chunks of 4, or of up to 4 x (k + 1) with speculation.
        assert names["llm.decode_chunk"] >= (1 if kind == "spec" else 3)
        assert names["llm.prefill"] == names["llm.admission_wait"] == 1
        assert all(parented for _, parented, _ in tspans)
        if kind == "spec":
            assert names["llm.spec"] >= 1
            spec_attrs = [a for n, _, a in tspans if n == "llm.spec"]
            assert set(spec_attrs[0]) == {"slot", "spec_proposed",
                                          "spec_accepted"}
        jd = _delta(_metrics(jme, name), jm0)
        td = _delta(_metrics(tme, name), tm0)
        assert td == jd
        assert td["tokens"] == 20 and td["ttft"]["total"] == 2
        if kind != "slotted":
            assert td["hits"] > 0
    finally:
        if kind == "disagg":
            jeng.close()
            teng.close()


def test_block_occupancy_gauge_equals_jax(models):
    name = "obs-occupancy"
    jeng, teng = _engines(models, "paged", name)
    for eng in (jeng, teng):
        eng.generate(PROMPT, max_new_tokens=6)
    for state in ("active", "cached", "free"):
        tags = {"deployment": name, "state": state}
        assert tme.serve_kv_block_occupancy().get(tags) == \
            jme.serve_kv_block_occupancy().get(tags)


def test_shed_counter_equals_jax(models):
    """A submit past max_queue raises Saturated and counts one shed, in both
    packages."""
    name = "obs-shed"
    jcfg, jp, tcfg, tp = models
    kw = dict(PAGED, max_queue=1)
    jeng = jllm.PagedLLMEngine(jp, jcfg, attention_kernel="gather",
                               name=name, **kw)
    teng = tllm.PagedLLMEngine(tp, tcfg, device="cpu", name=name, **kw)
    tags = {"deployment": name, "reason": "saturated"}
    before = (jme.serve_shed_total().get(tags),
              tme.serve_shed_total().get(tags))
    for eng, err in ((jeng, jllm.Saturated), (teng, Saturated)):
        queued = eng.submit(PROMPT, max_new_tokens=4)
        with pytest.raises(err):
            eng.submit(PROMPT, max_new_tokens=4)
        eng._cancel(queued)
    after = (jme.serve_shed_total().get(tags),
             tme.serve_shed_total().get(tags))
    assert after[1] - before[1] == after[0] - before[0] == 1


def test_unsampled_root_emits_nothing(models, monkeypatch):
    """A root that samples out carries its decision: no engine span."""
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE_RATE", "0")
    _, teng = _engines(models, "paged", "obs-unsampled")
    spans = []
    ttr.set_sink(spans.append)
    root = ttr.new_root_context()
    ttr.set_context(root)
    try:
        teng.generate(PROMPT, max_new_tokens=4)
    finally:
        ttr.set_context(None)
        ttr.set_sink(None)
    assert root[2] is False and spans == []

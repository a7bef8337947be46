"""The Serve slice end to end on ``tiny``, against the JAX package.

JAX's ``serve.run(llm_deployment(tiny, ...))`` on ``ray_tpu.init`` and the
port's on ``ray_tpu_torch.init`` with ``device="cpu"``, from the same
``init_params`` carried across by ``params_from_numpy``, answer the same
concurrent greedy requests through streaming handles and over the HTTP
ingress: the token streams must be identical and the response dicts equal
key for key (``decode_tps`` and ``ttft_s`` only present and >= 0). One
traced request's spans and task events (names, parents, attributes), the
``serve_tokens_total`` delta and the quota shed's counter delta must equal
JAX's. The engine class each engine knob chooses must equal JAX's. The two
runtimes are separate module singletons and run one after the other in this
process.

Then the port's own rules: a ``num_gpus=1`` deployment with no card never
runs on the CPU; ``num_gpus`` (and its alias ``num_tpus``) reaches the
replica as a ``GPU`` grant, and a replica that finds no card left stays
pending; with ``kv_tier_enabled=1`` the paged engine serves on the tier
(its replica's engine stats carry the tier counters, and a repeated prompt
spills); nothing is left after ``serve.shutdown()`` and ``shutdown()``;
and ``start_proxies``
serves from a proxy actor on each virtual node until ``drain_proxy``.
"""

import json
import os
import socket
import threading
import time
import urllib.request
from importlib import import_module

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.core import config as jconfig
from ray_tpu.core import metrics_export as jme
from ray_tpu.models import transformer as jtf
from ray_tpu.serve import llm as jllm
from ray_tpu.util import tracing as jtr
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import config as tconfig
from ray_tpu_torch.core import metrics_export as tme
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.util import tracing as ttr

PROMPTS = [[7, 3, 11], [2, 4, 6, 8, 10], [1] * 9, [5, 9] * 7,
           list(range(100, 125))]
N_NEW = 10
LM_KW = dict(slots=2, chunk=4, tenant_quotas={"A": 1.0})
RATES = ("decode_tps", "ttft_s")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    cfg = jtf.tiny(max_seq_len=64)
    jparams = jax.tree.map(lambda p: p * 3.0,   # varied greedy output
                           jtf.init_params(cfg, jax.random.key(0)))
    return jparams, jax.tree.map(np.asarray, jparams)


def _from_threads(call, n):
    outs, errs = [None] * n, []

    def client(i):
        try:
            outs[i] = call(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return outs


def _http_stream(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/lm", data=json.dumps(payload).encode(),
        headers={"X-Serve-Stream": "1", "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return [json.loads(line) for line in resp.read().decode().splitlines()
                if line.strip()]


def _normalized_trace(events, root_span):
    """(name, parent's name, attrs) of each span and task event of one
    trace, sorted; ids and replica keys, which differ by run, become
    names."""
    def sid(e):
        return e.get("span_id") or e["task_id"]

    names = {sid(e): e["name"] for e in events}
    names[root_span] = "serve.request"
    out = []
    for e in events:
        assert e.get("duration", 0) >= 0
        attrs = dict(e.get("attrs") or {})
        if "replica" in attrs:
            attrs["replica"] = "<replica>"
        out.append((e["name"], names.get(e.get("parent_span_id")),
                    tuple(sorted(attrs.items()))))
    return sorted(out, key=repr)


def _wait_idle_load(router):
    """Refresh the handle's router until its replica-load snapshot shows
    the replica idle, so the traced pick's attributes are the same in
    every run."""
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        router._refresh(block=True)
        load = list(router._replica_load.values())
        if load and load[0].get("slots_busy") == 0 and \
                load[0].get("queue_depth") == 0:
            return
        time.sleep(0.05)
    raise AssertionError("replica load never reached the router idle")


def _drive(rt, serve, tracing, me, lm, saturated):
    """Everything the comparisons read, from one package's stack: streams
    through concurrent streaming handles and over HTTP, one traced
    request's events, and the metric deltas."""
    # A pool no request evicts from: the traced request's prefix hit is then
    # the same in every run, whatever order the concurrent ones retired in.
    rt.init(resources={"CPU": 4},
            system_config={"serve_kv_pool_blocks": 257})
    try:
        handle = serve.run(lm.bind(), route_prefix="/lm", _start_proxy=True,
                           http_port=0)
        port = import_module(f"{serve.__name__}.api")._proxy.bound_port
        tags = {"deployment": "LM"}
        tokens0 = me.serve_tokens_total().get(tags)
        shed0 = me.serve_shed_total().get(
            {"deployment": "LM", "reason": "quota"})

        def stream(i):
            return list(handle.options(stream=True).remote(
                {"prompt_ids": PROMPTS[i], "max_new_tokens": N_NEW}))

        streams = _from_threads(stream, len(PROMPTS))
        http = _from_threads(lambda i: _http_stream(
            port, {"prompt_ids": PROMPTS[i], "max_new_tokens": N_NEW}), 2)

        # Quota: tenant A holds its one slot; a second A request sheds.
        held = iter(handle.options(stream=True).remote(
            {"prompt_ids": PROMPTS[0], "max_new_tokens": N_NEW,
             "tenant": "A"}))
        first = next(held)
        with pytest.raises(saturated) as shed:
            handle.options(stream=True).remote(
                {"prompt_ids": PROMPTS[1], "max_new_tokens": N_NEW,
                 "tenant": "A"})
        quota = [first] + list(held)

        _wait_idle_load(handle._router)
        gen = handle.options(stream=True).remote(
            {"prompt_ids": PROMPTS[4], "max_new_tokens": N_NEW})
        traced = list(gen)
        tracing.flush()
        gcs = import_module(f"{rt.__name__}.core.runtime").get_runtime().gcs
        events = gcs.trace(gen.trace_id)
        root_span = gen._trace[1][1]
        return {
            "streams": streams, "http": http, "quota": quota,
            "shed": (shed.value.reason, shed.value.retry_after_s),
            "traced": traced,
            "trace": _normalized_trace(events, root_span),
            "tokens": me.serve_tokens_total().get(tags) - tokens0,
            "sheds": me.serve_shed_total().get(
                {"deployment": "LM", "reason": "quota"}) - shed0,
        }
    finally:
        serve.shutdown()
        rt.shutdown()


@pytest.fixture(scope="module")
def runs(params):
    jparams, nparams = params
    jcfg = jtf.tiny(max_seq_len=64)
    want = _drive(ray_tpu, jserve, jtr, jme,
                  jllm.llm_deployment(jcfg, lambda: jparams, name="LM",
                                      **LM_KW),
                  jllm.Saturated)
    tcfg = ttf.tiny(max_seq_len=64)
    got = _drive(ray_tpu_torch, tserve, ttr, tme,
                 tllm.llm_deployment(
                     tcfg, lambda: params_from_numpy(nparams, "cpu"),
                     name="LM", device="cpu", **LM_KW),
                 tllm.Saturated)
    return want, got


def _same_items(want, got):
    """Equal key for key; the rates only present and >= 0."""
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in RATES:
            if k in w:
                assert g[k] >= 0
        assert {k: v for k, v in g.items() if k not in RATES} == \
            {k: v for k, v in w.items() if k not in RATES}


def test_streams_through_handles_equal_jax(runs):
    want, got = runs
    for w, g in zip(want["streams"], got["streams"]):
        assert [i["token"] for i in g] == [i["token"] for i in w]
        assert len(g) == N_NEW
        _same_items(w, g)
        assert g[-1]["finish_reason"] == "stop" and "ttft_s" in g[-1]
    # The weights give varied greedy streams, not one repeated token.
    assert len({t["token"] for s in got["streams"] for t in s}) > 3
    _same_items(want["quota"], got["quota"])
    _same_items(want["traced"], got["traced"])


def test_streams_over_http_equal_jax(runs):
    want, got = runs
    for w, g in zip(want["http"], got["http"]):
        _same_items(w, g)
    assert [[i["token"] for i in s] for s in got["http"]] == \
        [[i["token"] for i in s] for s in got["streams"][:2]]


def test_spans_and_metric_deltas_equal_jax(runs):
    want, got = runs
    names = [t[0] for t in got["trace"]]
    for name in ("serve.router_pick", "serve.replica_queue",
                 "ReplicaActor.handle_request_streaming", "llm.prefill",
                 "llm.decode_chunk", "serve.request"):
        assert name in names, names
    assert got["trace"] == want["trace"]
    assert got["tokens"] == want["tokens"] == \
        N_NEW * (len(PROMPTS) + 2 + 1 + 1)
    assert got["sheds"] == want["sheds"] == 1
    assert got["shed"][0] == want["shed"][0] == "quota"
    assert got["shed"][1] == pytest.approx(want["shed"][1])


class _Stub:
    """Records which engine class the replica builds, and with what."""

    built = []

    def __init__(self, params, config, **kw):
        self.built.append((type(self).__name__, sorted(kw)))

    def warmup(self):
        pass


def _stubs(mod, monkeypatch):
    for name in ("DisaggregatedLLMEngine", "PagedLLMEngine", "LLMEngine"):
        monkeypatch.setattr(mod, name, type(name, (_Stub,), {}))


@pytest.mark.parametrize("knobs", [
    {}, {"serve_kv_paged_enabled": False},
    {"serve_disaggregation_enabled": True},
    {"serve_disaggregation_enabled": True, "serve_kv_paged_enabled": False},
])
@pytest.mark.parametrize("draft", [False, True])
def test_engine_choice_equals_jax(knobs, draft, monkeypatch):
    chosen = []
    for mod, cfg_mod in ((jllm, jconfig), (tllm, tconfig)):
        _stubs(mod, monkeypatch)
        monkeypatch.setattr(cfg_mod, "_global", cfg_mod.Config(knobs))
        kw = dict(draft_config="draft-cfg",
                  draft_params_fn=lambda: "draft") if draft else {}
        if mod is tllm:
            kw["device"] = "cpu"
        lm = mod.llm_deployment("cfg", lambda: "params", name="choice", **kw)
        _Stub.built.clear()
        lm.func_or_class()
        (name, keys), = _Stub.built
        chosen.append((name, [k for k in keys if k != "device"]))
        if mod is tllm:
            assert "device" in keys
    assert chosen[0] == chosen[1]


# -- the port's own rules ------------------------------------------------------


_ran_on = []


class _Where:
    def __init__(self):
        _ran_on.append("constructed")

    def __call__(self, payload):
        return "served"


def test_num_gpus_deployment_without_a_card_never_runs(monkeypatch):
    from ray_tpu_torch.core.exceptions import ActorError
    from ray_tpu_torch.core.runtime import get_runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _ran_on.clear()
    ray_tpu_torch.init(resources={"CPU": 4})
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()
        dep = tserve.deployment(ray_actor_options={"num_gpus": 1})(_Where)
        handle = tserve.run(dep.bind())
        with pytest.raises(ActorError, match="no feasible node"):
            handle.remote({}).result(timeout_s=30)
        gcs = get_runtime().gcs
        replicas = [gcs.get_actor(r.actor_id) for r in
                    get_runtime().actors.values()
                    if r.creation_spec.function_name == "ReplicaActor"]
        assert replicas and all(
            a.state == "DEAD" and "no feasible node" in a.death_cause
            for a in replicas)
        assert _ran_on == []
    finally:
        tserve.shutdown()
        ray_tpu_torch.shutdown()


def _replica_states():
    from ray_tpu_torch.core.runtime import get_runtime

    rt = get_runtime()
    return sorted(rt.gcs.get_actor(a).state for a, r in rt.actors.items()
                  if r.creation_spec.function_name == "ReplicaActor")


@pytest.mark.parametrize("option", ["num_gpus", "num_tpus"])
def test_gpu_grant_reaches_the_replica_and_a_third_stays_pending(option):
    from ray_tpu_torch.serve.controller import (_DeploymentTarget,
                                                _replica_shape,
                                                get_or_create_controller)

    ray_tpu_torch.init(resources={"CPU": 4}, num_gpus=1)  # a card's count
    try:
        dep = tserve.deployment(num_replicas=2,
                                ray_actor_options={option: 0.5})(_Where)
        handle = tserve.run(dep.bind())
        assert handle.remote({}).result(timeout_s=30) == "served"
        assert _replica_shape(_DeploymentTarget(
            "w", _Where, (), {}, dep.config)) == {"GPU": 0.5}
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                _replica_states() != ["ALIVE", "ALIVE"]:
            time.sleep(0.05)
        assert _replica_states() == ["ALIVE", "ALIVE"]
        assert ray_tpu_torch.available_resources().get("GPU", 0) == 0
        ctrl = get_or_create_controller()
        assert ray_tpu_torch.get(ctrl.set_target_replicas.remote(
            "_Where", 3))
        time.sleep(0.5)
        assert _replica_states() == ["ALIVE", "ALIVE", "PENDING"]
        _v, table = ray_tpu_torch.get(ctrl.get_snapshot.remote(-1, 0.0))
        assert len(table["_Where"]["replicas"]) == 2
        assert handle.remote({}).result(timeout_s=30) == "served"
    finally:
        tserve.shutdown()
        ray_tpu_torch.shutdown()


def test_kv_tier_still_refuses_the_paged_engine(params):
    """The paged engine once refused ``kv_tier_enabled``; now a deployment
    with the tier on serves, its greedy stream equals the tier-off one, and
    the replica's engine stats carry the tier counters (the 26-token chain
    of a 16-token prompt spills its full 16-token block at retire)."""
    _jparams, nparams = params
    prompt = PROMPTS[3] + [1, 2]          # 16 tokens
    streams, stats = {}, {}
    for tier in (False, True):
        ray_tpu_torch.init(resources={"CPU": 4},
                           system_config={"kv_tier_enabled": tier})
        try:
            lm = tllm.llm_deployment(
                ttf.tiny(max_seq_len=64),
                lambda: params_from_numpy(nparams, "cpu"), name="tier",
                device="cpu", slots=2, chunk=4)
            handle = tserve.run(lm.bind())
            streams[tier] = [it["token"] for it in handle.options(
                stream=True).remote({"prompt_ids": prompt,
                                     "max_new_tokens": N_NEW})]
            stats[tier] = handle.options(
                method_name="get_engine_stats").remote().result()
        finally:
            tserve.shutdown()
            ray_tpu_torch.shutdown()
    assert streams[True] == streams[False] and len(streams[True]) == N_NEW
    assert "kv_tier_spilled_blocks" not in stats[False]
    assert stats[True]["kv_tier_spilled_blocks"] == 1
    assert stats[True]["kv_tier_hits_store"] == 0


def _refused(port):
    with socket.socket() as s:
        s.settimeout(2)
        return s.connect_ex(("127.0.0.1", port)) != 0


def test_nothing_left_after_shutdown(params):
    from ray_tpu_torch.serve import api

    _jparams, nparams = params
    before = set(threading.enumerate())
    pid = os.getpid()
    ray_tpu_torch.init(resources={"CPU": 4})
    lm = tllm.llm_deployment(
        ttf.tiny(max_seq_len=64), lambda: params_from_numpy(nparams, "cpu"),
        name="LM", device="cpu", slots=2, chunk=4)
    handle = tserve.run(lm.bind(), route_prefix="/lm", _start_proxy=True,
                        http_port=0, _start_grpc_proxy=True)
    http_port = api._proxy.bound_port
    grpc_port = api._grpc_proxy.port
    assert len(_http_stream(http_port, {"prompt_ids": PROMPTS[0],
                                        "max_new_tokens": 4})) == 4
    assert len(list(handle.options(stream=True).remote(
        {"prompt_ids": PROMPTS[1], "max_new_tokens": 4}))) == 4
    tserve.shutdown()
    ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        left = [t.name for t in set(threading.enumerate()) - before
                if t.is_alive()]
        if not left:
            break
        time.sleep(0.05)
    assert left == []
    assert _refused(http_port) and _refused(grpc_port)
    assert not [n for n in os.listdir("/dev/shm")
                if n.startswith(f"rtpu_store_{pid}_")]


def test_per_node_proxies_serve_and_drain():
    """``start_proxies`` puts one detached proxy actor (HTTP and gRPC) on
    each virtual node of the in-process runtime; each answers, and
    ``drain_proxy`` retires one and closes its port."""
    ray_tpu_torch.init(resources={"CPU": 2}, num_nodes=2)
    try:
        @tserve.deployment
        def model(payload):
            return {"doubled": payload["v"] * 2}

        tserve.run(model.bind(), route_prefix="/model")
        addrs = tserve.start_proxies(grpc=True)
        assert len(addrs) == 2
        assert set(tserve.proxy_grpc_addresses()) == set(addrs)
        for addr in addrs.values():
            req = urllib.request.Request(
                f"http://{addr}/model", data=json.dumps({"v": 4}).encode())
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert json.loads(resp.read()) == {"doubled": 8}
        node, addr = next(iter(addrs.items()))
        assert tserve.drain_proxy(node, timeout_s=5)
        assert _refused(int(addr.rsplit(":", 1)[1]))
    finally:
        tserve.shutdown()
        ray_tpu_torch.shutdown()

"""The port's Serve decisions against the JAX package's, exactly.

The same inputs go through both packages' pure pieces and must give the
same outputs: ``prefix_head_hash`` digests byte for byte; ``Router._pick``
choices (replica, and the ongoing counts and affinity map it leaves) for
the same seeded ``random`` state over the same load, model and affinity
snapshots; ``SLOPolicy.desired`` over seeded signal traces (hypothesis);
``TenantAdmission`` admit and shed sequences; ``Saturated`` pickling; and
the config schemas' validation.
"""

import pickle
import random
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_tpu.serve import admission as jadm
from ray_tpu.serve import autoscaling as jas
from ray_tpu.serve import config as jcfg
from ray_tpu.serve import errors as jerr
from ray_tpu.serve import handle as jhandle
from ray_tpu.util import blockhash as jbh
from ray_tpu_torch.serve import admission as tadm
from ray_tpu_torch.serve import autoscaling as tas
from ray_tpu_torch.serve import config as tcfg
from ray_tpu_torch.serve import errors as terr
from ray_tpu_torch.serve import handle as thandle
from ray_tpu_torch.util import blockhash as tbh

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


# -- prefix_head_hash ---------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(tokens=st.lists(st.integers(0, 50303), max_size=200),
       block_tokens=st.sampled_from([1, 4, 8, 16, 32]),
       blocks=st.integers(1, 8))
def test_prefix_head_hash_byte_for_byte(tokens, block_tokens, blocks):
    want = jbh.prefix_head_hash(tokens, block_tokens, blocks)
    got = tbh.prefix_head_hash(tokens, block_tokens, blocks)
    assert got == want
    assert (got is None) == (len(tokens) < block_tokens)


def test_affinity_hash_of_the_handles_equal():
    prompt = list(range(100, 180))
    payload = [{"prompt_ids": prompt}]
    want = jhandle.DeploymentHandle._affinity_hash(payload)
    assert want is not None
    assert thandle.DeploymentHandle._affinity_hash(payload) == want


# -- Router._pick -------------------------------------------------------------


class _StubReplica:
    def __init__(self, key):
        class _Id:
            @staticmethod
            def hex():
                return key

        self.actor_id = _Id()


def _router(mod, keys, load, model_ids, ongoing, affinity, max_ongoing):
    r = mod.Router.__new__(mod.Router)
    r._name = "cross"
    r._replicas = [_StubReplica(k) for k in keys]
    r._replica_load = {k: dict(v) for k, v in load.items()}
    r._model_ids = {k: list(v) for k, v in model_ids.items()}
    r._ongoing = dict(ongoing)
    r._max_ongoing = max_ongoing
    r._lock = threading.Lock()
    r._last_refresh = time.monotonic() + 3600  # _refresh() is a no-op
    r._version = 0
    r._affinity_map().update(affinity)
    return r


def _scenario(seed):
    """A replica set with mixed load reports, warm model sets, ongoing
    counts and affinity pins, and a request trace over them."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    keys = [f"r{i}" for i in range(n)]
    load = {}
    for k in keys:
        kind = rng.integers(0, 3)
        if kind == 1:
            total = float(rng.integers(1, 5))
            load[k] = {"slots_total": total,
                       "slots_busy": float(rng.integers(0, total + 1)),
                       "queue_depth": float(rng.integers(0, 4))}
        elif kind == 2:
            load[k] = {"ongoing": float(rng.integers(0, 3))}
    model_ids = {k: [f"m{j}" for j in range(3) if rng.random() < 0.4]
                 for k in keys}
    ongoing = {k: int(rng.integers(0, 3)) for k in keys}
    hashes = [bytes([i]) * 16 for i in range(4)]
    affinity = {h: keys[int(rng.integers(0, n))] for h in hashes
                if rng.random() < 0.5}
    trace = []
    for _ in range(24):
        model = f"m{int(rng.integers(0, 3))}" if rng.random() < 0.3 else ""
        ph = hashes[int(rng.integers(0, 4))] if rng.random() < 0.5 else None
        trace.append((model, ph, bool(rng.random() < 0.4)))
    return keys, load, model_ids, ongoing, affinity, trace


@pytest.mark.parametrize("seed", range(12))
def test_router_pick_choices_equal(seed):
    keys, load, model_ids, ongoing, affinity, trace = _scenario(seed)
    outs = []
    for mod in (jhandle, thandle):
        r = _router(mod, keys, load, model_ids, ongoing, affinity,
                    max_ongoing=6)
        random.seed(seed)
        picks = []
        for model, ph, finish in trace:
            # A pick that samples a replica at max_ongoing may wait for it
            # to free (a pick meant to block): keep every replica below.
            while any(r._ongoing.get(k, 0) >= 6 for k in keys):
                r._dec(max(keys, key=lambda k: (r._ongoing.get(k, 0), k)))
            _rep, key = r._pick(model, ph)
            picks.append(key)
            if finish:
                r._dec(key)
        outs.append((picks, dict(r._ongoing), dict(r._affinity_map())))
    assert outs[0] == outs[1]


def test_router_sheds_alike():
    load = {"slots_total": 1.0, "slots_busy": 1.0, "queue_depth": 32.0}
    errors = []
    for mod, err in ((jhandle, jerr.Saturated), (thandle, terr.Saturated)):
        r = _router(mod, ["a", "b"], {"a": load, "b": dict(load,
                                                          queue_depth=40.0)},
                    {}, {}, {}, max_ongoing=6)
        with pytest.raises(err) as ei:
            r._pick()
        errors.append((str(ei.value), ei.value.reason,
                       ei.value.retry_after_s))
    assert errors[0] == errors[1]


# -- SLOPolicy ----------------------------------------------------------------


_signals = st.builds(
    dict,
    ongoing=st.sampled_from([0.0, 0.5, 1.0, 2.0, 3.3, 8.0, 20.0]),
    queue_depth=st.sampled_from([0.0, 1.0, 4.0, 9.0, 30.0]),
    slots_busy=st.sampled_from([0.0, 1.0, 2.0, 4.0]),
    slots_total=st.sampled_from([0.0, 4.0, 8.0]),
    kv_active=st.sampled_from([0.0, 10.0, 60.0, 95.0]),
    kv_total=st.sampled_from([0.0, 100.0]),
    ttft_p99_s=st.sampled_from([None, 0.05, 0.3, 2.0]),
)


@settings(max_examples=150, deadline=None)
@given(cfg=st.builds(
           dict,
           min_replicas=st.integers(0, 2),
           max_replicas=st.integers(2, 8),
           target_ongoing_requests=st.sampled_from([1.0, 2.0, 4.0]),
           upscale_delay_s=st.sampled_from([0.0, 1.0]),
           downscale_delay_s=st.sampled_from([0.5, 2.0]),
           idle_timeout_s=st.sampled_from([1.0, 5.0]),
           hysteresis=st.sampled_from([0.0, 0.1, 0.3]),
           ttft_p99_slo_s=st.sampled_from([None, 0.2])),
       steps=st.lists(st.tuples(_signals, st.sampled_from([0.1, 0.5, 2.0])),
                      min_size=1, max_size=30),
       drain_single_step=st.booleans())
def test_slo_policy_desired_equal(cfg, steps, drain_single_step):
    policies = []
    for mod, cmod in ((jas, jcfg), (tas, tcfg)):
        p = mod.SLOPolicy(cmod.AutoscalingConfig(**cfg))
        p.drain_single_step = drain_single_step
        policies.append((mod, p))
    current = {id(p): 1 for _, p in policies}
    now = 0.0
    for sig, dt in steps:
        now += dt
        outs = []
        for mod, p in policies:
            s = mod.DeploymentSignals(replicas=current[id(p)], **sig)
            want = p.desired(current[id(p)], s, now)
            outs.append((want, p.pressure(s), p.ttft_violated(s)))
            current[id(p)] = want
        assert outs[0] == outs[1]


# -- TenantAdmission ----------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_tenant_admission_sequences_equal(seed):
    quotas = {"A": 2.0, "B": 1.0, "*": 3.0}
    tenants = ["A", "B", "C", "D", None]
    runs = []
    for mod in (jadm, tadm):
        adm = mod.TenantAdmission(quotas)
        held = []
        log = []
        r = np.random.default_rng(seed)
        for _ in range(60):
            op = r.integers(0, 10)
            if op < 6:
                tenant = tenants[int(r.integers(0, len(tenants)))]
                try:
                    rel = adm.acquire(tenant, deployment="x")
                    log.append(("admit", tenant, rel is None))
                    if rel is not None:
                        held.append(rel)
                except Exception as e:  # noqa: BLE001 — compared below
                    log.append(("shed", tenant, type(e).__name__, str(e),
                                e.reason, e.retry_after_s))
            elif op < 9 and held:
                held.pop(int(r.integers(0, len(held))))()
                log.append(("release",))
            else:
                adm.update({"A": float(r.integers(1, 4)), "*": 2.0})
                log.append(("update",))
            log.append(tuple(adm.in_flight(t) for t in "ABCD"))
        runs.append(log)
    assert runs[0] == runs[1]


# -- Saturated and the config schemas ------------------------------------------


@pytest.mark.parametrize("args", [
    ("over", {}),
    ("over quota", {"reason": "quota", "retry_after_s": 0.25}),
    ("", {"reason": "saturated", "retry_after_s": None}),
])
def test_saturated_pickles_alike(args):
    msg, kw = args
    j = pickle.loads(pickle.dumps(jerr.Saturated(msg, **kw)))
    t = pickle.loads(pickle.dumps(terr.Saturated(msg, **kw)))
    assert isinstance(t, terr.Saturated) and isinstance(t, RuntimeError)
    assert (str(t), t.reason, t.retry_after_s) == \
        (str(j), j.reason, j.retry_after_s)


@pytest.mark.parametrize("kw", [
    {}, {"min_replicas": 2, "max_replicas": 1}, {"min_replicas": -1},
    {"target_ongoing_requests": 0}, {"target_queue_depth": 0},
    {"target_kv_utilization": 0.0}, {"target_kv_utilization": 1.5},
    {"ttft_p99_slo_s": 0.0}, {"idle_timeout_s": -1.0}, {"hysteresis": 1.0},
])
def test_autoscaling_config_validates_alike(kw):
    results = []
    for mod in (jcfg, tcfg):
        try:
            results.append(("ok", vars(mod.AutoscalingConfig(**kw))))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]


@pytest.mark.parametrize("kw", [
    {}, {"num_replicas": -1}, {"max_ongoing_requests": 0},
    {"max_concurrency": 0}, {"tenant_quotas": {"A": -1.0}},
    {"tenant_quotas": {"A": 1.0, "*": 2.0}, "max_concurrency": 8},
])
def test_deployment_config_validates_alike(kw):
    results = []
    for mod in (jcfg, tcfg):
        try:
            results.append(("ok", vars(mod.DeploymentConfig(**kw))))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]

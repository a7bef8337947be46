"""JAX's SLO-autoscaling and routing tests on the port's Serve stack.

From ``tests/test_slo_autoscaling.py``: ``TestSLOPolicy``,
``TestTenantAdmission``, ``TestTTFTRollup`` and ``TestServeSLOEndToEnd``,
the last over a copy of ``benches/loadgen.py``'s ``sim_llm_deployment``
built on the port (a sleep-per-token engine with real slot and queue
accounting and the real streaming contract). ``TestLoadgenDeterminism``
tests ``benches/`` and stays with the JAX suite; ``TestLoadHarnessSweep``
is marked slow there. From ``tests/test_serve_llm.py``:
``TestOccupancyRouting`` and ``TestServeDataPlane`` (the port's
``Generator`` is the oracle). From ``tests/test_serve_paged.py``:
``TestRouterStaleEviction`` and ``TestPrefixAffinityRouting``.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.models import generate, transformer
from ray_tpu_torch.serve.admission import TenantAdmission
from ray_tpu_torch.serve.autoscaling import (DeploymentSignals, SLOPolicy,
                                             TTFTRollup)
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.errors import Saturated
from ray_tpu_torch.serve.handle import DeploymentHandle, Router
from ray_tpu_torch.serve.llm import llm_deployment
from ray_tpu_torch.util.blockhash import prefix_head_hash

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

PROMPTS = [[7, 3, 11], [2, 4, 6, 8, 10], [1] * 9, [5, 9] * 7]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def serve_cluster():
    ray_tpu_torch.init(resources={"CPU": 4})
    yield serve
    serve.shutdown()
    ray_tpu_torch.shutdown()


# -- the simulated LLM deployment (benches/loadgen.py's, on the port) --------


def sim_llm_deployment(name: str = "SIMLLM", *, slots: int = 4,
                       prefill_s_per_token: float = 0.0003,
                       decode_s_per_token: float = 0.02,
                       max_queue=None, **deployment_kwargs):
    """A serve deployment that behaves like the LLM engines — slot-bounded
    concurrency, a bounded admission queue that sheds :class:`Saturated`,
    the streaming contract, ``get_engine_stats`` feeding the controller,
    TTFT observed into the metrics — but sleeps a token's time instead of
    computing it."""
    from ray_tpu_torch.core.config import config as knobs

    q_limit = int(max_queue if max_queue is not None
                  else knobs().serve_admission_queue_limit)
    deployment_kwargs.setdefault(
        "max_concurrency", slots + max(q_limit, 4) + 4)

    @serve.deployment(name=name, **deployment_kwargs)
    class SimLLM:
        def __init__(self):
            self._cv = threading.Condition(threading.Lock())
            self._busy = 0
            self._waiting = 0

        def __call__(self, payload):
            from ray_tpu_torch.core.metrics_export import (metrics_enabled,
                                                           observe_shed,
                                                           serve_ttft_hist)

            prompt = payload.get("prompt_ids") or [1] * int(
                payload.get("prompt_len", 8))
            n = int(payload.get("max_new_tokens", 8))
            t0 = time.perf_counter()
            with self._cv:
                if q_limit and self._waiting >= q_limit:
                    observe_shed(name, "saturated")
                    raise Saturated(
                        f"engine {name}: {self._waiting} requests already "
                        f"waiting (serve_admission_queue_limit={q_limit})",
                        retry_after_s=self._waiting
                        * knobs().serve_retry_after_item_s)
                self._waiting += 1
                try:
                    while self._busy >= slots:
                        self._cv.wait(timeout=0.05)
                finally:
                    self._waiting -= 1
                self._busy += 1
            try:
                time.sleep(prefill_s_per_token * len(prompt))
                ttft = time.perf_counter() - t0
                if metrics_enabled():
                    serve_ttft_hist().observe(
                        ttft, {"deployment": name, "phase": "total"})
                for i in range(max(1, n)):
                    time.sleep(decode_s_per_token)
                    item = {"token": (i % 250) + 1, "index": i,
                            "decode_tps": round(1.0 / decode_s_per_token, 1)}
                    if i == max(1, n) - 1:
                        item["finish_reason"] = "stop"
                        item["ttft_s"] = ttft
                    yield item
            finally:
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()

        def get_engine_stats(self):
            with self._cv:
                return {"slots_total": slots, "slots_busy": self._busy,
                        "queue_depth": self._waiting}

    return SimLLM


# -------------------------------------------------------------- SLOPolicy --


def _asc(**kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 8)
    kw.setdefault("target_ongoing_requests", 2.0)
    kw.setdefault("upscale_delay_s", 0.0)
    kw.setdefault("downscale_delay_s", 2.0)
    kw.setdefault("idle_timeout_s", 10.0)
    return AutoscalingConfig(**kw)


class TestSLOPolicy:
    def test_scale_up_on_ongoing(self):
        p = SLOPolicy(_asc())
        sig = DeploymentSignals(replicas=1, ongoing=8.0)
        assert p.desired(1, sig, now=0.0) == 4  # ceil(1 * 8/2)

    def test_scale_up_on_queue_pressure(self):
        p = SLOPolicy(_asc(target_queue_depth=4.0))
        sig = DeploymentSignals(replicas=2, ongoing=0.0, queue_depth=24.0)
        assert p.desired(2, sig, now=0.0) == 6  # ceil(2 * 24/(2*4))

    def test_scale_up_on_kv_pressure(self):
        p = SLOPolicy(_asc(target_kv_utilization=0.5))
        sig = DeploymentSignals(replicas=2, kv_active=90.0, kv_total=100.0)
        assert p.desired(2, sig, now=0.0) == 4  # ceil(2 * 0.9/0.5)

    def test_hysteresis_dead_band_holds(self):
        p = SLOPolicy(_asc(hysteresis=0.25))
        # pressure 1.2 < 1.25 -> inside the band, hold
        sig = DeploymentSignals(replicas=2, ongoing=4.8)
        assert p.desired(2, sig, now=0.0) == 2
        # pressure 0.8 > 0.75 -> still inside, hold
        sig = DeploymentSignals(replicas=2, ongoing=3.2)
        assert p.desired(2, sig, now=10.0) == 2

    def test_ttft_violation_overrides(self):
        p = SLOPolicy(_asc(ttft_p99_slo_s=0.2))
        # utilization at target (pressure == 1.0) but latency breached
        sig = DeploymentSignals(replicas=2, ongoing=4.0, ttft_p99_s=0.5)
        assert p.desired(2, sig, now=0.0) == 3

    def test_no_flap_within_cooldown(self):
        p = SLOPolicy(_asc(downscale_delay_s=3.0))
        up = DeploymentSignals(replicas=1, ongoing=8.0)
        assert p.desired(1, up, now=0.0) == 4
        # quiet immediately after the resize: must NOT step down until the
        # low condition has held for downscale_delay_s
        low = DeploymentSignals(replicas=4, ongoing=1.0)
        assert p.desired(4, low, now=0.1) == 4
        assert p.desired(4, low, now=2.0) == 4
        assert p.desired(4, low, now=3.5) < 4  # held >= 3s -> downscale

    def test_downscale_hold_resets_on_pressure(self):
        p = SLOPolicy(_asc(downscale_delay_s=2.0, idle_timeout_s=60.0))
        low = DeploymentSignals(replicas=4, ongoing=1.0)
        mid = DeploymentSignals(replicas=4, ongoing=8.5)  # in dead band
        assert p.desired(4, low, now=0.0) == 4
        assert p.desired(4, mid, now=1.0) == 4  # interrupts the hold
        assert p.desired(4, low, now=2.5) == 4  # hold restarted at 2.5
        assert p.desired(4, low, now=4.6) < 4

    def test_idle_scales_to_min(self):
        p = SLOPolicy(_asc(idle_timeout_s=5.0))
        idle = DeploymentSignals(replicas=6, ongoing=0.0)
        assert p.desired(6, idle, now=0.0) == 6
        assert p.desired(6, idle, now=5.5) == 1  # straight to min

    def test_clamps_to_max(self):
        p = SLOPolicy(_asc(max_replicas=3))
        sig = DeploymentSignals(replicas=1, ongoing=100.0)
        assert p.desired(1, sig, now=0.0) == 3

    def test_upscale_delay_gates(self):
        p = SLOPolicy(_asc(upscale_delay_s=2.0))
        up = DeploymentSignals(replicas=1, ongoing=8.0)
        assert p.desired(1, up, now=0.0) == 4
        more = DeploymentSignals(replicas=4, ongoing=32.0)
        assert p.desired(4, more, now=0.5) == 4  # inside upscale cooldown
        assert p.desired(4, more, now=2.5) == 8


# -------------------------------------------------------------- admission --


class TestTenantAdmission:
    def test_quota_enforced_with_wildcard_default(self):
        adm = TenantAdmission({"A": 2.0, "*": 1.0})
        r1, r2 = adm.acquire("A"), adm.acquire("A")
        with pytest.raises(Saturated) as ei:
            adm.acquire("A", deployment="d")
        assert ei.value.reason == "quota"
        assert ei.value.retry_after_s and ei.value.retry_after_s > 0
        adm.acquire("B")  # wildcard: 1 in flight ok
        with pytest.raises(Saturated):
            adm.acquire("B")
        r1()
        assert adm.acquire("A") is not None
        r2()

    def test_release_idempotent(self):
        adm = TenantAdmission({"A": 1.0})
        rel = adm.acquire("A")
        rel()
        rel()  # double release must not free a phantom slot
        assert adm.in_flight("A") == 0
        rel2 = adm.acquire("A")
        with pytest.raises(Saturated):
            adm.acquire("A")
        rel2()

    def test_no_quota_table_admits_everything(self):
        adm = TenantAdmission(None)
        assert adm.acquire("anyone") is None
        adm2 = TenantAdmission({"A": 1.0})
        # tenant not listed and no wildcard -> unlimited
        assert adm2.acquire("B") is None

    def test_update_applies_live(self):
        adm = TenantAdmission({"A": 1.0})
        rel = adm.acquire("A")
        adm.update({"A": 2.0})
        rel2 = adm.acquire("A")  # limit raised while in flight
        rel()
        rel2()

    def test_saturated_survives_pickle(self):
        import pickle

        e = Saturated("over", reason="quota", retry_after_s=0.25)
        e2 = pickle.loads(pickle.dumps(e))
        assert (str(e2), e2.reason, e2.retry_after_s) == \
            ("over", "quota", 0.25)

    def test_config_validates_quotas(self):
        with pytest.raises(ValueError):
            DeploymentConfig(tenant_quotas={"A": -1.0})


# ------------------------------------------------------------ TTFT rollup --


class TestTTFTRollup:
    def test_delta_window_quantile(self, monkeypatch):
        import ray_tpu_torch.core.metrics_export as me

        snaps = [
            {"bounds": [0.1, 1.0], "buckets": [100, 0, 0],
             "sum": 5.0, "count": 100},
            # window adds 100 slow observations: cumulative p99 would stay
            # polluted forever; the DELTA p99 must see only the new ones
            {"bounds": [0.1, 1.0], "buckets": [100, 100, 0],
             "sum": 60.0, "count": 200},
        ]
        it = iter(snaps)
        monkeypatch.setattr(me, "cluster_histogram",
                            lambda name, tags: next(it))
        roll = TTFTRollup(min_interval_s=1.0)
        first = roll.p99("d", now=0.0)
        assert first is not None and first <= 0.1
        # rate limit: inside min_interval the cached value is returned
        assert roll.p99("d", now=0.5) == first
        second = roll.p99("d", now=2.0)
        assert second is not None and second > 0.5

    def test_no_data_returns_none(self, monkeypatch):
        import ray_tpu_torch.core.metrics_export as me

        monkeypatch.setattr(me, "cluster_histogram", lambda n, t: None)
        assert TTFTRollup(0.0).p99("d", now=0.0) is None


# ------------------------------------------------------------------- e2e --


def _drive_open_loop(handle, stop, tenant="default", gap_s=0.05,
                     tokens=8):
    """Background offered load: fire-and-forget streams until ``stop``."""
    threads = []

    def one():
        try:
            for _ in handle.options(stream=True).remote(
                    {"prompt_ids": [1] * 8, "max_new_tokens": tokens,
                     "tenant": tenant}):
                pass
        except Exception:  # noqa: BLE001 — sheds are expected under burst
            pass

    def pump():
        while not stop.is_set():
            t = threading.Thread(target=one, daemon=True)
            t.start()
            threads.append(t)
            time.sleep(gap_s)

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    return pumper, threads


def _replica_count(name):
    from ray_tpu_torch.serve.controller import get_or_create_controller

    info = ray_tpu_torch.get(
        get_or_create_controller().list_deployments.remote())
    return info[name]["num_replicas"]


class TestServeSLOEndToEnd:
    def test_quota_tenant_isolated_e2e(self, serve_cluster):
        serve = serve_cluster
        sim = sim_llm_deployment("sim-quota", slots=2,
                                 decode_s_per_token=0.05)
        handle = serve.run(
            sim.options(num_replicas=1,
                        tenant_quotas={"A": 1.0, "*": 100.0}).bind())
        stop = threading.Event()
        # tenant A holds its single quota slot with a long stream
        pumper, workers = _drive_open_loop(handle, stop, tenant="A",
                                           gap_s=0.02, tokens=24)
        try:
            time.sleep(0.3)
            # A is over quota: a second A request sheds with reason=quota
            shed = None
            for _ in range(50):
                try:
                    for _ in handle.options(stream=True).remote(
                            {"prompt_ids": [1] * 4, "max_new_tokens": 1,
                             "tenant": "A"}):
                        pass
                except Saturated as e:
                    shed = e
                    break
                time.sleep(0.05)
            assert shed is not None and shed.reason == "quota"
            assert shed.retry_after_s and shed.retry_after_s > 0
            # ...while tenant B still gets served
            got = 0
            for item in handle.options(stream=True).remote(
                    {"prompt_ids": [1] * 4, "max_new_tokens": 4,
                     "tenant": "B"}):
                got += 1
            assert got == 4
        finally:
            stop.set()
            pumper.join(timeout=5)
            # Drain every in-flight stream BEFORE serve/runtime teardown.
            for w in workers:
                w.join(timeout=10)

    def test_scale_up_then_idle_scale_down_no_flap(self, serve_cluster):
        serve = serve_cluster
        sim = sim_llm_deployment("sim-scale", slots=2,
                                 decode_s_per_token=0.04)
        handle = serve.run(sim.options(
            num_replicas=1,
            autoscaling_config={
                "min_replicas": 1, "max_replicas": 3,
                "target_ongoing_requests": 2.0, "target_queue_depth": 2.0,
                "upscale_delay_s": 0.0, "downscale_delay_s": 0.5,
                "idle_timeout_s": 1.0, "hysteresis": 0.1,
            }).bind())
        stop = threading.Event()
        pumper, workers = _drive_open_loop(handle, stop, gap_s=0.03,
                                           tokens=10)
        counts = []
        try:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                counts.append(_replica_count("sim-scale"))
                if counts[-1] >= 2:
                    break
                time.sleep(0.1)
            assert max(counts) >= 2, f"never scaled up: {counts}"
        finally:
            stop.set()
            pumper.join(timeout=5)
            for w in workers:
                w.join(timeout=5)
        # idle: must fall back to min within idle_timeout + signal latency
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline:
            if _replica_count("sim-scale") == 1:
                break
            time.sleep(0.1)
        assert _replica_count("sim-scale") == 1, "did not scale to min"
        # hysteresis/no-flap: once at min with zero load it STAYS there
        # for longer than the downscale cooldown (0.5s)
        for _ in range(6):
            assert _replica_count("sim-scale") == 1
            time.sleep(0.1)

    def test_replica_death_converges_to_target(self, serve_cluster):
        from ray_tpu_torch.core.exceptions import ActorError
        from ray_tpu_torch.serve.controller import get_or_create_controller

        serve = serve_cluster
        sim = sim_llm_deployment("sim-death", slots=2,
                                 decode_s_per_token=0.01)
        handle = serve.run(sim.options(num_replicas=2).bind())
        ctrl = get_or_create_controller()

        def live_replicas():
            _v, table = ray_tpu_torch.get(ctrl.get_snapshot.remote(-1, 0.0))
            return table["sim-death"]["replicas"]

        deadline = time.monotonic() + 10.0
        while len(live_replicas()) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        reps = live_replicas()
        assert len(reps) == 2
        victim = reps[0]
        ray_tpu_torch.kill(victim)
        # the controller must notice the death and respawn to target
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if _replica_count("sim-death") == 2:
                alive = live_replicas()
                if len(alive) == 2 and all(
                        r.actor_id.hex() != victim.actor_id.hex()
                        for r in alive):
                    break
            time.sleep(0.1)
        alive = live_replicas()
        assert len(alive) == 2
        assert all(r.actor_id.hex() != victim.actor_id.hex()
                   for r in alive)
        # and the fleet still serves — the handle's router snapshot may
        # stay up to SNAPSHOT_MAX_AGE_S stale and route one more request
        # at the dead replica (streams can't resubmit mid-flight), so a
        # real client retries on ActorError
        got = 0
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            try:
                got = sum(1 for _ in handle.options(stream=True).remote(
                    {"prompt_ids": [1] * 4, "max_new_tokens": 3}))
                break
            except ActorError:
                time.sleep(0.3)
        assert got == 3


# ---------------------------------------------- routing (test_serve_llm) --


class _StubReplica:
    def __init__(self, key):
        class _Id:
            @staticmethod
            def hex():
                return key

        self.actor_id = _Id()


def _mk_router(replicas, load):
    r = Router.__new__(Router)
    r._name = "stub"
    r._replicas = replicas
    r._replica_load = load
    r._model_ids = {}
    r._ongoing = {}
    r._max_ongoing = 100
    r._lock = threading.Lock()
    r._last_refresh = time.monotonic()  # fresh — _refresh() is a no-op
    r._version = 0
    return r


class TestOccupancyRouting:
    def test_slots_exhausted(self):
        r = _mk_router([], {
            "full": {"slots_total": 4.0, "slots_busy": 4.0},
            "free": {"slots_total": 4.0, "slots_busy": 1.0},
            "plain": {"ongoing": 2.0},
        })
        assert r._slots_exhausted("full")
        assert not r._slots_exhausted("free")
        assert not r._slots_exhausted("plain")  # non-engine replica
        assert not r._slots_exhausted("unknown")

    def test_pick_prefers_free_slots(self):
        reps = [_StubReplica("full"), _StubReplica("free")]
        r = _mk_router(reps, {
            "full": {"slots_total": 2.0, "slots_busy": 2.0,
                     "queue_depth": 0.0},
            "free": {"slots_total": 2.0, "slots_busy": 0.0,
                     "queue_depth": 0.0},
        })
        for _ in range(10):
            best, key = r._pick()
            assert key == "free"
            r._dec(key)

    def test_all_shedding_requires_every_replica_over_limit(self):
        from ray_tpu_torch.core.config import config

        limit = config().serve_admission_queue_limit
        assert limit > 0  # default knob enables shedding
        reps = [_StubReplica("a"), _StubReplica("b")]
        over = {"slots_total": 1.0, "slots_busy": 1.0,
                "queue_depth": float(limit)}
        under = dict(over, queue_depth=float(limit) - 1)
        assert _mk_router(reps, {"a": over, "b": over})._all_shedding(reps)
        assert not _mk_router(reps, {"a": over,
                                     "b": under})._all_shedding(reps)
        # A replica that doesn't report a queue (plain deployment) never
        # sheds.
        assert not _mk_router(reps, {"a": over})._all_shedding(reps)
        assert not _mk_router(
            reps, {"a": over, "b": {"ongoing": 1.0}})._all_shedding(reps)

    def test_pick_sheds_when_all_over_limit(self):
        from ray_tpu_torch.core.config import config

        limit = float(config().serve_admission_queue_limit)
        reps = [_StubReplica("a"), _StubReplica("b")]
        load = {"slots_total": 1.0, "slots_busy": 1.0, "queue_depth": limit}
        r = _mk_router(reps, {"a": load, "b": load})
        with pytest.raises(Saturated):
            r._pick()


@pytest.fixture(scope="module")
def tiny_model():
    cfg = transformer.tiny(max_seq_len=64)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    return cfg, params


@pytest.fixture(scope="module")
def oracle(tiny_model):
    """Single-sequence reference decode (memoized — it is the slow path)."""
    cfg, params = tiny_model
    gen = generate.Generator(params, cfg, device="cpu")
    memo = {}

    def run(prompt, n, temperature=0.0, seed=0):
        key = (tuple(prompt), n, temperature, seed)
        if key not in memo:
            memo[key] = gen.generate(
                list(prompt), max_new_tokens=n,
                temperature=temperature, seed=seed)
        return memo[key]

    return run


class TestServeDataPlane:
    def test_concurrent_streams_contract_and_occupancy(self, serve_cluster,
                                                       tiny_model, oracle):
        """Concurrent streaming through handle → router → replica keeps the
        response contract and oracle-equal tokens; the replica's slot
        occupancy surfaces in the controller snapshot for routing."""
        cfg, params = tiny_model
        LM = llm_deployment(cfg, lambda: params, name="LM", slots=2,
                            chunk=4, device="cpu")
        handle = serve_cluster.run(LM.bind())

        outs = [None] * 3
        errs = []

        def client(i):
            try:
                toks = []
                last = None
                for item in handle.options(stream=True).remote(
                        {"prompt_ids": PROMPTS[i], "max_new_tokens": 8}):
                    assert {"token", "index", "decode_tps"} <= set(item)
                    assert item["index"] == len(toks)
                    toks.append(item["token"])
                    last = item
                assert last is not None
                assert last["finish_reason"] == "stop"
                outs[i] = toks
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errs
        for i in range(3):
            assert outs[i] == oracle(PROMPTS[i], 8), f"stream {i} diverged"

        # KV-occupancy metrics reach the controller snapshot (poll: the
        # controller merges get_state once per poll period).
        from ray_tpu_torch.serve.controller import get_or_create_controller

        controller = get_or_create_controller()
        deadline = time.monotonic() + 10
        load = {}
        while time.monotonic() < deadline:
            _v, table = ray_tpu_torch.get(
                controller.get_snapshot.remote(-1, 0.0))
            load = table.get("LM", {}).get("replica_load", {})
            if load:
                break
            time.sleep(0.1)
        assert load, "replica_load never reached the controller snapshot"
        stats = next(iter(load.values()))
        assert stats["slots_total"] == 2.0
        assert stats["queue_depth"] == 0.0
        assert "slots_busy" in stats


# -------------------------------------------- routing (test_serve_paged) --


class _FakeController:
    """get_snapshot.remote returns the canned table directly; the test
    monkeypatches ray_tpu_torch.get to the identity so Router._refresh
    consumes it without a live controller actor."""

    def __init__(self, version, table):
        outer = self

        class _Method:
            @staticmethod
            def remote(_version, _timeout):
                return outer._version, outer._table

        self._version = version
        self._table = table
        self.get_snapshot = _Method()


class TestRouterStaleEviction:
    def test_refresh_evicts_departed_replicas(self, monkeypatch):
        """Shrinking replica set: ongoing counts, load entries, and affinity
        pins for replicas gone from the snapshot are evicted — a stale entry
        must not keep steering (or starving) the pow-2 pick."""
        monkeypatch.setattr(ray_tpu_torch, "get", lambda x, **kw: x)
        a, b = _StubReplica("a"), _StubReplica("b")
        r = _mk_router([a, b], {})
        r._ongoing = {"a": 3, "b": 2}
        r._affinity_map().update({b"h-a": "a", b"h-b": "b"})
        r._controller = _FakeController(1, {"stub": {
            "replicas": [b],
            "max_ongoing_requests": 100,
            "model_ids": {},
            # Controller-side load table still carries the dead replica.
            "replica_load": {"a": {"slots_busy": 4.0, "slots_total": 4.0},
                             "b": {"slots_busy": 1.0, "slots_total": 4.0}},
        }})
        r._refresh(block=True)
        assert r._replicas == [b]
        assert r._ongoing == {"b": 2}
        assert r._replica_load == {"b": {"slots_busy": 1.0,
                                         "slots_total": 4.0}}
        assert r._affinity_map() == {b"h-b": "b"}
        # Picks route only to the survivor afterwards.
        for _ in range(5):
            _best, key = r._pick()
            assert key == "b"
            r._dec(key)


class TestPrefixAffinityRouting:
    def test_pick_prefers_affinity_replica(self):
        """An affinity-pinned replica wins the pick outright — even when
        pow-2 would prefer the other (lower ongoing) replica."""
        reps = [_StubReplica("a"), _StubReplica("b")]
        r = _mk_router(reps, {})
        r._affinity_map()[b"h1"] = "b"
        r._ongoing = {"a": 0, "b": 5}  # pow-2 would choose a
        for _ in range(10):
            _best, key = r._pick(prefix_hash=b"h1")
            assert key == "b"
            r._dec(key)

    def test_first_pick_records_affinity(self):
        reps = [_StubReplica("a"), _StubReplica("b")]
        r = _mk_router(reps, {})
        _best, key = r._pick(prefix_hash=b"h2")
        assert r._affinity_map()[b"h2"] == key
        # The same prefix sticks to that replica even though its ongoing
        # count is now higher than the other's.
        _best, key2 = r._pick(prefix_hash=b"h2")
        assert key2 == key

    def test_affinity_migrates_off_exhausted_replica(self):
        """A pinned replica reporting a full slot set loses the pick; the
        pow-2 winner inherits the pin (the prefix re-caches there)."""
        reps = [_StubReplica("a"), _StubReplica("b")]
        r = _mk_router(reps, {
            "b": {"slots_total": 2.0, "slots_busy": 2.0},
            "a": {"slots_total": 2.0, "slots_busy": 0.0},
        })
        r._affinity_map()[b"h3"] = "b"
        _best, key = r._pick(prefix_hash=b"h3")
        assert key == "a"
        assert r._affinity_map()[b"h3"] == "a"

    def test_affinity_map_lru_bound(self):
        r = _mk_router([_StubReplica("a")], {})
        r.AFFINITY_CAP = 3
        with r._lock:
            for i in range(5):
                r._note_affinity(b"k%d" % i, "a")
        assert list(r._affinity_map()) == [b"k2", b"k3", b"k4"]

    def test_handle_affinity_hash(self):
        from ray_tpu_torch.core.config import config

        cfg = config()
        assert cfg.serve_prefix_affinity_enabled  # on by default
        bt = int(cfg.serve_kv_block_tokens)
        prompt = list(range(2 * bt + 3))
        h = DeploymentHandle._affinity_hash([{"prompt_ids": prompt}])
        assert h == prefix_head_hash(
            prompt, bt, int(cfg.serve_prefix_affinity_blocks))
        assert h is not None
        # Sub-block prompts and non-LLM payloads produce no affinity key.
        assert DeploymentHandle._affinity_hash(
            [{"prompt_ids": prompt[:bt - 1]}]) is None
        assert DeploymentHandle._affinity_hash(["plain-arg"]) is None
        assert DeploymentHandle._affinity_hash([]) is None

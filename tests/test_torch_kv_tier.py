"""The cluster KV tier on the port, held against the JAX package.

First the 20 tests of ``tests/test_kv_tier.py`` on the port, under their
own names: the ``ShardedPrefixDirectory`` as a bounded refcounted cache
(publisher refcounts, LRU, TTL, ``on_free`` once, ``dump``/``load`` across
shard counts); the ``KVTier`` client on its local backend; store hits
across engines (token-identical to the port's ``Generator``); drain
migration over a ``KVHandoffLane``; the router's affinity rewrite; the
runtime backend's snapshot self-heal; a forced scale-down under multi-turn
sessions through ``serve.run(llm_deployment(...))``.

Then the port against JAX on the same inputs, TF32 off:

- random op sequences from a numpy seed on JAX's and the port's directory
  (publish, match, release, drop, sweep, stats, and dump/load into another
  shard count) give equal results, on one fake clock;
- JAX's and the port's ``PagedLLMEngine`` on ``tiny`` with the same weights
  (``params_from_numpy``) and the tier on give equal digests, payloads
  within 1e-5 (f32), equal ``kv_tier_hits_*`` and identical greedy streams,
  for a store hit and for a drain migration;
- on a port ``Cluster`` whose every process blocks ``jax`` and ``ray_tpu``,
  one worker process spills, another hits the store through the GCS's
  ``prefix_*`` RPCs, and a GCS restart over a stale snapshot self-heals;
  the streams equal JAX's in-process ones.

The module is pickled by value (``cloudpickle.register_pickle_by_value``):
the cluster's workers cannot import it.
"""

import os
import sys
import threading
import time

import cloudpickle
import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.core import config as jconfig
from ray_tpu.core import gcs_shards as jshards
from ray_tpu.models import transformer as jtf
from ray_tpu.serve import kv_tier as jkv_tier
from ray_tpu.serve.llm import PagedLLMEngine as JaxEngine
from ray_tpu.util import blockhash as jblockhash
from ray_tpu_torch.core import config as tconfig
from ray_tpu_torch.core.config import Config, config, set_config
from ray_tpu_torch.core.gcs_shards import ShardedPrefixDirectory
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.generate import Generator
from ray_tpu_torch.serve import kv_tier
from ray_tpu_torch.serve.handle import Router
from ray_tpu_torch.serve.llm import PagedLLMEngine
from ray_tpu_torch.util import blockhash

cloudpickle.register_pickle_by_value(sys.modules[__name__])
torch.backends.cuda.matmul.allow_tf32 = False

BT = 8  # test block size: small enough to exercise multi-block prompts
GEOM = dict(prompt_buckets=(16, 32), chunk=4, slots=2, block_tokens=BT,
            pool_blocks=129)
TIER_KNOBS = {"kv_tier_enabled": True, "kv_tier_drain_timeout_s": 5.0}


@pytest.fixture(scope="module", autouse=True)
def tier_enabled():
    """Flip the tier on for this module only, in both packages; engines
    read the flag at construction, so every engine below is built inside
    this scope."""
    # The installed tables (None: knobs read from the environment), not
    # config()'s snapshot of them, which set_config would install for
    # every later test of the process.
    prev, jprev = tconfig._global, jconfig._global
    set_config(Config(TIER_KNOBS))
    jconfig.set_config(jconfig.Config(TIER_KNOBS))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    set_config(prev)
    jconfig.set_config(jprev)


@pytest.fixture(autouse=True)
def fresh_local_tier():
    # A runtime's init and shutdown replace the port's config: re-apply the
    # tier knobs before every test.
    set_config(Config(TIER_KNOBS))
    kv_tier.reset_local_backend()
    jkv_tier.reset_local_backend()
    yield
    kv_tier.reset_local_backend()
    jkv_tier.reset_local_backend()


@pytest.fixture(scope="module")
def jax_model():
    cfg = jtf.tiny(max_seq_len=64)
    return cfg, jtf.init_params(cfg, jax.random.key(0))


@pytest.fixture(scope="module")
def tiny_model(jax_model):
    """The port's ``tiny`` with JAX's ``init_params`` carried across."""
    _cfg, jparams = jax_model
    return (ttf.tiny(max_seq_len=64),
            params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))


@pytest.fixture(scope="module")
def oracle(tiny_model):
    cfg, params = tiny_model
    gen = Generator(params, cfg, device="cpu")
    memo = {}

    def run(prompt, n, temperature=0.0, seed=0):
        key = (tuple(prompt), n, temperature, seed)
        if key not in memo:
            memo[key] = gen.generate(
                list(prompt), max_new_tokens=n,
                temperature=temperature, seed=seed)
        return memo[key]

    return run


def _mk_engine(tiny_model, name):
    cfg, params = tiny_model
    eng = PagedLLMEngine(params, cfg, device="cpu", max_queue=0, name=name,
                         **GEOM)
    eng.warmup()
    return eng


def _mk_jax_engine(jax_model, name):
    cfg, params = jax_model
    eng = JaxEngine(params, cfg, attention_kernel="gather", max_queue=0,
                    name=name, **GEOM)
    eng.warmup()
    return eng


def _d(i):
    return bytes([i]) * 16


# -- directory units ----------------------------------------------------------


class TestPrefixDirectory:
    def test_publisher_refcounts_gate_removal(self):
        freed = []
        d = ShardedPrefixDirectory(4, on_free=lambda dg, e: freed.append(dg))
        assert d.publish(_d(1), b"obj", 16, 2) is True
        assert d.publish(_d(1), b"obj", 16, 2) is False  # second publisher
        assert d.release(_d(1)) is False  # one publisher still holds it
        assert freed == []
        assert d.match([_d(1)]) is not None
        assert d.release(_d(1)) is True
        assert freed == [_d(1)]  # on_free exactly once, at zero refs
        assert d.match([_d(1)]) is None

    def test_match_longest_first_and_counters(self):
        d = ShardedPrefixDirectory(4)
        d.publish(_d(1), b"a", 8, 1)
        d.publish(_d(2), b"b", 16, 2)
        j, entry = d.match([_d(1), _d(2), _d(9)])
        assert j == 1 and entry["meta"] == b"b"  # longest wins
        assert d.match([_d(9)]) is None
        st = d.stats()
        assert st["prefix_dir_hits"] == 1 and st["prefix_dir_misses"] == 1

    def test_lru_capacity_eviction(self):
        freed = []
        d = ShardedPrefixDirectory(1, max_entries=3,
                                   on_free=lambda dg, e: freed.append(dg))
        for i in range(1, 6):
            d.publish(_d(i), b"x", 8, 1)
        assert d.stats()["prefix_dir_entries"] == 3
        assert freed == [_d(1), _d(2)]  # oldest out first
        # A match MRU-touches: the touched entry survives the next insert.
        assert d.match([_d(3)]) is not None
        d.publish(_d(6), b"x", 8, 1)
        assert d.match([_d(3)]) is not None
        assert d.match([_d(4)]) is None  # LRU victim instead

    def test_ttl_expiry(self):
        freed = []
        d = ShardedPrefixDirectory(2, ttl_s=0.05,
                                   on_free=lambda dg, e: freed.append(dg))
        d.publish(_d(1), b"x", 8, 1)
        assert d.match([_d(1)]) is not None
        time.sleep(0.08)
        assert d.match([_d(1)]) is None  # expired on the read path
        assert freed == [_d(1)]
        st = d.stats()
        assert st["prefix_dir_expired"] == 1

    def test_drop_is_unconditional(self):
        d = ShardedPrefixDirectory(2)
        d.publish(_d(1), b"x", 8, 1)
        d.publish(_d(1), b"x", 8, 1)  # refs = 2
        assert d.drop(_d(1)) is True  # fetch-miss self-heal ignores refs
        assert d.match([_d(1)]) is None

    def test_dump_load_across_shard_counts(self):
        d = ShardedPrefixDirectory(2, max_entries=8)
        for i in range(1, 5):
            d.publish(_d(i), b"m%d" % i, 8 * i, i)
        data = d.dump()
        d2 = ShardedPrefixDirectory(3, max_entries=8)  # GCS restart, resharded
        d2.load(data)
        assert d2.stats()["prefix_dir_entries"] == 4
        for i in range(1, 5):
            j, entry = d2.match([_d(i)])
            assert entry["meta"] == b"m%d" % i
            assert entry["tokens"] == 8 * i

    def test_load_preserves_lru_order(self):
        d = ShardedPrefixDirectory(1, max_entries=4)
        for i in range(1, 4):
            d.publish(_d(i), b"x", 8, 1)
            time.sleep(0.002)  # distinct wall-clock stamps
        d2 = ShardedPrefixDirectory(1, max_entries=4)
        d2.load(d.dump())
        d2.publish(_d(7), b"x", 8, 1)
        d2.publish(_d(8), b"x", 8, 1)  # over cap: evicts the OLDEST restored
        assert d2.match([_d(1)]) is None
        assert d2.match([_d(3)]) is not None


# -- tier client (local backend) ----------------------------------------------


class TestKVTierClient:
    def test_prefix_aliases_match_shorter_probe(self):
        t = kv_tier.KVTier("t")
        payload = {"k": None, "v": None, "tokens": list(range(24))}
        assert t.publish_chain([_d(1), _d(2), _d(3)], payload, 24, 3)
        # A probe covering only the first block still matches (alias entry).
        j, entry = t.match([_d(1)])
        assert j == 0 and entry["blocks"] == 1 and entry["tokens"] == 8
        j, entry = t.match([_d(1), _d(2)])
        assert j == 1 and entry["blocks"] == 2
        t.close()

    def test_fetch_miss_drops_entry(self):
        t = kv_tier.KVTier("t")
        t.publish_chain([_d(1)], {"k": None}, 8, 1)
        backend = t._resolve()
        with backend._lock:  # payload lost behind the directory's back
            backend._payloads.clear()
        m = t.match([_d(1)])
        assert m is not None
        assert t.fetch(_d(1), m[1]) is None
        assert t.match([_d(1)]) is None  # self-heal: entry dropped
        t.close()

    def test_close_drains_refs_to_zero(self):
        a = kv_tier.KVTier("a")
        b = kv_tier.KVTier("b")
        a.publish_chain([_d(1), _d(2)], {"k": None}, 16, 2)
        b.publish_chain([_d(1), _d(2)], {"k": None}, 16, 2)  # second pub
        a.close()
        st = a.stats()
        assert st["prefix_dir_entries"] == 2  # b still publishes them
        b.close()
        st = b.stats()
        assert st["prefix_dir_entries"] == 0
        assert st["prefix_dir_refs"] == 0
        assert st["prefix_dir_payloads"] == 0


# -- cluster-wide hits (bare engines, shared local tier) ----------------------


class TestClusterWideHit:
    def test_second_engine_fetches_from_store(self, tiny_model, oracle):
        """A computes and spills; B — which never saw the prompt — pulls
        the prefix from the store instead of recomputing, token-identical."""
        a = _mk_engine(tiny_model, "tier-a")
        b = _mk_engine(tiny_model, "tier-b")
        try:
            prompt = [5, 9] * 8  # 2 full blocks
            out_a = a.generate(list(prompt), max_new_tokens=8)
            assert a.stats()["kv_tier_spilled_blocks"] >= 2
            out_b = b.generate(list(prompt), max_new_tokens=8)
            assert out_a == out_b == oracle(prompt, 8)
            st = b.stats()
            assert st["kv_tier_hits_store"] >= BT  # >= one fetched block
            assert st["kv_tier_hits_local"] == 0
        finally:
            a.close()
            b.close()
        assert kv_tier._local_backend().stats()["prefix_dir_refs"] == 0

    def test_multi_turn_extension_hits_full_chain(self, tiny_model, oracle):
        """Turn 2 (= turn-1 prompt + output + new text) on a DIFFERENT
        engine covers A's whole spilled chain — the cluster-wide multi-turn
        path that makes replica death lossless."""
        a = _mk_engine(tiny_model, "tier-a2")
        b = _mk_engine(tiny_model, "tier-b2")
        try:
            p1 = [5, 9] * 8
            out1 = a.generate(list(p1), max_new_tokens=8)
            p2 = list(p1) + out1 + [3, 3]  # 26 tokens: 3 full blocks spilled
            out2 = b.generate(list(p2), max_new_tokens=4)
            assert out2 == oracle(p2, 4)
            assert b.stats()["kv_tier_hits_store"] >= 3 * BT
        finally:
            a.close()
            b.close()

    def test_cold_replica_warmup_vs_fresh_prefill(self, tiny_model, oracle):
        """A cold engine's first request over a spilled chain prefills ONLY
        the uncovered suffix — its engine-reported hit length equals the
        store hit, where a fresh engine with no tier hits nothing."""
        a = _mk_engine(tiny_model, "tier-a3")
        prompt = [7, 2] * 10  # 20 tokens: 2 full blocks
        out = a.generate(list(prompt), max_new_tokens=8)
        cold = _mk_engine(tiny_model, "tier-cold")
        try:
            out_cold = cold.generate(list(prompt), max_new_tokens=8)
            assert out_cold == out == oracle(prompt, 8)
            st = cold.stats()
            # Both probe-able full blocks came from the store — the cold
            # engine prefilled ONLY the uncovered suffix (its LOCAL lookup
            # saw nothing: kv.hit_tokens counts local hits only).
            assert st["kv_tier_hits_store"] == 2 * BT
            assert cold.kv.stats()["kv_hit_tokens"] == 0
        finally:
            a.close()
            cold.close()

    def test_flag_off_restores_private_kv(self, tiny_model):
        """kv_tier_enabled=0: no tier object, no directory traffic — the
        engine is byte-identical to the pre-tier PagedLLMEngine."""
        prev = config()
        set_config(Config({"kv_tier_enabled": False}))
        try:
            a = _mk_engine(tiny_model, "off-a")
            b = _mk_engine(tiny_model, "off-b")
            assert a._tier is None and b._tier is None
            prompt = [5, 9] * 8
            a.generate(list(prompt), max_new_tokens=8)
            b.generate(list(prompt), max_new_tokens=8)
            assert "kv_tier_spilled_blocks" not in a.stats()
            st = kv_tier._local_backend().stats()
            assert st["prefix_dir_published"] == 0
            a.close()
            b.close()
        finally:
            set_config(prev)


# -- drain migration ----------------------------------------------------------


class TestDrainMigration:
    def test_chains_migrate_over_lane(self, tiny_model, oracle):
        """Victim's tracked chains travel the handoff lane to the survivor,
        re-register as CACHED state, and attribute follow-up hits to
        ``migrated``; streams stay token-identical."""
        victim = _mk_engine(tiny_model, "mig-victim")
        survivor = _mk_engine(tiny_model, "mig-survivor")
        try:
            p1 = [5, 9] * 8
            out1 = victim.generate(list(p1), max_new_tokens=8)
            got = {}
            th = threading.Thread(
                target=lambda: got.setdefault(
                    "n", survivor.kv_migrate_in("kvtest-tmig-1")))
            th.start()
            sent = victim.kv_migrate_out("kvtest-tmig-1")
            th.join()
            assert sent >= 1 and got["n"] >= 1
            # Imported chains are pure cache (no pinned blocks).
            assert survivor.kv.stats()["kv_blocks_active"] == 0
            p2 = list(p1) + out1 + [3, 3]
            out2 = survivor.generate(list(p2), max_new_tokens=4)
            assert out2 == oracle(p2, 4)
            st = survivor.stats()
            assert st["kv_tier_hits_migrated"] >= 3 * BT
            assert st["kv_tier_hits_store"] == 0  # lane beat the store
        finally:
            victim.close()
            survivor.close()

    def test_migrate_out_without_survivor_lane_times_out(self, tiny_model):
        prev = config()
        set_config(Config({"kv_tier_enabled": True,
                           "kv_tier_drain_timeout_s": 0.2}))
        try:
            victim = _mk_engine(tiny_model, "mig-lonely")
            victim.generate([5, 9] * 8, max_new_tokens=8)
            assert victim.kv_migrate_out("kvtest-tnobody-home") == 0
            victim.close()
        finally:
            set_config(prev)


# -- router affinity rewrite --------------------------------------------------


class TestAffinityRewrite:
    def _router(self, aff):
        r = Router.__new__(Router)
        r.__dict__["_affinity"] = dict(aff)
        return r

    def test_drained_replica_entries_rewritten_to_target(self):
        r = self._router({b"h1": "victim", b"h2": "live-b", b"h3": "gone"})
        r._sweep_affinity_locked(
            live={"live-a", "live-b"},
            migrations={"victim": "live-a"})
        assert r._affinity_map() == {b"h1": "live-a", b"h2": "live-b"}

    def test_chain_following_and_cycle_safety(self):
        r = self._router({b"h1": "v1", b"h2": "v3"})
        r._sweep_affinity_locked(
            live={"live"},
            migrations={"v1": "v2", "v2": "live", "v3": "v4", "v4": "v3"})
        # v1 -> v2 -> live resolves; the v3 <-> v4 cycle sweeps.
        assert r._affinity_map() == {b"h1": "live"}


# -- GCS-backed directory (runtime backend) -----------------------------------


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4})
    yield
    ray_tpu_torch.shutdown()


class TestRuntimeBackend:
    def test_snapshot_roundtrip_and_stale_self_heal(self, ray_start_regular):
        """Directory state rides kv_dump/kv_load; a restored entry whose
        payload is gone drops on first fetch — no dangling object ids."""
        from ray_tpu_torch.core.runtime import get_runtime

        t = kv_tier.KVTier("rt")
        payload = {"k": torch.ones((2, 1, BT, 4, 16)),
                   "v": torch.ones((2, 1, BT, 4, 16)),
                   "tokens": list(range(BT))}
        assert t.publish_chain([_d(1)], payload, BT, 1)
        rt = get_runtime()
        assert not isinstance(t._resolve(), kv_tier._LocalBackend)
        m = rt.gcs.prefix_match([_d(1)])
        assert m is not None
        assert t.fetch(_d(1), m[1])["k"].shape[1] == 1
        dump = rt.gcs.kv_dump()
        # Restart-over-snapshot: the publisher dies (pin + entry go), THEN
        # the directory restores from the stale snapshot — its locator now
        # points at a freed object.
        t.close()
        assert rt.gcs.prefix_stats()["prefix_dir_entries"] == 0
        rt.gcs.kv_load(dump)
        assert rt.gcs.prefix_stats()["prefix_dir_entries"] == 1
        m = rt.gcs.prefix_match([_d(1)])
        assert m is not None
        assert t.fetch(_d(1), m[1]) is None  # object gone
        # The failed fetch dropped the entry (self-heal): no dangling
        # object ids survive a GCS restart over a stale snapshot.
        assert rt.gcs.prefix_stats()["prefix_dir_entries"] == 0


# -- end-to-end: scale-down under active sessions -----------------------------


@pytest.fixture
def serve_instance(ray_start_regular):
    from ray_tpu_torch import serve

    yield serve
    serve.shutdown()


class TestScaleDownE2E:
    def test_multi_turn_sessions_survive_forced_scale_down(
            self, serve_instance, tiny_model, oracle):
        """2 replicas -> 1 mid-run: the victim drains (in-flight streams
        finish), migrates its chains to the survivor, and retires; every
        session's turn 2 is token-identical to the no-drain tokens, zero
        streams drop, and the controller publishes the migration rewrite."""
        from ray_tpu_torch.serve.controller import get_or_create_controller
        from ray_tpu_torch.serve.llm import llm_deployment

        serve = serve_instance
        cfg, params = tiny_model
        # ray_tpu_torch.init (the ray_start_regular fixture) RESET the
        # global config from its system_config — re-apply the tier knobs
        # before any replica or controller reads them.
        set_config(Config(TIER_KNOBS))
        LM = llm_deployment(
            cfg, lambda: params, name="LM", slots=4, chunk=4,
            num_replicas=2, device="cpu")
        handle = serve.run(LM.bind())
        controller = get_or_create_controller()

        sessions = [[11 + i, 3 + i] * 9 for i in range(6)]  # 18 tokens
        turn1 = [None] * len(sessions)
        errs = []

        def run_turn(i, prompt, out):
            try:
                toks = []
                for item in handle.options(stream=True).remote(
                        {"prompt_ids": prompt, "max_new_tokens": 8}):
                    toks.append(item["token"])
                    if "finish_reason" in item:
                        assert item["finish_reason"] == "stop"
                out[i] = toks
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=run_turn,
                                    args=(i, sessions[i], turn1))
                   for i in range(len(sessions))]
        for t in threads:
            t.start()
        # Mid-run scale-down: streams are in flight RIGHT NOW.
        time.sleep(0.3)
        assert ray_tpu_torch.get(
            controller.set_target_replicas.remote("LM", 1), timeout=10)
        for t in threads:
            t.join()
        assert not errs, errs
        for i, prompt in enumerate(sessions):
            assert turn1[i] == oracle(prompt, 8), \
                f"turn-1 stream {i} diverged across the scale-down"

        # The drain must resolve: one routed replica + a migration
        # rewrite in the snapshot.
        deadline = time.monotonic() + 30
        migrations, reps = {}, []
        while time.monotonic() < deadline:
            _v, table = ray_tpu_torch.get(
                controller.get_snapshot.remote(-1, 0.0))
            entry = table.get("LM", {})
            migrations = entry.get("migrations", {})
            reps = entry.get("replicas", [])
            if len(reps) == 1 and migrations:
                break
            time.sleep(0.2)
        assert len(reps) == 1, "scale-down never converged"
        assert migrations, "drain-then-retire published no migration"

        # Turn 2 extends every session's chain — served by the
        # survivor, token-identical to a run that never scaled.
        turn2 = [None] * len(sessions)
        threads = []
        for i, prompt in enumerate(sessions):
            p2 = list(prompt) + turn1[i] + [2, 4]
            threads.append(threading.Thread(
                target=run_turn, args=(i, p2, turn2)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        hits_migrated = 0.0
        for i, prompt in enumerate(sessions):
            p2 = list(prompt) + turn1[i] + [2, 4]
            assert turn2[i] == oracle(p2, 8), \
                f"turn-2 stream {i} diverged after drain"
        # The victim's sessions now hit as `migrated` on the survivor.
        _v, table = ray_tpu_torch.get(controller.get_snapshot.remote(-1, 0.0))
        for m in table["LM"]["replica_load"].values():
            hits_migrated += float(m.get("kv_tier_hits_migrated") or 0)
        deadline = time.monotonic() + 10
        while hits_migrated == 0 and time.monotonic() < deadline:
            time.sleep(0.3)  # load poll lags by a poll period
            _v, table = ray_tpu_torch.get(
                controller.get_snapshot.remote(-1, 0.0))
            for m in table["LM"]["replica_load"].values():
                hits_migrated += float(
                    m.get("kv_tier_hits_migrated") or 0)
        assert hits_migrated > 0, \
            "no migrated-source hits: drain shipped no usable chains"


# -- the port against JAX: the directory --------------------------------------


def _directory_ops(rng, n_ops):
    """A random op sequence over 12 digests: publishes (with meta, tokens,
    blocks and hint), longest-prefix matches over probe chains, releases,
    drops, sweeps and clock steps across the TTL."""
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["publish", "publish", "match", "match", "release",
                           "drop", "sweep", "tick"])
        d = int(rng.integers(1, 13))
        if kind == "publish":
            nb = int(rng.integers(1, 5))
            ops.append(("publish", _d(d), bytes(rng.integers(0, 256, 4)
                                                  .astype(np.uint8)),
                        nb * BT, nb, f"r{int(rng.integers(0, 3))}"))
        elif kind == "match":
            n = int(rng.integers(1, 5))
            ops.append(("match", [_d(int(x)) for x in
                                  rng.integers(1, 13, n)]))
        elif kind == "tick":
            ops.append(("tick", float(rng.uniform(0.0, 3.0))))
        elif kind == "sweep":
            ops.append(("sweep",))
        else:
            ops.append((kind, _d(d)))
    return ops


def _apply(directory, op, clock):
    kind = op[0]
    if kind == "tick":
        clock[0] += op[1]
        return None
    if kind == "publish":
        _k, digest, meta, tokens, nb, hint = op
        return directory.publish(digest, meta, tokens, nb, hint=hint)
    if kind == "match":
        return directory.match(op[1])
    if kind == "sweep":
        return directory.sweep()
    return getattr(directory, kind)(op[1])


@pytest.mark.parametrize("shards", [(1, 3), (4, 2)])
@pytest.mark.parametrize("seed", range(6))
def test_directory_op_sequences_match_jax(seed, shards, monkeypatch):
    """The same random ops on JAX's and the port's directory, on one fake
    clock, give the same result at every step, the same stats, the same
    ``on_free`` reports, the same dump, and the same again after both
    reload their dump into another shard count."""
    clock = [1000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    n, m = shards
    freed = {"jax": [], "port": []}
    dirs = {
        "jax": jshards.ShardedPrefixDirectory(
            n, max_entries=6, ttl_s=5.0,
            on_free=lambda dg, e: freed["jax"].append((dg, e["meta"]))),
        "port": ShardedPrefixDirectory(
            n, max_entries=6, ttl_s=5.0,
            on_free=lambda dg, e: freed["port"].append((dg, e["meta"]))),
    }
    rng = np.random.default_rng(seed)
    for phase in range(2):
        for op in _directory_ops(rng, 60):
            got_jax = _apply(dirs["jax"], op, clock)
            if op[0] == "tick":
                continue
            assert got_jax == _apply(dirs["port"], op, clock), op
            assert dirs["jax"].stats() == dirs["port"].stats()
        assert freed["jax"] == freed["port"]
        dump = dirs["port"].dump()
        assert dump == dirs["jax"].dump()
        if phase == 0:  # a GCS restart into another shard count
            dirs["jax"] = jshards.ShardedPrefixDirectory(
                m, max_entries=6, ttl_s=5.0)
            dirs["port"] = ShardedPrefixDirectory(m, max_entries=6, ttl_s=5.0)
            dirs["jax"].load(dump)
            dirs["port"].load(dump)
            assert dirs["jax"].dump() == dirs["port"].dump() == dump


@pytest.mark.parametrize("n_tokens", [1, 8, 15, 16, 17, 40, 63])
def test_probe_digests_match_jax(n_tokens):
    """The probe's digests (capped at ``(len - 1) // bt`` blocks) are JAX's,
    byte for byte: one tier can index both packages' chains."""
    tokens = [int(t) for t in
              np.random.default_rng(n_tokens).integers(0, 50257, n_tokens)]
    cap = (len(tokens) - 1) // BT
    assert (blockhash.block_hashes(tokens, BT, max_blocks=cap)
            == jblockhash.block_hashes(tokens, BT, max_blocks=cap))


# -- the port against JAX: the engines ----------------------------------------

TIER_PROMPTS = [[5, 9] * 8, [7, 2] * 10, list(range(100, 118))]


def _tier_hits(stats):
    return {k: stats[k] for k in stats if k.startswith("kv_tier_")}


@pytest.mark.parametrize("prompt", TIER_PROMPTS)
def test_store_hit_matches_jax(prompt, tiny_model, jax_model):
    """A spills and B hits the store, in each package: the same digests
    publish, the payloads agree within 1e-5 in f32, the hit counters are
    equal and the greedy streams identical."""
    engines = {"jax": (_mk_jax_engine(jax_model, "xa"),
                       _mk_jax_engine(jax_model, "xb")),
               "port": (_mk_engine(tiny_model, "xa"),
                        _mk_engine(tiny_model, "xb"))}
    outs, stats, payloads = {}, {}, {}
    try:
        for pkg, (a, b) in engines.items():
            out_a = a.generate(list(prompt), max_new_tokens=8)
            backend = (jkv_tier if pkg == "jax" else kv_tier)._local_backend()
            payloads[pkg] = dict(backend._payloads)
            out_b = b.generate(list(prompt), max_new_tokens=8)
            outs[pkg] = (out_a, out_b)
            stats[pkg] = (_tier_hits(a.stats()), _tier_hits(b.stats()))
    finally:
        for a, b in engines.values():
            a.close()
            b.close()
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == outs["port"][1]
    assert stats["port"] == stats["jax"]
    assert stats["port"][1]["kv_tier_hits_store"] > 0
    assert set(payloads["port"]) == set(payloads["jax"])
    for digest, jp in payloads["jax"].items():
        tp = payloads["port"][digest]
        assert tp["tokens"] == jp["tokens"]
        for name in ("k", "v"):
            assert isinstance(tp[name], torch.Tensor)
            assert tp[name].device.type == "cpu"
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prompt", TIER_PROMPTS)
def test_drain_migration_matches_jax(prompt, tiny_model, jax_model):
    """The victim's chains cross a lane to the survivor in each package:
    the same chain count, identical greedy streams on the next turn and
    equal hit counters by source."""
    res = {}
    for pkg, mk, model in (("jax", _mk_jax_engine, jax_model),
                           ("port", _mk_engine, tiny_model)):
        victim, survivor = mk(model, "mv"), mk(model, "ms")
        try:
            out1 = victim.generate(list(prompt), max_new_tokens=8)
            got = {}
            lane = f"kvtest-x{pkg}-{os.getpid()}-{len(prompt)}"
            th = threading.Thread(target=lambda: got.setdefault(
                "n", survivor.kv_migrate_in(lane)))
            th.start()
            sent = victim.kv_migrate_out(lane)
            th.join()
            p2 = list(prompt) + out1 + [3, 3]
            out2 = survivor.generate(p2, max_new_tokens=4)
            res[pkg] = (out1, out2, sent, got["n"],
                        _tier_hits(survivor.stats()))
        finally:
            victim.close()
            survivor.close()
    assert res["port"] == res["jax"]
    assert res["port"][4]["kv_tier_hits_migrated"] > 0


def test_payload_of_another_dtype_is_refused(tiny_model, oracle,
                                             monkeypatch):
    """A directory hit whose payload is not the pool's dtype is refused with
    a logged error (the request prefills in full, token-identical), and
    ``kv_import_chain`` raises: nothing is cast quietly."""
    prompt = [5, 9] * 8
    digests = blockhash.block_hashes(prompt, BT,
                                     max_blocks=(len(prompt) - 1) // BT)
    cfg, _params = tiny_model
    shape = (cfg.n_layers, len(digests), BT, cfg.n_heads, cfg.head_dim)
    bad = {"k": torch.zeros(shape, dtype=torch.bfloat16),
           "v": torch.zeros(shape, dtype=torch.bfloat16),
           "tokens": prompt[:len(digests) * BT]}
    publisher = kv_tier.KVTier("elsewhere")
    publisher.publish_chain(digests, bad, len(digests) * BT, len(digests))
    from ray_tpu_torch.serve import llm as tllm

    errors = []
    monkeypatch.setattr(tllm.logger, "error",
                        lambda msg, *args: errors.append(msg % args))
    eng = _mk_engine(tiny_model, "refuser")
    try:
        out = eng.generate(list(prompt), max_new_tokens=8)
        assert out == oracle(prompt, 8)
        assert eng.stats()["kv_tier_hits_store"] == 0
        assert len(errors) == 1 and "refused a KV-tier payload" in errors[0]
        assert "bfloat16" in errors[0]
        with pytest.raises(ValueError, match="does not fit"):
            eng.kv_import_chain(dict(bad, n_real=len(digests) * BT))
        assert eng.kv.stats()["kv_blocks_active"] == 0
    finally:
        eng.close()
        publisher.close()


# -- the port against JAX: across a port Cluster ------------------------------

_BLOCKER = """
import os, sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "ray_tpu"):
            with open(os.environ["BOUNDARY_LOG"], "a") as f:
                f.write(f"{os.getpid()} {name}\\n")
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, _Block())
"""


class TierHost:
    """The port's paged engine, tier on, in a worker process."""

    def __init__(self, params, name, spill=True):
        from ray_tpu_torch.models import transformer as ttf_
        from ray_tpu_torch.serve.llm import PagedLLMEngine as Engine

        self.eng = Engine(params, ttf_.tiny(max_seq_len=64), device="cpu",
                          max_queue=0, name=name, **GEOM)
        if not spill:  # a minimum past any chain here: never publishes
            self.eng._tier_min_spill = 1 << 30
        self.eng.warmup()

    def generate(self, prompt, n):
        return self.eng.generate(prompt, max_new_tokens=n)

    def report(self):
        return os.getpid(), _tier_hits(self.eng.stats())


def test_cluster_spill_store_hit_and_snapshot_self_heal_match_jax(
        tiny_model, jax_model, tmp_path, monkeypatch):
    """On a port ``Cluster`` (every process blocks ``jax``/``ray_tpu``):
    worker P spills two chains through the GCS's ``prefix_*`` RPCs and the
    object store; worker F hits the store on one. P dies, and the GCS
    restarts over a snapshot that still indexes P's chains: the restored
    entry of P's other chain points at a lost object, so F's fetch misses,
    drops it (the directory shrinks by one) and F prefills in full. Every
    stream and hit count equals JAX's engines in this process on the same
    weights."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import runtime as truntime
    from ray_tpu_torch.core.cluster import Cluster, connect

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    log = tmp_path / "blocked.log"
    monkeypatch.setenv("BOUNDARY_LOG", str(log))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(site)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("RAY_TPU_KV_TIER_ENABLED", "1")
    prompt_a, prompt_b = [5, 9] * 10, [7, 2] * 10  # 2 probe-able blocks each

    # JAX's reference: A spills both chains, B hits the store on chain A
    # and prefills chain B in full once A's chains are gone.
    ja, jb = _mk_jax_engine(jax_model, "ja"), _mk_jax_engine(jax_model, "jb")
    jb._tier_min_spill = 1 << 30  # as F: never publishes
    try:
        want = [ja.generate(list(prompt_a), max_new_tokens=8),
                ja.generate(list(prompt_b), max_new_tokens=8),
                jb.generate(list(prompt_a), max_new_tokens=8)]
        want_hits = _tier_hits(jb.stats())
        ja.close()
        want.append(jb.generate(list(prompt_b), max_new_tokens=8))
        want_hits_after = _tier_hits(jb.stats())
    finally:
        ja.close()
        jb.close()

    _cfg, tparams = tiny_model
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2},
                      snapshot_path=str(tmp_path / "gcs.snap"))
    try:
        core = connect(cluster.gcs_address)
        try:
            host = rt.remote(TierHost)
            weights = rt.put(tparams)
            p = host.options(name="tier-p", lifetime="detached").remote(
                weights, "p")
            # F never spills: the directory holds P's entries alone, so a
            # drop shows.
            f = host.options(name="tier-f", lifetime="detached").remote(
                weights, "f", spill=False)
            got = [rt.get(p.generate.remote(prompt_a, 8), timeout=120),
                   rt.get(p.generate.remote(prompt_b, 8), timeout=120)]
            got.append(rt.get(f.generate.remote(prompt_a, 8), timeout=120))
            ppid, _ = rt.get(p.report.remote(), timeout=60)
            fpid, hits = rt.get(f.report.remote(), timeout=60)
            assert ppid != fpid and os.getpid() not in (ppid, fpid)
            assert hits == want_hits and hits["kv_tier_hits_store"] > 0
            n_before = core.gcs.prefix_stats()["prefix_dir_entries"]
            assert n_before > 0
            rt.kill(p)   # P's payloads go with its process; its entries stay
            deadline = time.monotonic() + 30
            while ppid in cluster.worker_pids(0) + cluster.worker_pids(1):
                assert time.monotonic() < deadline
                time.sleep(0.1)
            core._gcs_rpc.call("snapshot_now")
            cluster.kill_gcs()
            time.sleep(0.5)
            cluster.restart_gcs()
        finally:
            core.shutdown()
            truntime._global_runtime = None
        core = connect(cluster.gcs_address)
        try:
            deadline = time.monotonic() + 30
            while True:  # the daemons re-register F with the new GCS
                try:
                    f = rt.get_actor("tier-f")
                    break
                except ValueError:
                    assert time.monotonic() < deadline
                    time.sleep(0.2)
            assert core.gcs.prefix_stats()["prefix_dir_entries"] == n_before
            got.append(rt.get(f.generate.remote(prompt_b, 8), timeout=120))
            _pid, hits_after = rt.get(f.report.remote(), timeout=60)
            assert (core.gcs.prefix_stats()["prefix_dir_entries"]
                    == n_before - 1)
            rt.kill(f)
        finally:
            core.shutdown()
            truntime._global_runtime = None
    finally:
        cluster.shutdown()
    assert got == want
    assert hits_after == want_hits_after == want_hits
    assert not log.exists(), log.read_text()


@pytest.mark.parametrize("knob", [
    "kv_tier_enabled", "kv_tier_min_spill_blocks", "kv_tier_dir_max_entries",
    "kv_tier_dir_ttl_s", "kv_tier_drain_timeout_s"])
def test_tier_knob_has_jax_name_and_default(knob):
    port, jax_table = Config(), jconfig.Config()
    assert getattr(port, knob) == getattr(jax_table, knob)
    assert type(getattr(port, knob)) is type(getattr(jax_table, knob))


def test_tier_paths_record_no_steady_state_violation(tiny_model):
    """The spill (``_post_step``, outside the step's steady-state scope as
    in JAX), the store fetch and insert (inside it) and a migration's
    import add no implicit host read to a warm engine's steps: JAX compiles
    the tier's programs at warm-up for this; the port needs no warm-up."""
    from ray_tpu_torch.devtools import jitcheck

    was = jitcheck.installed()
    jitcheck.install()
    jitcheck.clear_violations()
    a = _mk_engine(tiny_model, "steady-a")
    b = _mk_engine(tiny_model, "steady-b")
    try:
        prompt = [5, 9] * 8
        out = a.generate(list(prompt), max_new_tokens=8)
        assert a.stats()["kv_tier_spilled_blocks"] >= 2
        assert b.generate(list(prompt), max_new_tokens=8) == out
        assert b.stats()["kv_tier_hits_store"] > 0
        th = threading.Thread(target=b.kv_migrate_in,
                              args=(f"kvtest-steady-{os.getpid()}",))
        th.start()
        assert a.kv_migrate_out(f"kvtest-steady-{os.getpid()}") >= 1
        th.join()
        assert a._steady and b._steady
        assert jitcheck.violations() == []
    finally:
        a.close()
        b.close()
        jitcheck.clear_violations()
        if not was:
            jitcheck.uninstall()

"""The port's paged forwards, block manager and block hashes against JAX.

``_forward_prefill_paged`` / ``_forward_decode_paged`` run on ``tiny()`` and
``tiny(pos="rope")`` in f32 with the JAX package's weights carried across by
``params_from_numpy``; the JAX side runs its gather path. Logits must agree
to 1e-4 (f32 matmuls and softmaxes summed in another order, through two
layers) and every pool block but the trash block 0 must agree to 1e-5 (one
projection deep). The pure-host parts — ``KVBlockManager`` and
``block_hashes`` — must give identical results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as jgen
from ray_tpu.models import transformer as jtf
from ray_tpu.util import blockhash as jhash
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.util import blockhash as thash

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

torch.backends.cuda.matmul.allow_tf32 = False

BT = 8
NUM_BLOCKS = 20
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5


@pytest.fixture(scope="module", params=["learned", "rope"])
def models(request):
    jcfg = jtf.tiny(max_seq_len=64, pos=request.param)
    tcfg = ttf.tiny(max_seq_len=64, pos=request.param)
    jparams = jtf.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def test_params_carry_across_key_for_key(models):
    jcfg, jparams, tcfg, tparams = models
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert ttf.param_count(tparams) == jtf.param_count(jparams)
    for path, leaf in flat_j:
        node = tparams
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_params_shapes_match_jax():
    """The port's own init gives the JAX layout (values differ: torch's
    generator is not jax.random)."""
    for cfg_fn in ("tiny", "gpt2_small"):
        tcfg = getattr(ttf, cfg_fn)(n_layers=2)
        jcfg = getattr(jtf, cfg_fn)(n_layers=2)
        tp = ttf.init_params(tcfg, 0, device="cpu")
        jp = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0)))
        tshapes = {k: tuple(v.shape) for k, v in tp["blocks"].items()}
        jshapes = {k: tuple(v.shape) for k, v in jp["blocks"].items()}
        assert tshapes == jshapes
        assert tuple(tp["tok_embed"].shape) == jp["tok_embed"].shape
        assert tcfg.padded_vocab == jcfg.padded_vocab
    small = ttf.gpt2_small()
    assert (small.padded_vocab, small.head_dim, small.n_layers) == (50304, 64,
                                                                     12)


def _pools(cfg):
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    return np.zeros((L, NUM_BLOCKS, BT, H, Dh), np.float32)


def _both_prefill(models, kernel, tokens, table, start_pos, suffix_len,
                  k0=None, v0=None):
    jcfg, jparams, tcfg, tparams = models
    k0 = _pools(tcfg) if k0 is None else k0
    v0 = _pools(tcfg) if v0 is None else v0
    jl, jk, jv = jgen._forward_prefill_paged(
        jparams, jnp.asarray(tokens), jnp.asarray(k0), jnp.asarray(v0),
        jnp.asarray(table), start_pos, suffix_len, jcfg, BT, kernel="gather")
    tk, tv = torch.tensor(k0), torch.tensor(v0)
    tl, tk2, tv2 = tgen._forward_prefill_paged(
        tparams, torch.tensor(tokens, dtype=torch.long), tk, tv,
        torch.tensor(table), start_pos, suffix_len, tcfg, BT, kernel=kernel)
    assert tk2 is tk and tv2 is tv          # updated in place
    return (np.asarray(jl), np.asarray(jk), np.asarray(jv),
            tl.numpy(), tk.numpy(), tv.numpy())


def _assert_pools(jk, jv, tk, tv):
    np.testing.assert_allclose(tk[:, 1:], jk[:, 1:], atol=POOL_TOL,
                               rtol=POOL_TOL)
    np.testing.assert_allclose(tv[:, 1:], jv[:, 1:], atol=POOL_TOL,
                               rtol=POOL_TOL)


@pytest.mark.parametrize("kernel", ["plain", "gather"])
def test_prefill_then_prefix_hit_then_decode(models, kernel):
    rng = np.random.default_rng(0)
    NB = 64 // BT
    # Cold prefill: 11 real tokens in a 16-bucket, blocks 3 and 7.
    prompt = rng.integers(0, 256, 19)
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :11] = prompt[:11]
    table = np.zeros(NB, np.int32)
    table[:3] = [3, 7, 5]
    jl, jk, jv, tl, tk, tv = _both_prefill(models, kernel, tokens, table, 0,
                                           11)
    np.testing.assert_allclose(tl[:, :11], jl[:, :11], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    _assert_pools(jk, jv, tk, tv)

    # Prefix hit: positions [0, 8) are reused, the suffix starts at 8 and
    # runs to 19 (crossing into the third block), pads past it redirect.
    suffix = np.zeros((1, 16), np.int32)
    suffix[0, :11] = prompt[8:19]
    jl, jk, jv, tl, tk, tv = _both_prefill(models, kernel, suffix, table, 8,
                                           11, k0=tk, v0=tv)
    np.testing.assert_allclose(tl[:, :11], jl[:, :11], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    _assert_pools(jk, jv, tk, tv)

    # Decode: slot 0 continues the sequence at 19, slot 1 is parked on an
    # all-trash table; then a T=2 step (the verify shape), one slot past
    # table capacity so its overhang write redirects to trash.
    jcfg, jparams, tcfg, tparams = models
    tables = np.stack([table, np.zeros(NB, np.int32)])
    for toks, lengths in ((np.array([[17], [0]], np.int32),
                           np.array([19, 0], np.int32)),
                          (np.array([[4, 9], [1, 2]], np.int32),
                           np.array([20, 63], np.int32))):
        jl, jk2, jv2 = jgen._forward_decode_paged(
            jparams, jnp.asarray(toks), jnp.asarray(jk), jnp.asarray(jv),
            jnp.asarray(tables), jnp.asarray(lengths), jcfg, BT,
            kernel="gather")
        tk_t, tv_t = torch.tensor(tk), torch.tensor(tv)
        tl, _, _ = tgen._forward_decode_paged(
            tparams, torch.tensor(toks, dtype=torch.long), tk_t, tv_t,
            torch.tensor(tables), torch.tensor(lengths), tcfg, BT,
            kernel=kernel)
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        jk, jv, tk, tv = (np.asarray(jk2), np.asarray(jv2), tk_t.numpy(),
                          tv_t.numpy())
        _assert_pools(jk, jv, tk, tv)


def test_pos_embed_clamps_past_max_seq_len(models):
    """A bucket that runs past max_seq_len (pads of a long suffix) reads
    pos_embed at max_seq_len - 1, as JAX clamps; nothing raises."""
    jcfg, jparams, tcfg, tparams = models
    NB = 64 // BT
    tokens = np.arange(1, 33, dtype=np.int32)[None]
    table = np.arange(1, NB + 1, dtype=np.int32)
    jl, jk, jv, tl, tk, tv = _both_prefill(models, "plain", tokens, table,
                                           48, 10)
    np.testing.assert_allclose(tl[:, :10], jl[:, :10], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    _assert_pools(jk, jv, tk, tv)


def test_resolve_attention_kernel():
    assert tgen.resolve_attention_kernel("auto", "cpu") == "plain"
    assert tgen.resolve_attention_kernel(None, "cpu") == "plain"
    assert tgen.resolve_attention_kernel("gather", "cpu") == "gather"
    assert tgen.resolve_attention_kernel("auto", "cuda") == "cuda"
    assert tgen.resolve_attention_kernel("gather", "cuda") == "gather"
    with pytest.raises(ValueError, match="CUDA pool"):
        tgen.resolve_attention_kernel("cuda", "cpu")
    with pytest.raises(ValueError, match="CPU pools only"):
        tgen.resolve_attention_kernel("plain", "cuda")
    with pytest.raises(ValueError):
        tgen.resolve_attention_kernel("pallas", "cpu")


def _manager_script(mgr):
    """One call sequence over alloc/release/lookup/COW/eviction; returns
    everything each call gave back, plus the final stats."""
    out = []
    a = list(range(1, 40))                       # 39 tokens: 4 full + 7
    b = a[:20] + [99, 98, 97, 96, 95]            # shares 2 full blocks
    ids_a = mgr.alloc(5)
    out.append(("alloc", ids_a))
    mgr.register_chain(a, ids_a, 39)             # full blocks + tail
    mgr.release(ids_a)
    out.append(("peek", mgr.peek_hit_len(a + [7])))
    full, tail, hit = mgr.lookup(a + [7, 8])     # full hit + tail (COW)
    out.append(("lookup", full, tail, hit))
    mgr.note_cow()
    fresh = mgr.alloc(2)
    out.append(("alloc", fresh))
    mgr.release([tail])
    mgr.release(full + fresh)
    out.append(("lookup_b", mgr.lookup(b)))
    full_b, _, _ = out[-1][1]
    mgr.release(full_b)
    out.append(("pin_chain", mgr.pin_chain(a, 39)))
    mgr.release(out[-1][1][0])
    # Exhaust the pool: cached blocks get evicted LRU-first.
    big = mgr.alloc(mgr.num_blocks - 1)
    out.append(("alloc_all", big))
    try:
        mgr.alloc(1)
        out.append(("no_raise",))
    except (jgen.NoFreeBlocks, tgen.NoFreeBlocks) as e:
        out.append(("NoFreeBlocks", str(e)))
    mgr.release(big)
    out.append(("after_evict", mgr.lookup(a)))
    mgr.release(out[-1][1][0])
    out.append(("stats", mgr.stats(), mgr.active_blocks()))
    return out


def test_kv_block_manager_matches_jax():
    j = _manager_script(jgen.KVBlockManager(16, BT))
    t = _manager_script(tgen.KVBlockManager(16, BT))
    assert t == j
    assert t[-1][2] == 0
    assert t[2][3] == 39 and t[2][2] is not None       # tail hit → COW


@pytest.mark.parametrize("n,bt,max_blocks", [(0, 16, None), (37, 16, None),
                                             (256, 16, 4), (100, 8, None),
                                             (1025, 16, None)])
def test_block_hashes_byte_identical(n, bt, max_blocks):
    toks = np.random.default_rng(n).integers(0, 50257, n).tolist()
    assert thash.SEED == jhash.SEED == b"ray_tpu-kv-block"
    assert (thash.block_hashes(toks, bt, max_blocks)
            == jhash.block_hashes(toks, bt, max_blocks))
    head = jhash.prefix_head_hash(toks, bt, 4)     # the JAX router's key
    assert thash.block_hashes(toks, bt, 4)[-1:] == ([head] if head else [])


PROMPTS = [[7, 3, 11], [2, 4, 6, 8, 10], list(range(100, 125))]


def test_forward_cached_prefill_then_decode_matches_jax(models):
    """``_forward_cached`` (the oracle's forward): a 9-token prefill, then a
    1-token decode at 9 and a 2-token step at 10 — logits and every cache
    row against JAX."""
    jcfg, jparams, tcfg, tparams = models
    toks = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(np.int32)
    jc = jgen.init_cache(jcfg, 2, 32)
    tc = tgen.init_cache(tcfg, 2, 32, device="cpu")
    for lo, hi in ((0, 9), (9, 10), (10, 12)):
        jl, jc = jgen._forward_cached(jparams, jnp.asarray(toks[:, lo:hi]),
                                      jc, jcfg, lo)
        tl, tc2 = tgen._forward_cached(
            tparams, torch.tensor(toks[:, lo:hi], dtype=torch.long), tc,
            tcfg, lo)
        assert tc2 is tc and tc["length"] == int(jc["length"]) == hi
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                       atol=POOL_TOL, rtol=POOL_TOL)


def test_generator_greedy_streams_match_jax(models):
    """The single-sequence oracle: greedy streams equal JAX's ``Generator``,
    ``stream=True`` yields them one at a time, and a prompt near max_len
    stops where JAX's does."""
    jcfg, jparams, tcfg, tparams = models
    jg = jgen.Generator(jparams, jcfg)
    tg = tgen.Generator(tparams, tcfg, device="cpu")
    for p in PROMPTS:
        want = jg.generate(p, max_new_tokens=12)
        assert tg.generate(p, max_new_tokens=12) == want
        it = tg.generate(p, max_new_tokens=12, stream=True)
        assert next(it) == want[0]
        assert [want[0]] + list(it) == want
    near_cap = list(range(1, 60))
    want = jg.generate(near_cap, max_new_tokens=10)
    assert len(want) == 64 - 59 + 1
    assert tg.generate(near_cap, max_new_tokens=10) == want
    sampled = tg.generate(PROMPTS[1], max_new_tokens=12, temperature=0.8,
                          seed=5)
    assert sampled == tg.generate(PROMPTS[1], max_new_tokens=12,
                                  temperature=0.8, seed=5)
    assert all(0 <= t < 256 for t in sampled)


def test_generator_chunked_fns_match_jax(models):
    """``chunked_fns``: a prefill fused with a greedy chunk from a padded
    bucket (decoding from the real length), then a second chunk — the
    tokens and the carried logits equal JAX's."""
    jcfg, jparams, tcfg, tparams = models
    jg = jgen.Generator(jparams, jcfg)
    tg = tgen.Generator(tparams, tcfg, device="cpu")
    padded = np.zeros((1, 16), np.int32)
    padded[0, :5] = PROMPTS[1]
    jpd, jdc = jg.chunked_fns(4, False)
    tpd, tdc = tg.chunked_fns(4, False)
    key = jax.random.key(0)
    jt, jl, jc, jpos, _ = jpd(jparams, jgen.init_cache(jcfg, 1), padded, 5,
                              key, 1.0)
    tt, tl, tc, tpos, _ = tpd(tg.params,
                              tgen.init_cache(tcfg, 1, device="cpu"),
                              padded, 5, None, 1.0)
    assert tt.tolist() == np.asarray(jt).tolist() and tpos == int(jpos) == 9
    jt, jl, jc, jpos, _ = jdc(jparams, jc, jl, jpos, key, 1.0)
    tt, tl, tc, tpos, _ = tdc(tg.params, tc, tl, tpos, None, 1.0)
    assert tt.tolist() == np.asarray(jt).tolist() and tpos == int(jpos)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_slotted_generator_matches_jax(models):
    """``SlottedGenerator``: two prompts prefilled into slots 2 and 0 (slot
    1 idle), a greedy chunk with slot 1 inactive, then a slot parked at the
    cache cap — logits, tokens, lengths and live cache rows against JAX."""
    jcfg, jparams, tcfg, tparams = models
    S, M = 3, 32
    js = jgen.SlottedGenerator(jparams, jcfg, slots=S, max_len=M)
    ts = tgen.SlottedGenerator(tparams, tcfg, slots=S, device="cpu",
                               max_len=M)
    jcache, jlast, jkeys = js.init_state()
    tcache, tlast, tgens = ts.init_state()
    for slot, p in ((2, PROMPTS[0]), (0, PROMPTS[1])):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :len(p)] = p
        jcache, jlast, jkeys = js.prefill_fn(16)(
            jparams, jcache, jlast, jkeys, padded, len(p), slot, 0)
        tcache, tlast, tgens = ts.prefill_fn(16)(
            tparams, tcache, tlast, tgens, padded, len(p), slot, 0)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    active = np.array([True, False, True])
    greedy = np.ones(S, bool)
    temps = np.zeros(S, np.float32)
    jt, jcache, jlast, jkeys = js.decode_fn(4)(
        jparams, jcache, jlast, jkeys, active, greedy, temps)
    tt, tcache, tlast, tgens = ts.decode_fn(4)(
        tparams, tcache, tlast, tgens, active, greedy, temps)
    assert tt.dtype == torch.int32
    assert tt[active].tolist() == np.asarray(jt)[active].tolist()
    assert tcache["lengths"].tolist() == np.asarray(jcache["lengths"]).tolist()
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache[name].numpy()[:, active],
            np.asarray(jcache[name])[:, active],
            atol=POOL_TOL, rtol=POOL_TOL)
    # A slot parked at the cap writes at M - 1 instead of out of bounds.
    lengths = np.array([M, 7, 0], np.int32)
    toks = np.array([[3], [4], [5]], np.int32)
    jl, _, _ = jgen._forward_decode_slotted(
        jparams, jnp.asarray(toks), jcache["k"], jcache["v"],
        jnp.asarray(lengths), jcfg)
    tl, _, _ = tgen._forward_decode_slotted(
        tparams, torch.tensor(toks, dtype=torch.long), tcache["k"],
        tcache["v"], torch.tensor(lengths), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)

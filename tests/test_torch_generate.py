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

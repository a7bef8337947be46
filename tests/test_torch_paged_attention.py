"""The port's paged attention against the JAX kernel and its reference.

On CPU tensors ``ray_tpu_torch.ops.paged_attention`` runs its plain version;
these cases (ported from ``test_paged_attention_kernel.py``) hold it against
the JAX Pallas kernel in interpret mode and the JAX
``paged_attention_reference``, at that file's tolerance (2e-5, f32). The
interpret-mode kernel costs seconds a case, so only the block-boundary
cases run it; every case runs against the JAX reference.

The CUDA kernel itself is held against the plain version on the card by
``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.paged_attention import paged_attention as jax_paged
from ray_tpu.ops.paged_attention import \
    paged_attention_reference as jax_reference
from ray_tpu_torch.ops import paged_attention as pa

torch.backends.cuda.matmul.allow_tf32 = False

BT = 8   # block_tokens
NB = 6   # blocks per sequence (table width)
H, D = 4, 16
TOL = 2e-5   # the JAX kernel tests' own tolerance, f32


def _setup(lengths, t_tokens, *, seed=0, pool_blocks=24):
    """Random pool + one live block chain per slot, as numpy operands."""
    rng = np.random.default_rng(seed)
    S = len(lengths)
    q = rng.standard_normal((S, t_tokens, H, D)).astype(np.float32)
    k_pool = rng.standard_normal((pool_blocks, BT, H, D)).astype(np.float32)
    v_pool = rng.standard_normal((pool_blocks, BT, H, D)).astype(np.float32)
    tables = np.zeros((S, NB), np.int32)
    nxt = 1  # block 0 stays trash
    for s, ln in enumerate(lengths):
        live = -(-max(ln + t_tokens, 1) // BT)
        for j in range(min(live, NB)):
            tables[s, j] = nxt
            nxt += 1
    return q, k_pool, v_pool, tables, np.asarray(lengths, np.int32)


def _port(ops, **kw):
    out = pa.paged_attention(*(torch.from_numpy(a) for a in ops), **kw)
    return out.numpy()


def _assert_close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


BOUNDARY_LENGTHS = [
    [0], [1], [5], [BT - 1], [BT], [BT + 1],        # block boundary +-1
    [2 * BT - 1], [2 * BT], [2 * BT + 1],
    [NB * BT - 1],                                   # table-capacity edge
]
RAGGED = [0, 3, BT, 2 * BT + 1, NB * BT - 2]


@pytest.mark.parametrize("lengths", BOUNDARY_LENGTHS + [RAGGED])
def test_decode_lengths_vs_reference(lengths):
    ops = _setup(lengths, 1)
    _assert_close(_port(ops), jax_reference(*ops))


@pytest.mark.parametrize("lengths", [[BT - 1], [BT], [NB * BT - 1], RAGGED])
def test_decode_lengths_vs_interpret_kernel(lengths):
    ops = _setup(lengths, 1)
    _assert_close(_port(ops), jax_paged(*ops, interpret=True))


@pytest.mark.parametrize("t_tokens", [2, 4, 7])
def test_multi_token_queries(t_tokens):
    """T > 1 queries: query t attends kv <= lengths + t, straddling block
    boundaries mid-chunk."""
    ops = _setup([0, BT - 1, BT, 13], t_tokens, seed=3)
    got = _port(ops)
    _assert_close(got, jax_reference(*ops))
    if t_tokens == 4:
        _assert_close(got, jax_paged(*ops, interpret=True))


def test_scale_override():
    ops = _setup([11], 1, seed=5)
    _assert_close(_port(ops, scale=0.25), jax_reference(*ops, scale=0.25))


def test_port_reference_is_the_dispatch_on_cpu():
    ops = _setup(RAGGED, 2, seed=4)
    t_ops = [torch.from_numpy(a) for a in ops]
    before = pa.launches
    a = pa.paged_attention(*t_ops)
    b = pa.paged_attention_reference(*t_ops)
    assert torch.equal(a, b)
    assert pa.launches == before    # the CPU path launches no kernel


def test_trash_block_cannot_leak():
    """Huge values in the trash block and in every dead table entry's
    target must not move a live output by a single ULP — in the port and
    in the JAX kernel alike."""
    lengths = [5, BT + 2]
    q, k_pool, v_pool, tables, lens = _setup(lengths, 1, seed=7)
    clean = _port((q, k_pool, v_pool, tables, lens))
    k_bad, v_bad = k_pool.copy(), v_pool.copy()
    k_bad[0] = 1e9
    v_bad[0] = -1e9
    bad_ops = (q, k_bad, v_bad, tables, lens)
    np.testing.assert_array_equal(_port(bad_ops), clean)
    _assert_close(_port(bad_ops), jax_paged(*bad_ops, interpret=True))


def test_nan_trash_keys_are_masked():
    """NaN keys in the trash block are masked before the softmax: the live
    rows stay exactly what they were."""
    q, k_pool, v_pool, tables, lens = _setup([5, BT + 2], 1, seed=8)
    clean = _port((q, k_pool, v_pool, tables, lens))
    k_bad = k_pool.copy()
    k_bad[0] = np.nan
    np.testing.assert_array_equal(_port((q, k_bad, v_pool, tables, lens)),
                                  clean)


def test_inactive_slot_is_finite():
    """An all-trash table at length 0 (a parked slot) gives finite output."""
    q, k_pool, v_pool, tables, lens = _setup([0, 9], 1, seed=9)
    tables[0] = 0
    assert np.isfinite(_port((q, k_pool, v_pool, tables, lens))).all()


def test_out_of_range_table_entries_clamp_like_jax():
    """JAX clamps an out-of-range gather index; the port clamps the same
    way instead of raising."""
    ops = list(_setup([3, 12], 1, seed=10))
    ops[3] = ops[3].copy()
    ops[3][1, 5] = 1000
    _assert_close(_port(ops), jax_reference(*(jnp.asarray(a) for a in ops)))


def test_cpu_kernel_checks_are_strict():
    """The wrapper's checks raise on what the kernel does not take (they
    run before any launch, so they are testable here)."""
    q, k_pool, v_pool, tables, lens = (torch.from_numpy(a) for a in
                                       _setup([3], 1))
    with pytest.raises(ValueError, match="head_dim"):     # D=16
        pa._check(q, k_pool, v_pool, tables, lens)
    q, k_pool, v_pool = (torch.cat([a, a], dim=-1)       # D=32
                         for a in (q, k_pool, v_pool))
    with pytest.raises(TypeError, match="int32"):
        pa._check(q, k_pool, v_pool, tables.long(), lens)
    with pytest.raises(TypeError, match="dtype"):
        pa._check(q.double(), k_pool, v_pool, tables, lens)
    with pytest.raises(ValueError, match="do not match"):
        pa._check(q[:, :, :2].contiguous(), k_pool, v_pool, tables, lens)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.cat([q, q], dim=-1)[..., ::2]
        pa._check(strided, k_pool, v_pool, tables, lens)
    pa._check(q, k_pool, v_pool, tables, lens)

"""The port's paged attention against the JAX kernel and its reference.

On CPU tensors ``ray_tpu_torch.ops.paged_attention`` runs its plain version;
these cases (ported from ``test_paged_attention_kernel.py``) hold it against
the JAX Pallas kernel in interpret mode and the JAX
``paged_attention_reference``, at that file's tolerance (2e-5, f32). The
interpret-mode kernel costs seconds a case, so only the block-boundary
cases run it; every case runs against the JAX reference.

The split kernel's host-side plan and its split-then-merge arithmetic
are held here too: the plan covers every table page exactly once, and
partials per split merged by the kernel's formula match the JAX kernel and
reference at 2e-5. The CUDA kernels themselves are held against the plain
version on the card by ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.paged_attention import paged_attention as jax_paged
from ray_tpu.ops.paged_attention import \
    paged_attention_reference as jax_reference
from ray_tpu_torch.ops import paged_attention as pa

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

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
    before = (pa.launches, pa.prefill_launches, pa.decode_launches)
    a = pa.paged_attention(*t_ops)
    b = pa.paged_attention_reference(*t_ops)
    assert torch.equal(a, b)
    # The CPU path launches no kernel.
    assert (pa.launches, pa.prefill_launches, pa.decode_launches) == before


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


@pytest.mark.parametrize("nb", [1, 6, 64, 100])
@pytest.mark.parametrize("bt", [1, 8, 16, 32])
def test_split_plan_covers_every_page_once(nb, bt):
    """Split j covers pages [j·pages, (j+1)·pages) ∩ [0, nb): together every
    page of the table exactly once, no split empty, each at least 64 keys
    unless one split takes the whole table, and more than one split only
    while the rows alone leave the card short of ~2 blocks an SM."""
    for S in (1, 4):
        for H in (4, 12):
            for T in (1, 8, 9, 1024):
                pages, n_split = pa.split_plan(nb, bt, S, H, T)
                covered = [p for j in range(n_split)
                           for p in range(j * pages,
                                          min((j + 1) * pages, nb))]
                assert covered == list(range(nb)), (S, H, T)
                assert (n_split - 1) * pages < nb
                assert pages == nb or pages * bt >= 64
                rows = S * H * -(-T // 8)
                assert n_split == 1 or rows < 264


def _split_merge(ops, pages, *, scale=None):
    """The split kernel's arithmetic, written plainly: per slot, head and
    query row, one partial (m, l, acc) per split of ``pages`` table pages —
    a split with no key that the row attends gives m = -1e30, l = 0,
    acc = 0 — then out = Σ e^{m_i−m} acc_i / Σ e^{m_i−m} l_i."""
    q, k_pool, v_pool, tables, lengths = (torch.from_numpy(np.asarray(a))
                                          for a in ops)
    S, T, H, D = q.shape
    bt, nb_seq = k_pool.shape[1], tables.shape[1]
    s_val = scale if scale is not None else 1.0 / D ** 0.5
    idx = tables.long().clamp(0, k_pool.shape[0] - 1)
    kc = k_pool[idx].reshape(S, nb_seq * bt, H, D)
    vc = v_pool[idx].reshape(S, nb_seq * bt, H, D)
    scores = torch.einsum("bthd,bshd->bhts", q, kc) * s_val
    kv_pos = torch.arange(nb_seq * bt)
    q_pos = lengths.long()[:, None] + torch.arange(T)[None, :]     # [S, T]
    ok = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]     # [S,1,T,K]
    parts = []
    for k0 in range(0, nb_seq * bt, pages * bt):
        sl = slice(k0, min(k0 + pages * bt, nb_seq * bt))
        s_j = torch.where(ok[..., sl], scores[..., sl],
                          torch.full_like(scores[..., sl], -1e30))
        m_j = s_j.max(dim=-1).values                              # [S,H,T]
        p_j = torch.where(ok[..., sl], torch.exp(s_j - m_j[..., None]),
                          torch.zeros_like(s_j))
        acc_j = torch.einsum("bhts,bshd->bhtd", p_j, vc[:, sl])
        parts.append((m_j, p_j.sum(-1), acc_j))
    m = torch.stack([m_j for m_j, _, _ in parts]).max(dim=0).values
    num = sum(torch.exp(m_j - m)[..., None] * acc_j for m_j, _, acc_j in parts)
    den = sum(torch.exp(m_j - m) * l_j for m_j, l_j, _ in parts)
    out = num / den.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).numpy()                        # [S,T,H,D]


@pytest.mark.parametrize("pages", [None, 1, 4])
@pytest.mark.parametrize("lengths", BOUNDARY_LENGTHS + [RAGGED])
def test_split_then_merge_matches_jax(lengths, pages):
    """Partials per split (the planner's, or 1 and 4 pages a split, so that
    short contexts leave splits empty) merged by the kernel's formula give
    the JAX reference's output, at decode (T = 1) and T = 3."""
    for T in (1, 3):
        ops = _setup(lengths, T, seed=11)
        plan = pages or pa.split_plan(NB, BT, len(lengths), H, T)[0]
        _assert_close(_split_merge(ops, plan), jax_reference(*ops))


@pytest.mark.parametrize("lengths", [[BT - 1], [NB * BT - 1], RAGGED])
def test_split_then_merge_matches_interpret_kernel(lengths):
    ops = _setup(lengths, 1, seed=12)
    _assert_close(_split_merge(ops, 2), jax_paged(*ops, interpret=True))


@pytest.mark.parametrize("T", [1, 2, 4, 5, 8, 9, 16, 1024])
def test_paged_route_on_cpu_dtypes(T):
    """The route depends on T and the dtype alone: f32 always takes the
    split kernel; bf16 takes the wgmma kernel from WGMMA_MIN_T (5) up."""
    assert pa.WGMMA_MIN_T == 5
    assert pa.paged_route(T, torch.float32) == "split"
    assert pa.paged_route(T, torch.bfloat16) == (
        "wgmma" if T >= 5 else "split")

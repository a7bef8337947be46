"""The port's flash attention (its plain versions, on the CPU) against the
JAX package's Pallas kernels in interpret mode.

Inputs come from numpy seeds and go to both packages. TF32 is off. The
cases are those of ``tests/test_flash_attention.py``. Tolerances: 2e-4 for
f32 outputs and for the plain backward against ``_flash_backward`` on the
same (o, lse, g) — the same f32 arithmetic summed in another order; 2e-3 for
gradients through the whole function and 1e-3 on the dense route (the JAX
tests' own bounds: the softmax's recomputation differs between the paths);
3e-2 for bf16 outputs (one bf16 rounding of an O(1) value, 2^-8, plus f32
sums in another order). The bf16 tensor-core kernels' extra rounding of
P and dS, emulated here, is held to 1e-2, the tolerance the card uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(b=2, l=128, h=4, d=32, seed=0, lk=None):
    rng = np.random.default_rng(seed)
    lk = l if lk is None else lk
    return (rng.standard_normal((b, l, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, h, d)).astype(np.float32))


def _t(*arrays, dtype=torch.float32, grad=False):
    return tuple(torch.tensor(a, dtype=dtype, requires_grad=grad)
                 for a in arrays)


def _fold(x):
    b, l, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, l, d)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(causal):
    q, k, v = _qkv()
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal, None,
                               64, 64, True)
    got = tfa.flash_attention(*_t(q, k, v), causal, None, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_forward_uneven_blocks():
    q, k, v = _qkv(l=256)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), True, None,
                               128, 64, True)
    got = tfa.flash_attention(*_t(q, k, v), True, None, 128, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_forward_bf16_inputs():
    q, k, v = _qkv(l=64)
    want = jfa.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), True, None, 32,
        32, True)
    got = tfa.flash_attention(*_t(q, k, v, dtype=torch.bfloat16), True,
                              None, 32, 32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("causal,lk", [(True, 128), (False, 128),
                                       (True, 64), (False, 192)])
def test_forward_reference_lse_matches_jax(causal, lk):
    """o and lse of the plain K1 against ``_flash_forward``, also with
    Lk != Lq under the top-left mask."""
    q, k, v = _qkv(b=2, l=128, h=2, d=32, seed=1, lk=lk)
    s = 1.0 / np.sqrt(32)
    jo, jlse = jfa._flash_forward(
        *(jnp.asarray(_fold(x)) for x in (q, k, v)), scale=s, causal=causal,
        block_q=64, block_k=64, interpret=True)
    o, lse = tfa.flash_forward_reference(*_t(q, k, v), scale=s,
                                         causal=causal)
    assert lse.shape == (2, 2, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy().reshape(4, 128),
                               np.asarray(jlse)[..., 0], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(_fold(o.numpy()), np.asarray(jo), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_reference_matches_jax(causal):
    """The plain K2/K3 against ``_flash_backward`` on the same (o, lse, g)."""
    q, k, v = _qkv(b=2, l=128, h=2, d=32, seed=2)
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    s = 1.0 / np.sqrt(32)
    jf = [jnp.asarray(_fold(x)) for x in (q, k, v, g)]
    jo, jlse = jfa._flash_forward(*jf[:3], scale=s, causal=causal,
                                  block_q=32, block_k=32, interpret=True)
    jd = jfa._flash_backward(*jf, jo, jlse, scale=s, causal=causal,
                             block_q=32, block_k=32, interpret=True)
    o = torch.tensor(np.asarray(jo).reshape(2, 2, 128, 32)).transpose(1, 2)
    lse = torch.tensor(np.asarray(jlse)[..., 0].reshape(2, 2, 128))
    got = tfa.flash_backward_reference(*_t(q, k, v, g), o, lse, scale=s,
                                       causal=causal)
    for a, b in zip(got, jd):
        np.testing.assert_allclose(_fold(a.numpy()), np.asarray(b),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("blocks", [(32, 32), (64, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_vjp(causal, blocks):
    q, k, v = _qkv(b=2, l=128, h=2, d=32, seed=3)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    out, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal, None, *blocks,
                                            True),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q, k, v, grad=True)
    o = tfa.flash_attention(tq, tk, tv, causal, None, *blocks)
    assert o.grad_fn is not None and "Flash" in type(o.grad_fn).__name__
    before = (tfa.forward_launches, tfa.dq_launches, tfa.dkv_launches)
    o.backward(torch.tensor(g))
    # The CPU runs the plain versions: no kernel is launched here.
    assert (tfa.forward_launches, tfa.dq_launches, tfa.dkv_launches) == before
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               rtol=2e-4, atol=2e-4)
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-3)


def test_ragged_length_takes_the_dense_route():
    """L=192 with block 128 takes the dense route in both packages; the
    gradients of sum(o**2) agree."""
    q, k, v = _qkv(b=1, l=192, h=2, d=16, seed=5)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jfa.flash_attention(
            q, k, v, True, None, 128, 128, True) ** 2),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    o = tfa.flash_attention(tq, tk, tv, True, None, 128, 128)
    assert "Flash" not in type(o.grad_fn).__name__
    (o ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-3)


def test_plain_versions_agree_with_dense_autograd():
    """The plain backward equals autograd through the dense reference, also
    for Lk != Lq (no JAX path covers the backward there)."""
    q, k, v = _qkv(b=1, l=96, h=2, d=32, seed=6, lk=160)
    g = torch.tensor(np.random.default_rng(7).standard_normal(q.shape),
                     dtype=torch.float32)
    s = 0.2
    for causal in (True, False):
        tq, tk, tv = _t(q, k, v, grad=True)
        dense = tfa._dense_reference(tq, tk, tv, scale=s, causal=causal)
        dense.backward(g)
        o, lse = tfa.flash_forward_reference(*_t(q, k, v), scale=s,
                                             causal=causal)
        torch.testing.assert_close(o, dense.detach(), rtol=1e-5, atol=1e-5)
        got = tfa.flash_backward_reference(*_t(q, k, v), g, o, lse, scale=s,
                                           causal=causal)
        for a, b in zip(got, (tq.grad, tk.grad, tv.grad)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tensor_core_rounding(q, k, v, g, o, lse, *, scale, causal):
    """What the bf16 tensor-core K1-K3 compute: scores, softmax statistics
    and every sum in f32, with P and dS rounded to bf16 before the products
    that take them as operands, and outputs rounded to bf16. Returns (o,
    lse) of the forward and (dq, dk, dv) of the backward on the given (o,
    lse)."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    s = tfa._scores(qf, kf, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_ = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    fwd_o = (torch.einsum("bhlk,bkhd->blhd", _bf16(p), vf)
             / l_.permute(0, 2, 1, 3)).to(torch.bfloat16)
    fwd_lse = (m + torch.log(l_))[..., 0]
    delta = tfa._delta(gf, o)
    p, ds = tfa._probs_and_ds(qf, kf, vf, gf, lse, delta, scale=scale,
                              causal=causal)
    dq = torch.einsum("bhlk,bkhd->blhd", _bf16(ds), kf).to(torch.bfloat16)
    dk = torch.einsum("bhlk,blhd->bkhd", _bf16(ds), qf).to(torch.bfloat16)
    dv = torch.einsum("bhlk,blhd->bkhd", _bf16(p), gf).to(torch.bfloat16)
    return (fwd_o, fwd_lse), (dq, dk, dv)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_rounding_within_bf16_tolerance_of_jax(causal, d):
    """The bf16 rounding of P and dS that the tensor-core kernels add keeps
    o, dq, dk and dv within the card's bf16 tolerance (1e-2) of the Pallas
    kernels (f32 inside, bf16 outputs), at the train step's head_dim and at
    128, where the kernels' tiles differ, and lse within 1e-4."""
    q, k, v = _qkv(b=2, l=128, h=2, d=d, seed=10)
    g = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)
    s = 1.0 / np.sqrt(d)
    jf = [jnp.asarray(_fold(x), jnp.bfloat16) for x in (q, k, v, g)]
    jo, jlse = jfa._flash_forward(*jf[:3], scale=s, causal=causal,
                                  block_q=64, block_k=64, interpret=True)
    jdq, jdk, jdv = jfa._flash_backward(*jf, jo, jlse, scale=s,
                                        causal=causal, block_q=64,
                                        block_k=64, interpret=True)
    o = torch.tensor(np.asarray(jo, np.float32).reshape(2, 2, 128, d)
                     ).transpose(1, 2).to(torch.bfloat16)
    lse = torch.tensor(np.asarray(jlse)[..., 0].reshape(2, 2, 128))
    (got_o, got_lse), (dq, dk, dv) = _tensor_core_rounding(
        *_t(q, k, v, g, dtype=torch.bfloat16), o, lse, scale=s,
        causal=causal)
    np.testing.assert_allclose(got_lse.numpy().reshape(4, 128),
                               np.asarray(jlse)[..., 0], rtol=1e-4, atol=1e-4)
    for got, want in ((got_o, jo), (dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(_fold(got.float().numpy()),
                                   np.asarray(want, np.float32), rtol=1e-2,
                                   atol=1e-2)


def test_kernel_wrappers_validate_on_the_host():
    """The checks the wrappers make before handing pointers to a kernel run
    in Python, so they are tested here on CPU tensors."""
    q, k, v = _t(*_qkv(b=1, l=64, h=2, d=64))
    tfa._check(q, k, v, q)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check(*_t(*_qkv(b=1, l=64, h=2, d=16)))
    with pytest.raises(TypeError, match="dtype"):
        tfa._check(q, k.double(), v)
    with pytest.raises(ValueError, match="gradient"):
        tfa._check(q, k, v, q[:, :32])
    with pytest.raises(ValueError, match="match q"):
        tfa._check(q, k[:, :, :1], v[:, :, :1])
    lse = torch.zeros(1, 2, 64)
    assert all(t.is_contiguous() for t in tfa._rows(q, lse, lse))
    with pytest.raises(ValueError, match="lse and delta"):
        tfa._rows(q, lse[:, :, :8])
    with pytest.raises(ValueError, match="lse and delta"):
        tfa._rows(q, lse.double())
    # Readable layouts pass through; an expanded gradient or an odd view is
    # copied to contiguous.
    assert tfa._kernel_operand(q) is q
    qkv = torch.zeros(1, 64, 3, 2, 64)
    k_view = qkv[:, :, 1]
    assert tfa._kernel_operand(k_view).data_ptr() == k_view.data_ptr()
    ones = torch.ones(()).expand(1, 64, 2, 64)
    assert tfa._kernel_operand(ones).is_contiguous()
    odd = torch.zeros(1, 64, 2, 65)[..., 1:]
    assert tfa._kernel_operand(odd).is_contiguous()


def test_launch_counts_lose_no_update_across_threads():
    """Concurrent trials and autograd's device thread bump the counters at
    once: 16 threads x 2000 bumps under a tiny switch interval lose none."""
    import sys
    import threading

    from ray_tpu_torch.ops import flash_attention as fa

    before = fa.dq_launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [fa._count("dq_launches") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fa.dq_launches - before == 16 * 2000
    fa.dq_launches = before

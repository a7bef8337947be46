"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false (the CPU test host). The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so this file imports only torch and numpy
and runs there with:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: 1e-4 in f32 (the kernels sum over up to ~1300 keys in another
order than the plain versions), 1e-2 in bf16 (both round an f32 result to
bf16; one bf16 step is 2^-8 relative; the bf16 flash forward and dK/dV
kernels also round P and dS to bf16 before their tensor-core products,
while dQ keeps an f32 dS, so dq and dk come from slightly different
roundings of dS); the flash lse, f32 in both dtypes, 1e-4. The bf16
tensor-core kernels' errors in o, dk and dv also stay within twice those
of torch's SDPA against the same plain versions. The tiny train step
through the flash kernels and through dense attention (f32): each gradient leaf 1e-4 relative to its largest entry,
floored at 1e-3 of the model's largest (bk's gradient is 0 in exact
arithmetic: both paths give rounding noise there), the losses of 3 AdamW
steps 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import training, transformer
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import layers
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm import PagedLLMEngine

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(rng, dt, lengths, T, *, H=12, D=64, bt=16, nb_seq=64,
              num_blocks=513):
    S = len(lengths)

    def rnd(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda").to(dt)

    q, kp, vp = rnd(S, T, H, D), rnd(num_blocks, bt, H, D), rnd(
        num_blocks, bt, H, D)
    kp[0] = 1e9          # poisoned trash block
    vp[0] = -1e9
    tables = np.zeros((S, nb_seq), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    nxt = 0
    for s, ln in enumerate(lengths):
        live = min(-(-(ln + T) // bt), nb_seq)
        tables[s, :live] = perm[nxt:nxt + live]
        nxt += live
    return (q, kp, vp, torch.tensor(tables, device="cuda"),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths,T,geom", [
    ([0, 15, 16, 1000], 1, {}),                       # engine decode
    ([0, 17, 300], 5, {}),                            # multi-token
    ([256], 64, {}),                                  # prefill, prefix hit
    ([0], 1024, {}),                                  # full bucket
    ([5, 63, 64], 3, dict(bt=8, nb_seq=16, D=32)),    # other geometry
    ([100, 7], 2, dict(D=128, H=4)),
])
def test_kernel_matches_plain_version(cuda, dtype, lengths, T, geom):
    dt = getattr(torch, dtype)
    ops = _operands(np.random.default_rng(len(lengths) * 100 + T), dt,
                    lengths, T, **geom)
    before = pa.launches
    got = pa.paged_attention(*ops)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    assert got.dtype == dt and got.shape == ops[0].shape
    want = pa.paged_attention_reference(*ops)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dt],
                               rtol=TOL[dt])


@pytest.mark.gpu
def test_nan_in_dead_pages_never_read(cuda):
    ops = _operands(np.random.default_rng(5), torch.bfloat16,
                    [0, 15, 16, 1000], 1)
    clean = pa.paged_attention(*ops)
    kp, vp = ops[1].clone(), ops[2].clone()
    kp[0] = float("nan")
    vp[0] = float("nan")
    assert torch.equal(pa.paged_attention(ops[0], kp, vp, *ops[3:]), clean)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    ops = _operands(np.random.default_rng(6), torch.float32, [3], 1,
                    D=16, H=4)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(*ops)
    ops = _operands(np.random.default_rng(6), torch.float32, [3], 1)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(ops[0], ops[1], ops[2], ops[3].long(), ops[4])
    with pytest.raises(ValueError, match="is on"):
        pa.paged_attention(ops[0], ops[1], ops[2], ops[3].cpu(), ops[4])


@pytest.mark.gpu
def test_engine_kernel_path_matches_gather_path(cuda):
    cfg = transformer.tiny(max_seq_len=64, n_heads=2)    # head_dim 32
    params = transformer.init_params(cfg, 0, device="cuda")
    kw = dict(prompt_buckets=(16, 32), chunk=4, slots=2, max_queue=0,
              block_tokens=8, pool_blocks=40)
    kern = PagedLLMEngine(params, cfg, attention_kernel="auto", **kw)
    plain = PagedLLMEngine(params, cfg, attention_kernel="gather", **kw)
    assert kern._pg.attention_kernel == "cuda"
    before = pa.launches
    for prompt in ([7, 3, 11], [2, 4, 6, 8, 10, 12, 14], list(range(20))):
        assert kern.generate(prompt, max_new_tokens=10) == plain.generate(
            prompt, max_new_tokens=10)
    assert pa.launches > before
    assert kern.kv.active_blocks() == plain.kv.active_blocks() == 0


def _flash_operands(seed, dt, B, Lq, Lk, H, D):
    rng = np.random.default_rng(seed)

    def rnd(L):
        return torch.tensor(rng.standard_normal((B, L, H, D)),
                            dtype=torch.float32, device="cuda").to(dt)

    return rnd(Lq), rnd(Lk), rnd(Lk), rnd(Lq)


def _flash_counts():
    return fa.forward_launches, fa.dq_launches, fa.dkv_launches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lq,lk", [(64, 64), (192, 192), (1024, 1024),
                                   (96, 160), (160, 96), (1000, 1000),
                                   (200, 520)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_kernels_match_plain_versions(cuda, dtype, causal, lq, lk, d):
    dt = getattr(torch, dtype)
    B, H = (2, 3) if lq < 1024 else (1, 2)
    q, k, v, g = _flash_operands(lq * 7 + d, dt, B, lq, lk, H, d)
    s = 1.0 / d ** 0.5
    before = _flash_counts()
    o, lse = fa.flash_forward(q, k, v, scale=s, causal=causal)
    torch.cuda.synchronize()
    assert _flash_counts() == (before[0] + 1, before[1], before[2])
    want_o, want_lse = fa.flash_forward_reference(q, k, v, scale=s,
                                                  causal=causal)
    assert o.dtype == dt and o.shape == q.shape and lse.shape == (B, H, lq)
    torch.testing.assert_close(o.float(), want_o.float(), atol=TOL[dt],
                               rtol=TOL[dt])
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    grads = fa.flash_backward(q, k, v, g, o, lse, scale=s, causal=causal)
    torch.cuda.synchronize()
    assert _flash_counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    want = fa.flash_backward_reference(q, k, v, g, o, lse, scale=s,
                                       causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert a.dtype == dt and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=TOL[dt],
                                   rtol=TOL[dt], msg=name)
    # No atomics: a second run gives the same bits.
    again = fa.flash_backward(q, k, v, g, o, lse, scale=s, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
def test_flash_bf16_errors_within_twice_sdpa(cuda):
    """The bf16 tensor-core K1 and K3 round P (and dS) to bf16 before their
    products, as torch's scaled_dot_product_attention does: against the
    same plain versions their max errors in o, dk and dv stay within twice
    SDPA's."""
    import torch.nn.functional as F

    q, k, v, g = _flash_operands(21, torch.bfloat16, 2, 1024, 1024, 4, 64)
    s = 0.125
    o, lse = fa.flash_forward(q, k, v, scale=s, causal=True)
    dk, dv = fa.flash_dkv(q, k, v, g, lse, fa._delta(g, o), scale=s,
                          causal=True)
    want_o, _ = fa.flash_forward_reference(q, k, v, scale=s, causal=True)
    want_dk, want_dv = fa.flash_dkv_reference(q, k, v, g, lse,
                                              fa._delta(g, o), scale=s,
                                              causal=True)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_dk, lib_dv = torch.autograd.grad(lib_o, (kt, vt), g.transpose(1, 2))

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    for name, got, lib, want in (("o", o, lib_o, want_o),
                                 ("dk", dk, lib_dk, want_dk),
                                 ("dv", dv, lib_dv, want_dv)):
        lib_err = err(lib.transpose(1, 2), want)
        assert err(got, want) <= 2 * lib_err, (name, err(got, want), lib_err)


@pytest.mark.gpu
def test_flash_autograd_on_strided_operands(cuda):
    """q, k, v as strided views of one [B, L, 3, H, D] tensor and an
    expanded output gradient go through the kernels like contiguous ones."""
    rng = np.random.default_rng(11)
    qkv = torch.tensor(rng.standard_normal((2, 128, 3, 4, 64)),
                       dtype=torch.float32, device="cuda")
    leaf = qkv.clone().requires_grad_(True)
    q, k, v = leaf.unbind(2)
    before = _flash_counts()
    fa.flash_attention(q, k, v, True).sum().backward()
    assert _flash_counts() == tuple(c + 1 for c in before)
    ref = qkv.clone().requires_grad_(True)
    fa._dense_reference(*ref.unbind(2), scale=0.125, causal=True).sum(
    ).backward()
    torch.testing.assert_close(leaf.grad, ref.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_refuses_what_it_cannot_take(cuda):
    q, k, v, g = _flash_operands(0, torch.float32, 1, 64, 64, 2, 16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward(q, k, v, scale=0.25, causal=True)
    q, k, v, g = _flash_operands(0, torch.float32, 1, 64, 64, 2, 64)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_forward(q, k.half(), v, scale=0.125, causal=True)
    with pytest.raises(ValueError, match="on"):
        fa.flash_forward(q, k.cpu(), v, scale=0.125, causal=True)
    o, lse = fa.flash_forward(q, k, v, scale=0.125, causal=True)
    delta = fa._delta(g, o)
    with pytest.raises(ValueError, match="lse and delta"):
        fa.flash_dq(q, k, v, g, lse[:, :1], delta, scale=0.125, causal=True)
    with pytest.raises(ValueError, match="lse and delta"):
        fa.flash_dkv(q, k, v, g, lse, delta.double(), scale=0.125,
                     causal=True)


@pytest.mark.gpu
def test_tiny_train_step_through_flash_kernels_matches_dense(cuda):
    base = transformer.tiny(n_heads=2, max_seq_len=128)     # head_dim 32
    tokens = torch.tensor(np.random.default_rng(12).integers(
        0, base.vocab_size, (2, 128)), device="cuda")
    results = {}
    for attn in ("flash", "dense"):
        cfg = base.replace(attn_impl=attn, remat=True)
        bundle = training.make_train_step(
            loss_fn=lambda p, b, cfg=cfg: transformer.lm_loss(p, b, cfg),
            init_params_fn=lambda seed: transformer.init_params(base, seed),
            optimizer=training.adamw(1e-3, weight_decay=0.1), device="cuda")
        params, opt = bundle.init(0)
        before = _flash_counts()
        transformer.lm_loss(params, {"tokens": tokens}, cfg).backward()
        grads = [p.grad.clone() for p in training._leaves(params)]
        n = base.n_layers if attn == "flash" else 0
        assert _flash_counts() == (before[0] + 2 * n, before[1] + n,
                                   before[2] + n)
        losses = []
        for _ in range(3):
            params, opt, m = bundle.step(params, opt, {"tokens": tokens})
            losses.append(m["loss"].item())
        results[attn] = grads, losses
    (gf, lf), (gd, ld) = results["flash"], results["dense"]
    floor = 1e-3 * max(b.abs().max() for b in gd)
    for a, b in zip(gf, gd):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), floor)
    np.testing.assert_allclose(lf, ld, rtol=1e-4)
    assert lf[-1] < lf[0]


@pytest.mark.gpu
def test_matmul_f32_runs_bf16_with_f32_output(cuda):
    """bf16 operands on the card: one tensor-core GEMM with an unrounded f32
    output (only the sum order differs from the f32 upcast: 1e-4), bf16
    gradients one rounding from the f32 ones (1e-2), and the same product
    with or without a graph to record."""
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.standard_normal((3, 5, 64)), dtype=torch.float32,
                     device="cuda").bfloat16()
    w = torch.tensor(rng.standard_normal((64, 48)), dtype=torch.float32,
                     device="cuda").bfloat16()
    want = torch.matmul(x.float(), w.float())
    got = layers.matmul_f32(x, w)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 48)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = layers.matmul_f32(xg, wg)
    assert torch.equal(y.detach(), got)
    g = torch.tensor(rng.standard_normal((3, 5, 48)), dtype=torch.float32,
                     device="cuda").bfloat16()
    y.to(torch.bfloat16).backward(g)
    xr, wr = x.float().requires_grad_(), w.float().requires_grad_()
    torch.matmul(xr, wr).backward(g.float())
    assert xg.grad.dtype == wg.grad.dtype == torch.bfloat16
    torch.testing.assert_close(xg.grad.float(), xr.grad, atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(wg.grad.float(), wr.grad, atol=1e-2,
                               rtol=1e-2)

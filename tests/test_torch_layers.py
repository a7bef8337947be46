"""The port's ``ops/layers.py`` against the JAX ops, on the same f32 inputs.

Inputs come from a numpy seed and pass between the packages as numpy
arrays. Tolerance: atol/rtol 1e-6 for the elementwise ops (one or two f32
roundings apart), 1e-5 where a reduction or a transcendental is summed in
another order (layer-norm and rms-norm statistics, logsumexp, rope's
sin/cos of large angles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import layers as jl
from ray_tpu_torch.ops import bias_gelu
from ray_tpu_torch.ops import layers as tl

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

torch.backends.cuda.matmul.allow_tf32 = False


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               atol=tol, rtol=tol)


def test_layer_norm():
    r = _rng(0)
    x = r.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    g = r.standard_normal(64).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    _close(tl.layer_norm(torch.tensor(x), torch.tensor(g), torch.tensor(b)),
           jl.layer_norm(x, g, b), 1e-5)


def test_rms_norm():
    r = _rng(1)
    x = r.standard_normal((4, 32)).astype(np.float32)
    g = r.standard_normal(32).astype(np.float32)
    _close(tl.rms_norm(torch.tensor(x), torch.tensor(g)),
           jl.rms_norm(x, g), 1e-5)


def test_gelu():
    x = _rng(2).standard_normal((7, 33)).astype(np.float32) * 4
    _close(tl.gelu(torch.tensor(x)), jl.gelu(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    r = _rng(3)
    x = r.standard_normal((2, 6, 48)).astype(np.float32)
    w = r.standard_normal((48, 24)).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32) if bias else None
    tb = torch.tensor(b) if bias else None
    _close(tl.linear(torch.tensor(x), torch.tensor(w), tb),
           jl.linear(x, w, b), 1e-5)


def test_linear_bf16_adds_bias_in_f32():
    """bf16 inputs: the product and the bias add stay in f32 and round once
    at the end, so the port and JAX agree to the bf16 rounding of one
    result (the f32 sums differ only in order)."""
    r = _rng(4)
    x = r.standard_normal((4, 32)).astype(np.float32)
    w = r.standard_normal((32, 16)).astype(np.float32)
    b = r.standard_normal(16).astype(np.float32)
    got = tl.linear(torch.tensor(x).bfloat16(), torch.tensor(w).bfloat16(),
                    torch.tensor(b).bfloat16())
    want = jl.linear(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                     jnp.asarray(b, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)


def test_softmax_cross_entropy():
    r = _rng(5)
    logits = r.standard_normal((3, 7, 50)).astype(np.float32) * 2
    labels = r.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -100
    tm, tn = tl.softmax_cross_entropy(torch.tensor(logits),
                                      torch.tensor(labels))
    jm, jn = jl.softmax_cross_entropy(logits, labels)
    _close(tm, jm, 1e-5)
    assert int(tn) == int(jn) == 3 * 7 - 3


@pytest.mark.parametrize("offset", [0, 500])
def test_rope(offset):
    r = _rng(6)
    x = r.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = (np.arange(9)[None, :] + offset + np.array([[0], [3]])).astype(
        np.int32)
    _close(tl.rope(torch.tensor(x), torch.tensor(pos)),
           jl.rope(x, pos), 1e-5)


# -- linear_gelu: the eager route, and the kernels' route on the CPU ---------

def _linear_gelu_case(dtype, seed=7, n=(2, 5), k=24, f=40):
    r = _rng(seed)
    mk = lambda *shape: torch.tensor(  # noqa: E731
        r.standard_normal(shape).astype(np.float32) * 2).to(dtype)
    return mk(*n, k), mk(k, f) * 0.3, mk(f)


def _value_and_grads(fn, x, w, b):
    x, w, b = (t.detach().requires_grad_(True) for t in (x, w, b))
    out = fn(x, w, b)
    g = torch.tensor(_rng(11).standard_normal(tuple(out.shape)).astype(
        np.float32)).to(out.dtype)
    out.backward(g)
    return out.detach(), x.grad, w.grad, b.grad


def _launches():
    return (bias_gelu.bias_gelu_forward_launches,
            bias_gelu.bias_gelu_backward_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_gelu_plain_route_is_the_eager_expression(dtype):
    """On CPU tensors ``linear_gelu`` is ``gelu(linear(...))`` bit for bit,
    forward and the gradients of x, w and b, and launches nothing."""
    before = _launches()
    got = _value_and_grads(tl.linear_gelu, *_linear_gelu_case(dtype))
    want = _value_and_grads(lambda x, w, b: tl.gelu(tl.linear(x, w, b)),
                            *_linear_gelu_case(dtype))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype
        assert torch.equal(a, b)
    assert _launches() == before


def test_linear_gelu_dtensor_takes_the_plain_route(monkeypatch):
    """A DTensor input keeps the eager chain, even where the kernels would
    otherwise take it (every tensor counted as on the card here)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    monkeypatch.setattr(bias_gelu, "_on_card", lambda t: True)
    x, w, b = _linear_gelu_case(torch.bfloat16)
    assert bias_gelu.takes(x, w, b)
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        mesh = DeviceMesh("cpu", [0])
        dx, dw, db = (DTensor.from_local(t, mesh, [Replicate()],
                                         run_check=False) for t in (x, w, b))
        assert not bias_gelu.takes(dx, dw, db)
        before = _launches()
        got = tl.linear_gelu(dx, dw, db)
        assert isinstance(got, DTensor)
        assert torch.equal(got.to_local(), tl.gelu(tl.linear(x, w, b)))
        assert _launches() == before
    finally:
        dist.destroy_process_group()


def test_linear_gelu_kernel_route_on_cpu_is_the_f32_expression(monkeypatch):
    """The kernels' route, run on the CPU through the kernels' plain
    versions: out within one bf16 rounding of the f32 expression, gradients
    within bf16 steps of f32 autograd's, and no launch counted."""
    monkeypatch.setattr(bias_gelu, "_on_card", lambda t: True)
    x, w, b = _linear_gelu_case(torch.bfloat16)
    before = _launches()
    out, gx, gw, gb = _value_and_grads(tl.linear_gelu, x, w, b)
    assert _launches() == before
    want = _value_and_grads(
        lambda x, w, b: tl.gelu(x @ w + b).to(torch.bfloat16),
        *(t.float() for t in (x, w, b)))
    assert out.dtype == gx.dtype == gw.dtype == gb.dtype == torch.bfloat16
    for got, ref in zip((out, gx, gw, gb), want):
        scale = ref.abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2 ** -6 * scale, (err, scale)
    # The eager bf16 chain rounds nine times; the kernels' route once.
    eager = tl.gelu(tl.linear(x, w, b)).float()
    ref = want[0].float()
    assert ((out.float() - ref).abs().mean()
            <= (eager - ref).abs().mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_tail_unchanged_on_cpu(dtype):
    """``_block_tail`` through ``linear_gelu`` gives the eager block's
    output bit for bit on CPU tensors."""
    from ray_tpu_torch.models import transformer as ttf

    cfg = ttf.tiny(dtype=dtype)
    params = ttf.init_params(cfg, 3, device="cpu")
    bp = {k: v[0].to(dtype) for k, v in params["blocks"].items()}
    r = _rng(12)
    h = torch.tensor(r.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32)).to(dtype)
    o = torch.tensor(r.standard_normal((2, 8, cfg.n_heads, cfg.head_dim))
                     .astype(np.float32)).to(dtype)
    got = ttf._block_tail(h, bp, o, dtype)
    h2 = h + ttf._out_proj(o, bp["wo"], bp["bo"], dtype)
    x = tl.layer_norm(h2, bp["ln2_g"], bp["ln2_b"])
    u = tl.gelu(tl.linear(x, bp["w_up"], bp["b_up"]))
    assert torch.equal(got, h2 + tl.linear(u, bp["w_down"], bp["b_down"]))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_linear_gelu_function_under_remat(monkeypatch, remat):
    """Through the kernels' Function (its plain versions on the CPU), remat
    "full" and "dots" give the loss and gradients of no remat bit for bit
    on ``tiny()`` in bf16, with the forward run twice a layer (forward and
    recompute) and the backward once."""
    from ray_tpu_torch.models import training as ttrain
    from ray_tpu_torch.models import transformer as ttf

    monkeypatch.setattr(bias_gelu, "_on_card", lambda t: True)
    calls = {"forward": 0, "backward": 0}
    for name in calls:
        real = getattr(bias_gelu, f"bias_gelu_{name}")

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(bias_gelu, f"bias_gelu_{name}", spy)
    runs = []
    for kw in (dict(remat=False),
               dict(remat=True, remat_policy=remat)):
        cfg = ttf.tiny(dtype=torch.bfloat16, **kw)
        params = ttrain._tree_map(lambda t: t.requires_grad_(True),
                                  ttf.init_params(cfg, 0, device="cpu"))
        tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                               generator=torch.Generator().manual_seed(0))
        for name in calls:
            calls[name] = 0
        loss = ttf.lm_loss(params, {"tokens": tokens}, cfg)
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in ttrain._leaves(params)],
                     dict(calls)))
    (loss0, grads0, calls0), (loss1, grads1, calls1) = runs
    n = cfg.n_layers
    assert calls0 == {"forward": n, "backward": n}
    assert calls1 == {"forward": 2 * n, "backward": n}
    assert torch.equal(loss0, loss1)
    for a, b in zip(grads0, grads1):
        assert torch.equal(a, b)

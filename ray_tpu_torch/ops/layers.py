"""Core neural-net ops on torch tensors.

Counterpart of ``ray_tpu/ops/layers.py``: computation runs in the input's
dtype with float32 where the JAX ops take it (layer-norm statistics, the
linear accumulate and bias add, the loss). :func:`matmul_f32` gives the JAX
``preferred_element_type=float32`` product: a bf16 tensor-core GEMM with
f32 output on the card, f32 operands everywhere else; on DTensors too,
for which :func:`_register_mm_dtype_sharding` gives DTensor the sharding
rules of that product (``aten.mm.dtype``), which it lacks.
:func:`linear_gelu` is ``gelu(linear(...))``; on plain bf16 CUDA tensors it
runs as that product and the hand-written kernels of ``ops/bias_gelu.py``.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.ops import bias_gelu


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm with f32 statistics regardless of input dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def rms_norm(x, gamma, eps: float = 1e-6):
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def gelu(x):
    # tanh approximation (GPT-2 uses this exact form)
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x * x * x)))


class _Bf16MatmulF32Out(torch.autograd.Function):
    """``a @ b`` for bf16 ``a`` [M, K] and ``b`` [K, N] on the card: one
    tensor-core product with f32 accumulation and f32 output, unrounded.
    The backward rounds the incoming f32 gradient to bf16 and returns bf16
    gradients (one rounding of an f32 accumulation each), as JAX's
    transpose of a ``preferred_element_type=float32`` dot does. Every caller
    casts this product to bf16 before anything else reads it, so the
    gradient arriving here is bf16-valued and that rounding is exact."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = g @ b.T if ctx.needs_input_grad[0] else None
        db = a.T @ g if ctx.needs_input_grad[1] else None
        return da, db


def _unsplit_middle(x):
    """A DTensor ``x`` split on a middle dim (the sequence) gathered on it,
    as megatron's sequence parallelism gathers before its projections:
    folding ``x``'s leading dims into one, as a matmul does, would turn
    that split into a strided shard, and DTensor (torch 2.13) then searches
    its redistribution plans for up to a minute an op."""
    if isinstance(x, DTensor) and any(
            isinstance(p, Shard) and 0 < p.dim < x.ndim - 1
            for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Shard) and 0 < p.dim < x.ndim - 1
            else p for p in x.placements])
    return x


def _keep_layout(y):
    """The identity on values; on a DTensor its backward brings the
    gradient to ``y``'s own placements, so a gradient split on the
    sequence is gathered before the matmul's unfold sees it."""
    if isinstance(y, DTensor):
        return y.redistribute(y.device_mesh, y.placements)
    return y


def matmul(x, w):
    """``x @ w`` for ``x`` [..., K] and ``w`` [K, N]; a DTensor ``x``
    through :func:`_unsplit_middle` and :func:`_keep_layout`."""
    return _keep_layout(torch.matmul(_unsplit_middle(x), w))


@functools.cache
def _register_mm_dtype_sharding():
    """Sharding rules of ``torch.mm(a, b, out_dtype=...)`` for DTensor,
    those of ``a @ b`` per mesh dim: replicated, rows of ``a`` split,
    columns of ``b`` split, or the contraction split into partial sums
    (registered once, at the first DTensor product)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.mm.dtype)
    def mm_dtype_sharding(a, b, out_dtype):
        return [([Replicate()], [Replicate(), Replicate(), None]),
                ([Shard(0)], [Shard(0), Replicate(), None]),
                ([Shard(1)], [Replicate(), Shard(1), None]),
                ([Partial()], [Shard(1), Shard(0), None])]


def matmul_f32(x, w):
    """``x @ w`` ([..., K] @ [K, N]) accumulated and returned in f32 — the
    JAX ``preferred_element_type=float32`` product. Two bf16 operands on the
    card run as one bf16 tensor-core GEMM with f32 output; everything else
    upcasts both operands to f32 (exact: a product of two bf16 values is
    exact in f32)."""
    if (x.is_cuda and x.dtype == torch.bfloat16
            and w.dtype == torch.bfloat16):
        if isinstance(x, DTensor):
            _register_mm_dtype_sharding()
            x = _unsplit_middle(x)
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _Bf16MatmulF32Out.apply(x2, w)
        else:   # no graph to record: skip the Function's host overhead
            y = torch.mm(x2, w, out_dtype=torch.float32)
        return _keep_layout(y.reshape(*x.shape[:-1], w.shape[-1]))
    return matmul(x.float(), w.float())


def linear(x, w, b=None):
    """``x @ w`` accumulated in f32, the bias added in f32, then cast back
    to ``x``'s dtype."""
    y = matmul_f32(x, w)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def linear_gelu(x, w, b):
    """``gelu(linear(x, w, b))``, the MLP's up-projection. Plain bf16 CUDA
    tensors with a width a multiple of 8 take one GEMM and one hand-written
    kernel a direction (``ops/bias_gelu.py``: GELU in f32, rounded once);
    everything else (CPU tensors, DTensors, f32 operands) runs this very
    expression."""
    if bias_gelu.takes(x, w, b):
        return bias_gelu.linear_gelu(x, w, b)
    return gelu(linear(x, w, b))


def softmax_cross_entropy(logits, labels, ignore_index: int = -100):
    """Token-level CE with f32 logits; ignores masked positions.

    Returns (mean_loss, n_valid_tokens)."""
    logits32 = logits.float()
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, safe_labels[..., None].long())[..., 0]
    nll = (logz - gold) * valid
    n = valid.sum().clamp(min=1)
    return nll.sum() / n, n


def rope(x, positions, *, base: float = 10000.0):
    """Rotary position embedding on the last dim, rotating the [even|odd]
    HALVES (not interleaved pairs). x: [..., L, H, D]; positions: [..., L]."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(base) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs          # [..., L, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)

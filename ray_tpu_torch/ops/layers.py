"""Core neural-net ops on torch tensors.

Counterpart of ``ray_tpu/ops/layers.py``: computation runs in the input's
dtype with float32 where the JAX ops take it (layer-norm statistics, the
linear accumulate and bias add, the loss). :func:`matmul_f32` gives the JAX
``preferred_element_type=float32`` product: a bf16 tensor-core GEMM with
f32 output on the card, f32 operands everywhere else.
"""

from __future__ import annotations

import math

import torch


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


def matmul_f32(x, w):
    """``x @ w`` ([..., K] @ [K, N]) accumulated and returned in f32 — the
    JAX ``preferred_element_type=float32`` product. Two bf16 operands on the
    card run as one bf16 tensor-core GEMM with f32 output; everything else
    upcasts both operands to f32 (exact: a product of two bf16 values is
    exact in f32)."""
    if (x.is_cuda and x.dtype == torch.bfloat16
            and w.dtype == torch.bfloat16):
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _Bf16MatmulF32Out.apply(x2, w)
        else:   # no graph to record: skip the Function's host overhead
            y = torch.mm(x2, w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def linear(x, w, b=None):
    """``x @ w`` accumulated in f32, the bias added in f32, then cast back
    to ``x``'s dtype."""
    y = matmul_f32(x, w)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


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

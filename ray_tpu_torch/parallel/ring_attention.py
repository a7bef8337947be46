"""Ring attention and Ulysses attention: sequence parallelism over the
``seq`` mesh axis.

Counterpart of ``ray_tpu/parallel/ring_attention.py``. Ring: the sequence
is split over the axis; K/V blocks rotate around its ring
(:func:`~ray_tpu_torch.parallel.spmd.ppermute`) while each rank
accumulates its queries' softmax online (log-sum-exp), so attention over L
tokens on P ranks, each holding L/P, is exact. Ulysses: an all-to-all swaps
the split from sequence to heads, each rank attends over the whole
sequence for its head group, and a second all-to-all swaps back.

As in JAX this is plain arithmetic (einsums in f32), not a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.parallel.spmd import (all_to_all, axis_index, axis_size,
                                         ppermute, spmd)

_NEG_INF = -1e30


def _block_attention(q, k, v, *, scale, mask):
    """One (q-block, kv-block) attention contribution in f32.

    q: [B, Lq, H, D]  k/v: [B, Lk, H, D]  mask: [Lq, Lk] additive or None.
    Returns (scores_max [B,H,Lq], exp_scores [B,H,Lq,Lk], pv [B,H,Lq,D]).
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores + mask[None, None, :, :]
    block_max = scores.amax(dim=-1)
    exp_scores = torch.exp(scores - block_max[..., None])
    pv = torch.einsum("bhqk,bkhd->bhqd", exp_scores, v.float())
    return block_max, exp_scores, pv


def _ring_attention_local(q, k, v, *, mesh, axis_name: str, causal: bool,
                          scale: Optional[float]):
    """Per-rank body: q [B, Lq, H, D], k/v [B, Lk, H, D], this rank's
    blocks of a sequence split along ``axis_name``."""
    orig_dtype = q.dtype
    b, lq, h, d = q.shape
    lk = k.shape[1]
    axis_size_ = axis_size(mesh, axis_name)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    my_idx = axis_index(mesh, axis_name)

    q32 = q.float()
    m = torch.full((b, h, lq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    q_pos = my_idx * lq + torch.arange(lq, device=q.device)
    k_cur, v_cur = k, v
    for i in range(axis_size_):
        src_idx = (my_idx - i) % axis_size_   # the rank this kv came from
        mask = None
        if causal:
            k_pos = src_idx * lk + torch.arange(lk, device=q.device)
            mask = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                               _NEG_INF).float()
        block_max, exp_scores, pv = _block_attention(
            q32, k_cur, v_cur, scale=scale, mask=mask)
        new_m = torch.maximum(m, block_max)
        # A fully masked block has block_max = NEG_INF: its contribution is
        # an exact 0, with no NaN from (-inf) - (-inf).
        corr = torch.exp(m - new_m)
        block_corr = torch.exp(block_max - new_m)
        l = l * corr + exp_scores.sum(dim=-1) * block_corr
        o = o * corr[..., None] + pv * block_corr[..., None]
        m = new_m
        if i + 1 < axis_size_:     # JAX's last rotation feeds nothing
            k_cur = ppermute(k_cur, mesh, axis_name)
            v_cur = ppermute(v_cur, mesh, axis_name)
    # Rows with zero mass (fully masked everywhere) give 0, not NaN.
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return torch.einsum("bhqd->bqhd", out).to(orig_dtype)


def make_ring_attention(mesh, *, causal: bool = True,
                        scale: Optional[float] = None, seq_axis: str = "seq",
                        batch_axes=("data", "fsdp"),
                        head_axis: str = "tensor"):
    """Ring attention over ``mesh``: ``attn(q, k, v)`` on [batch, seq,
    heads, head_dim] tensors (DTensors, or plain tensors holding the full
    value on every rank), batch split on ``batch_axes``, seq on
    ``seq_axis`` and heads on ``head_axis``. Returns a DTensor laid out
    the same way."""
    spec = (batch_axes, seq_axis, head_axis, None)

    def body(q, k, v):
        return _ring_attention_local(q, k, v, mesh=mesh, axis_name=seq_axis,
                                     causal=causal, scale=scale)

    return spmd(body, mesh, (spec, spec, spec), spec)


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """Plain full attention on one device: the numerical oracle."""
    b, l, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def make_ulysses_attention(mesh, *, causal: bool = True,
                           scale: Optional[float] = None,
                           seq_axis: str = "seq",
                           batch_axes=("data", "fsdp")):
    """Ulysses sequence parallelism: an all-to-all swaps the split dim from
    sequence to heads, each rank attends over the whole sequence for its
    head group, and a second all-to-all swaps back. Needs heads divisible
    by the axis size."""
    spec = (batch_axes, seq_axis, None, None)

    def body(q, k, v):
        # local [B, L/P, H, D] -> [B, L, H/P, D] and back
        def seq_to_heads(x):
            return all_to_all(x, mesh, seq_axis, split_dim=2, concat_dim=1)

        def heads_to_seq(x):
            return all_to_all(x, mesh, seq_axis, split_dim=1, concat_dim=2)

        out = reference_attention(seq_to_heads(q), seq_to_heads(k),
                                  seq_to_heads(v), causal=causal, scale=scale)
        return heads_to_seq(out)

    return spmd(body, mesh, (spec, spec, spec), spec)

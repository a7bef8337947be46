"""Mixture-of-Experts FFN (Switch, top-1): expert parallelism over the
``expert`` mesh axis.

Counterpart of ``ray_tpu/ops/moe.py``, einsum for einsum. Static shapes
throughout, as in JAX: each expert has a fixed capacity and tokens past it
are dropped (Switch's capacity factor). Tokens [B, S, D] -> top-1 router ->
dispatch [E, C, D] (E experts, C slots) -> each expert's FFN -> combined
back to [B, S, D], weighted by the router probability. Under a mesh the
parameters are DTensors whose expert dim is split over ``expert`` (by
:func:`logical_axes` and the rules) and DTensor inserts the collectives
the einsums need, as XLA does for JAX.

:func:`moe_topk` is the dropless top-k layer of sigmoid-routed models
(LFM2-MoE, DeepSeek-V3): the router scores every expert, a selection-only
bias picks each token's ``top_k``, and the layer computes the share that
the experts it holds (``held``, a range of expert ids: one card's part of
an expert-parallel layer) give, with no token dropped however uneven the
load. It reads nothing from the device on the host: the assignments held
are sorted by expert into a buffer sized for the worst case, and the
grouped products take the groups' offsets as a device tensor. ``topk_calls``
counts its calls (under ``_count_lock``; several threads run layers at
once).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ray_tpu_torch.ops.layers import gelu, matmul_f32
from ray_tpu_torch.parallel.mesh import replicated
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils.device import resolve_device

# moe_topk calls since import (or since a caller reset it to 0).
topk_calls = 0
_count_lock = threading.Lock()

# Rows of each expert's group in the sorted buffer are padded to a multiple
# of this, so every group starts on a 16-byte boundary in bf16 whichever
# dim the grouped products split (the backward's weight gradient groups
# along the rows).
GROUP_ALIGN = 16


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32

    def capacity(self, tokens_per_batch: int) -> int:
        c = int(self.capacity_factor * tokens_per_batch / self.num_experts)
        return max(4, ((c + 3) // 4) * 4)  # pad to a friendly multiple


def init_params(cfg: MoEConfig, generator: Union[torch.Generator, int],
                device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Router normal(0.02), experts He-normal, drawn on the CPU from
    ``generator`` (or an int seed) and then moved (the draws differ from
    ``jax.random``'s; ``models.convert.params_from_numpy`` carries JAX's
    across)."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff

    def nrm(shape, s):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (x * s).to(device=dev, dtype=cfg.dtype)

    return {"router": nrm((D, E), 0.02),
            "w_up": nrm((E, D, F), (2.0 / D) ** 0.5),
            "w_down": nrm((E, F, D), (2.0 / F) ** 0.5)}


def logical_axes(cfg: MoEConfig) -> Dict:
    return {
        "router": (None, None),
        "w_up": ("experts", "embed", "mlp"),
        "w_down": ("experts", "mlp", "embed"),
    }


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: rows of ``idx == arange(n)``; the arange is a
    replicated DTensor when ``idx`` is a DTensor."""
    ar = torch.arange(n, device=idx.device)
    if isinstance(idx, DTensor):
        ar = DTensor.from_local(ar, idx.device_mesh,
                                replicated(idx.device_mesh), run_check=False)
    return (idx[..., None] == ar).to(dtype)


def moe_ffn(params: Dict, x: torch.Tensor,
            cfg: MoEConfig) -> Tuple[torch.Tensor, Dict]:
    """Top-1 (Switch) MoE FFN. x: [B, S, D] -> ([B, S, D], aux metrics:
    ``aux_loss``, the Switch load-balancing loss, and
    ``dropped_fraction``)."""
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    C = cfg.capacity(T)
    flat = x.reshape(T, D)

    logits = torch.einsum("td,de->te", flat.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)                  # [T, E]
    expert_idx = torch.argmax(probs, dim=-1)               # [T]
    gate = probs.amax(dim=-1)                              # [T]

    # position of each token within its expert's queue
    onehot = _one_hot(expert_idx, E, torch.int32)          # [T, E]
    pos_in_expert = (torch.cumsum(onehot, dim=0) - 1) * onehot
    pos = pos_in_expert.sum(dim=-1)                        # [T]
    keep = pos < C                                         # overflow drops

    # dispatch [T, E, C]: one-hot of (expert, slot); overflow tokens map to
    # slot C, which is sliced away
    slot_onehot = _one_hot(torch.where(keep, pos, torch.full_like(pos, C)),
                           C + 1, torch.float32)[:, :C]    # [T, C]
    dispatch = onehot.float()[:, :, None] * slot_onehot[:, None, :]
    # The einsums below run as batched products over the expert dim E:
    # torch.einsum would fold E into another dim, which on DTensors split
    # over ``expert`` makes a strided shard that DTensor's planner (torch
    # 2.13) takes half a minute an op to route.
    # "tec,td->ecd"
    expert_in = torch.bmm(dispatch.permute(1, 2, 0),
                          flat.float().expand(E, T, D))        # [E, C, D]
    # "ecd,edf->ecf", "ecf,efd->ecd"
    h = gelu(torch.bmm(expert_in, params["w_up"].float()))
    out = torch.bmm(h, params["w_down"].float())              # [E, C, D]

    combine = dispatch * (gate * keep)[:, None, None]      # [T, E, C]
    # "tec,ecd->td"
    y = torch.bmm(combine.permute(1, 0, 2), out).sum(dim=0).to(x.dtype)

    # load-balancing auxiliary loss (Switch: E * sum_e f_e * P_e)
    frac_tokens = onehot.float().mean(dim=0)               # [E]
    frac_probs = probs.mean(dim=0)                         # [E]
    aux_loss = E * (frac_tokens * frac_probs).sum()
    metrics = {"aux_loss": aux_loss,
               "dropped_fraction": 1.0 - keep.float().mean()}
    return y.reshape(B, S, D), metrics


# ---------------------------------------------------------------------------
# Dropless top-k with sigmoid scores (LFM2-MoE, DeepSeek-V3)
# ---------------------------------------------------------------------------

def _swiglu(h):
    """``silu(gate) * up`` for ``h`` = [gate | up] on its last dim."""
    gate, up = h.chunk(2, dim=-1)
    return F.silu(gate) * up


def route_topk(x, router, bias, top_k: int, *, scaling: float = 1.0,
               norm: bool = True):
    """``(idx, weights)``, both [T, top_k]: the experts each token of ``x``
    [T, D] picks and their weights. The scores ``sigmoid(x @ router)`` of
    every expert are taken in f32; ``bias`` [E] counts for the choice only
    (the top ``top_k`` of ``scores + bias``, no gradient through it); the
    weights are the picked scores, normalised to sum 1 (``norm``, plus
    1e-6) and times ``scaling``, in f32."""
    scores = torch.sigmoid(x.float() @ router.float())
    idx = torch.topk(scores.detach() + bias, top_k, dim=-1).indices
    w = scores.gather(1, idx)
    if norm:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)
    return idx, w * scaling


def _held_layout(idx, held: range):
    """Where the assignments to the experts in ``held`` go in the grouped
    products' buffer, from device tensors alone: ``(rows, assign, ends)``.

    The assignments held are sorted by expert (stable: token order within
    an expert), each expert's group padded to ``GROUP_ALIGN`` rows. The
    buffer has ``R = T * min(k, len(held)) + len(held) * (GROUP_ALIGN - 1)``
    rows, room for every assignment held even when every token picks only
    held experts, so none is dropped. ``rows`` [T, k] is each assignment's
    buffer row (``R`` for one not held), ``assign`` [R] each buffer row's
    assignment ``t * k + j`` (``T * k`` for padding and the unused tail),
    ``ends`` [n] the groups' end rows in int32 (the grouped products'
    offsets)."""
    T, k = idx.shape
    n, dev = len(held), idx.device
    A = GROUP_ALIGN
    R = T * min(k, n) + n * (A - 1)
    local = idx.reshape(-1) - held.start
    key = torch.where((local >= 0) & (local < n), local,
                      torch.full_like(local, n))
    counts = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, key, torch.ones_like(key))
    sorted_key, order = torch.sort(key, stable=True)
    start = torch.cumsum(counts, 0) - counts
    ends = torch.cumsum((counts[:n] + A - 1) // A * A, 0)
    pstart = torch.cat([ends.new_zeros(1), ends])
    rank = torch.arange(T * k, device=dev) - start[sorted_key]
    slot = torch.where(sorted_key < n, pstart[sorted_key] + rank,
                       torch.full_like(rank, R))
    rows = torch.empty_like(slot).scatter_(0, order, slot)
    assign = torch.full((R + 1,), T * k, dtype=torch.int64,
                        device=dev).scatter_(
        0, rows, torch.arange(T * k, device=dev))[:R]
    return rows.view(T, k), assign, ends.to(torch.int32)


class _GatherRows(torch.autograd.Function):
    """``cat([x, zero row])[idx]`` whose backward is a gather as well:
    ``back`` [len(x), m] lists, for each row of ``x``, the rows of the
    output that read it (``len(idx)``, a zero row, for none), and a row's
    gradient is the sum of theirs. The rows of the sorted buffer and the
    assignments are each other's inverse maps, so neither direction needs
    an atomic add or the sort that advanced indexing's backward makes."""

    @staticmethod
    def forward(ctx, x, idx, back):
        ctx.save_for_backward(back)
        return torch.cat([x, x.new_zeros(1, x.shape[-1])]).index_select(
            0, idx)

    @staticmethod
    def backward(ctx, g):
        back, = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros(1, g.shape[-1])])
        gx = g.index_select(0, back.reshape(-1)).view(*back.shape, -1)
        return gx.sum(dim=1), None, None


def _looped_experts(x, w13, w2, idx, w, held: range):
    """The same sum by a loop over the held experts, each product one f32
    accumulation rounded to ``x``'s dtype as the grouped products round
    it. It reads each expert's tokens on the host: the plain route."""
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    with tracing.step_span("moe.experts"):
        for g, e in enumerate(held):
            t, j = (idx == e).nonzero(as_tuple=True)
            h = matmul_f32(x[t], w13[g]).to(x.dtype)
            yg = matmul_f32(_swiglu(h), w2[g]).to(x.dtype)
            y = y.index_add(0, t, yg.float() * w[t, j, None])
    return y


def moe_topk(params: Dict, x: torch.Tensor, bias: torch.Tensor, *,
             top_k: int, held: range, scaling: float = 1.0,
             norm: bool = True, load_out: Optional[torch.Tensor] = None,
             route_out: Optional[torch.Tensor] = None,
             route: str = "auto") -> torch.Tensor:
    """Dropless top-k MoE FFN: what the experts in ``held`` give.

    ``x`` [..., D]; ``params``: ``router`` [D, E] over all E experts (f32
    for f32 logits: a router rounded to ``x``'s dtype rounds them),
    ``w13`` [n, D, 2F] (gate then up) and ``w2`` [n, F, D] for the
    ``n = len(held)`` experts held, in ``x``'s dtype; ``bias`` [E] f32,
    the selection-only expert bias. Each token picks ``top_k`` of all E
    (:func:`route_topk`); an assignment to an expert held adds
    ``weight * w2(silu(w1 x) * w3 x)``, one to an expert not held adds
    nothing (that is another card's share). Returns [..., D] in ``x``'s
    dtype, the sum taken in f32.

    ``load_out`` [E] int64, where given, receives every expert's count of
    assignments by copy (a recomputation under remat writes the same
    counts again); ``route_out`` [T, top_k] int64 the picks, likewise.
    ``route``: ``grouped`` (``torch._grouped_mm`` over the
    sorted buffer, no host sync: bf16 only), ``loop`` (one product pair an
    expert) or ``auto`` (grouped for bf16 on the card, loop elsewhere).

    Opens the spans ``moe.route`` (the router through the sort and the
    gather), ``moe.experts`` (the grouped products and the SwiGLU) and
    ``moe.combine`` (the weighted sum) inside a trace someone asked for
    (``tracing.step_span``). The recomputation under remat opens them
    again where it runs in the trace's context (``models/lfm2.py`` carries
    the forward's into it), so they time the forward and the recompute."""
    global topk_calls
    with _count_lock:
        topk_calls += 1
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    T, D = x.shape
    if route == "auto":
        route = ("grouped" if x.is_cuda and x.dtype == torch.bfloat16
                 else "loop")
    with tracing.step_span("moe.route"):
        idx, w = route_topk(x, params["router"], bias, top_k,
                            scaling=scaling, norm=norm)
        if load_out is not None:
            flat = idx.reshape(-1)
            load_out.copy_(torch.zeros_like(load_out).index_add_(
                0, flat, torch.ones_like(flat)))
        if route_out is not None:
            route_out.copy_(idx)
        if route == "grouped":
            rows, assign, ends = _held_layout(idx, held)
            xb = _GatherRows.apply(x, assign // top_k, rows)
    if route == "loop":
        y = _looped_experts(x, params["w13"], params["w2"], idx, w, held)
        return y.to(x.dtype).reshape(shape)
    if route != "grouped":
        raise ValueError(f"unknown moe route {route!r}")
    # Rows past the last group are never read: the grouped products leave
    # them unwritten.
    with tracing.step_span("moe.experts"):
        h = torch._grouped_mm(xb, params["w13"], offs=ends)
        yb = torch._grouped_mm(_swiglu(h), params["w2"], offs=ends)
    with tracing.step_span("moe.combine"):
        yg = _GatherRows.apply(yb, rows.reshape(-1), assign[:, None])
        y = (yg.view(T, top_k, D).float() * w[..., None]).sum(dim=1)
    return y.to(x.dtype).reshape(shape)

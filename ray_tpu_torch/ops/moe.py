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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.ops.layers import gelu
from ray_tpu_torch.parallel.mesh import replicated
from ray_tpu_torch.utils.device import resolve_device


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

"""Small MLP classifier: the MNIST end-to-end gate model.

Counterpart of ``ray_tpu/models/mlp.py``: ``[{"w", "b"}, ...]`` layers,
products accumulated in f32 and the bias added in f32 before the cast back
(JAX's ``preferred_element_type=float32``), ReLU between layers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from ray_tpu_torch.ops.layers import linear
from ray_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Tuple[int, ...] = (128, 128)
    n_classes: int = 10
    dtype: torch.dtype = torch.float32


def init_params(config: MLPConfig, generator: Union[torch.Generator, int],
                device: Optional[Union[str, torch.device]] = None) -> Dict:
    """He-normal weights, zero biases, drawn on the CPU from ``generator``
    (or an int seed) and then moved."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    dims = (config.in_dim,) + tuple(config.hidden) + (config.n_classes,)
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator) * (2.0 / a) ** 0.5
        layers.append({"w": w.to(device=dev, dtype=config.dtype),
                       "b": torch.zeros((b,), dtype=config.dtype,
                                        device=dev)})
    return {"layers": layers}


def logical_axes(config: MLPConfig) -> Dict:
    n = len(config.hidden) + 1
    return {"layers": [{"w": (None, "mlp"), "b": ("mlp",)} if i < n - 1
                       else {"w": ("mlp", None), "b": (None,)}
                       for i in range(n)]}


def forward(params: Dict, x: torch.Tensor, config: MLPConfig) -> torch.Tensor:
    h = x.to(config.dtype)
    layers = params["layers"]
    for i, layer in enumerate(layers):
        h = linear(h, layer["w"].to(config.dtype), layer["b"])
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def classifier_loss(params: Dict, batch: Dict, config: MLPConfig):
    logits = forward(params, batch["x"], config).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return (logz - gold).mean()

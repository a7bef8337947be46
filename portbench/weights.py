"""Random GPT-2 weights made on the device from the seed.

The benchmark makes the weights, not the port: the same seed gives the same
tree on the same device, one ``torch.randn`` a leaf (the 16 block leaves
are stacked over the layers, so a whole model is 20 draws), in the dtype it
is served or trained in. The tree has the layout the port's models take:
blocks stacked on a leading layer dim, ``wq/wk/wv`` [L, D, H, Dh], ``wo``
[L, H, Dh, D], the vocabulary padded to ``padded_vocab`` rows and the output
head tied to ``tok_embed``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_MASK63 = (1 << 63) - 1


def mix(seed: int, *salt: int) -> int:
    """A 63-bit generator seed from a run's ``--seed`` (any size) and the
    integers in ``salt``, so different streams of one run never overlap."""
    m64 = (1 << 64) - 1
    x = seed & m64
    for s in salt:
        x = (x * 6364136223846793005 + 1442695040888963407 + s) & m64
        x ^= x >> 29
    return x & _MASK63


def make(cfg: Dict, seed: int, device, dtype: torch.dtype) -> Dict:
    """The weight tree of ``cfg`` drawn from ``seed`` on ``device``, stored
    in ``dtype``: normal(0, 0.02), residual projections normal(0, 0.02 /
    sqrt(2 n_layer)), positions normal(0, 0.01), biases 0 and norm gains 1
    (the configuration file's ``assumed.init``)."""
    g = torch.Generator(device=device).manual_seed(mix(seed, 1))
    L, D, H = cfg["n_layer"], cfg["n_embd"], cfg["n_head"]
    Dh, F, V = D // H, cfg["n_inner"], cfg["padded_vocab"]
    std = cfg["initializer_range"]
    res = std / math.sqrt(2 * L)

    def nrm(shape, s):
        x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return x.mul_(s).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    blocks = {
        "ln1_g": const((L, D), 1.0), "ln1_b": const((L, D), 0.0),
        "wq": nrm((L, D, H, Dh), std), "wk": nrm((L, D, H, Dh), std),
        "wv": nrm((L, D, H, Dh), std), "wo": nrm((L, H, Dh, D), res),
        "bq": const((L, H, Dh), 0.0), "bk": const((L, H, Dh), 0.0),
        "bv": const((L, H, Dh), 0.0), "bo": const((L, D), 0.0),
        "ln2_g": const((L, D), 1.0), "ln2_b": const((L, D), 0.0),
        "w_up": nrm((L, D, F), std), "b_up": const((L, F), 0.0),
        "w_down": nrm((L, F, D), res), "b_down": const((L, D), 0.0),
    }
    return {"tok_embed": nrm((V, D), std), "blocks": blocks,
            "lnf_g": const((D,), 1.0), "lnf_b": const((D,), 0.0),
            "pos_embed": nrm((cfg["n_positions"], D), 0.01)}

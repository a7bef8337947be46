"""Random LFM2-MoE weights made on the device from the seed.

The benchmark makes the weights, not the port: the same seed gives the same
tree on the same device, one ``torch.randn`` a leaf, in the dtype it is
trained in. The tree has the layout ``ray_tpu_torch/models/lfm2.py`` takes:
one stack per kind of sublayer on a leading layer dim (``conv``, ``attn``,
``dense``, ``moe``; each with its pre-norm), the experts held as
``w13`` [moe layers, held, D, 2 F] (gate then up) and ``w2`` [moe layers,
held, F, D], the router [moe layers, D, routed experts], the head tied to
``tok_embed``. Init as the configuration's ``assumed.init`` says.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.weights import mix


def make(cfg: Dict, seed: int, device, dtype: torch.dtype) -> Dict:
    """The weight tree of ``cfg`` drawn from ``seed`` on ``device``, stored
    in ``dtype``: matrices normal(0, initializer_range), conv taps
    normal(0, 1/sqrt(conv_L_cache)), norm gains 1."""
    g = torch.Generator(device=device).manual_seed(mix(seed, 1))
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh, K = D // H, cfg["conv_L_cache"]
    types = cfg["layer_types"]
    Lc = sum(t == "conv" for t in types)
    La = len(types) - Lc
    Ld = cfg["num_dense_layers"]
    Lm = cfg["num_hidden_layers"] - Ld
    lo, hi = cfg["experts_held"]
    n, Fe, Fd = hi - lo, cfg["moe_intermediate_size"], \
        cfg["intermediate_size"]
    E = cfg.get("published", {}).get("num_experts", cfg["num_experts"])
    std = cfg["initializer_range"]

    def nrm(shape, s=std):
        x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return x.mul_(s).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "tok_embed": nrm((V, D)),
        "conv": {"norm": ones((Lc, D)), "in_proj": nrm((Lc, D, 3 * D)),
                 "conv": nrm((Lc, D, K), K ** -0.5),
                 "out_proj": nrm((Lc, D, D))},
        "attn": {"norm": ones((La, D)), "wq": nrm((La, D, H * Dh)),
                 "wk": nrm((La, D, KV * Dh)), "wv": nrm((La, D, KV * Dh)),
                 "q_norm": ones((La, Dh)), "k_norm": ones((La, Dh)),
                 "wo": nrm((La, H * Dh, D))},
        "dense": {"norm": ones((Ld, D)), "w1": nrm((Ld, D, Fd)),
                  "w3": nrm((Ld, D, Fd)), "w2": nrm((Ld, Fd, D))},
        "moe": {"norm": ones((Lm, D)), "router": nrm((Lm, D, E)),
                "w13": nrm((Lm, n, D, 2 * Fe)), "w2": nrm((Lm, n, Fe, D))},
        "final_norm": ones((D,)),
    }

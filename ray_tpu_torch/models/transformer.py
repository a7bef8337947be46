"""Decoder-only transformer LM (GPT-2 family): configs and parameters.

Counterpart of ``ray_tpu/models/transformer.py`` (configs and
``init_params``). Parameters are a plain dict of tensors in the JAX
package's layout, so the two packages can compute with the same weights:
blocks are STACKED on a leading ``layers`` dim, ``wq/wk/wv`` are
[L, D, H, Dh], ``wo`` is [L, H, Dh, D], the vocab is padded to
``vocab_multiple`` and the output projection is tied to ``tok_embed``.

The training forward and loss are not in this slice.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Union

import torch

from ray_tpu_torch.utils.device import resolve_device


def pad_vocab(n: int, multiple: int = 128) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # storage dtype
    pos: str = "learned"                       # "learned" (gpt2) | "rope"
    tie_embeddings: bool = True
    vocab_multiple: int = 128

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size, self.vocab_multiple)

    def replace(self, **kw) -> "TransformerConfig":
        return replace(self, **kw)


def gpt2_small(**kw) -> TransformerConfig:
    """GPT-2 124M."""
    return TransformerConfig(**kw)


def gpt2_medium(**kw) -> TransformerConfig:
    return TransformerConfig(d_model=1024, n_layers=24, n_heads=16,
                             d_ff=4096, **kw)


def gpt2_large(**kw) -> TransformerConfig:
    return TransformerConfig(d_model=1280, n_layers=36, n_heads=20,
                             d_ff=5120, **kw)


def gpt2_xl(**kw) -> TransformerConfig:
    return TransformerConfig(d_model=1600, n_layers=48, n_heads=25,
                             d_ff=6400, **kw)


def tiny(**kw) -> TransformerConfig:
    """Test-sized config (runs in ms on CPU)."""
    defaults = dict(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_seq_len=64, dtype=torch.float32, vocab_multiple=8,
    )
    defaults.update(kw)
    return TransformerConfig(**defaults)


def init_params(config: TransformerConfig,
                generator: Union[torch.Generator, int],
                device: Optional[Union[str, torch.device]] = None) -> Dict:
    """GPT-2 init: normal(0.02), residual projections scaled by 1/sqrt(2N).

    ``generator`` is a CPU ``torch.Generator`` (or an int seed for one): the
    weights are drawn on the CPU and then moved, so one seed gives the same
    weights on every device. The draws differ from ``jax.random``'s; use
    ``models.convert.params_from_numpy`` to compute with the JAX package's
    weights."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    c = config
    dt = c.param_dtype
    std = 0.02
    res_std = std / (2 * c.n_layers) ** 0.5

    def nrm(shape, s=std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (x * s).to(device=dev, dtype=dt)

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    L, D, H, Dh, F, V = (c.n_layers, c.d_model, c.n_heads, c.head_dim,
                         c.d_ff, c.padded_vocab)
    blocks = {
        "ln1_g": full((L, D), 1.0), "ln1_b": full((L, D), 0.0),
        "wq": nrm((L, D, H, Dh)), "wk": nrm((L, D, H, Dh)),
        "wv": nrm((L, D, H, Dh)),
        "wo": nrm((L, H, Dh, D), res_std),
        "bq": full((L, H, Dh), 0.0), "bk": full((L, H, Dh), 0.0),
        "bv": full((L, H, Dh), 0.0), "bo": full((L, D), 0.0),
        "ln2_g": full((L, D), 1.0), "ln2_b": full((L, D), 0.0),
        "w_up": nrm((L, D, F)), "b_up": full((L, F), 0.0),
        "w_down": nrm((L, F, D), res_std), "b_down": full((L, D), 0.0),
    }
    params = {
        "tok_embed": nrm((V, D)),
        "blocks": blocks,
        "lnf_g": full((D,), 1.0), "lnf_b": full((D,), 0.0),
    }
    if c.pos == "learned":
        params["pos_embed"] = nrm((c.max_seq_len, D), 0.01)
    if not c.tie_embeddings:
        params["lm_head"] = nrm((D, V))
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(int(p.numel()) for p in _leaves(params))

"""Decoder-only transformer LM (GPT-2 family): configs, parameters and the
training forward.

Counterpart of ``ray_tpu/models/transformer.py``. Parameters are a plain
dict of tensors in the JAX package's layout, so the two packages can compute
with the same weights: blocks are STACKED on a leading ``layers`` dim,
``wq/wk/wv`` are [L, D, H, Dh], ``wo`` is [L, H, Dh, D], the vocab is padded
to ``vocab_multiple`` and the output projection is tied to ``tok_embed``.

:func:`forward` is a Python loop over the stacked blocks (JAX's
``lax.scan``): ``params["blocks"][name][i]`` is a view, so gradients land in
the stacked leaf. ``remat=True`` wraps each block in
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``, policy "full").
Attention is picked by :func:`_make_attention` as in JAX: flash attention
(``ops/flash_attention``, the CUDA kernels on the card) from
``max_seq_len >= 1024``, dense below. The block body (:func:`_heads`,
:func:`_block_tail`, :func:`_logits`) is shared with the serving forwards of
``models/generate.py``.

Not ported yet (ROADMAP Queue 1 item 8): the mesh and sharding rules,
``logical_axes``, ring and Ulysses attention, ``make_tp_block_fn``,
``pp_lm_loss``; and ``remat_policy="dots"``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.layers import (gelu, layer_norm, linear, matmul_f32,
                                      rope, softmax_cross_entropy)
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
    attn_impl: str = "auto"                    # auto|dense|flash|ring|ulysses
    remat: bool = False                        # checkpoint each block
    remat_policy: str = "full"                 # "full" ("dots": not ported)
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


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _heads(x, w, b, dtype):
    """``einsum("btd,dhk->bthk", x, w)`` rounded to ``dtype``, then the bias
    added in ``dtype`` — the JAX q/k/v order (the bias is NOT added in f32,
    unlike :func:`linear`)."""
    B, T, D = x.shape
    _, H, Dh = w.shape
    y = torch.matmul(x, w.reshape(D, H * Dh)).to(dtype)
    return y.reshape(B, T, H, Dh) + b


def _out_proj(o, w, b, dtype):
    """``einsum("bthk,hkd->btd", o, w)`` rounded to ``dtype`` plus the bias
    in ``dtype``."""
    B, T, H, Dh = o.shape
    return torch.matmul(o.reshape(B, T, H * Dh),
                        w.reshape(H * Dh, -1)).to(dtype) + b


def _block_tail(h, bp, o, dtype):
    """Attention output projection, residual and MLP of one block."""
    h = h + _out_proj(o, bp["wo"], bp["bo"], dtype)
    x = layer_norm(h, bp["ln2_g"], bp["ln2_b"])
    u = gelu(linear(x, bp["w_up"], bp["b_up"]))
    return h + linear(u, bp["w_down"], bp["b_down"])


def _logits(params, h, c: TransformerConfig):
    """Final layer norm and the output projection, logits in f32."""
    cast = lambda p: p.to(c.dtype)
    h = layer_norm(h, cast(params["lnf_g"]), cast(params["lnf_b"]))
    w_out = (params["tok_embed"].T if c.tie_embeddings
             else params["lm_head"])
    return matmul_f32(h, cast(w_out))


def _dense_attention(q, k, v, *, scale: float):
    """Causal full attention in f32. q/k/v: [B, L, H, Dh]."""
    l = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _make_attention(config: TransformerConfig):
    scale = 1.0 / config.head_dim ** 0.5
    impl = config.attn_impl
    # Largest power-of-two block <= 512 that divides the sequence, so flash
    # never silently takes the dense route for lengths like 1280.
    block = next((b for b in (512, 256, 128)
                  if config.max_seq_len % b == 0), None)
    if impl == "auto":
        impl = ("flash" if config.max_seq_len >= 1024 and block is not None
                else "dense")
    if impl == "flash":
        blk = block or 128
        return functools.partial(flash_attention, causal=True, scale=scale,
                                 block_q=blk, block_k=blk)
    if impl == "dense":
        return functools.partial(_dense_attention, scale=scale)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl {impl!r} needs a device mesh, not yet ported "
            f"(ROADMAP Queue 1 item 8)")
    raise ValueError(f"unknown attn_impl {config.attn_impl!r}")


def make_block_fn(config: TransformerConfig):
    """One transformer block as ``block(h, bp) -> h``, ``bp`` one layer's
    parameters (cast to the compute dtype inside, as in JAX)."""
    c = config
    attention = _make_attention(c)

    def block(h, bp):
        bp = {k: v.to(c.dtype) for k, v in bp.items()}
        x = layer_norm(h, bp["ln1_g"], bp["ln1_b"])
        q = _heads(x, bp["wq"], bp["bq"], c.dtype)
        k = _heads(x, bp["wk"], bp["bk"], c.dtype)
        v = _heads(x, bp["wv"], bp["bv"], c.dtype)
        if c.pos == "rope":
            positions = torch.arange(h.shape[1], device=h.device)
            q = rope(q, positions)
            k = rope(k, positions)
        return _block_tail(h, bp, attention(q, k, v), c.dtype)

    return block


def forward(params: Dict, tokens: torch.Tensor,
            config: TransformerConfig) -> torch.Tensor:
    """tokens [B, L] -> logits [B, L, padded_vocab] in the compute dtype."""
    c = config
    if c.remat and c.remat_policy == "dots":
        raise NotImplementedError("remat_policy 'dots' is not yet ported "
                                  "(ROADMAP Queue 1 item 2)")
    cast = lambda p: p.to(c.dtype)
    L = tokens.shape[1]
    h = cast(params["tok_embed"])[tokens]
    if c.pos == "learned":
        h = h + cast(params["pos_embed"])[:L]
    block = make_block_fn(c)
    blocks = params["blocks"]
    for layer in range(c.n_layers):
        bp = {k: v[layer] for k, v in blocks.items()}
        if c.remat:
            h = checkpoint(block, h, bp, use_reentrant=False)
        else:
            h = block(h, bp)
    return _logits(params, h, c).to(c.dtype)


def lm_loss(params: Dict, batch: Dict[str, torch.Tensor],
            config: TransformerConfig) -> torch.Tensor:
    """Next-token LM loss. batch: {"tokens": [B, L]} (optionally
    "loss_mask")."""
    tokens = batch["tokens"]
    logits = forward(params, tokens, config)
    mask = batch.get("loss_mask")
    keep = (mask[:, 1:] > 0 if mask is not None
            else torch.ones_like(tokens[:, 1:], dtype=torch.bool))
    labels = torch.where(keep, tokens[:, 1:], torch.full_like(
        tokens[:, 1:], -100))
    loss, _ = softmax_cross_entropy(logits[:, :-1], labels)
    return loss

"""Decoder-only transformer LM (GPT-2 family): configs, parameters and the
training forward.

Counterpart of ``ray_tpu/models/transformer.py``. Parameters are a plain
dict of tensors in the JAX package's layout, so the two packages can compute
with the same weights: blocks are STACKED on a leading ``layers`` dim,
``wq/wk/wv`` are [L, D, H, Dh], ``wo`` is [L, H, Dh, D], the vocab is padded
to ``vocab_multiple`` and the output projection is tied to ``tok_embed``.

:func:`forward` is a Python loop over the stacked blocks (JAX's
``lax.scan``). It unbinds each stacked leaf once, before the loop, so
layer ``i`` gets views of the stacks and the backward writes each stacked
gradient with one ``stack`` of the layers' gradients (indexing,
``v[layer]``, would zero-fill a whole stacked gradient a layer and add
``n_layers`` of them up). ``unbound_forwards`` counts the forwards.
``remat=True`` wraps each block in
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``): policy "full"
recomputes the whole block, policy "dots" saves the outputs of the
projection GEMMs (``aten.mm``/``addmm``: JAX's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, attention
included. Attention is picked by :func:`_make_attention` as in JAX: flash
attention (``ops/flash_attention``, the CUDA kernels on the card) from
``max_seq_len >= 1024``, dense below. The block body (:func:`_heads`,
:func:`_block_tail`, :func:`_logits`) is shared with the serving forwards
of ``models/generate.py``.

With ``mesh`` and ``rules`` (``parallel/``), parameters are DTensors placed
by :func:`logical_axes` under the rules (:func:`shard_params`) and every
op runs on DTensors; activations are constrained (redistributed) at JAX's
points. Attention runs per rank on local blocks: dense and flash with
batch on the batch axes, heads on ``tensor`` and the whole sequence (the
flash kernels see plain local tensors), ring and Ulysses over ``seq``.
:func:`pp_lm_loss` runs the blocks as a GPipe pipeline over ``pipe``, with
:func:`make_tp_block_fn`'s explicit tensor- and sequence-parallel
collectives inside.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, replace
from typing import Dict, Optional, Union

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.layers import (layer_norm, linear, linear_gelu,
                                      matmul, matmul_f32, rope,
                                      softmax_cross_entropy)
from ray_tpu_torch.parallel.mesh import compute_mesh, mesh_shape, replicated
from ray_tpu_torch.parallel.sharding import (ShardingRules, constrain,
                                             shard_pytree)
from ray_tpu_torch.parallel.spmd import axis_index, pbroadcast, psum, spmd
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils.device import resolve_device


# Forwards that took the layers' parameters by one unbind of the stacked
# leaves, since import (or since a caller reset it to 0). Several threads run
# forwards at once (trials of one process), so it is bumped under a lock.
unbound_forwards = 0
_count_lock = threading.Lock()


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
    remat_policy: str = "full"                 # "full" | "dots"
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


def logical_axes(config: TransformerConfig) -> Dict:
    """Tree of logical axis names mirroring ``init_params``'s output."""
    c = config
    blocks = {
        "ln1_g": ("layers", "embed"), "ln1_b": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "bq": ("layers", "heads", "head_dim"),
        "bk": ("layers", "kv_heads", "head_dim"),
        "bv": ("layers", "kv_heads", "head_dim"), "bo": ("layers", "embed"),
        "ln2_g": ("layers", "embed"), "ln2_b": ("layers", "embed"),
        "w_up": ("layers", "embed", "mlp"), "b_up": ("layers", "mlp"),
        "w_down": ("layers", "mlp", "embed"), "b_down": ("layers", "embed"),
    }
    axes = {
        "tok_embed": ("vocab", "embed"),
        "blocks": blocks,
        "lnf_g": ("embed",), "lnf_b": ("embed",),
    }
    if c.pos == "learned":
        axes["pos_embed"] = (None, "embed")
    if not c.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def shard_params(params: Dict, logical: Dict, mesh,
                 rules: ShardingRules) -> Dict:
    """Place a parameter tree on ``mesh`` under its logical axes
    (``parallel.sharding.shard_pytree``); every rank passes the same full
    tensors."""
    return shard_pytree(params, logical, mesh, rules)


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
    y = matmul(x, w.reshape(D, H * Dh)).to(dtype)
    return y.reshape(B, T, H, Dh) + b


def _out_proj(o, w, b, dtype):
    """``einsum("bthk,hkd->btd", o, w)`` rounded to ``dtype`` plus the bias
    in ``dtype``."""
    B, T, H, Dh = o.shape
    return matmul(o.reshape(B, T, H * Dh), w.reshape(H * Dh, -1)).to(dtype) + b


def _no_constraint(x, logical):
    return x


def _block_tail(h, bp, o, dtype, cstr=_no_constraint):
    """Attention output projection, residual and MLP of one block;
    ``cstr(x, logical)`` pins the activations' layout under a mesh."""
    h = cstr(h + _out_proj(o, bp["wo"], bp["bo"], dtype),
             ("batch", "seq_act", None))
    x = layer_norm(h, bp["ln2_g"], bp["ln2_b"])
    u = cstr(linear_gelu(x, bp["w_up"], bp["b_up"]),
             ("batch", "seq_act", "mlp"))
    return cstr(h + linear(u, bp["w_down"], bp["b_down"]),
                ("batch", "seq_act", None))


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


def _local_attention(fn, mesh, rules: ShardingRules):
    """``fn(q, k, v)`` on each rank's local blocks: batch split on the
    batch axes, heads on the heads axis, the whole sequence. The flash
    kernels' ``autograd.Function`` sees plain tensors."""
    spec = rules.mesh_axes(("batch", None, "heads", None))
    return spmd(fn, mesh, (spec, spec, spec), spec)


def _make_attention(config: TransformerConfig, mesh=None,
                    rules: Optional[ShardingRules] = None):
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
        fn = functools.partial(flash_attention, causal=True, scale=scale,
                               block_q=blk, block_k=blk)
    elif impl == "dense":
        fn = functools.partial(_dense_attention, scale=scale)
    elif impl in ("ring", "ulysses"):
        if mesh is None:
            raise ValueError(
                f"attn_impl {impl!r} needs a device mesh: pass mesh= (and "
                f"rules=) to forward/lm_loss")
        from ray_tpu_torch.parallel import ring_attention

        make = (ring_attention.make_ring_attention if impl == "ring"
                else ring_attention.make_ulysses_attention)
        return make(mesh, causal=True, scale=scale)
    else:
        raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
    if mesh is None:
        return fn
    return _local_attention(fn, mesh, rules)


def _constrainer(mesh, rules):
    if mesh is None:
        return _no_constraint
    return lambda x, logical: constrain(x, mesh, rules, logical)


def _positions(h):
    """Token positions 0..L-1 of ``h`` [B, L, ...], a replicated DTensor
    when ``h`` is one."""
    pos = torch.arange(h.shape[1], device=h.device)
    if isinstance(h, DTensor):
        pos = DTensor.from_local(pos, h.device_mesh,
                                 replicated(h.device_mesh), run_check=False)
    return pos


def make_block_fn(config: TransformerConfig, mesh=None,
                  rules: Optional[ShardingRules] = None):
    """One transformer block as ``block(h, bp) -> h``, ``bp`` one layer's
    parameters (cast to the compute dtype inside, as in JAX). Under a mesh
    the activations are constrained where JAX constrains them."""
    c = config
    rules = rules or ShardingRules()
    attention = _make_attention(c, mesh, rules)
    cstr = _constrainer(mesh, rules)

    def block(h, bp):
        bp = {k: v.to(c.dtype) for k, v in bp.items()}
        x = layer_norm(h, bp["ln1_g"], bp["ln1_b"])
        q = _heads(x, bp["wq"], bp["bq"], c.dtype)
        k = _heads(x, bp["wk"], bp["bk"], c.dtype)
        v = _heads(x, bp["wv"], bp["bv"], c.dtype)
        if c.pos == "rope":
            positions = _positions(h)
            q = rope(q, positions)
            k = rope(k, positions)
        q = cstr(q, ("batch", "seq_act", "heads", "head_dim"))
        k = cstr(k, ("batch", "seq_act", "kv_heads", "head_dim"))
        v = cstr(v, ("batch", "seq_act", "kv_heads", "head_dim"))
        return _block_tail(h, bp, attention(q, k, v), c.dtype, cstr)

    return block


def make_tp_block_fn(config: TransformerConfig, mesh, rules: ShardingRules):
    """Per-RANK transformer block for use inside an SPMD region (the
    pipeline body): tensor and sequence parallelism as explicit collectives
    on local blocks instead of layout constraints.

    - megatron TP: q/k/v/up projections are column-parallel (weights arrive
      with their heads/mlp dims locally sliced; their input goes through
      ``pbroadcast``, whose backward sums the partial input gradients),
      out/down projections row-parallel with a ``psum`` over the tensor
      axis before the (replicated) bias;
    - SP: ring attention over the seq axis, RoPE positions offset by the
      rank's sequence block.

    With tensor = seq = 1 this is the plain block body."""
    c = config
    scale = 1.0 / c.head_dim ** 0.5
    shape = mesh_shape(mesh)
    tensor_axis = rules.heads if isinstance(rules.heads, str) else None
    seq_axis = rules.seq_act if isinstance(rules.seq_act, str) else None
    tp = shape.get(tensor_axis, 1)
    sp = shape.get(seq_axis, 1)

    from ray_tpu_torch.parallel.ring_attention import _ring_attention_local

    def attention(q, k, v):
        if sp > 1:
            return _ring_attention_local(q, k, v, mesh=mesh,
                                         axis_name=seq_axis, causal=True,
                                         scale=scale)
        return _dense_attention(q, k, v, scale=scale)

    def column(x):
        return pbroadcast(x, mesh, tensor_axis) if tp > 1 else x

    def row(y):
        return psum(y, mesh, tensor_axis) if tp > 1 else y

    def block(h, bp):
        bp = {k: v.to(c.dtype) for k, v in bp.items()}
        x = column(layer_norm(h, bp["ln1_g"], bp["ln1_b"]))
        q = _heads(x, bp["wq"], bp["bq"], c.dtype)
        k = _heads(x, bp["wk"], bp["bk"], c.dtype)
        v = _heads(x, bp["wv"], bp["bv"], c.dtype)
        if c.pos == "rope":
            off = axis_index(mesh, seq_axis) * h.shape[1] if sp > 1 else 0
            positions = off + torch.arange(h.shape[1], device=h.device)
            q = rope(q, positions)
            k = rope(k, positions)
        o = attention(q, k, v)
        B, T, H, Dh = o.shape
        o = matmul_f32(o.reshape(B, T, H * Dh), bp["wo"].reshape(H * Dh, -1))
        h = h + row(o).to(c.dtype) + bp["bo"]

        x = column(layer_norm(h, bp["ln2_g"], bp["ln2_b"]))
        u = linear_gelu(x, bp["w_up"], bp["b_up"])
        d = row(matmul_f32(u, bp["w_down"]))
        # Bias in f32 then cast: the order of ops.layers.linear.
        return h + (d + bp["b_down"].float()).to(c.dtype)

    return block


# The projection GEMMs (no batch dims); ``mm.dtype`` is the card's bf16
# product with f32 output (``ops.layers.matmul_f32``).
_DOTS = frozenset(
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
    + ([torch.ops.aten.mm.dtype] if "dtype" in torch.ops.aten.mm.overloads()
       else []))


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy "dots": keep what the projection GEMMs
    return, recompute every other op, ``aten.bmm`` and the flash forward
    among them."""
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(block, config: TransformerConfig):
    """``block`` under ``config``'s remat policy."""
    if not config.remat:
        return block
    if config.remat_policy == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _dots_policy)
        return lambda h, bp: checkpoint(block, h, bp, use_reentrant=False,
                                        context_fn=context)
    if config.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {config.remat_policy!r}")
    return lambda h, bp: checkpoint(block, h, bp, use_reentrant=False)


def _embed(params, tokens, c: TransformerConfig, cstr):
    """Token (and learned position) embeddings. The table is gathered
    whole first, ``(None, None)``, as JAX does before its lookup."""
    tbl = cstr(params["tok_embed"].to(c.dtype), (None, None))
    # F.embedding, not tbl[tokens]: on DTensors torch 2.11's sharding rule
    # for index_put (the lookup's backward) fails; embedding's holds.
    h = torch.nn.functional.embedding(tokens, tbl)
    if c.pos == "learned":
        h = h + params["pos_embed"].to(c.dtype)[:tokens.shape[1]]
    return cstr(h, ("batch", "seq_act", None))


def _place_tokens(tokens, mesh):
    """Tokens as a DTensor on ``mesh`` (replicated if they were a plain
    tensor: every rank holds the whole batch)."""
    if mesh is None or isinstance(tokens, DTensor):
        return tokens
    return DTensor.from_local(tokens, compute_mesh(mesh), replicated(mesh),
                              run_check=False)


def forward(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
            *, mesh=None, rules: Optional[ShardingRules] = None
            ) -> torch.Tensor:
    """tokens [B, L] -> logits [B, L, padded_vocab] in the compute dtype.

    With ``mesh`` (and ``rules``, default ``ShardingRules()``) the
    parameters are DTensors on the mesh, the logits a DTensor laid out
    ``("batch", "seq_act", "vocab")``. The layers' ``dim 0`` must not be
    split over the mesh (``pp_lm_loss`` takes a ``pipe``-split stack)."""
    global unbound_forwards
    c = config
    rules = rules or ShardingRules()
    cstr = _constrainer(mesh, rules)
    h = _embed(params, _place_tokens(tokens, mesh), c, cstr)
    block = _remat(make_block_fn(c, mesh, rules), c)
    # Outside the remat wrapper, so the recompute does not repeat it.
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    with _count_lock:
        unbound_forwards += 1
    for layer in range(c.n_layers):
        h = block(h, {k: v[layer] for k, v in layers.items()})
    logits = _logits(params, h, c).to(c.dtype)
    return cstr(logits, ("batch", "seq_act", "vocab"))


def _next_token_loss(logits, tokens, batch, cstr):
    # The gold logit's gather must see the whole vocab dim: DTensor turns a
    # gather over a split dim into a masked partial sum that it cannot
    # reduce for 3-D logits (torch 2.13), so the vocab is gathered first.
    logits = cstr(logits, ("batch", "seq_act", None))
    mask = batch.get("loss_mask")
    keep = (mask[:, 1:] > 0 if mask is not None
            else torch.ones_like(tokens[:, 1:], dtype=torch.bool))
    labels = torch.where(keep, tokens[:, 1:], torch.full_like(
        tokens[:, 1:], -100))
    loss, _ = softmax_cross_entropy(logits[:, :-1], labels)
    return loss


def lm_loss(params: Dict, batch: Dict[str, torch.Tensor],
            config: TransformerConfig, *, mesh=None,
            rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """Next-token LM loss. batch: {"tokens": [B, L]} (optionally
    "loss_mask"). Under a mesh the loss is a replicated DTensor scalar.
    Opens the spans ``lm.forward`` (the logits) and ``lm.loss`` (the
    cross-entropy) inside a trace that was asked for (``step_span``)."""
    tokens = _place_tokens(batch["tokens"], mesh)
    with tracing.step_span("lm.forward"):
        logits = forward(params, tokens, config, mesh=mesh, rules=rules)
    with tracing.step_span("lm.loss"):
        batch = {k: _place_tokens(v, mesh) for k, v in batch.items()}
        return _next_token_loss(logits, tokens, batch,
                                _constrainer(mesh, rules or ShardingRules()))


def pp_lm_loss(params: Dict, batch: Dict[str, torch.Tensor],
               config: TransformerConfig, *, mesh, rules: ShardingRules,
               num_microbatches: int) -> torch.Tensor:
    """``lm_loss`` with the block stack run as a GPipe pipeline over the
    ``pipe`` mesh axis (``parallel/pipeline.py``). The embedding and the LM
    head run on DTensors as in :func:`forward`; only the blocks hand
    activations stage to stage, through :func:`make_tp_block_fn`'s body
    (tensor- and sequence-parallel inside). Losses match the non-PP
    ``lm_loss``."""
    from ray_tpu_torch.parallel.pipeline import make_pipeline

    c = config
    tokens = _place_tokens(batch["tokens"], mesh)
    B, L = tokens.shape
    if B % num_microbatches:
        raise ValueError(f"batch {B} does not split into "
                         f"{num_microbatches} microbatches")
    shape = mesh_shape(mesh)
    dp = 1
    for ax in (rules.batch if isinstance(rules.batch, tuple)
               else (rules.batch,)):
        if ax is not None:
            dp *= shape[ax]
    if B % dp or (B // dp) % num_microbatches:
        raise ValueError(f"per-device batch {B}/{dp} must split evenly into "
                         f"{num_microbatches} microbatches")
    cstr = _constrainer(mesh, rules)
    h = _embed(params, tokens, c, cstr)

    # Weights enter the pipeline split per their logical axes with embed
    # replicated (the fsdp gather happens once, at the region's boundary).
    pp_rules = rules.update(embed=None)
    param_specs = {k: pp_rules.mesh_axes(v)
                   for k, v in logical_axes(c)["blocks"].items()}
    seq_ax = rules.seq_act if isinstance(rules.seq_act, str) else None
    x_spec = (rules.batch, None, seq_ax, None)
    block = make_tp_block_fn(c, mesh, rules)
    pipeline = make_pipeline(
        lambda bp, x: block(x, bp), mesh, num_microbatches=num_microbatches,
        pipe_axis=rules.layers, batch_axes=rules.batch, x_spec=x_spec,
        param_specs=param_specs, remat=c.remat)
    mb = B // num_microbatches
    # Microbatch index on the TRAILING side of the split: a batch-split
    # [B, ...] reshapes into [mb, M, ...] without moving data.
    x4 = h.reshape(mb, num_microbatches, L, h.shape[-1])
    h = pipeline(params["blocks"], x4)
    h = cstr(h.reshape(B, L, h.shape[-1]), ("batch", "seq_act", None))
    logits = cstr(_logits(params, h, c).to(c.dtype),
                  ("batch", "seq_act", "vocab"))
    batch = {k: _place_tokens(v, mesh) for k, v in batch.items()}
    return _next_token_loss(logits, tokens, batch, cstr)

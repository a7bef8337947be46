"""Generation with a KV cache: the serving engines' device halves, the
single-sequence oracle, and the paged engine's block manager.

Counterpart of ``ray_tpu/models/generate.py``:

- :class:`Generator` — one sequence (or a fixed batch) over a private cache
  [L, B, max_len, H, Dh]; the oracle the engines are held to;
- :class:`SlottedGenerator` — the slotted engine's device half: S
  independent sequences, one cache row each, every slot at its own length;
- :class:`PagedGenerator` — the paged engine's device half: K/V in a SHARED
  pool of ``block_tokens``-sized blocks addressed through per-sequence
  block tables, attended with ``ops.paged_attention`` (the CUDA kernel on
  the card); with a draft model it also runs speculative decoding, whose
  verify step calls the kernel with T = k+1 query rows a slot.

Where JAX clamps or drops an out-of-range index, torch raises or
device-asserts, so every JAX clamp is written out here: the table lookup
``clip(pos // bt, 0, NB-1)``, the ``write_ok`` redirect of pad and overhang
writes to trash block 0, the slotted write position at ``max_len - 1``,
``dynamic_update_slice``'s start clamp and the ``pos_embed`` clamp at
``max_seq_len - 1``. Duplicate scatter targets (pads and inactive slots all
hit block 0) are harmless: nothing live reads block 0.

JAX threads the caches through donated buffers; here they are updated IN
PLACE and the functions return the same tensors. Each JAX ``lax.scan`` over
a decode chunk is a Python loop issuing device work; argmax and sampling
stay on the device and a chunk ends with one host copy of its tokens (done
by the engine). Sampling draws from per-slot ``torch.Generator``s (JAX:
threefry keys), so sampled streams repeat for a seed but are not JAX's;
greedy streams match JAX token for token.

The disaggregation handoff moves whole blocks between two engines' pools
(:meth:`PagedGenerator.extract_fn`, :meth:`PagedGenerator.insert_fn`):
plain tensor indexing, as in JAX, where no Pallas kernel computes them.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.models.transformer import (TransformerConfig, _block_tail,
                                              _heads, _logits)
from ray_tpu_torch.ops.layers import layer_norm, rope
from ray_tpu_torch.ops.paged_attention import paged_attention
from ray_tpu_torch.util import blockhash
from ray_tpu_torch.utils.device import resolve_device

_MODES = ("cuda", "plain", "gather")


def resolve_attention_kernel(mode: Optional[str],
                             device: Union[str, torch.device]) -> str:
    """Resolve the ``serve_paged_attention_kernel`` knob for a pool on
    ``device``: ``cuda`` (the hand-written kernel, CUDA pools only),
    ``plain`` (the plain PyTorch version, CPU pools only) or ``gather`` (the
    table-gather + dense-mask path of :func:`_attend_cached`, either
    device). ``auto`` picks ``cuda`` for a CUDA pool and ``plain`` for a CPU
    pool."""
    dev = torch.device(device)
    mode = (mode or "auto").lower()
    if mode == "auto":
        return "cuda" if dev.type == "cuda" else "plain"
    if mode not in _MODES:
        raise ValueError(f"serve_paged_attention_kernel must be "
                         f"auto|cuda|plain|gather, got {mode!r}")
    if mode == "cuda" and dev.type != "cuda":
        raise ValueError(f"attention kernel 'cuda' needs a CUDA pool, not "
                         f"{dev}")
    if mode == "plain" and dev.type != "cpu":
        raise ValueError(f"attention kernel 'plain' runs CPU pools only, not "
                         f"{dev}; use 'gather' for a plain path on the card")
    return mode


def _attend_cached(q, k_cache, v_cache, valid_len, *, scale: float):
    """q: [B, T, H, D] against cache [B, S, H, D]; positions >= valid_len are
    masked, and for T > 1 a causal mask applies within the window.
    ``valid_len`` is a scalar or a [B] vector of per-row lengths."""
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(),
                          k_cache.float()) * scale
    kv_pos = torch.arange(S, device=q.device)[None, None, None, :]
    vl = torch.as_tensor(valid_len, device=q.device).long()
    if vl.dim():                                          # per-row [B]
        vl = vl.reshape(-1, 1, 1, 1)
    q_pos = (vl - T) + torch.arange(T, device=q.device)[None, None, :, None]
    scores = torch.where(kv_pos <= q_pos, scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v_cache.float())
    return out.to(q.dtype)


def _to_device(tree, device, dtype: Optional[torch.dtype] = None):
    """A parameter tree moved to ``device`` (and cast to ``dtype``, if
    given). The forwards cast at every use, as the JAX ones do, which is
    then a no-op with the same rounding."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def _gumbel(like: torch.Tensor, rows: Sequence[int], gens) -> torch.Tensor:
    """Gumbel noise for the listed rows of ``like`` [S, V], zeros elsewhere,
    row s drawn from ``gens[s]``: ``argmax(x + noise)`` samples softmax(x)
    in those rows. Only the listed rows draw, so a request's stream depends
    on its own seed and logits, never on its neighbours."""
    g = torch.zeros_like(like)
    for s in rows:
        u = torch.rand(like.shape[-1], generator=gens[s], device=like.device)
        g[s] = -torch.log(-torch.log(u))
    return g


def _next_tokens(real, greedy_t, temp_safe, samplers, gens) -> torch.Tensor:
    """Per-slot next tokens from logits ``real`` [S, V]: argmax for greedy
    slots, a sample of softmax(real / temp) for the ``samplers``."""
    nxt = real.argmax(dim=-1)
    if samplers:
        samp = (real / temp_safe
                + _gumbel(real, samplers, gens)).argmax(dim=-1)
        nxt = torch.where(greedy_t, nxt, samp)
    return nxt


class _SlotOperands:
    """A decode chunk's per-slot operands on the device: the active mask
    (``act``, ``act_col``, ``adv``), greedy mask, safe temperatures and the
    active sampled slots, which alone draw random numbers."""

    def __init__(self, active, greedy, temps, device):
        active = np.asarray(active, bool)
        greedy = np.asarray(greedy, bool)
        self.act = torch.as_tensor(active, device=device)
        self.act_col = self.act[:, None]
        self.adv = self.act.to(torch.int32)
        self.greedy = torch.as_tensor(greedy, device=device)
        self.temp_safe = torch.as_tensor(
            np.maximum(np.asarray(temps, np.float32), 1e-6),
            device=device)[:, None]
        self.samplers = [s for s in range(len(active))
                         if active[s] and not greedy[s]]


def init_cache(config: TransformerConfig, batch: int,
               max_len: Optional[int] = None, device=None) -> Dict:
    """Private KV cache [L, batch, max_len, H, Dh] for K and for V, and the
    valid ``length`` every row shares. ``device`` defaults to the card;
    ``device="cpu"`` puts it on the CPU."""
    device = resolve_device(device)
    c = config
    max_len = max_len or c.max_seq_len
    shape = (c.n_layers, batch, max_len, c.n_heads, c.head_dim)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
            "v": torch.zeros(shape, dtype=c.dtype, device=device),
            "length": 0}


def _forward_cached(params, tokens, cache, config: TransformerConfig,
                    start_pos: int):
    """Forward ``tokens`` [B, T] at positions [start_pos, start_pos+T),
    writing their K/V into ``cache`` in place. Returns (logits [B, T, V]
    f32, cache)."""
    c = config
    cast = lambda p: p.to(c.dtype)
    B, T = tokens.shape
    M = cache["k"].shape[2]
    dev = tokens.device
    h = cast(params["tok_embed"])[tokens]
    positions = start_pos + torch.arange(T, device=dev)
    if c.pos == "learned":
        h = h + cast(params["pos_embed"])[
            positions.clamp(max=c.max_seq_len - 1)]
    scale = 1.0 / c.head_dim**0.5
    valid_len = start_pos + T
    # JAX's dynamic_update_slice moves its start back until the update fits.
    w0 = max(0, min(int(start_pos), M - T))

    for layer in range(c.n_layers):
        bp = {k: cast(v[layer]) for k, v in params["blocks"].items()}
        x = layer_norm(h, bp["ln1_g"], bp["ln1_b"])
        q = _heads(x, bp["wq"], bp["bq"], c.dtype)
        k = _heads(x, bp["wk"], bp["bk"], c.dtype)
        v = _heads(x, bp["wv"], bp["bv"], c.dtype)
        if c.pos == "rope":
            q = rope(q, positions)
            k = rope(k, positions)
        cache["k"][layer, :, w0:w0 + T] = k
        cache["v"][layer, :, w0:w0 + T] = v
        o = _attend_cached(q, cache["k"][layer], cache["v"][layer], valid_len,
                           scale=scale)
        h = _block_tail(h, bp, o, c.dtype)
    cache["length"] = valid_len
    return _logits(params, h, c), cache


def init_slot_cache(config: TransformerConfig, slots: int,
                    max_len: Optional[int] = None, device=None) -> Dict:
    """KV cache for ``slots`` INDEPENDENT sequences: the batch dim is a slot
    index and ``lengths[s]`` (int32 [S]) replaces the single ``length`` —
    each slot decodes at its own position. ``device`` defaults to the card;
    ``device="cpu"`` puts it on the CPU."""
    device = resolve_device(device)
    c = config
    max_len = max_len or c.max_seq_len
    shape = (c.n_layers, slots, max_len, c.n_heads, c.head_dim)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
            "v": torch.zeros(shape, dtype=c.dtype, device=device),
            "lengths": torch.zeros((slots,), dtype=torch.int32,
                                   device=device)}


def _forward_decode_slotted(params, tokens, k_cache, v_cache, lengths,
                            config: TransformerConfig):
    """One decode step for S independent slots: ``tokens`` [S, 1] at per-slot
    positions ``lengths`` [S]. Writes each slot's new K/V at its own position
    (in place) and attends with per-slot validity. Returns (logits [S, 1, V]
    f32, k_cache, v_cache); rows are independent, so an inactive slot's
    garbage never reaches its neighbours."""
    c = config
    cast = lambda p: p.to(c.dtype)
    S, T = tokens.shape  # T == 1
    M = k_cache.shape[2]
    dev = tokens.device
    h = cast(params["tok_embed"])[tokens]
    # A slot parked at the context cap (retired, awaiting refill) writes at
    # M - 1, as JAX clamps: its row is dead either way.
    pos = lengths.long().clamp(max=M - 1)
    positions = pos[:, None]                              # [S, 1]
    if c.pos == "learned":
        h = h + cast(params["pos_embed"])[
            positions.clamp(max=c.max_seq_len - 1)]
    scale = 1.0 / c.head_dim**0.5
    rows = torch.arange(S, device=dev)
    valid_len = pos + 1                                # new token attendable

    for layer in range(c.n_layers):
        bp = {k: cast(v[layer]) for k, v in params["blocks"].items()}
        x = layer_norm(h, bp["ln1_g"], bp["ln1_b"])
        q = _heads(x, bp["wq"], bp["bq"], c.dtype)
        k = _heads(x, bp["wk"], bp["bk"], c.dtype)
        v = _heads(x, bp["wv"], bp["bv"], c.dtype)
        if c.pos == "rope":
            q = rope(q, positions)
            k = rope(k, positions)
        k_cache[layer, rows, pos] = k[:, 0]
        v_cache[layer, rows, pos] = v[:, 0]
        o = _attend_cached(q, k_cache[layer], v_cache[layer], valid_len,
                           scale=scale)
        h = _block_tail(h, bp, o, c.dtype)
    return _logits(params, h, c), k_cache, v_cache


class SlottedGenerator:
    """Slot-level prefill + batched decode for continuous batching: the
    slotted engine's device half (``serve/llm.py`` :class:`LLMEngine`).

    S cache slots hold S independent sequences. :meth:`prefill_fn` writes
    ONE prompt's K/V into its slot and parks its next-token logits in the
    ``last`` [S, V] rows; :meth:`decode_fn` advances every active slot by
    ``chunk`` tokens (inactive slots keep their lengths and ``last`` rows;
    greedy and sampled slots share the chunk through per-slot operands).

    Device state is ``(cache, last, gens)``: the slot cache, ``last`` (f32)
    and one ``torch.Generator`` per slot, seeded at prefill. The functions
    update them in place and return them.
    """

    def __init__(self, params, config: TransformerConfig, *, slots: int,
                 device, max_len: Optional[int] = None):
        self.params = params
        self.config = config
        self.slots = slots
        self.device = torch.device(device)
        self.max_len = max_len or config.max_seq_len
        self.logits_dim = (params["tok_embed"].shape[0]
                           if config.tie_embeddings
                           else params["lm_head"].shape[-1])
        # Decode steps run (one forward each), for the engine's accounting.
        self.decode_forwards = 0

    def init_state(self):
        cache = init_slot_cache(self.config, self.slots, self.max_len,
                                self.device)
        last = torch.zeros((self.slots, self.logits_dim), dtype=torch.float32,
                           device=self.device)
        gens = [torch.Generator(device=self.device) for _ in range(self.slots)]
        return cache, last, gens

    def prefill_fn(self, bucket: int):
        """insert_prefill(params, cache, last, gens, padded [1,P], real_len,
        slot, seed) -> (cache, last, gens): one prompt's K/V into one slot,
        its last real token's logits into ``last[slot]``, the slot's
        generator seeded."""
        c = self.config

        def insert_prefill(params, cache, last, gens, padded, real_len, slot,
                           seed):
            if np.shape(padded) != (1, bucket):
                raise ValueError(f"prefill bucket {bucket} got tokens of "
                                 f"shape {np.shape(padded)}")
            tokens = torch.as_tensor(np.asarray(padded, np.int64),
                                     device=self.device)
            tmp = init_cache(c, 1, bucket, self.device)
            logits, tmp = _forward_cached(params, tokens, tmp, c, 0)
            slot = int(slot)
            cache["k"][:, slot, :bucket] = tmp["k"][:, 0]
            cache["v"][:, slot, :bucket] = tmp["v"][:, 0]
            cache["lengths"][slot] = int(real_len)
            last[slot] = logits[0, int(real_len) - 1]
            gens[slot].manual_seed(int(seed))
            return cache, last, gens

        return insert_prefill

    def decode_fn(self, chunk: int):
        """decode_chunk(params, cache, last, gens, active, greedy, temps) ->
        (toks [S, chunk] int32 on the device, cache, last, gens): ``chunk``
        steps advancing every active slot."""
        c = self.config
        V = c.vocab_size

        def decode_chunk(params, cache, last, gens, active, greedy, temps):
            ops = _SlotOperands(active, greedy, temps, self.device)
            lengths = cache["lengths"]
            toks = []
            for _ in range(chunk):
                nxt = _next_tokens(last[:, :V], ops.greedy, ops.temp_safe,
                                   ops.samplers, gens)
                logits, _, _ = _forward_decode_slotted(
                    params, nxt[:, None], cache["k"], cache["v"], lengths, c)
                self.decode_forwards += 1
                lengths = lengths + ops.adv
                last = torch.where(ops.act_col, logits[:, -1], last)
                toks.append(nxt)
            cache["lengths"] = lengths
            return torch.stack(toks, dim=1).to(torch.int32), cache, last, gens

        return decode_chunk


def init_block_pool(config: TransformerConfig, num_blocks: int,
                    block_tokens: int, device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Shared paged KV pool [L, num_blocks, block_tokens, H, Dh] for K and
    for V. Block 0 is the reserved TRASH block: freed table rows and pad
    positions point at it."""
    c = config
    shape = (c.n_layers, num_blocks, block_tokens, c.n_heads, c.head_dim)
    return (torch.zeros(shape, dtype=c.dtype, device=device),
            torch.zeros(shape, dtype=c.dtype, device=device))


def _paged_attend(q, k_pool, v_pool, tables, lengths, *, scale, kernel):
    """Attention over the paged pool for one layer, switched by ``kernel``:
    ``cuda``/``plain`` go through :func:`paged_attention` (kernel on the
    card, plain version on the CPU); ``gather`` is the table-gather +
    dense-mask path."""
    if kernel in ("cuda", "plain"):
        return paged_attention(q, k_pool, v_pool, tables, lengths,
                               scale=scale)
    S, T = q.shape[:2]
    nb, bt, H, D = k_pool.shape
    nb_seq = tables.shape[1]
    idx = tables.long().clamp(0, nb - 1)       # JAX's gather clamps
    kc = k_pool[idx].reshape(S, nb_seq * bt, H, D)
    vc = v_pool[idx].reshape(S, nb_seq * bt, H, D)
    return _attend_cached(q, kc, vc, lengths.long() + T, scale=scale)


def _forward_prefill_paged(params, tokens, k_pool, v_pool, table, start_pos,
                           suffix_len, config: TransformerConfig,
                           block_tokens: int, kernel: str = "plain"):
    """Prefill ``tokens`` [1, P] (a SUFFIX bucket) at absolute positions
    [start_pos, start_pos+P) into the paged pool through ``table`` [NB]
    (int32). Only the first ``suffix_len`` positions are real: pad writes go
    to trash block 0, and pad queries sit causally after every real row.
    Updates the pools in place; returns (logits [1, P, V] f32, k_pool,
    v_pool)."""
    c = config
    cast = lambda p: p.to(c.dtype)
    B, P = tokens.shape  # B == 1
    NB = table.shape[0]
    bt = block_tokens
    dev = tokens.device
    h = cast(params["tok_embed"])[tokens]
    positions = start_pos + torch.arange(P, device=dev)
    if c.pos == "learned":
        h = h + cast(params["pos_embed"])[
            positions.clamp(max=c.max_seq_len - 1)][None]
    scale = 1.0 / c.head_dim**0.5
    lengths1 = torch.full((1,), int(start_pos), dtype=torch.int32, device=dev)
    write_ok = torch.arange(P, device=dev) < suffix_len
    blk = torch.where(write_ok,
                      table.long()[(positions // bt).clamp(0, NB - 1)], 0)
    off = positions % bt
    tables = table[None]

    for layer in range(c.n_layers):
        bp = {k: cast(v[layer]) for k, v in params["blocks"].items()}
        x = layer_norm(h, bp["ln1_g"], bp["ln1_b"])
        q = _heads(x, bp["wq"], bp["bq"], c.dtype)
        k = _heads(x, bp["wk"], bp["bk"], c.dtype)
        v = _heads(x, bp["wv"], bp["bv"], c.dtype)
        if c.pos == "rope":
            q = rope(q, positions[None])
            k = rope(k, positions[None])
        # Write before attend: the kernel reads these rows from the pool.
        k_pool[layer, blk, off] = k[0]
        v_pool[layer, blk, off] = v[0]
        o = _paged_attend(q, k_pool[layer], v_pool[layer], tables, lengths1,
                          scale=scale, kernel=kernel)
        h = _block_tail(h, bp, o, c.dtype)
    return _logits(params, h, c), k_pool, v_pool


def _forward_decode_paged(params, tokens, k_pool, v_pool, tables, lengths,
                          config: TransformerConfig, block_tokens: int,
                          kernel: str = "plain"):
    """Decode ``tokens`` [S, T] for S sequences over the paged pool: slot
    s's token t sits at absolute position ``lengths[s] + t``, its K/V
    written to block ``tables[s, pos // bt]`` row ``pos % bt`` and attention
    run back through the table row. Positions at or past table capacity
    write to trash block 0 instead of clamping onto the last cell. ``tables``
    [S, NB] and ``lengths`` [S] are int32. Updates the pools in place;
    returns (logits [S, T, V] f32, k_pool, v_pool)."""
    c = config
    cast = lambda p: p.to(c.dtype)
    S, T = tokens.shape
    NB = tables.shape[1]
    bt = block_tokens
    max_len = NB * bt
    dev = tokens.device
    h = cast(params["tok_embed"])[tokens]
    positions = (lengths.long()[:, None]
                 + torch.arange(T, device=dev)[None, :])    # [S, T]
    write_ok = positions < max_len
    pos_c = positions.clamp(max=max_len - 1)
    if c.pos == "learned":
        h = h + cast(params["pos_embed"])[
            positions.clamp(max=c.max_seq_len - 1)]
    scale = 1.0 / c.head_dim**0.5
    rows = torch.arange(S, device=dev)[:, None]
    blk = torch.where(write_ok, tables.long()[rows, pos_c // bt], 0)
    off = pos_c % bt

    for layer in range(c.n_layers):
        bp = {k: cast(v[layer]) for k, v in params["blocks"].items()}
        x = layer_norm(h, bp["ln1_g"], bp["ln1_b"])
        q = _heads(x, bp["wq"], bp["bq"], c.dtype)
        k = _heads(x, bp["wk"], bp["bk"], c.dtype)
        v = _heads(x, bp["wv"], bp["bv"], c.dtype)
        if c.pos == "rope":
            q = rope(q, positions)
            k = rope(k, positions)
        k_pool[layer, blk, off] = k
        v_pool[layer, blk, off] = v
        o = _paged_attend(q, k_pool[layer], v_pool[layer], tables, lengths,
                          scale=scale, kernel=kernel)
        h = _block_tail(h, bp, o, c.dtype)
    return _logits(params, h, c), k_pool, v_pool


class PagedGenerator:
    """Paged device half of the serving engine: K/V lives in a SHARED block
    pool addressed through per-sequence block tables.

    Device state is ``(k_pool, v_pool, last, gens)``: the pools, the
    per-slot next-token logits ``last`` [S, V] (f32) and one
    ``torch.Generator`` per slot, seeded from the request's seed at prefill.
    The functions below update the pools and ``last`` in place and return
    the state; block tables and lengths are host numpy arrays owned by the
    engine and :class:`KVBlockManager`, copied to the device per call.

    With ``draft_params``/``draft_config`` it also runs speculative decoding
    (:meth:`spec_decode_fn`): the draft's own pool (:meth:`init_draft_state`)
    has the target pool's block geometry, so the SAME block tables index
    both.

    Sampled streams are deterministic for a seed, but they are not the JAX
    engine's (torch's generators are not threefry); greedy streams match it
    token for token.
    """

    def __init__(self, params, config: TransformerConfig, *, slots: int,
                 num_blocks: int, block_tokens: int, device,
                 max_len: Optional[int] = None,
                 attention_kernel: str = "auto",
                 draft_params=None,
                 draft_config: Optional[TransformerConfig] = None):
        self.params = params
        self.config = config
        self.slots = slots
        self.device = torch.device(device)
        self.max_len = max_len or config.max_seq_len
        self.block_tokens = int(block_tokens)
        if self.max_len % self.block_tokens:
            raise ValueError(
                f"max_len {self.max_len} not a multiple of "
                f"serve_kv_block_tokens {self.block_tokens}")
        self.blocks_per_seq = self.max_len // self.block_tokens
        self.num_blocks = int(num_blocks)
        self.attention_kernel = resolve_attention_kernel(attention_kernel,
                                                         self.device)
        if (draft_params is None) != (draft_config is None):
            raise ValueError("draft_params and draft_config go together")
        if draft_config is not None and (
                draft_config.vocab_size != config.vocab_size):
            raise ValueError(
                f"draft vocab {draft_config.vocab_size} != target vocab "
                f"{config.vocab_size} — speculative verify needs one vocab")
        self.draft_params = draft_params
        self.draft_config = draft_config
        self.logits_dim = (params["tok_embed"].shape[0]
                           if config.tie_embeddings
                           else params["lm_head"].shape[-1])
        # Forward passes run, for the engine's launch accounting: one per
        # prefill dispatch and one per decode step (the target's layers);
        # one per speculative verify (target, T = k+1); and the draft's, one
        # per draft prefill and one per draft-chain token (T = 1).
        self.prefill_forwards = 0
        self.decode_forwards = 0
        self.spec_forwards = 0
        self.draft_prefill_forwards = 0
        self.draft_forwards = 0

    def _i32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def init_state(self):
        k_pool, v_pool = init_block_pool(self.config, self.num_blocks,
                                         self.block_tokens, self.device)
        last = torch.zeros((self.slots, self.logits_dim), dtype=torch.float32,
                           device=self.device)
        gens = [torch.Generator(device=self.device) for _ in range(self.slots)]
        return k_pool, v_pool, last, gens

    def prefill_fn(self, bucket: int):
        """paged_prefill(params, k_pool, v_pool, last, gens, table [NB],
        padded [1,P], start_pos, suffix_len, slot, seed) -> (k_pool, v_pool,
        last, gens): prefill the SUFFIX bucket at start_pos (the prefix-hit
        length), park the last real token's logits in ``last[slot]`` and
        seed the slot's generator."""
        c = self.config
        bt = self.block_tokens
        kernel = self.attention_kernel

        def paged_prefill(params, k_pool, v_pool, last, gens, table, padded,
                          start_pos, suffix_len, slot, seed):
            if np.shape(padded) != (1, bucket):
                raise ValueError(f"prefill bucket {bucket} got tokens of "
                                 f"shape {np.shape(padded)}")
            tokens = torch.as_tensor(np.asarray(padded, np.int64),
                                     device=self.device)
            logits, k_pool, v_pool = _forward_prefill_paged(
                params, tokens, k_pool, v_pool, self._i32(table),
                int(start_pos), int(suffix_len), c, bt, kernel=kernel)
            self.prefill_forwards += 1
            last[int(slot)] = logits[0, int(suffix_len) - 1]
            gens[int(slot)].manual_seed(int(seed))
            return k_pool, v_pool, last, gens

        return paged_prefill

    def decode_fn(self, chunk: int):
        """paged_decode(params, k_pool, v_pool, last, gens, tables [S,NB],
        lengths [S], active, greedy, temps) -> (toks [S, chunk] int32 on the
        device, k_pool, v_pool, last, gens): ``chunk`` steps advancing every
        active slot through its block table. Inactive slots compute on
        all-trash tables; their lengths, ``last`` rows and generators stay
        as they were."""
        c = self.config
        bt = self.block_tokens
        kernel = self.attention_kernel
        V = c.vocab_size

        def paged_decode(params, k_pool, v_pool, last, gens, tables, lengths,
                         active, greedy, temps):
            ops = _SlotOperands(active, greedy, temps, self.device)
            tables_t = self._i32(tables)
            lens = self._i32(lengths)
            toks = []
            for _ in range(chunk):
                nxt = _next_tokens(last[:, :V], ops.greedy, ops.temp_safe,
                                   ops.samplers, gens)
                logits, k_pool, v_pool = _forward_decode_paged(
                    params, nxt[:, None], k_pool, v_pool, tables_t, lens, c,
                    bt, kernel=kernel)
                self.decode_forwards += 1
                lens = lens + ops.adv
                last = torch.where(ops.act_col, logits[:, -1], last)
                toks.append(nxt)
            return (torch.stack(toks, dim=1).to(torch.int32), k_pool, v_pool,
                    last, gens)

        return paged_decode

    def init_draft_state(self):
        """The draft model's pool: the draft's own layers, the target pool's
        block geometry, so the SAME block tables index both and speculation
        adds no :class:`KVBlockManager` state."""
        return init_block_pool(self.draft_config, self.num_blocks,
                               self.block_tokens, self.device)

    def draft_prefill_fn(self, bucket: int):
        """draft_prefill(draft_params, kd_pool, vd_pool, table [NB],
        padded [1,P], start_pos, suffix_len) -> (kd_pool, vd_pool): the
        DRAFT model over the same suffix bucket through the same block
        table, so its pool holds draft K/V for every position the target's
        holds. Logits are dropped: the first proposal conditions on the
        verified tail, not on prefill output."""
        dc = self.draft_config
        bt = self.block_tokens
        kernel = self.attention_kernel

        def draft_prefill(draft_params, kd_pool, vd_pool, table, padded,
                          start_pos, suffix_len):
            if np.shape(padded) != (1, bucket):
                raise ValueError(f"prefill bucket {bucket} got tokens of "
                                 f"shape {np.shape(padded)}")
            tokens = torch.as_tensor(np.asarray(padded, np.int64),
                                     device=self.device)
            _, kd_pool, vd_pool = _forward_prefill_paged(
                draft_params, tokens, kd_pool, vd_pool, self._i32(table),
                int(start_pos), int(suffix_len), dc, bt, kernel=kernel)
            self.draft_prefill_forwards += 1
            return kd_pool, vd_pool

        return draft_prefill

    def spec_decode_fn(self, chunk: int, k: int):
        """Speculative decode: ``chunk`` steps, each proposing ``k`` draft
        tokens and verifying them in ONE batched target forward.

        spec_decode(params, draft_params, k_pool, v_pool, kd_pool, vd_pool,
        last, gens, tables, lengths, active, greedy, temps, spec_on, tail,
        pending, use_pending) -> (toks [S, chunk, k+1], counts [S, chunk],
        accepted [S, chunk], k_pool, v_pool, kd_pool, vd_pool, last, gens,
        tail, pending, use_pending), the first three int32 and the last
        three [S] tensors on the device.

        Per step and slot: token n0 comes from ``last`` (or the carried
        rejection replacement when ``use_pending``); the draft runs k+1
        single-token forwards — forward 0 re-consumes ``tail`` (the last
        accepted token) at position len-1, an idempotent K/V rewrite that
        also fills the one draft-K/V hole a fully accepted step leaves, then
        forwards 1..k consume n0, d_1, ..., d_{k-1} and propose d_1..d_k. The
        target verifies [n0, d_1..d_k] in one [S, k+1] forward (the paged
        kernel at T = k+1). Acceptance is rejection sampling, u·q(d) < p(d),
        which keeps the target's distribution for ANY draft; greedy slots
        take the exact argmax prefix match. The slot advances 1 + a tokens,
        a the accepted run. On rejection at a < k the replacement is drawn
        from the renormalised residual max(p - q, 0) (greedy: the target's
        argmax) and carried as ``pending``, next step's n0; on full
        acceptance ``last`` becomes the verify logits at position k. Writes
        past the accepted run are overwritten before they are attendable.

        ``toks[s, t, :counts[s, t]]`` are step t's emitted tokens. A slot
        with ``spec_on`` False (acceptance EWMA under the floor, or no table
        headroom for chunk*(k+1)) has its proposals force-rejected: a == 0
        and it emits n0 alone, refreshing ``last`` from verify row 0 (its
        n0's logits, the plain decode chain) with no pending carry.

        Random draws (n0, the k proposals, k uniforms and one residual
        draw a step) come from each active sampled slot's own generator;
        greedy and inactive slots draw nothing."""
        if self.draft_config is None:
            raise ValueError("spec_decode_fn requires a draft model")
        if k < 1:
            raise ValueError("serve_spec_tokens must be >= 1 when "
                             "speculative decoding is enabled")
        c = self.config
        dc = self.draft_config
        bt = self.block_tokens
        kernel = self.attention_kernel
        V = c.vocab_size
        dev = self.device

        def spec_decode(params, draft_params, k_pool, v_pool, kd_pool,
                        vd_pool, last, gens, tables, lengths, active, greedy,
                        temps, spec_on, tail, pending, use_pending):
            ops = _SlotOperands(active, greedy, temps, dev)
            act, samplers = ops.act, ops.samplers
            S = act.shape[0]
            on = torch.as_tensor(np.asarray(spec_on, bool), device=dev)
            tables_t = self._i32(tables)
            lens = self._i32(lengths)
            tail = self._i32(tail).long()
            pending = self._i32(pending).long()
            use_pending = torch.as_tensor(np.asarray(use_pending, bool),
                                          device=dev)
            toks, counts, accepted = [], [], []
            for _ in range(chunk):
                n0 = _next_tokens(last[:, :V], ops.greedy, ops.temp_safe,
                                  samplers, gens)
                n0 = torch.where(use_pending, pending, n0)

                # Draft chain: k+1 single-token forwards through the SHARED
                # block tables into the draft pool.
                cur_tok, cur_pos = tail, (lens - 1).clamp(min=0)
                proposals, dlogits = [], []
                for i in range(k + 1):
                    dl, kd_pool, vd_pool = _forward_decode_paged(
                        draft_params, cur_tok[:, None], kd_pool, vd_pool,
                        tables_t, cur_pos, dc, bt, kernel=kernel)
                    self.draft_forwards += 1
                    if i == 0:
                        # Forward 0 only (re)writes tail's draft K/V at
                        # lens-1; its logits are superseded by n0's chain.
                        cur_tok, cur_pos = n0, lens
                        continue
                    dreal = dl[:, 0, :V]
                    d_i = _next_tokens(dreal, ops.greedy, ops.temp_safe,
                                       samplers, gens)
                    proposals.append(d_i)
                    dlogits.append(dreal)
                    cur_tok, cur_pos = d_i, lens + i

                # One batched target verify over [n0, d_1..d_k].
                verify = torch.stack([n0] + proposals, dim=1)    # [S, k+1]
                logits, k_pool, v_pool = _forward_decode_paged(
                    params, verify, k_pool, v_pool, tables_t, lens, c, bt,
                    kernel=kernel)
                self.spec_forwards += 1
                treal = logits[:, :, :V]                         # [S, k+1, V]
                props = verify[:, 1:]                            # [S, k]
                dreal_all = torch.stack(dlogits, dim=1)          # [S, k, V]

                # Greedy acceptance: exact argmax prefix match. Sampled:
                # u < p(d)/q(d), the target/draft probability of d.
                ok = props == treal[:, :k].argmax(dim=-1)
                if samplers:
                    tcol = ops.temp_safe[:, :, None]
                    p_d = torch.softmax(treal[:, :k] / tcol, dim=-1).gather(
                        -1, props[..., None])[..., 0]
                    q_d = torch.softmax(dreal_all / tcol, dim=-1).gather(
                        -1, props[..., None])[..., 0]
                    u = torch.zeros((S, k), device=dev)
                    for s in samplers:
                        u[s] = torch.rand(k, generator=gens[s], device=dev)
                    samp_ok = u * q_d.clamp(min=1e-30) < p_d
                    ok = torch.where(ops.greedy[:, None], ok, samp_ok)
                ok = ok & on[:, None] & act[:, None]
                a = torch.cumprod(ok.long(), dim=1).sum(dim=1)   # [S] in 0..k
                full = a == k
                adv = (1 + a) * ops.adv

                # The replacement at the rejection point: a draw from the
                # residual max(p - q, 0) keeps the emitted distribution the
                # target's (greedy: the target's argmax).
                t_at_a = treal.gather(
                    1, a[:, None, None].expand(S, 1, V))[:, 0]   # [S, V]
                repl = t_at_a.argmax(dim=-1)
                if samplers:
                    q_at_a = dreal_all.gather(1, a.clamp(max=k - 1)[
                        :, None, None].expand(S, 1, V))[:, 0]
                    p_a = torch.softmax(t_at_a / ops.temp_safe, dim=-1)
                    q_a = torch.softmax(q_at_a / ops.temp_safe, dim=-1)
                    resid = (p_a - q_a).clamp(min=0.0)
                    rsum = resid.sum(dim=-1, keepdim=True)
                    resid = torch.where(rsum > 0, resid / rsum, p_a)
                    logp = torch.log(resid + 1e-30)
                    r_samp = (logp + _gumbel(logp, samplers, gens)).argmax(
                        dim=-1)
                    repl = torch.where(ops.greedy, repl, r_samp)

                tail = torch.where(act, verify.gather(1, a[:, None])[:, 0],
                                   tail)
                pending = torch.where(act, repl, pending)
                # A spec-on slot that rejected carries the residual draw as
                # next step's n0; a fully accepted slot refreshes `last` from
                # verify row k. A spec-OFF slot never really rejected (the
                # gate force-fails acceptance), so the residual draw would
                # be the WRONG distribution: it refreshes `last` from verify
                # row 0 (its n0's logits, the plain decode chain) and drops
                # any pending carry.
                use_pending = torch.where(act, ~full & on, use_pending)
                refresh = act & (full | ~on)
                row_idx = torch.where(on, k, 0)
                row = logits.gather(1, row_idx[:, None, None].expand(
                    S, 1, logits.shape[-1]))[:, 0]
                last = torch.where(refresh[:, None], row, last)
                lens = lens + adv.to(torch.int32)
                toks.append(verify)
                counts.append(adv)
                accepted.append(a * ops.adv)
            i32 = torch.int32
            return (torch.stack(toks, dim=1).to(i32),
                    torch.stack(counts, dim=1).to(i32),
                    torch.stack(accepted, dim=1).to(i32),
                    k_pool, v_pool, kd_pool, vd_pool, last, gens,
                    tail.to(i32), pending.to(i32), use_pending)

        return spec_decode

    def copy_fn(self):
        """copy_block(k_pool, v_pool, src, dst) -> (k_pool, v_pool): the
        copy-on-write primitive — duplicate one shared block into a private
        block (every layer) before divergent writes."""

        def copy_block(k_pool, v_pool, src, dst):
            k_pool[:, int(dst)] = k_pool[:, int(src)]
            v_pool[:, int(dst)] = v_pool[:, int(src)]
            return k_pool, v_pool

        return copy_block

    def extract_fn(self, nb: int):
        """extract(k_pool, v_pool, block_ids [nb]) -> (k [L,nb,bt,H,Dh], v):
        gather a finished prefill's blocks for the disaggregation handoff
        into new tensors on the pool's device; the pools are left as they
        are (the prefill engine keeps serving its prefix cache from them)."""

        def extract(k_pool, v_pool, block_ids):
            ids = torch.as_tensor(np.asarray(block_ids, np.int64),
                                  device=k_pool.device)
            if ids.shape != (nb,):
                raise ValueError(f"extract of {nb} blocks got ids of shape "
                                 f"{tuple(ids.shape)}")
            return k_pool[:, ids], v_pool[:, ids]

        return extract

    def insert_fn(self, nb: int):
        """insert(k_pool, v_pool, k [L,nb,bt,H,Dh], v, block_ids [nb]) ->
        (k_pool, v_pool): write handed-off blocks into the pools IN PLACE
        (JAX donates the pools and rebinds them; here the tensors every
        table, operand and kernel call holds are the ones written). ``k``
        and ``v`` may lie on another device (the lane's host views): they
        are copied to the pool's device first."""

        def insert(k_pool, v_pool, k, v, block_ids):
            ids = torch.as_tensor(np.asarray(block_ids, np.int64),
                                  device=k_pool.device)
            if ids.shape != (nb,) or tuple(k.shape[1:2]) != (nb,):
                raise ValueError(f"insert of {nb} blocks got ids of shape "
                                 f"{tuple(ids.shape)} and k of shape "
                                 f"{tuple(k.shape)}")
            k_pool.index_copy_(1, ids, torch.as_tensor(k).to(k_pool.device))
            v_pool.index_copy_(1, ids, torch.as_tensor(v).to(v_pool.device))
            return k_pool, v_pool

        return insert

    def set_last_fn(self):
        """set_last(last, gens, row [V], slot, seed) -> (last, gens): park a
        next-token logits row and seed the slot's generator."""

        def set_last(last, gens, row, slot, seed):
            last[int(slot)] = torch.as_tensor(np.asarray(row, np.float32),
                                              device=self.device)
            gens[int(slot)].manual_seed(int(seed))
            return last, gens

        return set_last


class NoFreeBlocks(RuntimeError):
    """The pool cannot supply an allocation even after evicting every
    unpinned cached block — the caller should keep the request queued."""


class KVBlockManager:
    """Host-side bookkeeping for the paged KV pool: free list, refcounts,
    and the prefix-reuse hash table. A copy of the JAX package's manager.

    Block states (block 0, the trash block, is never managed):

    - FREE: on ``_free``, content garbage;
    - ACTIVE: refcount > 0, pinned by one or more live sequences;
    - CACHED: refcount 0 but hash-retained — the block's content is a
      registered prefix and future lookups may hit it; evicted LRU-first
      when the free list runs dry.

    Full blocks are keyed by the chained digest of the token prefix ending
    at them (``util.blockhash``); a retired sequence's PARTIAL tail block is
    additionally keyed by ``(parent_digest, tail_token_tuple)`` so a
    follow-up turn can reuse it — hit tail blocks are handed out
    COPY-ON-WRITE (the engine duplicates them via
    ``PagedGenerator.copy_fn`` before the divergent suffix writes into
    them); full hit blocks are read-only to every sharer.

    Thread-safe behind one internal lock; never calls out while holding it
    (safe under the engine's state lock — lock order: engine state → here).
    """

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks < 2:
            raise ValueError("pool needs at least one block beyond trash")
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self._lock = threading.Lock()
        self._free = collections.deque(range(1, num_blocks))
        self._ref: Dict[int, int] = {}
        self._by_hash: Dict[bytes, int] = {}       # full-block digest -> id
        self._hash_of: Dict[int, bytes] = {}
        self._tail_by_key: Dict[tuple, int] = {}   # (parent, tokens) -> id
        self._tail_key_of: Dict[int, tuple] = {}
        # CACHED blocks in LRU order (oldest first).
        self._cached: "Dict[int, None]" = {}
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.cow_copies = 0

    # -- allocation -----------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks off the free list, evicting LRU cached blocks
        (dropping their hash entries) as needed; raises :class:`NoFreeBlocks`
        without side effects when the pool can't supply them."""
        with self._lock:
            if len(self._free) + len(self._cached) < n:
                raise NoFreeBlocks(
                    f"need {n} blocks; {len(self._free)} free + "
                    f"{len(self._cached)} cached of {self.num_blocks - 1}")
            out = []
            for _ in range(n):
                if self._free:
                    b = self._free.popleft()
                else:
                    b = next(iter(self._cached))   # LRU head
                    self._drop_cached_locked(b)
                self._ref[b] = 1
                out.append(b)
            return out

    def _drop_cached_locked(self, b: int) -> None:
        self._cached.pop(b, None)
        d = self._hash_of.pop(b, None)
        if d is not None and self._by_hash.get(d) == b:
            del self._by_hash[d]
        tk = self._tail_key_of.pop(b, None)
        if tk is not None and self._tail_by_key.get(tk) == b:
            del self._tail_by_key[tk]

    def release(self, block_ids: Sequence[int]) -> None:
        """Unpin blocks; at refcount 0 a hash-registered block becomes
        CACHED (reusable, LRU-evictable), an unregistered one goes straight
        back to the free list."""
        with self._lock:
            for b in block_ids:
                r = self._ref.get(b, 0) - 1
                if r > 0:
                    self._ref[b] = r
                    continue
                self._ref.pop(b, None)
                if b in self._hash_of or b in self._tail_key_of:
                    self._cached.pop(b, None)
                    self._cached[b] = None         # move to MRU end
                else:
                    self._free.append(b)

    # -- prefix reuse ---------------------------------------------------------
    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], Optional[int], int]:
        """Longest reusable prefix of ``tokens``: returns ``(full_blocks,
        tail_block, hit_len)`` with every returned block PINNED (caller must
        ``release`` them with the sequence). hit_len is capped at
        ``len(tokens) - 1`` so at least one suffix token is always
        recomputed — prefill must produce last-token logits.

        ``tail_block`` is SHARED CONTENT: the caller must copy it before
        writing (COW)."""
        bt = self.block_tokens
        cap = len(tokens) - 1
        if cap <= 0:
            return [], None, 0
        digests = blockhash.block_hashes(tokens, bt, max_blocks=cap // bt)
        with self._lock:
            full: List[int] = []
            parent = blockhash.SEED
            for d in digests:
                b = self._by_hash.get(d)
                if b is None:
                    break
                full.append(b)
                parent = d
            k = len(full)
            hit_len = k * bt
            tail = None
            for t in range(min(bt - 1, cap - hit_len), 0, -1):
                key = (parent, tuple(int(x) for x in
                                     tokens[hit_len:hit_len + t]))
                b = self._tail_by_key.get(key)
                if b is not None:
                    tail = b
                    hit_len += t
                    break
            for b in full + ([tail] if tail is not None else []):
                if self._ref.get(b, 0) == 0:
                    self._cached.pop(b, None)      # CACHED -> ACTIVE
                self._ref[b] = self._ref.get(b, 0) + 1
            self.hit_tokens += hit_len
            self.miss_tokens += len(tokens) - hit_len
            return full, tail, hit_len

    def register_chain(self, tokens: Sequence[int], block_ids: Sequence[int],
                       n_real: int) -> None:
        """Publish a sequence's blocks into the reuse table: every block
        fully covered by the first ``n_real`` REAL tokens gets its chained
        digest, and the partial remainder (if any) gets a tail entry. First
        registration wins."""
        bt = self.block_tokens
        n_full = min(n_real // bt, len(block_ids))
        digests = blockhash.block_hashes(tokens[:n_real], bt,
                                         max_blocks=n_full)
        with self._lock:
            parent = blockhash.SEED
            for i, d in enumerate(digests):
                b = block_ids[i]
                if d not in self._by_hash and b not in self._hash_of \
                        and b not in self._tail_key_of:
                    self._by_hash[d] = b
                    self._hash_of[b] = d
                parent = d
            t = n_real - n_full * bt
            if t > 0 and n_full < len(block_ids):
                b = block_ids[n_full]
                key = (parent, tuple(int(x) for x in
                                     tokens[n_full * bt:n_real]))
                if key not in self._tail_by_key and b not in self._hash_of \
                        and b not in self._tail_key_of:
                    self._tail_by_key[key] = b
                    self._tail_key_of[b] = key

    def peek_hit_len(self, tokens: Sequence[int]) -> int:
        """Advisory hit length: same walk as :meth:`lookup` but pins nothing
        and skips the counters — the engine's admission-budget estimate."""
        bt = self.block_tokens
        cap = len(tokens) - 1
        if cap <= 0:
            return 0
        digests = blockhash.block_hashes(tokens, bt, max_blocks=cap // bt)
        with self._lock:
            hit_len = 0
            parent = blockhash.SEED
            for d in digests:
                if d not in self._by_hash:
                    break
                hit_len += bt
                parent = d
            for t in range(min(bt - 1, cap - hit_len), 0, -1):
                key = (parent, tuple(int(x) for x in
                                     tokens[hit_len:hit_len + t]))
                if key in self._tail_by_key:
                    return hit_len + t
            return hit_len

    def pin(self, block_ids: Sequence[int]) -> None:
        """Refcount-bump blocks the caller already holds ids for (CACHED ->
        ACTIVE as needed)."""
        with self._lock:
            for b in block_ids:
                if self._ref.get(b, 0) == 0:
                    self._cached.pop(b, None)
                self._ref[b] = self._ref.get(b, 0) + 1

    def pin_chain(self, tokens: Sequence[int],
                  n_real: int) -> Tuple[List[int], int]:
        """Pin a registered chain EXACTLY as :meth:`register_chain` laid it
        out: every full block of ``tokens[:n_real]`` plus the exact partial
        tail entry. Returns ``(pinned_ids, covered_tokens)`` — empty when
        even the first block is gone (counters untouched)."""
        bt = self.block_tokens
        n_full = n_real // bt
        digests = blockhash.block_hashes(tokens[:n_real], bt,
                                         max_blocks=n_full)
        with self._lock:
            ids: List[int] = []
            parent = blockhash.SEED
            for d in digests:
                b = self._by_hash.get(d)
                if b is None:
                    break
                ids.append(b)
                parent = d
            covered = len(ids) * bt
            if len(ids) == n_full and n_real > covered:
                key = (parent, tuple(int(x) for x in
                                     tokens[covered:n_real]))
                b = self._tail_by_key.get(key)
                if b is not None:
                    ids.append(b)
                    covered = n_real
            for b in ids:
                if self._ref.get(b, 0) == 0:
                    self._cached.pop(b, None)      # CACHED -> ACTIVE
                self._ref[b] = self._ref.get(b, 0) + 1
            return ids, covered

    def note_cow(self) -> None:
        with self._lock:
            self.cow_copies += 1

    # -- introspection --------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        with self._lock:
            active = len(self._ref)
            return {
                "kv_blocks_total": float(self.num_blocks - 1),
                "kv_blocks_active": float(active),
                "kv_blocks_cached": float(len(self._cached)),
                "kv_blocks_free": float(len(self._free)),
                "kv_hit_tokens": float(self.hit_tokens),
                "kv_miss_tokens": float(self.miss_tokens),
                "kv_cow_copies": float(self.cow_copies),
            }

    def active_blocks(self) -> int:
        """Blocks pinned by live sequences — must drop to 0 when every
        request retires (the leak-check invariant)."""
        with self._lock:
            return len(self._ref)


class Generator:
    """Prefill + decode over a private cache for one (config, batch,
    max_len) shape: the single-sequence oracle the serving engines are held
    to.

    - :meth:`generate` runs one token a step and hands each to the host as
      it is picked: one token per yield is the oracle's contract.
    - :meth:`chunked_fns` fuses a prefill with ``chunk`` decode steps (JAX:
      one ``lax.scan`` dispatch; here a Python loop of device work whose
      tokens come back as one tensor).

    ``device`` defaults to the card; ``device="cpu"`` runs on the CPU. The
    parameters are moved there and cast to the compute dtype once.
    """

    def __init__(self, params, config: TransformerConfig, *, batch: int = 1,
                 max_len: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device, config.dtype)
        self.config = config
        self.batch = batch
        self.max_len = max_len or config.max_seq_len
        self._chunked = {}  # (chunk, sampled) -> (prefill_decode, decode)

    def _prefill(self, params, cache, tokens):
        return _forward_cached(params, tokens, cache, self.config, 0)

    def _decode(self, params, cache, token, pos):
        logits, cache = _forward_cached(params, token, cache, self.config, pos)
        return logits[:, -1], cache

    def _pick(self, last, temp: float, gen: Optional[torch.Generator]):
        """Next tokens [B] from ``last``: argmax, or with ``gen`` a sample
        of softmax(last / temp) (the vocab padding masked off)."""
        real = last[:, :self.config.vocab_size]
        if gen is None:
            return real.argmax(dim=-1)
        rows = range(real.shape[0])
        return (real / temp + _gumbel(real, rows, [gen] * len(rows))).argmax(
            dim=-1)

    def chunked_fns(self, chunk: int, sampled: bool):
        """(prefill_decode, decode_chunk) for a chunk size:

        prefill_decode(params, cache, padded [B,P], real_len, rng, temp) and
        decode_chunk(params, cache, last, pos, rng, temp) each return (toks
        [B, chunk] int32, last, cache, pos, rng); ``rng`` is a
        ``torch.Generator`` (unused when not ``sampled``). Prefill reads the
        first logits at the REAL last position and decoding starts at
        ``real_len``, so pad K/V is overwritten before the causal mask could
        expose it."""
        key = (chunk, sampled)
        if key in self._chunked:
            return self._chunked[key]
        c = self.config

        def steps(params, cache, last, pos, rng, temp):
            toks = []
            for _ in range(chunk):
                nxt = self._pick(last, temp, rng if sampled else None)
                logits, cache = _forward_cached(params, nxt[:, None], cache,
                                                c, pos)
                last, pos = logits[:, -1], pos + 1
                toks.append(nxt)
            return (torch.stack(toks, dim=1).to(torch.int32), last, cache,
                    pos, rng)

        def prefill_decode(params, cache, padded, real_len, rng, temp):
            tokens = torch.as_tensor(np.asarray(padded, np.int64),
                                     device=self.device)
            logits, cache = _forward_cached(params, tokens, cache, c, 0)
            return steps(params, cache, logits[:, int(real_len) - 1],
                         int(real_len), rng, temp)

        def decode_chunk(params, cache, last, pos, rng, temp):
            return steps(params, cache, last, int(pos), rng, temp)

        self._chunked[key] = (prefill_decode, decode_chunk)
        return self._chunked[key]

    def generate(self, prompt_tokens, *, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 stream: bool = False):
        """Greedy (temperature=0) or sampled generation of row 0. Returns
        the token list (or, with ``stream``, a generator of tokens)."""

        def run():
            prompt = torch.as_tensor(
                np.asarray(prompt_tokens, np.int64).reshape(self.batch, -1),
                device=self.device)
            P = prompt.shape[1]
            cache = init_cache(self.config, self.batch, self.max_len,
                               self.device)
            logits, cache = self._prefill(self.params, cache, prompt)
            gen = (torch.Generator(device=self.device).manual_seed(int(seed))
                   if temperature > 0 else None)
            last = logits[:, -1]
            pos = P
            for _ in range(max_new_tokens):
                nxt = self._pick(last, temperature, gen)
                # One host read a token: the oracle's contract (the engines
                # read once a chunk).
                yield int(nxt[0])
                if pos >= self.max_len:
                    return
                last, cache = self._decode(self.params, cache, nxt[:, None],
                                           pos)
                pos += 1

        if stream:
            return run()
        return list(run())

"""Paged generation: the serving engine's device half, and its block manager.

Counterpart of the paged part of ``ray_tpu/models/generate.py``. K/V lives
in a SHARED pool of ``block_tokens``-sized blocks addressed through
per-sequence block tables; the prefill and decode forwards write the new
tokens' K/V into the pool first and then attend through the tables with
``ops.paged_attention`` (the CUDA kernel on the card).

Where JAX clamps or drops an out-of-range index, torch raises or
device-asserts, so every JAX clamp is written out here: the table lookup
``clip(pos // bt, 0, NB-1)``, the ``write_ok`` redirect of pad and overhang
writes to trash block 0, and the ``pos_embed`` clamp at ``max_seq_len - 1``.
Duplicate scatter targets (pads and inactive slots all hit block 0) are
harmless: nothing live reads block 0.

JAX threads the pools through donated buffers; here the pools are updated
IN PLACE and the functions return the same tensors. The JAX ``lax.scan``
over a decode chunk is a Python loop issuing device work; argmax and
sampling stay on the device and a chunk ends with one host copy of its
tokens (done by the engine).

Not in this slice: the slotted generator, the single-sequence ``Generator``,
speculative decoding (``draft_prefill_fn``/``spec_decode_fn``) and the
disaggregation/KV-tier block transfer (``extract_fn``/``insert_fn``).
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

    Sampled streams are deterministic for a seed, but they are not the JAX
    engine's (torch's generators are not threefry); greedy streams match it
    token for token.
    """

    def __init__(self, params, config: TransformerConfig, *, slots: int,
                 num_blocks: int, block_tokens: int, device,
                 max_len: Optional[int] = None,
                 attention_kernel: str = "auto"):
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
        self.logits_dim = (params["tok_embed"].shape[0]
                           if config.tie_embeddings
                           else params["lm_head"].shape[-1])
        # Forward passes run, for the engine's launch accounting: one per
        # prefill dispatch, one per decode step.
        self.prefill_forwards = 0
        self.decode_forwards = 0

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
            dev = self.device
            active = np.asarray(active, bool)
            greedy = np.asarray(greedy, bool)
            tables_t = self._i32(tables)
            lens = self._i32(lengths)
            adv = self._i32(active)
            act_col = torch.as_tensor(active, device=dev)[:, None]
            greedy_t = torch.as_tensor(greedy, device=dev)
            temp_safe = torch.as_tensor(
                np.maximum(np.asarray(temps, np.float32), 1e-6),
                device=dev)[:, None]
            # Only active sampled slots draw: a request's stream depends on
            # its own seed and logits, never on its neighbours.
            samplers = [s for s in range(self.slots)
                        if active[s] and not greedy[s]]
            toks = []
            for _ in range(chunk):
                real = last[:, :V]
                nxt = real.argmax(dim=-1)
                if samplers:
                    # Gumbel-max sampling from softmax(real / temp).
                    gumbel = torch.zeros_like(real)
                    for s in samplers:
                        u = torch.rand(V, generator=gens[s], device=dev)
                        gumbel[s] = -torch.log(-torch.log(u))
                    samp = (real / temp_safe + gumbel).argmax(dim=-1)
                    nxt = torch.where(greedy_t, nxt, samp)
                logits, k_pool, v_pool = _forward_decode_paged(
                    params, nxt[:, None], k_pool, v_pool, tables_t, lens, c,
                    bt, kernel=kernel)
                self.decode_forwards += 1
                lens = lens + adv
                last = torch.where(act_col, logits[:, -1], last)
                toks.append(nxt)
            return (torch.stack(toks, dim=1).to(torch.int32), k_pool, v_pool,
                    last, gens)

        return paged_decode

    def copy_fn(self):
        """copy_block(k_pool, v_pool, src, dst) -> (k_pool, v_pool): the
        copy-on-write primitive — duplicate one shared block into a private
        block (every layer) before divergent writes."""

        def copy_block(k_pool, v_pool, src, dst):
            k_pool[:, int(dst)] = k_pool[:, int(src)]
            v_pool[:, int(dst)] = v_pool[:, int(src)]
            return k_pool, v_pool

        return copy_block

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

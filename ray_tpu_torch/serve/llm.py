"""LLM serving — the continuous-batching paged KV-cache engine.

Counterpart of ``ray_tpu/serve/llm.py`` for this slice: the iteration-level
scheduler (:class:`LLMEngine`) and the paged engine with prefix reuse
(:class:`PagedLLMEngine`), on PyTorch tensors with the paged-attention CUDA
kernel on the card.

Scheduling is iteration-level (the vLLM/Orca policy): each engine step

1. retires finished slots (max_new_tokens reached, or no room for another
   chunk before ``max_len`` — ``length_cap``) and immediately
2. admits queued prompts into the free slots, bounded by a prefill token
   budget per step (``serve_llm_prefill_tokens``), then
3. runs ONE batched decode chunk and distributes each slot's tokens to its
   request's queue; the chunk's tokens come to the host in one copy.

There is no engine thread: the step loop is driven by whichever request
thread wins a non-blocking try-lock (``drive``). Every device call happens
under ``_step_lock``; the admission path touches host state only.
Admission control sheds with :class:`~ray_tpu_torch.serve.errors.Saturated`
once ``max_queue`` requests are already waiting.

Not in this slice (see ROADMAP.md): the slotted engine, speculative
decoding, the cluster KV tier, prefill/decode disaggregation, the Serve
deployment (``llm_deployment``), tracing spans, metrics export and the
steady-state guard, each marked where it would sit.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from ray_tpu_torch.core.config import config as _get_config
from ray_tpu_torch.models.generate import (KVBlockManager, NoFreeBlocks,
                                           PagedGenerator)
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.serve.errors import Saturated
from ray_tpu_torch.utils.device import resolve_device
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.llm")


def _default_buckets(max_len: int) -> List[int]:
    buckets, b = [], 16
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


def _check_token_ids(prompt: np.ndarray, vocab: int, name: str) -> None:
    """Reject out-of-range token ids at admission. An out-of-range embedding
    lookup device-asserts on the card and, with a SHARED paged pool, garbage
    written by one request outlives it — a bad id must never reach the
    device."""
    if int(prompt.min()) < 0 or int(prompt.max()) >= vocab:
        raise ValueError(
            f"engine {name}: prompt token ids must be in [0, {vocab})")


def _shed(name: str, depth: int, limit: int, what: str) -> Saturated:
    """Build the engine-queue-full :class:`Saturated`: ``retry_after_s``
    estimates the queue's drain time at one admitted-item service time per
    waiting request. (The shed counter of the metrics pipeline comes with
    the metrics slice.)"""
    try:
        retry = depth * _get_config().serve_retry_after_item_s
    except ValueError:  # a malformed env override: the hint is advisory
        retry = None
    return Saturated(
        f"engine {name}: {depth} requests {what} "
        f"(serve_admission_queue_limit={limit})",
        retry_after_s=retry)


class _Request:
    """One in-flight generation: its token queue, slot, and counters."""

    __slots__ = (
        "prompt", "padded", "real_len", "bucket", "max_new", "temperature",
        "seed", "tokens", "cond", "slot", "emitted", "done", "cancelled",
        "error", "finish_reason", "decode_tokens", "decode_seconds",
        "submitted_at", "ttft_s", "queued_s", "prefill_s", "out_ids",
        "hit_tokens",
    )

    def __init__(self, prompt, padded, real_len, bucket, max_new,
                 temperature, seed, cond):
        self.prompt = prompt
        self.padded = padded
        self.real_len = real_len
        self.bucket = bucket
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.tokens: collections.deque = collections.deque()
        self.cond = cond
        self.slot: Optional[int] = None
        self.emitted = 0
        self.done = False
        self.cancelled = False
        self.error: Optional[BaseException] = None
        self.finish_reason: Optional[str] = None
        self.decode_tokens = 0
        self.decode_seconds = 0.0
        self.submitted_at = time.perf_counter()
        self.ttft_s: Optional[float] = None
        # TTFT decomposition: submit→admission and the prefill dispatch.
        self.queued_s = 0.0
        self.prefill_s = 0.0
        # Every delivered token id, in order — the paged engine registers
        # the finished prompt+output chain in the prefix cache at retire.
        self.out_ids: List[int] = []
        self.hit_tokens = 0

    def decode_tps(self) -> float:
        if self.decode_seconds == 0:
            return 0.0
        return self.decode_tokens / self.decode_seconds


class LLMEngine:
    """Continuous-batching scheduler: S cache slots, caller-driven stepping.

    Concurrency comes from calling ``stream`` from many threads — their
    sequences SHARE the batched decode dispatches. The device half funnels
    through the hooks below; :class:`PagedLLMEngine` implements them. (The
    JAX package's slotted device half is not ported yet, so this class is
    not used on its own.)
    """

    def __init__(self, params, config: TransformerConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 max_len: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 chunk: int = 8,
                 slots: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 name: str = "LLM"):
        knobs = _get_config()
        self.device = resolve_device(device)
        self.config = config
        # Parameters are cast to the compute dtype once, here: the forwards
        # cast at every use as the JAX ones do, which is then a no-op, and
        # the rounding is the same.
        self.params = _to_device(params, self.device, config.dtype)
        self.max_len = max_len or config.max_seq_len
        self.buckets = sorted(prompt_buckets or _default_buckets(self.max_len))
        self.chunk = chunk
        self.slots = int(slots if slots is not None else knobs.serve_llm_slots)
        self.max_queue = int(max_queue if max_queue is not None
                             else knobs.serve_admission_queue_limit)
        self.prefill_budget = int(knobs.serve_llm_prefill_tokens)
        self.name = name
        self._init_device()

        # Lock order: _step_lock (try-acquired, never under others) →
        # _state_lock (request/slot bookkeeping; also every req.cond) →
        # _agg_lock. Device dispatches happen holding only _step_lock.
        self._step_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._agg_lock = threading.Lock()

        self._waiting: collections.deque = collections.deque()
        self._slot_req: List[Optional[_Request]] = [None] * self.slots
        self._slot_len = [0] * self.slots  # host mirror of device lengths
        self._active = np.zeros(self.slots, bool)
        self._greedy = np.ones(self.slots, bool)
        self._temps = np.zeros(self.slots, np.float32)

        # Aggregate decode counters; the per-request truth lives on each
        # _Request.
        self.decode_tokens = 0
        self.decode_seconds = 0.0
        self.finish_reason = "stop"  # convenience; races under concurrency

    # -- device-half hooks ----------------------------------------------------
    def _init_device(self) -> None:
        raise NotImplementedError(
            "the slotted engine is not ported yet; use PagedLLMEngine")

    def _reset_device_state(self) -> None:
        raise NotImplementedError

    def _admission_cost(self, req: _Request) -> int:
        """Prefill tokens this admission charges against the step budget
        (called under _state_lock)."""
        return req.bucket

    def _dispatch_prefill(self, req: _Request, slot: int) -> None:
        """Run the prompt's prefill into ``slot``. May raise
        :class:`NoFreeBlocks` — the scheduler requeues the request at the
        head and stops admitting this step."""
        raise NotImplementedError

    def _decode_operands_locked(self):
        """Extra decode operands snapshotted under _state_lock (the paged
        engine's block tables/lengths)."""
        return None

    def _run_decode(self, active, greedy, temps, extra):
        """One decode chunk; returns the [S, chunk] tokens on the device."""
        raise NotImplementedError

    def _slot_result(self, host_toks, slot: int):
        """The step's emitted tokens for ``slot`` plus its device-length
        advance. Called under _state_lock."""
        return [int(t) for t in host_toks[slot][:self.chunk]], self.chunk

    def _release_slot_device(self, slot: int) -> None:
        """Per-slot device-side cleanup when a slot frees (paged: unpin the
        slot's blocks). Called under _state_lock; must be idempotent."""

    def _on_retire_locked(self, req: _Request) -> None:
        """A request finished cleanly and still owns its slot (paged:
        publish its prefix into the reuse cache). Called under _state_lock
        just before the slot frees."""

    def _discard_request_locked(self, req: _Request) -> None:
        """A request is leaving the engine WITHOUT owning a slot."""

    # -- public single-request surface ---------------------------------------
    def warmup(self) -> None:
        raise NotImplementedError

    def _bucket_for(self, n: int) -> int:
        # One full decode chunk must fit after the prompt: decode always
        # advances in `chunk`-token dispatches, and a slot with no room for
        # one retires as length_cap before emitting anything.
        if n + self.chunk > self.max_len:
            raise ValueError(
                f"prompt of {n} tokens leaves no room for a {self.chunk}-token "
                f"decode chunk within max_len {self.max_len}")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt of {n} tokens exceeds max_len {self.max_len}")

    def stream(self, prompt_ids: Sequence[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0, seed: int = 0,
               result: Optional[Dict] = None) -> Iterable[int]:
        """Yield generated token ids for ONE request, decoded in shared
        batched chunks with every other in-flight request.

        ``result``, if given, receives ``{"finish_reason", "decode_tps",
        "ttft_s"}`` — per-request values."""
        if result is None:
            result = {}
        req = self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                          temperature=temperature, seed=seed)

        def run():
            try:
                for tok in self.drive(req):
                    result["decode_tps"] = req.decode_tps()
                    yield tok
            finally:
                result["finish_reason"] = self.finish_reason = (
                    req.finish_reason or "stop")
                if req.ttft_s is not None:
                    result["ttft_s"] = req.ttft_s

        gen = run()
        # Submitted EAGERLY (Saturated raises at call time), but an abandoned
        # generator that never started skips drive()'s cancel-in-finally;
        # the finalizer unqueues it at collection.
        weakref.finalize(gen, self._cancel, req)
        return gen

    def generate(self, prompt_ids: Sequence[int], **kw) -> List[int]:
        return list(self.stream(prompt_ids, **kw))

    # -- request lifecycle ----------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0, seed: int = 0) -> _Request:
        """Validate + enqueue; raises :class:`Saturated` when ``max_queue``
        requests are already waiting for a slot (0 disables shedding)."""
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        real_len = int(prompt.shape[0])
        if real_len == 0:
            raise ValueError("empty prompt")
        _check_token_ids(prompt, self.config.vocab_size, self.name)
        prompt = prompt.astype(np.int32)
        bucket = self._bucket_for(real_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :real_len] = prompt
        req = _Request(prompt, padded, real_len, bucket, int(max_new_tokens),
                       float(temperature), int(seed),
                       threading.Condition(self._state_lock))
        if max_new_tokens <= 0:
            req.done = True
            req.finish_reason = "stop"
            return req
        with self._state_lock:
            if self.max_queue and len(self._waiting) >= self.max_queue:
                raise _shed(self.name, len(self._waiting), self.max_queue,
                            "already waiting")
            self._waiting.append(req)
        return req

    def drive(self, req: _Request) -> Iterable[int]:
        """Yield ``req``'s tokens, stepping the engine whenever this thread
        wins the step try-lock (otherwise another request's thread is the
        driver and this one waits on its queue). Abandoning the generator
        cancels the request and frees its slot."""
        try:
            while True:
                with self._state_lock:
                    out = list(req.tokens)
                    req.tokens.clear()
                    done, err = req.done, req.error
                for tok in out:
                    yield tok
                if err is not None:
                    raise err
                if done:
                    return
                if self._step_lock.acquire(False):
                    try:
                        self._step()
                    finally:
                        self._step_lock.release()
                else:
                    with self._state_lock:
                        if not req.tokens and not req.done:
                            # Timed slice as a safety net only: the exiting
                            # driver hands off via _wake_inflight, and token
                            # arrival notifies directly. req.cond wraps
                            # _state_lock, so wait() releases it.
                            req.cond.wait(timeout=0.01)
        finally:
            self._cancel(req)
            # Driver handoff: wake every in-flight request so one of them
            # re-elects immediately instead of waiting out a poll slice.
            self._wake_inflight()

    def _wake_inflight(self) -> None:
        with self._state_lock:
            for r in self._slot_req:
                if r is not None:
                    r.cond.notify_all()
            for r in self._waiting:
                r.cond.notify_all()

    def _cancel(self, req: _Request) -> None:
        """No-op on a finished request; otherwise unqueue/mark-cancelled and
        free its slot for the next admission."""
        with self._state_lock:
            if req.done:
                return
            req.cancelled = True
            try:
                self._waiting.remove(req)
            except ValueError:
                pass
            if req.slot is not None:
                self._free_slot_locked(req.slot)
            else:
                self._discard_request_locked(req)
            req.done = True
            if req.finish_reason is None:
                req.finish_reason = "cancelled"
            req.cond.notify_all()

    def _free_slot_locked(self, slot: int) -> None:
        self._release_slot_device(slot)
        r = self._slot_req[slot]
        if r is not None:
            r.slot = None
        self._slot_req[slot] = None
        self._slot_len[slot] = 0
        self._active[slot] = False

    def _finish_locked(self, req: _Request, reason: str) -> None:
        req.finish_reason = reason
        req.done = True
        if req.slot is not None:
            self._on_retire_locked(req)
            self._free_slot_locked(req.slot)
        req.cond.notify_all()

    def _fail_inflight(self, err: BaseException) -> None:
        """A device-dispatch failure poisons every in-flight request: their
        cache state is gone. Reset to a fresh empty engine."""
        logger.error("engine %s: device step failed (%r); failing every "
                     "in-flight request and resetting the pool", self.name,
                     err)
        with self._state_lock:
            victims = list(self._waiting) + [r for r in self._slot_req
                                             if r is not None]
            for r in self._waiting:
                self._discard_request_locked(r)
            self._waiting.clear()
            for slot in range(self.slots):
                self._free_slot_locked(slot)
            for r in victims:
                r.error = err
                r.done = True
                if r.finish_reason is None:
                    r.finish_reason = "error"
                r.cond.notify_all()
        self._reset_device_state()

    # -- the iteration-level scheduler ----------------------------------------
    def _step(self) -> None:
        # Called holding _step_lock (the elected driver). The JAX engine runs
        # each post-warmup step under jitcheck.steady_state(); its torch twin
        # (a sync/recompile guard) comes with the devtools slice.
        try:
            self._step_inner()
        except BaseException as err:
            self._fail_inflight(err)
            raise

    def _step_inner(self) -> None:
        # 1. Retire: a slot whose next chunk would cross max_len ends as
        #    length_cap BEFORE dispatch, and cancelled slots free now.
        with self._state_lock:
            for slot in range(self.slots):
                req = self._slot_req[slot]
                if req is None:
                    continue
                if req.cancelled:
                    self._free_slot_locked(slot)
                elif self._slot_len[slot] + self.chunk > self.max_len:
                    self._finish_locked(req, "length_cap")

        # 2. Admit queued prompts into free slots under the prefill budget.
        #    The FIRST admission always goes through — the budget bounds how
        #    much prefill work piles into one step, never progress.
        admitted_tokens = 0
        while True:
            with self._state_lock:
                free = next((s for s in range(self.slots)
                             if self._slot_req[s] is None), None)
                if free is None or not self._waiting:
                    break
                nxt = self._waiting[0]
                cost = self._admission_cost(nxt)
                if admitted_tokens and (
                        admitted_tokens + cost > self.prefill_budget):
                    break
                self._waiting.popleft()
                if nxt.cancelled:
                    continue
                nxt.slot = free
                self._slot_req[free] = nxt
                self._slot_len[free] = nxt.real_len
                self._active[free] = True
                self._greedy[free] = nxt.temperature <= 0
                self._temps[free] = nxt.temperature if nxt.temperature > 0 else 0.0
            t_admit = time.perf_counter()
            try:
                self._dispatch_prefill(nxt, free)
            except NoFreeBlocks:
                # Pool exhausted even after cache eviction: requeue at the
                # head and stop admitting — in-flight retires free blocks.
                with self._state_lock:
                    self._free_slot_locked(free)
                    if not nxt.cancelled:
                        self._waiting.appendleft(nxt)
                break
            nxt.queued_s = t_admit - nxt.submitted_at
            nxt.prefill_s = time.perf_counter() - t_admit
            # (The llm.admission_wait / llm.prefill spans come with the
            # tracing slice.)
            admitted_tokens += cost

        with self._state_lock:
            if not any(r is not None for r in self._slot_req):
                return
            active = self._active.copy()
            greedy = self._greedy.copy()
            temps = self._temps.copy()
            extra = self._decode_operands_locked()

        # 3. One batched decode chunk advancing every active slot.
        t0 = time.perf_counter()
        toks = self._run_decode(active, greedy, temps, extra)
        host_toks = toks.cpu().numpy()  # the step's single device sync
        dt = time.perf_counter() - t0
        now = time.perf_counter()

        # 4. Distribute each slot's tokens to its request.
        delivered_total = 0
        with self._state_lock:
            for slot in range(self.slots):
                req = self._slot_req[slot]
                if req is None or not active[slot]:
                    continue
                emitted, adv = self._slot_result(host_toks, slot)
                self._slot_len[slot] += adv
                if req.cancelled:
                    self._free_slot_locked(slot)
                    continue
                upto = min(len(emitted), req.max_new - req.emitted)
                if upto > 0 and req.ttft_s is None:
                    req.ttft_s = now - req.submitted_at
                new_toks = emitted[:upto]
                req.tokens.extend(new_toks)
                req.out_ids.extend(new_toks)
                req.emitted += upto
                req.decode_tokens += upto
                req.decode_seconds += dt
                delivered_total += upto
                if req.emitted >= req.max_new:
                    self._finish_locked(req, "stop")
                else:
                    req.cond.notify_all()
        with self._agg_lock:
            self.decode_tokens += delivered_total
            self.decode_seconds += dt
        # (The llm.decode_chunk spans and the token/TTFT metrics of the JAX
        # engine's _observe come with the tracing and metrics slices.)

    # -- introspection --------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Slot occupancy + admission queue depth."""
        with self._state_lock:
            busy = sum(1 for r in self._slot_req if r is not None)
            depth = len(self._waiting)
        return {"slots_total": float(self.slots), "slots_busy": float(busy),
                "queue_depth": float(depth)}

    def decode_tokens_per_sec(self) -> float:
        with self._agg_lock:
            if self.decode_seconds == 0:
                return 0.0
            return self.decode_tokens / self.decode_seconds


def _to_device(tree, device: torch.device, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


class PagedLLMEngine(LLMEngine):
    """Continuous-batching engine over a PAGED KV cache with prefix reuse.

    Same scheduler and streaming contract as :class:`LLMEngine`; the device
    half is a shared pool of ``serve_kv_block_tokens``-sized KV blocks
    (:class:`~ray_tpu_torch.models.generate.PagedGenerator`) addressed
    through per-slot block tables, with a host-side
    :class:`~ray_tpu_torch.models.generate.KVBlockManager` doing refcounts
    and hash-based prefix reuse:

    - admission looks the prompt up in the block-hash table and prefills
      ONLY the uncached suffix (``start_pos = hit_len``);
    - a hit on a retired sequence's partial tail block is copy-on-write:
      the block is duplicated into a private block before the divergent
      suffix writes into it; full-block hits share by refcount alone;
    - at retire the finished prompt+output chain is registered so the NEXT
      turn of the conversation hits it;
    - pool exhaustion (after LRU-evicting unpinned cached blocks) requeues
      the request rather than failing it.

    ``device`` defaults to the card; ``device="cpu"`` runs the plain
    attention version on the CPU. Speculative decoding (``spec_tokens``,
    ``draft_params``) is not ported yet and raises.
    """

    def __init__(self, params, config: TransformerConfig, *,
                 block_tokens: Optional[int] = None,
                 pool_blocks: Optional[int] = None,
                 attention_kernel: Optional[str] = None,
                 draft_params=None,
                 draft_config: Optional[TransformerConfig] = None,
                 spec_tokens: Optional[int] = None, **kw):
        knobs = _get_config()
        if draft_params is not None or draft_config is not None or (
                spec_tokens or 0) > 0:
            raise NotImplementedError(
                "speculative decoding is not yet ported to ray_tpu_torch")
        self.block_tokens = int(block_tokens if block_tokens is not None
                                else knobs.serve_kv_block_tokens)
        self._pool_blocks_cfg = int(pool_blocks if pool_blocks is not None
                                    else knobs.serve_kv_pool_blocks)
        self.attention_kernel = str(
            attention_kernel if attention_kernel is not None
            else knobs.serve_paged_attention_kernel)
        super().__init__(params, config, **kw)

    # -- device-half hooks ----------------------------------------------------
    def _init_device(self) -> None:
        self.blocks_per_seq = -(-self.max_len // self.block_tokens)
        # Auto pool size: 2x a full slot set plus the trash block — half the
        # pool can idle as reusable prefix cache under full load.
        num_blocks = self._pool_blocks_cfg or (
            2 * self.slots * self.blocks_per_seq + 1)
        self._pg = PagedGenerator(self.params, self.config, slots=self.slots,
                                  num_blocks=num_blocks,
                                  block_tokens=self.block_tokens,
                                  device=self.device,
                                  max_len=self.max_len,
                                  attention_kernel=self.attention_kernel)
        self.kv = KVBlockManager(num_blocks, self.block_tokens)
        (self._k_pool, self._v_pool,
         self._last, self._gens) = self._pg.init_state()
        self._slot_table = np.zeros((self.slots, self.blocks_per_seq),
                                    np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(self.slots)]

    def _reset_device_state(self) -> None:
        (self._k_pool, self._v_pool,
         self._last, self._gens) = self._pg.init_state()
        # Pool contents are gone — the prefix cache resets with it.
        self.kv = KVBlockManager(self.kv.num_blocks, self.block_tokens)
        self._slot_table[:] = 0
        self._slot_blocks = [[] for _ in range(self.slots)]

    def warmup(self) -> None:
        """Run prefill for every bucket, a decode chunk, the COW copy and
        set_last once, then reset: the kernel is built and the allocator and
        cuBLAS are warm before the first request's TTFT."""
        with self._step_lock:
            zero_row = np.zeros(self.blocks_per_seq, np.int32)  # all trash
            for b in self.buckets:
                pf = self._pg.prefill_fn(b)
                (self._k_pool, self._v_pool, self._last, self._gens) = pf(
                    self.params, self._k_pool, self._v_pool, self._last,
                    self._gens, zero_row, np.zeros((1, b), np.int32),
                    0, b, 0, 0)
            df = self._pg.decode_fn(self.chunk)
            toks, self._k_pool, self._v_pool, self._last, self._gens = df(
                self.params, self._k_pool, self._v_pool, self._last,
                self._gens, np.zeros((self.slots, self.blocks_per_seq),
                                     np.int32),
                np.zeros(self.slots, np.int32), np.zeros(self.slots, bool),
                self._greedy, self._temps)
            toks.cpu()
            cf = self._pg.copy_fn()
            self._k_pool, self._v_pool = cf(self._k_pool, self._v_pool, 0, 0)
            sl = self._pg.set_last_fn()
            self._last, self._gens = sl(
                self._last, self._gens,
                np.zeros(self._last.shape[1], np.float32), 0, 0)
            self._reset_device_state()

    def _suffix_bucket(self, n: int) -> int:
        # The suffix prefill's bucket — unlike _bucket_for it needs no
        # decode-chunk headroom check (submit validated the full prompt).
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _admission_cost(self, req: _Request) -> int:
        hit = self.kv.peek_hit_len([int(t) for t in req.prompt])
        return self._suffix_bucket(max(1, req.real_len - hit))

    def _dispatch_prefill(self, req: _Request, slot: int) -> None:
        bt = self.block_tokens
        tokens = [int(t) for t in req.prompt]
        full, tail, hit_len = self.kv.lookup(tokens)
        try:
            # The table must cover every position this sequence can ever
            # write: the prompt plus whole decode chunks until max_new is
            # reached (the finishing chunk's spill past max_new still lands
            # in the pool).
            n_chunks = -(-req.max_new // self.chunk)
            max_written = min(self.max_len,
                              req.real_len + n_chunks * self.chunk)
            need = -(-max_written // bt)
            # Full-block hits are shared in place; a tail hit contributes
            # CONTENT only (its copy-on-write destination is a fresh block).
            fresh = self.kv.alloc(need - len(full))
        except NoFreeBlocks:
            self.kv.release(full + ([tail] if tail is not None else []))
            raise
        ids = list(full)
        if tail is not None:
            dst = fresh.pop(0)
            cf = self._pg.copy_fn()
            self._k_pool, self._v_pool = cf(self._k_pool, self._v_pool,
                                            int(tail), int(dst))
            self.kv.note_cow()
            self.kv.release([tail])  # pin the private copy, not the original
            ids.append(dst)
        ids.extend(fresh)
        row = np.zeros(self.blocks_per_seq, np.int32)
        row[:len(ids)] = ids
        req.hit_tokens = hit_len
        req.bucket = self._suffix_bucket(req.real_len - hit_len)

        suffix_len = req.real_len - hit_len
        padded = np.zeros((1, req.bucket), np.int32)
        padded[0, :suffix_len] = req.prompt[hit_len:]
        pf = self._pg.prefill_fn(req.bucket)
        (self._k_pool, self._v_pool, self._last, self._gens) = pf(
            self.params, self._k_pool, self._v_pool, self._last, self._gens,
            row, padded, hit_len, suffix_len, slot, req.seed)
        # Commit ATOMICALLY with the cancel path: this runs outside
        # _state_lock, so a concurrent _cancel may have freed the slot
        # mid-dispatch. Publishing the prompt's FULL blocks here (decode
        # writes only at positions >= real_len) lets a concurrent request
        # with the same prefix hit while this one still decodes.
        n_full_prompt = (req.real_len // bt) * bt
        with self._state_lock:
            if self._slot_req[slot] is not req or req.cancelled:
                self.kv.release(ids)  # slot lost mid-dispatch — drop the pins
                return
            self._slot_table[slot, :] = row
            self._slot_blocks[slot] = ids
            if n_full_prompt:
                self.kv.register_chain(tokens, ids, n_full_prompt)

    def _decode_operands_locked(self):
        return (self._slot_table.copy(),
                np.asarray(self._slot_len, np.int32))

    def _run_decode(self, active, greedy, temps, extra):
        tables, lengths = extra
        df = self._pg.decode_fn(self.chunk)
        (toks, self._k_pool, self._v_pool,
         self._last, self._gens) = df(
            self.params, self._k_pool, self._v_pool, self._last,
            self._gens, tables, lengths, active, greedy, temps)
        return toks

    def _release_slot_device(self, slot: int) -> None:
        ids = self._slot_blocks[slot]
        if ids:
            self._slot_blocks[slot] = []
            self._slot_table[slot, :] = 0
            self.kv.release(ids)

    def _on_retire_locked(self, req: _Request) -> None:
        ids = self._slot_blocks[req.slot] if req.slot is not None else []
        if not ids:
            return
        # Register the finished prompt+output chain (including a partial
        # tail entry) — the conversation's next turn extends exactly this
        # token sequence. Tokens past `emitted` (final-chunk spill) were
        # written to the pool but are NOT part of the chain.
        chain = [int(t) for t in req.prompt] + req.out_ids[:req.emitted]
        n_real = min(len(chain), len(ids) * self.block_tokens)
        self.kv.register_chain(chain, ids, n_real)

    # -- introspection --------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Slot occupancy, queue depth, pool state and prefix-cache counters,
        plus the forward passes run (``prefill_forwards``,
        ``decode_forwards``: each runs the attention once per layer)."""
        out = super().stats()
        out.update(self.kv.stats())
        out["prefill_forwards"] = float(self._pg.prefill_forwards)
        out["decode_forwards"] = float(self._pg.decode_forwards)
        return out

"""LLM serving — the continuous-batching engines on one device.

Counterpart of ``ray_tpu/serve/llm.py`` for this slice: the iteration-level
scheduler with its slotted device half (:class:`LLMEngine`, the
``serve_kv_paged_enabled=0`` engine) and the paged engine with prefix reuse
and speculative decoding (:class:`PagedLLMEngine`), on PyTorch tensors with
the paged-attention CUDA kernel on the card.

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

Prefill/decode disaggregation in one process
(:class:`DisaggregatedLLMEngine`) pairs two paged engines over a shm KV
handoff lane. Each engine step emits the request spans of
``util.tracing`` (``llm.admission_wait``, ``llm.prefill``,
``llm.decode_chunk``, ``llm.spec``) for sampled requests, and observes the
serve metrics of ``core.metrics_export`` (tokens, TTFT by phase, prefix hit
tokens, pool occupancy, speculation, sheds) in this process's registry.

Not in this slice (see ROADMAP.md): the cluster KV tier (``kv_tier_enabled``
raises), the Serve deployment (``llm_deployment``), the metrics exporter to
the GCS and the steady-state guard, each marked where it would sit.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from ray_tpu_torch.core import metrics_export
from ray_tpu_torch.core.config import config as _get_config
from ray_tpu_torch.models.generate import (KVBlockManager, NoFreeBlocks,
                                           PagedGenerator, SlottedGenerator,
                                           _to_device)
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.serve.errors import Saturated
from ray_tpu_torch.util import tracing
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
    """Build the engine-queue-full :class:`Saturated` (and bump the shed
    counter): ``retry_after_s`` estimates the queue's drain time at one
    admitted-item service time per waiting request."""
    metrics_export.observe_shed(name, "saturated")
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
        "submitted_at", "ttft_s", "trace_ctx", "queued_s", "prefill_s",
        "out_ids", "blocks", "hit_tokens", "preloaded",
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
        # Paged-engine state: pool blocks pinned for a QUEUED request that
        # already owns them (disaggregation handoff), prefix-cache hit size,
        # and — for handed-off requests — the prefill's last-token logits
        # row (None means prefill runs locally at admission).
        self.blocks: List[int] = []
        self.hit_tokens = 0
        self.preloaded: Optional[np.ndarray] = None
        # Captured at submit time on the request's own thread; engine spans
        # use THIS explicit context (the step loop runs on whichever thread
        # won the driver election — its ambient context belongs to another
        # request). None unless the trace sampled in.
        self.trace_ctx = (tracing.current_context()
                          if tracing.is_sampled() else None)

    def decode_tps(self) -> float:
        if self.decode_seconds == 0:
            return 0.0
        return self.decode_tokens / self.decode_seconds


class LLMEngine:
    """Continuous-batching engine: S cache slots, caller-driven stepping.

    Concurrency comes from calling ``stream`` from many threads — their
    sequences SHARE the batched decode dispatches. The device half funnels
    through the hooks below: here a slot cache of S private max_len rows
    (:class:`~ray_tpu_torch.models.generate.SlottedGenerator`), attended
    through ``_attend_cached`` (no paged kernel); :class:`PagedLLMEngine`
    overrides them with the paged pool.

    ``device`` defaults to the card; ``device="cpu"`` runs on the CPU.
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

    # -- device-half hooks (the paged engine overrides these) -----------------
    def _init_device(self) -> None:
        self._sg = SlottedGenerator(self.params, self.config,
                                    slots=self.slots, device=self.device,
                                    max_len=self.max_len)
        self._cache, self._last, self._gens = self._sg.init_state()

    def _reset_device_state(self) -> None:
        self._cache, self._last, self._gens = self._sg.init_state()

    def _admission_cost(self, req: _Request) -> int:
        """Prefill tokens this admission charges against the step budget
        (called under _state_lock)."""
        return req.bucket

    def _dispatch_prefill(self, req: _Request, slot: int) -> None:
        """Run the prompt's prefill into ``slot``. May raise
        :class:`NoFreeBlocks` — the scheduler requeues the request at the
        head and stops admitting this step."""
        pf = self._sg.prefill_fn(req.bucket)
        self._cache, self._last, self._gens = pf(
            self.params, self._cache, self._last, self._gens, req.padded,
            req.real_len, slot, req.seed)

    def _decode_operands_locked(self):
        """Extra decode operands snapshotted under _state_lock (the paged
        engine's block tables/lengths)."""
        return None

    def _run_decode(self, active, greedy, temps, extra):
        """One decode chunk; returns the [S, chunk] tokens on the device."""
        df = self._sg.decode_fn(self.chunk)
        toks, self._cache, self._last, self._gens = df(
            self.params, self._cache, self._last, self._gens, active, greedy,
            temps)
        return toks

    def _slot_result(self, host_toks, slot: int):
        """The step's emitted tokens for ``slot`` plus its device-length
        advance: always ``chunk`` here; the speculative paged engine emits
        a variable 1..chunk*(k+1). Called under _state_lock."""
        return [int(t) for t in host_toks[slot][:self.chunk]], self.chunk

    def _chunk_span_attrs(self, slot: int) -> Optional[Dict]:
        """Extra attrs for a request's ``llm.decode_chunk`` span (the spec
        engine reports its proposed/accepted counts)."""
        return None

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
        """Run prefill for every bucket and a decode chunk once, then reset:
        the allocator and the matmul libraries are warm before the first
        request's TTFT."""
        with self._step_lock:
            for b in self.buckets:
                pf = self._sg.prefill_fn(b)
                self._cache, self._last, self._gens = pf(
                    self.params, self._cache, self._last, self._gens,
                    np.zeros((1, b), np.int32), b, 0, 0)
            df = self._sg.decode_fn(self.chunk)
            toks, self._cache, self._last, self._gens = df(
                self.params, self._cache, self._last, self._gens,
                np.zeros(self.slots, bool), self._greedy, self._temps)
            toks.cpu()
            self._reset_device_state()

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
            if nxt.trace_ctx is not None:
                tracing.emit(
                    "llm.admission_wait", nxt.trace_ctx,
                    duration=nxt.queued_s,
                    attrs={"slot": free, "engine": self.name})
                tracing.emit(
                    "llm.prefill", nxt.trace_ctx,
                    duration=nxt.prefill_s,
                    attrs={"slot": free, "bucket": nxt.bucket,
                           "prompt_len": nxt.real_len,
                           "hit_tokens": nxt.hit_tokens})
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
        ttfts: List[tuple] = []  # (total, queued, prefill) per first token
        batch_size = int(active.sum())
        chunk_spans: List[tuple] = []  # sampled requests' (ctx, slot, ntok)
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
                    ttfts.append((req.ttft_s, req.queued_s, req.prefill_s))
                if req.trace_ctx is not None and upto > 0:
                    chunk_spans.append((req.trace_ctx, slot, upto))
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
        # Emitted OUTSIDE _state_lock: a span sink may take its own locks.
        for ctx, slot, ntok in chunk_spans:
            attrs = {"slot": slot, "tokens": ntok, "batch": batch_size}
            extra_attrs = self._chunk_span_attrs(slot)
            if extra_attrs:
                attrs.update(extra_attrs)
                # Propose + verify run fused in the one spec call, so the
                # spec span's duration IS the step's device time; the attrs
                # carry the per-slot proposed/accepted split.
                tracing.emit("llm.spec", ctx, duration=dt, end_time=None,
                             attrs={"slot": slot, **extra_attrs})
            tracing.emit("llm.decode_chunk", ctx, duration=dt, end_time=None,
                         attrs=attrs)
        self._observe(delivered_total, ttfts)

    def _observe(self, delivered: int, ttfts: List[tuple]) -> None:
        """The step's serve metrics: tokens delivered, and each first
        token's TTFT split by phase."""
        if not metrics_export.metrics_enabled():
            return
        tags = {"deployment": self.name}
        if delivered:
            metrics_export.serve_tokens_total().inc(delivered, tags)
        hist = metrics_export.serve_ttft_hist()
        for total, queued, prefill in ttfts:
            # Phase split: queued (submit→admission), prefill (the prefill
            # dispatch), decode (the remainder — first chunk + distribution).
            hist.observe(total, {**tags, "phase": "total"})
            hist.observe(queued, {**tags, "phase": "queued"})
            hist.observe(prefill, {**tags, "phase": "prefill"})
            hist.observe(max(0.0, total - queued - prefill),
                         {**tags, "phase": "decode"})

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

    def _throwaway_calls(self, prompt_len: int):
        """``(prefill(seed), decode())`` on a throwaway device state with
        slot 0 active: the calls :meth:`device_metrics` times."""
        bucket = self._bucket_for(prompt_len)
        pf = self._sg.prefill_fn(bucket)
        df = self._sg.decode_fn(self.chunk)
        padded = np.zeros((1, bucket), np.int32)
        active = np.zeros(self.slots, bool)
        active[0] = True
        greedy = np.ones(self.slots, bool)
        temps = np.zeros(self.slots, np.float32)
        state = list(self._sg.init_state())

        def prefill(seed):
            state[:] = pf(self.params, *state, padded, prompt_len, 0, seed)

        def decode():
            state[:] = df(self.params, *state, active, greedy, temps)[1:]

        return prefill, decode

    def device_metrics(self, *, prompt_len: int = 16, reps: int = 10) -> Dict:
        """TTFT and decode rate of the device work alone, excluding the
        host's per-step reads.

        Runs on a throwaway device state (serialized with serving by the
        step lock): TTFT is prefill + the first decode chunk; the decode
        rate chains chunks and synchronises once at the end, so the host's
        queueing overlaps the device. One slot active: the per-sequence
        rate of the batched chunk. Times are the host's clock around work
        that ends in a device synchronisation."""
        with self._step_lock:
            prefill, decode = self._throwaway_calls(prompt_len)
            prefill(0)                       # warm both before timing
            decode()
            _synchronize(self.device)
            t0 = time.perf_counter()
            for i in range(reps):
                prefill(i)
                decode()
            _synchronize(self.device)
            ttft_ms = (time.perf_counter() - t0) / reps * 1e3

            n_chunks = (self.max_len - prompt_len) // self.chunk - 1
            if n_chunks < 1:
                return {"device_ttft_ms": round(ttft_ms, 2),
                        "device_decode_tokens_per_sec": 0.0}
            prefill(0)
            _synchronize(self.device)
            t0 = time.perf_counter()
            for _ in range(n_chunks):
                decode()
            _synchronize(self.device)
            dt = time.perf_counter() - t0
        return {
            "device_ttft_ms": round(ttft_ms, 2),
            "device_decode_tokens_per_sec": round(n_chunks * self.chunk / dt,
                                                  1),
        }


def _synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (CPU work is already done)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
      the request rather than failing it;
    - with ``spec_tokens`` k > 0 (``serve_spec_tokens``) and a draft model,
      each decode step proposes k draft tokens a slot and verifies them in
      one target forward (the paged kernel at T = k+1); a slot whose
      acceptance EWMA sinks below ``serve_spec_accept_floor``, or whose
      table lacks room for a spec chunk, falls back to one token a step.

    ``device`` defaults to the card; ``device="cpu"`` runs the plain
    attention version on the CPU. The cluster KV tier (``kv_tier_enabled``)
    is not ported yet and raises.
    """

    def __init__(self, params, config: TransformerConfig, *,
                 block_tokens: Optional[int] = None,
                 pool_blocks: Optional[int] = None,
                 attention_kernel: Optional[str] = None,
                 draft_params=None,
                 draft_config: Optional[TransformerConfig] = None,
                 spec_tokens: Optional[int] = None, **kw):
        knobs = _get_config()
        if knobs.kv_tier_enabled:
            raise NotImplementedError(
                "the cluster KV tier (kv_tier_enabled) is not yet ported to "
                "ray_tpu_torch")
        self.spec_k = int(spec_tokens if spec_tokens is not None
                          else knobs.serve_spec_tokens)
        if self.spec_k > 0 and draft_params is None:
            raise ValueError(
                "serve_spec_tokens > 0 needs a draft model "
                "(draft_params/draft_config)")
        self._draft_params = draft_params
        self._draft_config = draft_config
        self._spec = self.spec_k > 0
        self._spec_floor = float(knobs.serve_spec_accept_floor)
        self._spec_alpha = float(knobs.serve_spec_accept_alpha)
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
        if self._draft_params is not None and self._draft_config is not None:
            self._draft_params = _to_device(self._draft_params, self.device,
                                            self._draft_config.dtype)
        self._pg = PagedGenerator(self.params, self.config, slots=self.slots,
                                  num_blocks=num_blocks,
                                  block_tokens=self.block_tokens,
                                  device=self.device,
                                  max_len=self.max_len,
                                  attention_kernel=self.attention_kernel,
                                  draft_params=self._draft_params,
                                  draft_config=self._draft_config)
        self.kv = KVBlockManager(num_blocks, self.block_tokens)
        (self._k_pool, self._v_pool,
         self._last, self._gens) = self._pg.init_state()
        self._slot_table = np.zeros((self.slots, self.blocks_per_seq),
                                    np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(self.slots)]
        self._hit_pending = 0  # hit tokens awaiting metric flush (step thread)
        self._init_spec_state()

    def _init_spec_state(self) -> None:
        # Speculative-decoding host state, all [S] and owned by the step
        # thread, except the per-slot resets at admission and release (under
        # _state_lock, which the step thread also holds there).
        if not self._spec:
            return
        self._kd_pool, self._vd_pool = self._pg.init_draft_state()
        self._spec_tail = np.zeros(self.slots, np.int32)
        self._spec_pending = np.zeros(self.slots, np.int32)
        self._spec_use_pending = np.zeros(self.slots, bool)
        self._spec_ewma = np.ones(self.slots, np.float32)
        self._spec_on = np.zeros(self.slots, bool)
        self._last_counts = None        # last spec step's [S, chunk] advances
        self._spec_last_accept = np.zeros(self.slots, np.int64)
        self._spec_last_on = np.zeros(self.slots, bool)
        self._spec_last_dt = 0.0
        self._spec_proposed_pending = 0  # await metric flush (step thread)
        self._spec_accepted_pending = 0
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0

    def _reset_device_state(self) -> None:
        (self._k_pool, self._v_pool,
         self._last, self._gens) = self._pg.init_state()
        # Pool contents are gone — the prefix cache resets with it.
        self.kv = KVBlockManager(self.kv.num_blocks, self.block_tokens)
        self._slot_table[:] = 0
        self._slot_blocks = [[] for _ in range(self.slots)]
        self._init_spec_state()

    def warmup(self) -> None:
        """Run prefill for every bucket, a decode chunk, the COW copy and
        set_last once (with speculation also the draft prefills and a spec
        chunk), then reset: the kernel is built and the allocator and
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
            if self._spec:
                for b in self.buckets:
                    dpf = self._pg.draft_prefill_fn(b)
                    self._kd_pool, self._vd_pool = dpf(
                        self._draft_params, self._kd_pool, self._vd_pool,
                        zero_row, np.zeros((1, b), np.int32), 0, b)
                self._kd_pool, self._vd_pool = cf(self._kd_pool,
                                                  self._vd_pool, 0, 0)
                sf = self._pg.spec_decode_fn(self.chunk, self.spec_k)
                out = sf(self.params, self._draft_params, self._k_pool,
                         self._v_pool, self._kd_pool, self._vd_pool,
                         self._last, self._gens,
                         np.zeros((self.slots, self.blocks_per_seq),
                                  np.int32),
                         np.zeros(self.slots, np.int32),
                         np.zeros(self.slots, bool), self._greedy,
                         self._temps, np.zeros(self.slots, bool),
                         np.zeros(self.slots, np.int32),
                         np.zeros(self.slots, np.int32),
                         np.zeros(self.slots, bool))
                out[0].cpu()
            self._reset_device_state()

    def _suffix_bucket(self, n: int) -> int:
        # The suffix prefill's bucket — unlike _bucket_for it needs no
        # decode-chunk headroom check (submit validated the full prompt).
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _admission_cost(self, req: _Request) -> int:
        if req.preloaded is not None:
            return 0  # prefill already paid on the prefill-side engine
        hit = self.kv.peek_hit_len([int(t) for t in req.prompt])
        return self._suffix_bucket(max(1, req.real_len - hit))

    def _dispatch_prefill(self, req: _Request, slot: int) -> None:
        bt = self.block_tokens
        if req.preloaded is not None:
            self._attach_preloaded(req, slot)
            return
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
            if self._spec:
                # The draft pool mirrors the block tables, so a COW fork
                # duplicates the tail's draft-side content too.
                self._kd_pool, self._vd_pool = cf(
                    self._kd_pool, self._vd_pool, int(tail), int(dst))
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
        if self._spec:
            # Warm the draft pool over the same suffix and table, so the
            # draft chain starts from draft K/V at every committed position.
            dpf = self._pg.draft_prefill_fn(req.bucket)
            self._kd_pool, self._vd_pool = dpf(
                self._draft_params, self._kd_pool, self._vd_pool, row,
                padded, hit_len, suffix_len)
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
            self._hit_pending += hit_len
            if self._spec:
                # Fresh speculation state: the draft chain's first forward
                # re-consumes the last prompt token at real_len - 1, so the
                # tail starts as that token. The EWMA starts optimistic; the
                # headroom gate and acceptance feedback take it from there.
                self._spec_tail[slot] = tokens[-1]
                self._spec_pending[slot] = 0
                self._spec_use_pending[slot] = False
                self._spec_ewma[slot] = 1.0
                self._spec_on[slot] = True

    def _attach_preloaded(self, req: _Request, slot: int) -> None:
        """Disaggregation handoff: the prompt's K/V blocks were already
        written into the pool by ``admit_prefilled`` — attach the table row
        and seed the slot's logits row and generator from the handed-off
        state."""
        ids = list(req.blocks)
        row = np.zeros(self.blocks_per_seq, np.int32)
        row[:len(ids)] = ids
        sl = self._pg.set_last_fn()
        self._last, self._gens = sl(self._last, self._gens,
                                    np.asarray(req.preloaded, np.float32),
                                    slot, req.seed)
        # Same atomic commit as _dispatch_prefill: a cancel that freed the
        # slot mid-attach found _slot_blocks[slot] empty (and, with req.slot
        # set, never took the _discard_request_locked path), so the handoff
        # pins are ours to drop here.
        with self._state_lock:
            req.blocks = []
            if self._slot_req[slot] is not req or req.cancelled:
                self.kv.release(ids)
                return
            self._slot_table[slot, :] = row
            self._slot_blocks[slot] = ids
            self._hit_pending += req.hit_tokens
            if self._spec:
                # Handed-off blocks carry no draft-side KV — the draft never
                # saw this prompt. Speculation stays off for the request;
                # the slot decodes one token a step.
                self._spec_on[slot] = False
                self._spec_ewma[slot] = 0.0
                self._spec_use_pending[slot] = False

    def _decode_operands_locked(self):
        base = (self._slot_table.copy(),
                np.asarray(self._slot_len, np.int32))
        if not self._spec:
            return base
        tables, lengths = base
        # Headroom gate: a spec step can write chunk*(k+1) positions ahead,
        # so a slot without that much table room degrades to one token a
        # step INSIDE the same call — the base retire rule (slot_len + chunk
        # > max_len: length_cap before dispatch) holds either way.
        cap = self.blocks_per_seq * self.block_tokens
        headroom = lengths + self.chunk * (self.spec_k + 1) <= cap
        spec_on = self._spec_on & headroom & self._active
        return base + (spec_on, self._spec_tail.copy(),
                       self._spec_pending.copy(),
                       self._spec_use_pending.copy())

    def _run_plain_decode(self, active, greedy, temps, tables, lengths):
        df = self._pg.decode_fn(self.chunk)
        (toks, self._k_pool, self._v_pool,
         self._last, self._gens) = df(
            self.params, self._k_pool, self._v_pool, self._last,
            self._gens, tables, lengths, active, greedy, temps)
        return toks

    def _run_decode(self, active, greedy, temps, extra):
        if not self._spec:
            return self._run_plain_decode(active, greedy, temps, *extra)
        tables, lengths, spec_on, tail, pending, use_pending = extra
        if not spec_on.any() and not (use_pending & active).any():
            # Every slot degraded (low acceptance, no headroom) and none
            # still carries a rejection replacement: the plain one-token
            # chunk is strictly cheaper than a spec step that would
            # force-reject everything. (A just-demoted slot runs one more
            # spec step, which consumes its pending token.)
            self._last_counts = None
            self._spec_last_accept[:] = 0
            self._spec_last_on[:] = False
            return self._run_plain_decode(active, greedy, temps, tables,
                                          lengths)
        sf = self._pg.spec_decode_fn(self.chunk, self.spec_k)
        t0 = time.perf_counter()
        (toks, counts, accepted, self._k_pool, self._v_pool, self._kd_pool,
         self._vd_pool, self._last, self._gens, tail_t, pending_t,
         up_t) = sf(
            self.params, self._draft_params, self._k_pool, self._v_pool,
            self._kd_pool, self._vd_pool, self._last, self._gens, tables,
            lengths, active, greedy, temps, spec_on, tail, pending,
            use_pending)
        # One host copy syncs the step's speculation state: the advances,
        # the accepted runs and the chain state carried to the next step.
        # Only the step thread writes that state between the operand
        # snapshot and here; admission resets come before the NEXT snapshot.
        c = self.chunk
        host = torch.cat([counts, accepted, tail_t[:, None],
                          pending_t[:, None],
                          up_t[:, None].to(torch.int32)], dim=1).cpu().numpy()
        self._spec_last_dt = time.perf_counter() - t0
        self._last_counts = host[:, :c]
        acc = host[:, c:2 * c].sum(axis=1)
        self._spec_tail = host[:, 2 * c].copy()
        self._spec_pending = host[:, 2 * c + 1].copy()
        self._spec_use_pending = host[:, 2 * c + 2].astype(bool)
        # The acceptance EWMA feeds the next step's gate: a slot whose EWMA
        # sinks below the floor stops proposing for the rest of its request
        # (its draft passes would cost more than its accepted tokens buy).
        self._spec_last_accept = acc
        self._spec_last_on = spec_on
        prop = np.where(spec_on, self.chunk * self.spec_k, 0)
        live = prop > 0
        if live.any():
            a = self._spec_alpha
            self._spec_ewma[live] = ((1.0 - a) * self._spec_ewma[live]
                                     + a * acc[live] / prop[live])
            self._spec_on[live] = self._spec_ewma[live] >= self._spec_floor
        self._spec_proposed_pending += int(prop.sum())
        self._spec_accepted_pending += int(acc.sum())
        self._spec_proposed_total += int(prop.sum())
        self._spec_accepted_total += int(acc.sum())
        return toks

    def _slot_result(self, host_toks, slot: int):
        if not self._spec or self._last_counts is None:
            return super()._slot_result(host_toks, slot)
        counts = self._last_counts[slot]          # [chunk] advances
        toks = host_toks[slot]                    # [chunk, k+1]
        out: List[int] = []
        for t in range(counts.shape[0]):
            out.extend(int(x) for x in toks[t, :counts[t]])
        return out, int(counts.sum())

    def _chunk_span_attrs(self, slot: int) -> Optional[Dict]:
        if (not self._spec or self._last_counts is None
                or not self._spec_last_on[slot]):
            return None
        return {"spec_proposed": self.chunk * self.spec_k,
                "spec_accepted": int(self._spec_last_accept[slot])}

    def _release_slot_device(self, slot: int) -> None:
        ids = self._slot_blocks[slot]
        if ids:
            self._slot_blocks[slot] = []
            self._slot_table[slot, :] = 0
            self.kv.release(ids)
        if self._spec:
            self._spec_on[slot] = False
            self._spec_use_pending[slot] = False

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

    def _discard_request_locked(self, req: _Request) -> None:
        ids, req.blocks = req.blocks, []
        if ids:
            self.kv.release(ids)

    # -- disaggregation halves ------------------------------------------------
    def prefill_to_blocks(self, prompt_ids: Sequence[int], *, seed: int = 0):
        """Prefill-side half of disaggregated serving: run (suffix-)prefill
        for ``prompt_ids`` into pool blocks and return them for the handoff
        lane — ``(k [L,nb,bt,H,Dh], v, last_row [V], hit_tokens)``. ``k``
        and ``v`` are new tensors on the engine's device (the lane copies
        them to the host, straight into its slot); ``last_row`` is a host
        f32 array.

        The chain (full blocks AND partial tail — nothing will extend these
        blocks here) is registered in the LOCAL prefix cache before the pins
        drop, so a same-prefix prompt later only prefills its suffix even
        on the prefill side. Uses slot 0 under the step lock; a prefill
        engine serves no decode traffic, so the slot is exclusive. The
        prefill seeds the slot's generator and draws nothing from it.
        """
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        real_len = int(prompt.shape[0])
        if real_len == 0:
            raise ValueError("empty prompt")
        bt = self.block_tokens
        tokens = [int(t) for t in prompt]
        with self._step_lock:
            full, tail, hit_len = self.kv.lookup(tokens)
            try:
                need = -(-real_len // bt)
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
                self.kv.release([tail])
                ids.append(dst)
            ids.extend(fresh)
            row = np.zeros(self.blocks_per_seq, np.int32)
            row[:len(ids)] = ids
            suffix_len = real_len - hit_len
            bucket = self._suffix_bucket(suffix_len)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :suffix_len] = prompt[hit_len:]
            pf = self._pg.prefill_fn(bucket)
            (self._k_pool, self._v_pool, self._last, self._gens) = pf(
                self.params, self._k_pool, self._v_pool, self._last,
                self._gens, row, padded, hit_len, suffix_len, 0, seed)
            ef = self._pg.extract_fn(len(ids))
            k, v = ef(self._k_pool, self._v_pool, np.asarray(ids, np.int32))
            last_row = self._last[0].cpu().numpy()
            self.kv.register_chain(tokens, ids, real_len)
            self.kv.release(ids)
        return k, v, last_row, hit_len

    def admit_prefilled(self, prompt_ids: Sequence[int],
                        k: torch.Tensor, v: torch.Tensor,
                        last_row: np.ndarray, *, max_new_tokens: int = 32,
                        temperature: float = 0.0, seed: int = 0,
                        hit_tokens: int = 0,
                        submitted_at: Optional[float] = None,
                        trace_ctx=None, timeout_s: float = 30.0) -> _Request:
        """Decode-side half of disaggregated serving: write handed-off KV
        blocks into the pool and enqueue a decode-only request (admission
        attaches the table row instead of prefilling). Blocks — briefly —
        until the pool can supply the sequence's block budget.

        The upload is synchronous: the device is synchronised after the
        insert, so on return the caller may release the shm views ``k``/
        ``v`` point into.
        """
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        real_len = int(prompt.shape[0])
        if real_len == 0:
            raise ValueError("empty prompt")
        bucket = self._bucket_for(real_len)  # validates decode headroom
        req = _Request(prompt, None, real_len, bucket, int(max_new_tokens),
                       float(temperature), int(seed),
                       threading.Condition(self._state_lock))
        req.trace_ctx = trace_ctx
        if submitted_at is not None:
            req.submitted_at = submitted_at
        if max_new_tokens <= 0:
            req.done = True
            req.finish_reason = "stop"
            return req
        nb_in = int(k.shape[1])
        n_chunks = -(-req.max_new // self.chunk)
        max_written = min(self.max_len, real_len + n_chunks * self.chunk)
        need = max(-(-max_written // self.block_tokens), nb_in)
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                ids = self.kv.alloc(need)
                break
            except NoFreeBlocks:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.002)  # in-flight retires free blocks
        with self._step_lock:
            inf = self._pg.insert_fn(nb_in)
            self._k_pool, self._v_pool = inf(
                self._k_pool, self._v_pool, k, v,
                np.asarray(ids[:nb_in], np.int32))
            # The upload must have landed before the lane slot is acked.
            _synchronize(self.device)
        # Publish the prompt's full blocks for LOCAL hits too — a colocated
        # follow-up skips the handoff entirely.
        tokens = [int(t) for t in prompt]
        n_full = (real_len // self.block_tokens) * self.block_tokens
        if n_full:
            self.kv.register_chain(tokens, ids, n_full)
        req.blocks = ids
        req.preloaded = np.array(last_row, np.float32)  # a writable copy
        req.hit_tokens = int(hit_tokens)
        with self._state_lock:
            self._waiting.append(req)
        return req

    # -- introspection --------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Slot occupancy, queue depth, pool state and prefix-cache counters;
        the forward passes run, each of which runs the attention once a
        layer (the target's: ``prefill_forwards``, ``decode_forwards``,
        ``spec_forwards`` — the verify at T = k+1; the draft's:
        ``draft_prefill_forwards``, ``draft_forwards`` — one per draft-chain
        token); with speculation, the proposed and accepted totals."""
        out = super().stats()
        out.update(self.kv.stats())
        for name in ("prefill_forwards", "decode_forwards", "spec_forwards",
                     "draft_prefill_forwards", "draft_forwards"):
            out[name] = float(getattr(self._pg, name))
        if self._spec:
            prop = self._spec_proposed_total
            acc = self._spec_accepted_total
            out["spec_proposed_total"] = float(prop)
            out["spec_accepted_total"] = float(acc)
            out["spec_accept_ratio"] = float(acc) / prop if prop else 0.0
        return out

    def _observe(self, delivered: int, ttfts: List[tuple]) -> None:
        super()._observe(delivered, ttfts)
        hits, self._hit_pending = self._hit_pending, 0
        if not metrics_export.metrics_enabled():
            if self._spec:
                self._spec_proposed_pending = 0
                self._spec_accepted_pending = 0
            return
        tags = {"deployment": self.name}
        if hits:
            metrics_export.serve_kv_hit_tokens_total().inc(hits, tags)
        st = self.kv.stats()
        gauge = metrics_export.serve_kv_block_occupancy()
        for state in ("active", "cached", "free"):
            gauge.set(st[f"kv_blocks_{state}"], {**tags, "state": state})
        if self._spec:
            prop, self._spec_proposed_pending = self._spec_proposed_pending, 0
            acc, self._spec_accepted_pending = self._spec_accepted_pending, 0
            if prop:
                metrics_export.serve_spec_proposed_total().inc(prop, tags)
            if acc:
                metrics_export.serve_spec_accepted_total().inc(acc, tags)
            tot_prop = self._spec_proposed_total
            if tot_prop:
                metrics_export.serve_spec_accept_ratio().set(
                    self._spec_accepted_total / tot_prop, tags)
            # The spec call IS the first decode chunk for a first token
            # delivered this step — its propose+verify time is a TTFT phase
            # of its own next to queued/prefill/decode.
            if ttfts and self._last_counts is not None:
                hist = metrics_export.serve_ttft_hist()
                for _ in ttfts:
                    hist.observe(self._spec_last_dt,
                                 {**tags, "phase": "spec"})

    def close(self) -> None:
        """Release what the engine holds outside itself: nothing without the
        cluster KV tier (not ported), so a no-op. Idempotent; the engine
        owns no threads to stop."""

    def _throwaway_calls(self, prompt_len: int):
        # A throwaway pool: slot 0 on a table of fresh blocks, the plain
        # decode chunk.
        bucket = self._suffix_bucket(prompt_len)
        bps = self.blocks_per_seq
        pf = self._pg.prefill_fn(bucket)
        df = self._pg.decode_fn(self.chunk)
        padded = np.zeros((1, bucket), np.int32)
        row = np.arange(1, bps + 1, dtype=np.int32)
        tables = np.zeros((self.slots, bps), np.int32)
        tables[0] = row
        lengths = np.zeros(self.slots, np.int32)
        lengths[0] = prompt_len
        active = np.zeros(self.slots, bool)
        active[0] = True
        greedy = np.ones(self.slots, bool)
        temps = np.zeros(self.slots, np.float32)
        state = list(self._pg.init_state())

        def prefill(seed):
            state[:] = pf(self.params, *state, row, padded, 0, prompt_len, 0,
                          seed)

        def decode():
            state[:] = df(self.params, *state, tables, lengths, active,
                          greedy, temps)[1:]

        return prefill, decode


def lane_capacity(config: TransformerConfig, block_tokens: int,
                  blocks_per_seq: int, logits_dim: int) -> int:
    """Bytes one handoff lane slot holds: the K and V of a whole sequence's
    blocks, the f32 last-token logits row and 64 KiB for the rest of the
    meta (JAX's formula)."""
    c = config
    block_bytes = (c.n_layers * block_tokens * c.n_heads * c.head_dim
                   * c.dtype.itemsize)
    return 2 * blocks_per_seq * block_bytes + logits_dim * 4 + 65536


class _DisaggTicket:
    """One request's place in the disaggregated pipeline: queued → prefill
    → lane → decode-engine ``_Request``. Resolution (req or error) is
    signalled through the engine's condition variable."""

    __slots__ = ("prompt", "max_new", "temperature", "seed", "req", "error",
                 "resolved", "cancelled", "trace_ctx", "submitted_at")

    def __init__(self, prompt, max_new, temperature, seed):
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.req: Optional[_Request] = None
        self.error: Optional[BaseException] = None
        self.resolved = False
        self.cancelled = False
        self.submitted_at = time.perf_counter()
        self.trace_ctx = (tracing.current_context()
                          if tracing.is_sampled() else None)


class DisaggregatedLLMEngine:
    """Prefill/decode disaggregation: a prefill-specialized
    :class:`PagedLLMEngine` feeding a decode-specialized one over a
    :class:`~ray_tpu_torch.serve.dag_pipeline.KVHandoffLane`.

    Mixed prefill+decode in one engine serializes heterogeneous work — a
    long prompt's prefill stalls every in-flight decode chunk behind it.
    Here decode NEVER runs a prompt prefill: a prefill worker thread turns
    prompts into KV blocks (with its own prefix cache, so shared prefixes
    cost their FLOPs once), ships them over the lane's deferred-ack shm
    ring, and an ingest worker thread writes them into the decode pool
    (``insert_fn``, in place) and enqueues a decode-only request.
    Streaming contract, shedding, and stats match :class:`LLMEngine`;
    ``close()`` joins the workers and destroys the lane.

    Both halves share this object and ``device`` (the card unless
    ``device="cpu"``). The workers and the request threads that drive the
    decode steps all launch on the device's default stream, so their
    kernels run in stream order: the split paged-attention kernel's
    arrival counters are shared per device and need that order.
    """

    def __init__(self, params, config: TransformerConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 max_len: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 chunk: int = 8, slots: Optional[int] = None,
                 max_queue: Optional[int] = None, name: str = "LLM",
                 prefill_slots: int = 1,
                 block_tokens: Optional[int] = None,
                 pool_blocks: Optional[int] = None,
                 lane_slots: int = 4):
        from ray_tpu_torch.serve.dag_pipeline import KVHandoffLane

        knobs = _get_config()
        self.name = name
        self.chunk = chunk
        self.max_queue = int(max_queue if max_queue is not None
                             else knobs.serve_admission_queue_limit)
        # spec_tokens=0: disaggregated decode admits via KV handoff, where
        # draft-side KV never exists — speculation is a colocated-engine
        # feature.
        self.decode = PagedLLMEngine(
            params, config, device=device, max_len=max_len,
            prompt_buckets=prompt_buckets, chunk=chunk, slots=slots,
            max_queue=0, name=name, block_tokens=block_tokens,
            pool_blocks=pool_blocks, spec_tokens=0)
        self.device = self.decode.device
        self.prefill = PagedLLMEngine(
            params, config, device=self.device, max_len=max_len,
            prompt_buckets=prompt_buckets, chunk=chunk,
            slots=max(1, prefill_slots), max_queue=0,
            name=f"{name}-prefill", block_tokens=block_tokens,
            pool_blocks=pool_blocks, spec_tokens=0)
        self.slots = self.decode.slots
        self.finish_reason = "stop"  # single-stream convenience, as LLMEngine

        cap = lane_capacity(config, self.decode.block_tokens,
                            self.decode.blocks_per_seq,
                            self.decode._pg.logits_dim)
        self.lane = KVHandoffLane(capacity=cap, slots=max(2, lane_slots))

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pq: collections.deque = collections.deque()
        self._lane_fifo: collections.deque = collections.deque()
        self._closed = False
        self._prefill_thread = threading.Thread(
            target=self._prefill_loop, name=f"{name}-disagg-prefill",
            daemon=True)
        self._ingest_thread = threading.Thread(
            target=self._ingest_loop, name=f"{name}-disagg-ingest",
            daemon=True)
        self._prefill_thread.start()
        self._ingest_thread.start()

    # -- pipeline workers -----------------------------------------------------
    def _prefill_loop(self) -> None:
        from ray_tpu_torch.dag.channel import ChannelTimeout

        while True:
            with self._cv:
                while not self._pq and not self._closed:
                    self._cv.wait(timeout=0.1)
                if self._closed:
                    return
                t = self._pq.popleft()
            if t.cancelled:
                self._resolve(t, error=None)
                continue
            try:
                k, v, last_row, hit = self.prefill.prefill_to_blocks(
                    t.prompt, seed=t.seed)
                meta = {"prompt": t.prompt, "max_new": t.max_new,
                        "temperature": t.temperature, "seed": t.seed,
                        "hit_tokens": hit, "last_row": last_row,
                        "submitted_at": t.submitted_at}
                with self._cv:
                    self._lane_fifo.append(t)
                while True:
                    try:
                        self.lane.send(meta, k, v, timeout=1.0)
                        break
                    except ChannelTimeout:  # decode side slow to drain
                        if self._closed:
                            with self._cv:
                                try:
                                    self._lane_fifo.remove(t)
                                except ValueError:
                                    pass
                            self._resolve(
                                t, error=RuntimeError("engine closed"))
                            break
            except BaseException as e:  # noqa: BLE001 — poison one request
                # The ticket may already sit in _lane_fifo (send can fail
                # AFTER the append — channel fault, oversized payload);
                # leaving it there would pair every later handoff with the
                # wrong ticket. Unqueue before resolving.
                with self._cv:
                    try:
                        self._lane_fifo.remove(t)
                    except ValueError:
                        pass
                self._resolve(t, error=e)

    def _ingest_loop(self) -> None:
        from ray_tpu_torch.dag.channel import ChannelClosed, ChannelTimeout

        while True:
            try:
                meta, k, v, token = self.lane.recv(timeout=0.25)
            except ChannelTimeout:
                if self._closed:
                    return
                continue
            except ChannelClosed:
                return
            with self._cv:
                t = self._lane_fifo.popleft() if self._lane_fifo else None
            if t is None:
                # Payload with no waiting ticket (its prefill thread
                # unqueued itself on a send-path error) — drop it and
                # return the ring slot.
                del k, v
                self.lane.ack(token)
                continue
            try:
                req = self.decode.admit_prefilled(
                    meta["prompt"], k, v, meta["last_row"],
                    max_new_tokens=meta["max_new"],
                    temperature=meta["temperature"], seed=meta["seed"],
                    hit_tokens=meta["hit_tokens"],
                    submitted_at=meta["submitted_at"],
                    trace_ctx=t.trace_ctx)
            except BaseException as e:  # noqa: BLE001 — poison one request
                del k, v
                self.lane.ack(token)
                self._resolve(t, error=e)
                continue
            # The upload landed (admit_prefilled synchronises) — release the
            # ring slot back to the prefill writer. THE deferred-ack handoff.
            del k, v
            self.lane.ack(token)
            self._resolve(t, req=req)

    def _resolve(self, t: _DisaggTicket, req: Optional[_Request] = None,
                 error: Optional[BaseException] = None) -> None:
        with self._cv:
            t.req = req
            t.error = error
            t.resolved = True
            cancelled = t.cancelled
            self._cv.notify_all()
        if cancelled and req is not None:
            self.decode._cancel(req)

    # -- request surface (LLMEngine contract) ---------------------------------
    def submit(self, prompt_ids: Sequence[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0, seed: int = 0) -> _DisaggTicket:
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if prompt.shape[0] == 0:
            raise ValueError("empty prompt")
        _check_token_ids(prompt, self.decode.config.vocab_size, self.name)
        prompt = prompt.astype(np.int32)
        self.decode._bucket_for(int(prompt.shape[0]))  # validate headroom
        t = _DisaggTicket(prompt, int(max_new_tokens), float(temperature),
                          int(seed))
        if max_new_tokens <= 0:
            t.resolved = True
            return t
        with self._cv:
            if self._closed:
                raise RuntimeError(f"engine {self.name} closed")
            if self.max_queue and len(self._pq) >= self.max_queue:
                raise _shed(self.name, len(self._pq), self.max_queue,
                            "already waiting for prefill")
            self._pq.append(t)
            self._cv.notify_all()
        return t

    def stream(self, prompt_ids: Sequence[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0, seed: int = 0,
               result: Optional[Dict] = None) -> Iterable[int]:
        if result is None:
            result = {}
        t = self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                        temperature=temperature, seed=seed)

        def run():
            raised = None
            try:
                with self._cv:
                    deadline = time.monotonic() + 120.0
                    while not t.resolved:
                        # _cv wraps self._lock; wait() releases it.
                        if not self._cv.wait(timeout=0.2) \
                                and time.monotonic() > deadline:
                            raise TimeoutError(
                                "disaggregated prefill stalled")
                if t.error is not None:
                    raise t.error
                if t.req is None:
                    return
                for tok in self.decode.drive(t.req):
                    result["decode_tps"] = t.req.decode_tps()
                    yield tok
            except BaseException as e:
                raised = e
                raise
            finally:
                if t.req is not None:
                    fr = t.req.finish_reason or "stop"
                elif t.error is not None or raised is not None:
                    # The prefill-stall TimeoutError resolves nothing on the
                    # ticket — without tracking the raise this path would
                    # claim a clean "stop" for a generator that blew up.
                    fr = "error"
                elif t.cancelled:
                    fr = "cancelled"
                else:
                    fr = "stop"
                result["finish_reason"] = self.finish_reason = fr
                if t.req is not None and t.req.ttft_s is not None:
                    result["ttft_s"] = t.req.ttft_s

        gen = run()
        weakref.finalize(gen, self._cancel_ticket, t)
        return gen

    def generate(self, prompt_ids: Sequence[int], **kw) -> List[int]:
        return list(self.stream(prompt_ids, **kw))

    def _cancel_ticket(self, t: _DisaggTicket) -> None:
        req = None
        with self._cv:
            t.cancelled = True
            try:
                self._pq.remove(t)
                t.resolved = True  # never entered the pipeline
            except ValueError:
                req = t.req  # mid-pipeline (worker resolves) or decoding
            self._cv.notify_all()
        if req is not None:
            self.decode._cancel(req)

    # -- engine surface delegates ---------------------------------------------
    def warmup(self) -> None:
        self.prefill.warmup()
        self.decode.warmup()

    def stats(self) -> Dict[str, float]:
        out = self.decode.stats()
        with self._cv:
            out["queue_depth"] += float(len(self._pq)
                                        + len(self._lane_fifo))
        pf = self.prefill.kv.stats()
        out["prefill_kv_hit_tokens"] = pf["kv_hit_tokens"]
        out["prefill_kv_blocks_cached"] = pf["kv_blocks_cached"]
        return out

    def decode_tokens_per_sec(self) -> float:
        return self.decode.decode_tokens_per_sec()

    def device_metrics(self, **kw) -> Dict:
        return self.decode.device_metrics(**kw)

    def close(self) -> None:
        """Stop the pipeline workers, poison-pill the lane, destroy it.
        Pending tickets resolve as errors. Idempotent."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            leftovers = list(self._pq)
            self._pq.clear()
            self._cv.notify_all()
        for t in leftovers:
            self._resolve(t, error=RuntimeError(f"engine {self.name} closed"))
        self._prefill_thread.join(timeout=5.0)
        self.lane.close()  # pill — wakes the ingest loop
        self._ingest_thread.join(timeout=5.0)
        if self._ingest_thread.is_alive():
            # It can be parked in admit_prefilled's alloc retry (bounded by
            # its timeout_s=30) while holding zero-copy views into the ring
            # — wait that bound out before touching the mapping.
            self._ingest_thread.join(timeout=35.0)
        with self._cv:
            stranded = list(self._lane_fifo)
            self._lane_fifo.clear()
        for t in stranded:
            self._resolve(t, error=RuntimeError(f"engine {self.name} closed"))
        if self._ingest_thread.is_alive():
            # Still wedged: destroy() would unmap shm under the thread's
            # live views — leak the lane instead and let channel teardown
            # reclaim it when the views drop.
            return
        self.lane.destroy()

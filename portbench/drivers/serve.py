"""The serving driver: the port's paged engine under a closed loop of
client threads, for a fixed window.

Set-up makes the weights on the device from the seed in the dtype they are
served in, builds ``PagedLLMEngine`` with the mix's slots, pool and prefill
budget a step (``serve_llm_prefill_tokens``), runs its ``warmup`` (every
prompt bucket and the decode chunk) and starts the clients, each a request
at a time through ``engine.stream``, the engine's public entry, sending its
next request when the last one ends. The window opens once every client
has its first token (the slots are full) and lasts ``--seconds``; requests
sent in it are then driven to their first token, and every request still
in flight is abandoned.

Check: a sample, drawn from the seed, of the greedy requests that finished,
the longest among them, is run through the plain reference's full forward
(prompt plus served tokens, no cache); the widest gap by which a served
token's logit lies below the reference's best decides ``correct``, with any
request that failed.
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from portbench import check, weights
from portbench.drivers import port_config
from portbench.traffic import serve as traffic

_BUDGET = "RAY_TPU_SERVE_LLM_PREFILL_TOKENS"


@dataclass
class Request:
    prompt: np.ndarray
    known: int                  # leading tokens an earlier request had whole
    max_new: int
    temperature: float
    submitted: float
    tokens: List[int] = field(default_factory=list)
    times: List[float] = field(default_factory=list)
    finished: Optional[float] = None
    error: Optional[str] = None


class _Client:
    """One closed-loop client: its session, the request in flight."""

    def __init__(self):
        self.records: List[Request] = []
        self.session: Optional[traffic.Session] = None
        self.turn = 0
        self.known_sys = 0
        self.history = np.zeros(0, np.int64)
        self.req = None             # the engine's request (``submit``)
        self.stream = None          # ``engine.drive(req)``
        self.stopped = False


class _Clients:
    """The closed loop: ``n`` clients, each sending its next request the
    moment the last one ends, driven from the calling thread one engine
    step at a time.

    A pass takes every token the engine has already delivered to each
    client (``drive`` yields a request's delivered tokens without stepping)
    and sends a finished client's next request at once; then one ``next``
    on a request that has none steps the engine once. So every step admits
    every request that the step before it freed a slot for, and the window
    holds the same work from run to run. With a thread a client, whether a
    client sent its next request before the next step began was a race for
    the interpreter, and the window's rate swung by a fifth from run to
    run."""

    def __init__(self, engine, gen: traffic.Generator, n: int):
        self.engine = engine
        self.gen = gen
        self.clients = [_Client() for _ in range(n)]

    @property
    def records(self) -> List[Request]:
        return [q for c in self.clients for q in c.records]

    def _submit(self, c: _Client) -> None:
        if c.session is None or c.turn >= len(c.session.turns):
            c.session, c.known_sys = self.gen.next_session()
            c.turn = 0
            c.history = (c.session.system if c.session.system is not None
                         else np.zeros(0, np.int64))
        turn = c.session.turns[c.turn]
        prompt = np.concatenate([c.history, turn.user])
        rec = Request(prompt, c.known_sys if c.turn == 0 else len(c.history),
                      turn.max_new, turn.temperature, time.perf_counter())
        c.records.append(rec)
        try:
            c.req = self.engine.submit(prompt.tolist(),
                                       max_new_tokens=turn.max_new,
                                       temperature=turn.temperature,
                                       seed=turn.seed)
        except Exception as e:  # noqa: BLE001 — a refused request counts
            rec.error = repr(e)
            c.stopped = True
            return
        c.stream = self.engine.drive(c.req)

    def _take(self, c: _Client, n: int) -> bool:
        """Take ``n`` tokens from ``c``'s stream; False once its request
        has ended (the stream's end is read as one more) or failed."""
        rec = c.records[-1]
        try:
            for _ in range(n):
                tok = next(c.stream)
                rec.times.append(time.perf_counter())
                rec.tokens.append(int(tok))
        except StopIteration:
            rec.finished = time.perf_counter()
            c.history = np.concatenate(
                [rec.prompt, np.asarray(rec.tokens, np.int64)])
            c.turn += 1
            c.req = c.stream = None
            return False
        except Exception as e:  # noqa: BLE001 — a failed request counts
            rec.error = repr(e)
            c.stopped = True
            c.req = c.stream = None
            return False
        return True

    def _drain(self, c: _Client) -> None:
        """Every token already delivered to ``c``, and its next request if
        this one is done."""
        if c.stopped:
            return
        if c.req is None:
            self._submit(c)
            return
        buffered = c.req.emitted - len(c.records[-1].tokens)
        if buffered or c.req.done:
            if not self._take(c, buffered + (1 if c.req.done else 0)):
                if not c.stopped:
                    self._submit(c)

    def step(self, only=None) -> None:
        """One pass over the clients (those ``only`` picks), then one
        engine step through a request that has no token waiting, one
        holding a slot if any does."""
        picked = [c for c in self.clients if only is None or only(c)]
        for c in picked:
            self._drain(c)
        waiting = [c for c in picked if c.req is not None
                   and c.req.emitted == len(c.records[-1].tokens)]
        if waiting:
            self._take(min(waiting, key=lambda c: c.req.slot is None), 1)

    def run(self, until, timeout: float, only=None) -> bool:
        """Step until ``until()``; False if ``timeout`` seconds passed
        first."""
        deadline = time.perf_counter() + timeout
        while not until():
            if time.perf_counter() > deadline:
                return False
            self.step(only)
        return True

    def full(self) -> bool:
        """Every client has had a first token."""
        return all(c.records and c.records[0].tokens for c in self.clients)

    def close(self) -> None:
        """Abandon every request in flight (the engine cancels it)."""
        for c in self.clients:
            if c.stream is not None:
                c.stream.close()
            c.req = c.stream = None


def _sample(records: List[Request], seed: int, want_tokens: int,
            most: int) -> List[Request]:
    """Finished greedy requests drawn from the seed, the longest first,
    until ``want_tokens`` served tokens or ``most`` requests."""
    done = [r for r in records if r.finished is not None and r.error is None
            and r.temperature == 0.0 and r.tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.tokens))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed & (2**63 - 1), 17])
    out, n = [longest], len(longest.tokens)
    for j in rng.permutation(len(rest)):
        if n >= want_tokens or len(out) >= most:
            break
        out.append(rest[j])
        n += len(rest[j].tokens)
    return out


def run(r, *, control: bool = False) -> None:
    """Drive cell ``r`` (a ``portbench.run.Run``). ``control`` also reads,
    on the same sample, the lower-precision control's gap and the gap of a
    token altered where it is served (the calibration's readings)."""
    import torch
    from ray_tpu_torch.serve.llm import PagedLLMEngine

    from portbench.reference import gpt2
    from portbench.trace import Window

    cfg, mix, dev = r.cfg, r.mix, r.device
    if dev == "cuda":
        r.extra["device_name"] = torch.cuda.get_device_name()
    tcfg = port_config(cfg, torch)
    params = weights.make(cfg, r.seed, dev, tcfg.dtype)
    # The prefill budget a step is a knob of the port's config, read when
    # the engine is built; the mix sets it as a deployment would.
    saved = os.environ.get(_BUDGET)
    os.environ[_BUDGET] = str(mix["prefill_tokens"])
    try:
        engine = PagedLLMEngine(params, tcfg, device=dev, slots=mix["slots"],
                                pool_blocks=mix["pool_blocks"], max_queue=0)
    finally:
        if saved is None:
            del os.environ[_BUDGET]
        else:
            os.environ[_BUDGET] = saved
    del params
    engine.warmup()
    gen = traffic.Generator(mix, r.seed, cfg["vocab_size"], mix["clients"],
                            engine.block_tokens)
    clients = _Clients(engine, gen, mix["clients"])
    if not clients.run(clients.full, mix["ramp_timeout_s"]):
        raise RuntimeError("the clients did not all get a first token")
    window = Window(torch) if r.trace and dev == "cuda" else None
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    r.setup_done()
    if window:
        window.start()
    stats0 = engine.stats()
    t0 = time.perf_counter()
    t1 = t0 + r.seconds
    clients.run(lambda: time.perf_counter() >= t1, 2 * r.seconds + 60)
    t1 = time.perf_counter()
    stats1 = engine.stats()
    # Requests sent in the window get their first token before the loop
    # stops, so the TTFT tail counts their wait.
    waiting = lambda c: (c.req is not None and not c.records[-1].tokens
                         and c.records[-1].submitted >= t0)
    drained = clients.run(lambda: not any(map(waiting, clients.clients)),
                          mix["stop_timeout_s"], only=waiting)
    if window:
        window.stop()
        r.trace_window = window
    clients.close()
    sync()
    r.window_s = t1 - t0
    records = clients.records
    r.extra.update(t0=t0, t1=t1, stats0=stats0, stats1=stats1,
                   requests=records)
    r.attempted = sum(t0 <= q.submitted < t1 for q in records)
    r.failed = sum(q.error is not None for q in records)
    if dev == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()

    sample = _sample(records, r.seed, mix["check_tokens"],
                     mix["check_requests"])
    del engine, clients
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    params = weights.make(cfg, r.seed, dev, tcfg.dtype)
    gap, ctl_gap, alt_gap = 0.0, 0.0, 0.0
    rng = np.random.default_rng([r.seed & (2**63 - 1), 19])
    alt_at = int(rng.integers(len(sample))) if sample else 0
    for j, q in enumerate(sample):
        seq = np.concatenate([q.prompt, np.asarray(q.tokens, np.int64)])
        ref = gpt2.next_token_logits(params, seq, len(q.prompt), cfg,
                                     device=dev)
        gap = max(gap, check.widest_gap(ref, q.tokens)[0])
        if control:
            low = gpt2.next_token_logits(params, seq, len(q.prompt), cfg,
                                         fp8=True, device=dev)
            ctl_gap = max(ctl_gap, check.widest_gap(
                ref, low.argmax(dim=-1).tolist())[0])
            if j == alt_at:
                i = int(rng.integers(len(q.tokens)))
                bad = list(q.tokens)
                bad[i] = (bad[i] + 1 + int(rng.integers(cfg["vocab_size"] - 1))
                          ) % cfg["vocab_size"]
                alt_gap = check.widest_gap(ref[i:i + 1], bad[i:i + 1])[0]
    r.extra["check_sample"] = {"requests": len(sample),
                               "tokens": sum(len(q.tokens) for q in sample)}
    if control:
        r.extra["calibration"] = {"control_gap": ctl_gap,
                                  "altered_token_gap": alt_gap}
    numbers = {"widest_gap": gap if sample else float("nan")}
    ok, r.checks = check.judge(numbers, r.limits)
    r.correct = ok and r.failed == 0 and drained

"""Env-overridable configuration: the knobs the port's modules read.

Counterpart of ``ray_tpu/core/config.py`` cut to this slice. Each flag
resolves from the ``RAY_TPU_<NAME>`` environment variable, else its default
— the same names and defaults as the JAX package, so one environment
configures both engines alike. (The JAX package's ``system_config`` dict
comes from ``ray_tpu.init``, which the port does not have yet.)
"""

from __future__ import annotations

import os


class _Flag:
    __slots__ = ("name", "default", "type")

    def __init__(self, default):
        self.default = default
        self.type = type(default)
        self.name = None  # filled by __set_name__

    def __set_name__(self, owner, name):
        self.name = name

    def resolve(self):
        env = os.environ.get(f"RAY_TPU_{self.name.upper()}")
        if env is not None:
            return self._coerce(env)
        return self.default

    def _coerce(self, value):
        if self.type is bool:
            return value.lower() in ("1", "true", "yes", "on")
        try:
            return self.type(value)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"invalid value {value!r} for config flag '{self.name}': "
                f"expected {self.type.__name__} (set via the "
                f"RAY_TPU_{self.name.upper()} env var)") from e


class Config:
    """Resolved serve knobs; build one with :func:`config`."""

    # KV-cache slots per continuous-batching engine: sequences that decode
    # together in one batched dispatch.
    serve_llm_slots = _Flag(4)
    # Prefill token budget per engine iteration (the first admission of a
    # step is always exempt, so the budget bounds batching, never progress).
    serve_llm_prefill_tokens = _Flag(128)
    # Admission-control shed threshold: past this many waiting requests,
    # submit raises Saturated. 0 disables shedding.
    serve_admission_queue_limit = _Flag(32)
    # Tokens per KV block in the paged pool.
    serve_kv_block_tokens = _Flag(16)
    # Blocks in the shared pool (block 0 is trash). 0 = auto: 2x a full slot
    # set at max_len, plus the trash block.
    serve_kv_pool_blocks = _Flag(0)
    # Paged-attention implementation: "auto" picks the CUDA kernel for a
    # CUDA pool and the plain version for a CPU pool; "cuda" / "plain" force
    # one of those (and must match the pool's device); "gather" runs the
    # table-gather + dense-mask formulation.
    serve_paged_attention_kernel = _Flag("auto")
    # Per-queued-request service-time estimate (seconds) behind the
    # Saturated.retry_after_s hint.
    serve_retry_after_item_s = _Flag(0.05)
    # Speculative decoding: draft tokens each slot proposes a step, verified
    # in ONE batched target forward. 0 disables it; > 0 needs a draft model
    # (PagedLLMEngine draft_params/draft_config). Greedy output stays
    # token-identical; sampled output keeps the target's distribution.
    serve_spec_tokens = _Flag(0)
    # Per-slot acceptance floor: a slot whose acceptance EWMA sinks below it
    # stops proposing for the rest of its request.
    serve_spec_accept_floor = _Flag(0.35)
    # EWMA factor of that acceptance rate (new = (1-a)*old + a*step_rate).
    serve_spec_accept_alpha = _Flag(0.3)
    # The cluster-wide KV tier. Not ported yet: the paged engine raises when
    # it is on rather than serve without it.
    kv_tier_enabled = _Flag(False)

    # -- timeouts -------------------------------------------------------------
    # Wait budget of internal loops that re-check a predicate; a blocked
    # channel endpoint is recorded as stalled after a quarter of it.
    internal_wait_timeout_s = _Flag(60.0)

    # -- shm channels ---------------------------------------------------------
    # Ring depth of an shm channel: values in flight on one edge before the
    # writer blocks on the reader's ack (1 = strict lock-step).
    dag_channel_slots = _Flag(8)
    # Busy-spin iterations before a blocked channel endpoint sleep-polls.
    dag_channel_tight_spins = _Flag(0)
    # Sleep-poll granularity (microseconds) of a blocked channel endpoint;
    # backs off exponentially to 40x this while idle.
    dag_channel_spin_us = _Flag(50.0)

    # -- observability --------------------------------------------------------
    # Gate of every built-in metric observation (off = one flag check).
    metrics_export_enabled = _Flag(True)
    # Request tracing master gate: off, every potential span costs one flag
    # check; on, head-based sampling below decides per trace at its root.
    trace_enabled = _Flag(True)
    # Head-based sampling probability in [0, 1], decided once at a trace
    # root and carried in the context.
    trace_sample_rate = _Flag(1.0)
    # Per-process flight recorder (util.flightrec): a bounded mmap'd event
    # ring under the session dir. Off = every record site costs one check.
    flightrec_enabled = _Flag(True)
    # Flight-recorder ring size per process, KiB (128-byte slots).
    flightrec_ring_kb = _Flag(256)

    def __init__(self):
        for name, flag in list(vars(type(self)).items()):
            if isinstance(flag, _Flag):
                setattr(self, name, flag.resolve())


def config() -> Config:
    """The knobs as the environment sets them now (read at each call, so an
    engine built after an env change sees the change)."""
    return Config()

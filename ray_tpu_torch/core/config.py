"""Env-overridable configuration: the serve knobs the paged engine reads.

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

    def __init__(self):
        for name, flag in list(vars(type(self)).items()):
            if isinstance(flag, _Flag):
                setattr(self, name, flag.resolve())


def config() -> Config:
    """The knobs as the environment sets them now (read at each call, so an
    engine built after an env change sees the change)."""
    return Config()

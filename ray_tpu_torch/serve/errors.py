"""Serve data-plane errors.

Counterpart of ``ray_tpu/serve/errors.py``: typed errors the engine raises
so callers can tell "back off and retry" (:class:`Saturated`) from a real
failure.
"""

from __future__ import annotations

from typing import Optional


class Saturated(RuntimeError):
    """Admission control shed: the request was refused FAST instead of
    queueing unboundedly, so the caller can apply its own backpressure. The
    request was NOT started; retrying is always safe.

    ``reason`` names the shed class (``"saturated"``: the engine's queue is
    past ``max_queue``; ``"quota"``: a tenant is over its admission quota).
    ``retry_after_s``, when set, is an advisory backoff hint computed from
    the observed queue depth.
    """

    def __init__(self, message: str = "", *, reason: str = "saturated",
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s

    def __reduce__(self):
        # Exception pickling replays only positional ``args``; the shed
        # class and backoff hint must survive a process hop.
        return (_rebuild_saturated,
                (str(self), self.reason, self.retry_after_s))


def _rebuild_saturated(message, reason, retry_after_s) -> Saturated:
    return Saturated(message, reason=reason, retry_after_s=retry_after_s)

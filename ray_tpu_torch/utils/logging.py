"""Structured logging for the port's components.

Counterpart of ``ray_tpu/utils/logging.py``: one logger namespace per
component under ``ray_tpu_torch``, with the process id and component on every
line so interleaved multi-process logs stay attributable.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(process)d %(name)s] %(message)s"
_configured = False


def log_swallowed(logger: logging.Logger, context: str) -> None:
    """Record an intentionally swallowed exception instead of ``pass``: the
    traceback stays one ``RAY_TPU_LOG_LEVEL=DEBUG`` away. Call from inside
    the ``except`` block; never raises, not even during interpreter
    teardown."""
    try:
        logger.debug("swallowed exception in %s", context, exc_info=True)
    except Exception:  # raylint: ignore[swallowed-exception] — the helper
        pass  # itself must not raise


def get_logger(component: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("RAY_TPU_LOG_LEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("ray_tpu_torch")
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _configured = True
    return logging.getLogger(f"ray_tpu_torch.{component}")

"""Model multiplexing — many models per deployment, routed to warm replicas.

The port's copy of ``ray_tpu/serve/multiplex.py``: a replica method
decorated with ``@serve.multiplexed(max_num_models_per_replica=N)`` loads
models on demand into a per-replica LRU; each loaded set is reported to the
controller, and the router prefers replicas that already hold the requested
``multiplexed_model_id`` — cold replicas only see a model id when every warm
one is saturated, so the cluster converges to a stable model↔replica
assignment without any central planner.

A "model" here is typically a dict of parameter tensors already resident
in the card's memory — the LRU bound is that memory's budget, and
routing-to-warm avoids re-uploading weights through the host for every
request.
"""

from __future__ import annotations

import contextvars
import threading
from collections import OrderedDict
from typing import Any, Callable, List, Optional

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "ray_tpu_multiplexed_model_id", default="")

# Per-process registry of wrappers so the hosting replica can report its
# loaded model ids (one replica process hosts at most one deployment).
_wrappers: List["_ModelMultiplexWrapper"] = []
_wrappers_lock = threading.Lock()


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the CURRENT request (reference:
    ``serve.get_multiplexed_model_id``)."""
    return _current_model_id.get()


class _LoadGate:
    """One load ATTEMPT: waiters park on ``event``; if the loader raised,
    ``error`` carries the exception to every waiter of THIS attempt (a later
    request starts a fresh attempt — transient failures stay retryable)."""

    __slots__ = ("event", "error")

    def __init__(self):
        self.event = threading.Event()
        self.error: Optional[BaseException] = None


def _wait_slice() -> float:
    """internal_wait_timeout_s, with its default as the fallback."""
    try:
        from ray_tpu_torch.core.config import config

        return config().internal_wait_timeout_s
    except Exception:  # noqa: BLE001 — config unavailable mid-teardown
        return 60.0


class _ModelMultiplexWrapper:
    """LRU of loaded models keyed by model id."""

    def __init__(self, loader: Callable[[Any, str], Any],
                 max_num_models: int):
        self._loader = loader
        self._max = max_num_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        # Per-model load gates: concurrent cold requests for the SAME model
        # must not each run the loader (two weight uploads to the card, transient 2x
        # memory). One thread loads; the rest wait on its gate.
        self._loading: dict = {}
        with _wrappers_lock:
            _wrappers.append(self)

    def loaded_model_ids(self) -> List[str]:
        with self._lock:
            return list(self._models.keys())

    def load(self, instance, model_id: str) -> Any:
        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
                gate = self._loading.get(model_id)
                if gate is None:
                    gate = _LoadGate()
                    self._loading[model_id] = gate
                    break  # this thread loads
            # Timed slices (not one magic 600s park): a loader thread lost
            # to a kill mid-load wakes the waiters at the internal cadence
            # to re-check instead of stranding them.
            gate.event.wait(timeout=_wait_slice())
            if gate.event.is_set() and gate.error is not None:
                # THIS attempt failed: every parked waiter gets the loader's
                # exception instead of serially re-running a failing loader.
                raise gate.error
            # loaded (or still loading / loader died) — re-check the cache
        try:
            model = self._loader(instance, model_id)
        except BaseException as e:  # noqa: BLE001 — propagate to waiters
            with self._lock:
                self._loading.pop(model_id, None)
            gate.error = e
            gate.event.set()
            raise
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            if len(self._models) > self._max:
                self._models.popitem(last=False)  # LRU eviction
            self._loading.pop(model_id, None)
        gate.event.set()
        return model


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator for a replica's model-loader method::

        @serve.deployment
        class Models:
            @serve.multiplexed(max_num_models_per_replica=4)
            def get_model(self, model_id: str):
                return load_params(model_id)   # cached per replica, LRU

            def __call__(self, payload):
                model = self.get_model(serve.get_multiplexed_model_id())
                return infer(model, payload)

    Callers pick the model with
    ``handle.options(multiplexed_model_id="m1").remote(...)``.
    """

    def decorate(loader: Callable) -> Callable:
        wrapper = _ModelMultiplexWrapper(loader, max_num_models_per_replica)

        def bound(self, model_id: Optional[str] = None):
            mid = model_id if model_id is not None else get_multiplexed_model_id()
            if not mid:
                raise ValueError(
                    "no model id: pass one explicitly or set "
                    "handle.options(multiplexed_model_id=...) on the caller")
            return wrapper.load(self, mid)

        bound.__name__ = getattr(loader, "__name__", "get_model")
        bound._multiplex_wrapper = wrapper
        return bound

    return decorate


def loaded_model_ids() -> List[str]:
    """All model ids loaded in this process (union over wrappers)."""
    with _wrappers_lock:
        wrappers = list(_wrappers)
    out: List[str] = []
    for w in wrappers:
        out.extend(w.loaded_model_ids())
    return out


def set_current_model_id(model_id: str):
    return _current_model_id.set(model_id)


def reset_current_model_id(token) -> None:
    _current_model_id.reset(token)

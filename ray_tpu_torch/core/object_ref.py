"""ObjectRef — the distributed future handle.

The port's copy of ``ray_tpu/core/object_ref.py``.

Analog of the reference's ``ObjectRef`` (Cython class in
``python/ray/_raylet.pyx``; ownership semantics in
``src/ray/core_worker/reference_count.h:61``). A ref names an immutable object
in the cluster; holding it keeps the object pinned (reference counting), and
passing it into a task creates a borrow. Refs are awaitable and hashable.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

if TYPE_CHECKING:
    pass

logger = get_logger("object_ref")


def _runtime():
    from ray_tpu_torch.core.runtime import get_runtime

    return get_runtime()


class ObjectRef:
    __slots__ = ("_id", "_owner_hint", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_hint: str | None = None):
        self._id = object_id
        self._owner_hint = owner_hint
        rt = _maybe_runtime()
        if rt is not None:
            # The owner hint rides along so a foreign ref registers this
            # process as a BORROWER with the object's owner
            # (reference_count.h:61; see _LocalRefCounter).
            rt.reference_counter.add_local_reference(object_id, owner_hint)

    @property
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def future(self):
        """A concurrent.futures.Future resolving to the object's value."""
        return _runtime().future_for(self)

    def __await__(self):
        import asyncio

        fut = _runtime().asyncio_future_for(self, asyncio.get_event_loop())
        return fut.__await__()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        # Serialize-time collection: a value being put/returned that
        # CONTAINS refs must pin them on the outer object's owner until the
        # outer is freed (nested-ref half of the borrow protocol). The
        # serializer opens a collection scope; every ref pickled inside it
        # lands here.
        from ray_tpu_torch.core import serialization as _ser

        _ser.note_serialized_ref(self)
        return (ObjectRef, (self._id, self._owner_hint))

    def __del__(self):
        # Finalizers run at arbitrary decref points — possibly while this
        # thread holds runtime locks — so the release must not take locks
        # here: release_local_ref defers to a drainer in multiprocess mode
        # (CoreWorker) and stays synchronous in-process (Runtime).
        try:
            rt = _maybe_runtime()
            if rt is not None:
                rt.release_local_ref(self._id)
        except Exception:  # noqa: BLE001 — interpreter shutdown
            log_swallowed(logger, "ref release")


def _maybe_runtime():
    try:
        from ray_tpu_torch.core import runtime as _rt_mod
    except Exception:
        return None
    return _rt_mod._global_runtime


class ObjectRefGenerator:
    """Streaming-generator return handle.

    Analog of the reference's ``ObjectRefGenerator``
    (``python/ray/_raylet.pyx:272``; generator returns reported via
    ``core_worker.cc:3199 HandleReportGeneratorItemReturns``): iterating yields
    ObjectRefs to items as the remote generator produces them.
    """

    def __init__(self, task_id, runtime):
        self._task_id = task_id
        self._runtime = runtime
        self._next_index = 0

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        ref = self._runtime.next_generator_item(self._task_id, self._next_index)
        if ref is None:
            raise StopIteration
        self._next_index += 1
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        ref = await self._runtime.next_generator_item_async(
            self._task_id, self._next_index
        )
        if ref is None:
            raise StopAsyncIteration
        self._next_index += 1
        return ref

    def __del__(self):
        # Reclaim owner-side stream state + never-consumed inline items
        # (they were registered owned at report time and have no handles).
        # Deferred in multiprocess mode: release_generator takes runtime
        # locks a finalizer's interrupted thread may already hold.
        try:
            release = getattr(self._runtime, "release_generator_deferred",
                              None)
            (release or self._runtime.release_generator)(self._task_id)
        except Exception:  # noqa: BLE001 — interpreter teardown
            log_swallowed(logger, "release_generator")

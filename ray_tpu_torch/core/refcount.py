"""Distributed reference counting (ownership model).

The port's copy of ``ray_tpu/core/refcount.py``.

Analog of the reference's ``ReferenceCounter``
(``src/ray/core_worker/reference_count.h:61`` — every object has exactly one
*owner* (the worker that created it); local refs + submitted-task refs +
borrower sets keep it alive; lineage pinning keeps the creating TaskSpec
around for reconstruction). This implementation tracks, per object:

- local reference count (ObjectRef instances alive in this process),
- submitted-task count (tasks in flight that take the object as an argument),
- a lineage pin (the creating task spec, enabling resubmit-on-loss).

When all counts reach zero the object is released from the store. The borrow
protocol collapses in-process (a single driver process owns all refs in local
mode); the interface carries owner metadata so a multi-worker deployment can
extend it without API change.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ObjectID


class _Ref:
    __slots__ = ("local", "submitted", "lineage", "owner")

    def __init__(self):
        self.local = 0
        self.submitted = 0
        self.lineage = None  # TaskSpec that created this object, for recovery
        self.owner: Optional[str] = None

    def total(self) -> int:
        return self.local + self.submitted


class ReferenceCounter:
    def __init__(self, on_release: Callable[[ObjectID], None] | None = None):
        self._lock = threading.Lock()
        self._refs: Dict[ObjectID, _Ref] = {}
        self._on_release = on_release
        # An allocation inside a critical section can start a GC pass that
        # runs an ObjectRef finalizer on the thread holding _lock; its
        # release must not take the (non-reentrant) lock again. Such
        # decrements wait in _deferred until the section ends.
        self._holder: Optional[int] = None
        self._deferred: List[Tuple[ObjectID, str]] = []

    @contextlib.contextmanager
    def _locked(self):
        with self._lock:
            self._holder = threading.get_ident()
            try:
                yield
            finally:
                self._holder = None
        while self._deferred:
            try:
                object_id, field = self._deferred.pop()
            except IndexError:  # another thread drained it
                break
            self._dec(object_id, field)

    def add_local_reference(self, object_id: ObjectID,
                            owner_hint: Optional[str] = None) -> None:
        # owner_hint is part of the shared ObjectRef contract; in-process
        # mode has a single owner so the borrow protocol collapses here.
        with self._locked():
            self._refs.setdefault(object_id, _Ref()).local += 1

    def remove_local_reference(self, object_id: ObjectID) -> None:
        self._dec(object_id, "local")

    def add_submitted_task_reference(self, object_id: ObjectID) -> None:
        with self._locked():
            self._refs.setdefault(object_id, _Ref()).submitted += 1

    def remove_submitted_task_reference(self, object_id: ObjectID) -> None:
        self._dec(object_id, "submitted")

    def set_lineage(self, object_id: ObjectID, task_spec) -> None:
        with self._locked():
            self._refs.setdefault(object_id, _Ref()).lineage = task_spec

    def get_lineage(self, object_id: ObjectID):
        with self._locked():
            ref = self._refs.get(object_id)
            return ref.lineage if ref else None

    def num_references(self, object_id: ObjectID) -> int:
        with self._locked():
            ref = self._refs.get(object_id)
            return ref.total() if ref else 0

    def _dec(self, object_id: ObjectID, field: str) -> None:
        if self._holder == threading.get_ident():
            self._deferred.append((object_id, field))
            return
        release = False
        with self._locked():
            ref = self._refs.get(object_id)
            if ref is None:
                return
            setattr(ref, field, max(0, getattr(ref, field) - 1))
            if ref.total() == 0:
                del self._refs[object_id]
                release = True
        if release and self._on_release is not None:
            self._on_release(object_id)

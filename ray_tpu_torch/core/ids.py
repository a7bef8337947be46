"""Binary unique identifiers for every first-class entity in the runtime.

The port's copy of ``ray_tpu/core/ids.py``: the same byte layouts and
derivations, so an id made by either package reads the same in the other.

Analog of the reference's ID system (reference:
``src/ray/common/id.h`` — JobID 4 bytes, ActorID 16, TaskID 24, ObjectID 28,
composed hierarchically so an ObjectID embeds the TaskID that created it and a
TaskID embeds its ActorID/JobID). We keep the same hierarchical-embedding idea
with simpler fixed sizes: all IDs are raw bytes with a hex repr, ordered and
hashable, usable as dict keys across process boundaries.
"""

from __future__ import annotations

import os
import threading

_NIL = b"\xff"


class BaseID:
    """Immutable binary ID. Subclasses fix SIZE (bytes)."""

    SIZE = 16
    __slots__ = ("_bytes", "_hash")

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got "
                f"{len(binary) if isinstance(binary, bytes) else type(binary)}"
            )
        self._bytes = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(_NIL * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == _NIL * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4

    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(cls.SIZE, "big"))

    @classmethod
    def next(cls) -> "JobID":
        with cls._lock:
            cls._counter += 1
            return cls.from_int(cls._counter)


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(cls.SIZE - JobID.SIZE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])


class TaskID(BaseID):
    # ActorID prefix (16) + unique suffix (8), mirroring the reference's
    # TaskID = ActorID + unique bytes layout (src/ray/common/id.h).
    SIZE = 24

    @classmethod
    def for_task(cls, job_id: JobID, actor_id: ActorID | None = None) -> "TaskID":
        prefix = (actor_id or ActorID.nil()).binary()
        return cls(prefix + os.urandom(cls.SIZE - ActorID.SIZE))

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[: ActorID.SIZE])


class ObjectID(BaseID):
    # TaskID prefix (24) + return-index (4), mirroring ObjectID = TaskID + index
    # (src/ray/common/id.h ObjectID layout).
    SIZE = 28

    @classmethod
    def for_put(cls) -> "ObjectID":
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[TaskID.SIZE :], "big")


class PlacementGroupID(BaseID):
    SIZE = 16

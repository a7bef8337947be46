"""User-visible runtime exceptions.

The port's copy of ``ray_tpu/core/exceptions.py``.

Analog of the reference's ``python/ray/exceptions.py`` — a ``TaskError`` that
wraps the remote traceback and re-raises at ``get`` (RayTaskError), actor death
(RayActorError), object loss (ObjectLostError), get timeout, and cancellation.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception remotely; re-raised at ``get``.

    Mirrors RayTaskError: carries the remote traceback string and the original
    exception (pickled across the wire) as ``cause``.
    """

    def __init__(self, function_name: str, remote_traceback: str, cause: BaseException | None):
        self.function_name = function_name
        self.remote_traceback = remote_traceback
        self.cause = cause
        super().__init__(
            f"task {function_name} failed:\n{remote_traceback}"
        )

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        try:
            import cloudpickle

            cloudpickle.dumps(exc)
            cause = exc
        except Exception:
            cause = None  # unpicklable exception: keep only the traceback text
        return cls(function_name, tb, cause)

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is an instance of the original type."""
        if self.cause is not None and isinstance(self.cause, Exception):
            # Chain so the remote traceback is visible.
            self.cause.__cause__ = None
            return self.cause
        return self

    def __reduce__(self):
        return (TaskError, (self.function_name, self.remote_traceback, self.cause))


class ActorError(RayTpuError):
    """An actor task failed because the actor is dead or dying."""

    def __init__(self, actor_id=None, message: str = "actor died"):
        self.actor_id = actor_id
        self._message = message
        super().__init__(f"{message} (actor={actor_id})")

    def __reduce__(self):
        return (type(self), (self.actor_id, self._message))


class ActorDiedError(ActorError):
    pass


class ActorUnavailableError(ActorError):
    """Actor temporarily unreachable (restarting); call may be retried."""


class ObjectLostError(RayTpuError):
    def __init__(self, object_id, message="object lost and not recoverable"):
        self.object_id = object_id
        self._message = message
        super().__init__(f"{message} (object={object_id})")

    def __reduce__(self):
        return (ObjectLostError, (self.object_id, self._message))


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"task was cancelled (task={task_id})")

    def __reduce__(self):
        return (TaskCancelledError, (self.task_id,))


class RuntimeNotInitializedError(RayTpuError):
    def __init__(self):
        super().__init__(
            "ray_tpu_torch.init() must be called before using the API"
        )


class OutOfMemoryError(RayTpuError):
    """Object store is full and eviction/spilling could not make room."""


class WorkerDiedError(RayTpuError):
    """A worker process exited while running a task (retriable).

    Raised by the node daemon's ``execute_task`` when its worker's RPC
    connection drops mid-task (reference: worker failure reported by the
    raylet to the owner, which retries per ``max_retries`` —
    ``task_manager.cc``). Lives here (not in the daemon module) so it
    unpickles in every process regardless of ``python -m`` aliasing.
    """

    def __init__(self, message: str, retriable: bool = True):
        super().__init__(message)
        self.retriable = retriable

    def __reduce__(self):
        return (WorkerDiedError, (self.args[0], self.retriable))


class PendingCallsLimitExceededError(RayTpuError):
    """Actor's max_pending_calls was exceeded."""

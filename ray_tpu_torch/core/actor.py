"""Actor classes and handles.

Analog of the reference's ``python/ray/actor.py`` (``ActorClass`` :563,
``_remote`` :851, method proxies :201): ``@remote`` on a class yields an
``ActorClass``; ``.remote(...)`` registers + creates the actor through the
GCS-driven path (``gcs_actor_manager.cc:255,280``); method calls flow through
an ``ActorHandle`` straight to the actor's mailbox (the direct actor transport
of ``direct_actor_task_submitter.cc`` — no scheduler on the call path), with
per-handle sequence numbers for ordering.

The port's copy of ``ray_tpu/core/actor.py``; ``ActorMethod.bind`` authors
a compiled-DAG stage (``ray_tpu_torch/dag``).
"""

from __future__ import annotations

import hashlib
import itertools
import uuid
from typing import Any, Dict

from ray_tpu_torch.core.ids import ActorID, TaskID
from ray_tpu_torch.core.runtime import get_runtime
from ray_tpu_torch.core.remote_function import make_task_args, resolve_options
from ray_tpu_torch.core.task_spec import TaskSpec, TaskType


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str):
        self._handle = handle
        self._method_name = method_name

    def remote(self, *args, **kwargs):
        return self._handle._submit(self._method_name, args, kwargs, {})

    def bind(self, *args):
        """Author a compiled-DAG stage (compile with
        ``.experimental_compile()``). Each arg is an upstream DAG node
        (fan-in: one channel-fed value per tick) or a constant baked into
        every call; at least one must be a DAG node."""
        from ray_tpu_torch.dag.dag_node import ClassMethodNode

        # ClassMethodNode validates that at least one arg is a DAG node.
        return ClassMethodNode(self._handle, self._method_name, *args)

    def options(self, **overrides):
        handle, name = self._handle, self._method_name

        class _Bound:
            def remote(self, *args, **kwargs):
                return handle._submit(name, args, kwargs, overrides)

        return _Bound()

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; use .remote()"
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str, class_id: str):
        self._actor_id = actor_id
        self._class_name = class_name
        self._class_id = class_id
        self._seq = itertools.count()
        # Fresh per handle instance (incl. unpickled copies): sequence numbers
        # are scoped to (caller, handle), mirroring the reference's per-caller
        # submit queues.
        self._caller_id = uuid.uuid4().hex
        # Option resolution is pure and override-free calls dominate the hot
        # path — resolve once per handle instead of per call.
        self._plain_options = resolve_options({"max_retries": 0}, {})

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def _submit(self, method_name: str, args, kwargs, overrides):
        rt = get_runtime()
        options = (self._plain_options if not overrides
                   else resolve_options({"max_retries": 0}, overrides))
        task_args, task_kwargs = make_task_args(args, kwargs)
        from ray_tpu_torch.util import tracing

        spec = TaskSpec(
            task_id=TaskID.for_task(rt.job_id, self._actor_id),
            job_id=rt.job_id,
            task_type=TaskType.ACTOR_TASK,
            function_id=self._class_id,
            function_name=self._class_name,
            args=task_args,
            kwargs=task_kwargs,
            options=options,
            actor_id=self._actor_id,
            actor_method=method_name,
            sequence_number=next(self._seq),
            caller_id=self._caller_id,
            trace_ctx=tracing.context_for_spec(),
        )
        refs = rt.submit_actor_task(spec)
        if options.num_returns in ("dynamic", "streaming"):
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, rt)
        if options.num_returns == 0:
            return None
        if options.num_returns == 1:
            return refs[0]
        return refs

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name, self._class_id))


class ActorClass:
    def __init__(self, cls, default_options: Dict[str, Any]):
        self._cls = cls
        self._default_options = default_options
        self._class_name = cls.__name__
        try:
            import cloudpickle

            code_hash = hashlib.sha1(cloudpickle.dumps(cls)).hexdigest()
        except Exception:
            code_hash = uuid.uuid4().hex
        self._class_id = f"actor:{self._class_name}:{code_hash[:16]}"

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._class_name}' cannot be instantiated directly; "
            f"use .remote()"
        )

    @property
    def underlying(self):
        return self._cls

    def options(self, **overrides) -> "_BoundActorClass":
        return _BoundActorClass(self, overrides)

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, {})

    def _remote(self, args, kwargs, overrides) -> ActorHandle:
        rt = get_runtime()
        options = resolve_options(self._default_options, overrides)
        if options.get_if_exists:
            if not options.name:
                raise ValueError("get_if_exists requires a name")
            existing = rt.gcs.get_named_actor(
                options.name, options.namespace or rt.namespace
            )
            if existing is not None:
                return ActorHandle(existing, self._class_name, self._class_id)
        if rt.gcs.get_function(self._class_id) is None:
            rt.gcs.export_function(self._class_id, self._cls)
        task_args, task_kwargs = make_task_args(args, kwargs)
        spec = TaskSpec(
            task_id=TaskID.for_task(rt.job_id),
            job_id=rt.job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            function_id=self._class_id,
            function_name=self._class_name,
            args=task_args,
            kwargs=task_kwargs,
            options=options,
        )
        actor_id = rt.create_actor(spec)
        return ActorHandle(actor_id, self._class_name, self._class_id)


class _BoundActorClass:
    def __init__(self, actor_class: ActorClass, overrides):
        self._ac = actor_class
        self._overrides = overrides

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._ac._remote(args, kwargs, self._overrides)


def get_actor(name: str, namespace: str | None = None) -> ActorHandle:
    """Look up a named actor (reference: ``ray.get_actor`` →
    GCS named-actor table)."""
    rt = get_runtime()
    actor_id = rt.gcs.get_named_actor(name, namespace or rt.namespace)
    if actor_id is None:
        raise ValueError(f"no actor named '{name}' in namespace "
                         f"'{namespace or rt.namespace}'")
    info = rt.gcs.get_actor(actor_id)
    return ActorHandle(actor_id, info.class_name if info else "?", f"actor:{name}")

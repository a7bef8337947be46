"""@remote functions — decoration, option resolution, submission.

Analog of the reference's ``python/ray/remote_function.py`` (``_remote`` :266
→ ``core_worker.submit_task`` :435) and the unified option table
(``python/ray/_private/ray_option_utils.py``). The function body is exported
once to the GCS function store keyed by a content hash — the reference's
function-manager export path (``python/ray/_private/function_manager.py:195``).

The port's copy of ``ray_tpu/core/remote_function.py``, with the card as the
accelerator resource: ``num_gpus`` grants ``GPU`` (``num_tpus`` is accepted
as its alias, as the JAX package accepts ``num_gpus`` for ``TPU``), and
``accelerator_type="H100"`` adds the ``GPU-H100`` marker.
"""

from __future__ import annotations

import hashlib
import uuid
from typing import Any, Dict

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import TaskID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.runtime import get_runtime
from ray_tpu_torch.core.task_spec import TaskArg, TaskOptions, TaskSpec, TaskType

_VALID_OPTIONS = {
    "num_cpus", "num_tpus", "num_gpus", "resources", "num_returns", "max_retries",
    "retry_exceptions", "name", "scheduling_strategy", "max_restarts",
    "max_task_retries", "max_concurrency", "max_pending_calls", "lifetime",
    "namespace", "get_if_exists", "concurrency_groups", "runtime_env",
    "memory", "accelerator_type",
}


def resolve_options(defaults: Dict[str, Any], overrides: Dict[str, Any]) -> TaskOptions:
    merged = dict(defaults)
    for source in (defaults, overrides):
        for k in source:
            if k not in _VALID_OPTIONS:
                raise ValueError(f"unknown option '{k}' (valid: {sorted(_VALID_OPTIONS)})")
    merged.update(overrides)
    resources = dict(merged.get("resources") or {})
    if merged.get("num_cpus") is not None:
        resources["CPU"] = float(merged["num_cpus"])
    # The card is the accelerator resource; accept num_tpus as an alias so
    # code written for the JAX package ports over, but it grants cards.
    n_acc = merged.get("num_gpus", merged.get("num_tpus"))
    if n_acc is not None:
        resources["GPU"] = float(n_acc)
    if merged.get("memory") is not None:
        resources["memory"] = float(merged["memory"])
    if merged.get("accelerator_type"):
        resources[f"GPU-{merged['accelerator_type'].upper()}"] = 0.001
    opts = TaskOptions(
        name=merged.get("name") or "",
        num_returns=merged.get("num_returns", 1),
        resources=resources,
        max_retries=merged.get("max_retries", config().default_max_retries),
        retry_exceptions=merged.get("retry_exceptions", False),
        max_restarts=merged.get("max_restarts", 0),
        max_task_retries=merged.get("max_task_retries", 0),
        max_concurrency=merged.get("max_concurrency", 1),
        max_pending_calls=merged.get("max_pending_calls", -1),
        lifetime=merged.get("lifetime"),
        namespace=merged.get("namespace"),
        runtime_env=merged.get("runtime_env"),
        get_if_exists=merged.get("get_if_exists", False),
        concurrency_groups=merged.get("concurrency_groups") or {},
    )
    if merged.get("scheduling_strategy") is not None:
        strategy = merged["scheduling_strategy"]
        if isinstance(strategy, str):
            from ray_tpu_torch.core.task_spec import (
                DefaultSchedulingStrategy,
                SpreadSchedulingStrategy,
            )

            strategy = {
                "DEFAULT": DefaultSchedulingStrategy(),
                "SPREAD": SpreadSchedulingStrategy(),
            }[strategy]
        from ray_tpu_torch.core.task_spec import NodeAffinitySchedulingStrategy

        if (isinstance(strategy, NodeAffinitySchedulingStrategy)
                and isinstance(strategy.node_id, str)):
            # Accept the hex form (what nodes()/the state API return): the
            # scheduler keys nodes by NodeID, and an unnormalized string
            # would silently never match — a hard affinity then queues
            # forever instead of erroring.
            from ray_tpu_torch.core.ids import NodeID

            strategy = NodeAffinitySchedulingStrategy(
                node_id=NodeID.from_hex(strategy.node_id),
                soft=strategy.soft)
        opts.scheduling_strategy = strategy
    return opts


def make_task_args(args, kwargs) -> tuple[list[TaskArg], dict[str, TaskArg]]:
    def convert(v):
        if isinstance(v, ObjectRef):
            return TaskArg(object_id=v.id, owner_addr=v._owner_hint)
        return TaskArg(value=v)

    return [convert(a) for a in args], {k: convert(v) for k, v in kwargs.items()}


class RemoteFunction:
    def __init__(self, function, default_options: Dict[str, Any]):
        self._function = function
        self._default_options = default_options
        self._function_name = getattr(function, "__qualname__", str(function))
        try:
            import cloudpickle

            code_hash = hashlib.sha1(cloudpickle.dumps(function)).hexdigest()
        except Exception:
            code_hash = uuid.uuid4().hex
        self._function_id = f"fn:{self._function_name}:{code_hash[:16]}"
        self._exported = False
        # Override-free calls dominate the hot path: resolve options once
        # (lazily — decoration must not raise) and reuse the SAME object so
        # the cached task-spec template encoder memo-hits per callable.
        self._plain_options = None

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._function_name}' cannot be called directly; "
            f"use .remote() (or access the original via .underlying)"
        )

    @property
    def underlying(self):
        return self._function

    def options(self, **overrides) -> "_BoundRemoteFunction":
        return _BoundRemoteFunction(self, overrides)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, {})

    def _remote(self, args, kwargs, overrides):
        rt = get_runtime()
        if not self._exported or rt.gcs.get_function(self._function_id) is None:
            rt.gcs.export_function(self._function_id, self._function)
            self._exported = True
        if overrides:
            options = resolve_options(self._default_options, overrides)
        else:
            options = self._plain_options
            if options is None:
                options = self._plain_options = resolve_options(
                    self._default_options, {})
        task_args, task_kwargs = make_task_args(args, kwargs)
        from ray_tpu_torch.util import tracing

        spec = TaskSpec(
            task_id=TaskID.for_task(rt.job_id),
            job_id=rt.job_id,
            task_type=TaskType.NORMAL_TASK,
            function_id=self._function_id,
            function_name=options.name or self._function_name,
            args=task_args,
            kwargs=task_kwargs,
            options=options,
            trace_ctx=tracing.context_for_spec(),
        )
        refs = rt.submit_task(spec)
        if options.num_returns in ("dynamic", "streaming"):
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, rt)
        if options.num_returns == 0:
            return None
        if options.num_returns == 1:
            return refs[0]
        return refs


class _BoundRemoteFunction:
    def __init__(self, remote_function: RemoteFunction, overrides):
        self._rf = remote_function
        self._overrides = overrides

    def remote(self, *args, **kwargs):
        return self._rf._remote(args, kwargs, self._overrides)

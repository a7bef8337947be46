"""Replica actor — hosts one copy of a deployment's callable.

The port's copy of ``ray_tpu/serve/replica.py``: wraps the user's
class/function, counts ongoing requests (the router's pow-2 signal),
applies ``user_config`` via ``reconfigure``, exposes a health
check, and supports sync functions, async coroutines, and (async) generators
for streaming responses.
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Callable, Dict, Optional


class ReplicaActor:
    def __init__(
        self,
        deployment_name: str,
        serialized_callable: Callable,
        init_args: tuple,
        init_kwargs: dict,
        user_config: Optional[Dict] = None,
    ):
        self.deployment_name = deployment_name
        self._is_function = not inspect.isclass(serialized_callable)
        if self._is_function:
            self._callable = serialized_callable
        else:
            self._callable = serialized_callable(*init_args, **init_kwargs)
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        if user_config is not None:
            self.reconfigure(user_config)

    # -- control plane -------------------------------------------------------
    def reconfigure(self, user_config: Dict) -> bool:
        if not self._is_function and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        return True

    def check_health(self) -> bool:
        if not self._is_function and hasattr(self._callable, "check_health"):
            self._callable.check_health()
        return True

    def get_metrics(self) -> Dict[str, float]:
        """``ongoing``/``total`` (the router drain probe's keys) merged with
        the hosted callable's ``get_engine_stats`` (slot occupancy, queue
        depth — KV-occupancy-aware routing), when it exposes one."""
        with self._lock:
            metrics = {"ongoing": float(self._ongoing),
                       "total": float(self._total)}
        if not self._is_function and hasattr(self._callable,
                                             "get_engine_stats"):
            try:
                stats = self._callable.get_engine_stats() or {}
                for k, v in stats.items():
                    metrics.setdefault(k, float(v))
            except Exception:  # noqa: BLE001 — a sick engine must not
                from ray_tpu_torch.utils.logging import (get_logger,  # break the
                                                   log_swallowed)  # probe

                log_swallowed(get_logger("serve_replica"),
                              "get_engine_stats")
        return metrics

    def get_state(self) -> Dict[str, Any]:
        """Model ids + load metrics in ONE control-plane RPC — what the
        controller's periodic poll distributes to routers as
        ``replica_load``."""
        return {"model_ids": self.multiplexed_model_ids(),
                "metrics": self.get_metrics()}

    def multiplexed_model_ids(self) -> list:
        """Model ids loaded in this replica (multiplex.py registry)."""
        from ray_tpu_torch.serve.multiplex import loaded_model_ids

        return loaded_model_ids()

    def kv_migrate_out(self, lane_name: str) -> int:
        """Drain-then-retire victim half (cluster KV tier): ship the hosted
        engine's warm prefix chains over the named handoff lane. 0 when the
        callable doesn't serve a paged engine."""
        if not self._is_function and hasattr(self._callable, "kv_migrate_out"):
            return int(self._callable.kv_migrate_out(lane_name))
        return 0

    def kv_migrate_in(self, lane_name: str) -> int:
        """Drain-then-retire survivor half: create the lane and import the
        victim's chains as warm prefix state. 0 when not applicable."""
        if not self._is_function and hasattr(self._callable, "kv_migrate_in"):
            return int(self._callable.kv_migrate_in(lane_name))
        return 0

    # -- data plane ----------------------------------------------------------

    def _trace_queue_wait(self, kwargs) -> None:
        """Emit the handle-submit → replica-pickup span. The handle injects
        ``_trace_submit_ts`` only into SAMPLED requests, so untraced calls
        pay one dict-pop here and nothing else."""
        submit_ts = kwargs.pop("_trace_submit_ts", None)
        if submit_ts is None:
            return
        from ray_tpu_torch.util import tracing

        ctx = tracing.current_context()
        if ctx is not None:
            tracing.emit("serve.replica_queue", ctx,
                         duration=max(0.0, time.time() - submit_ts),
                         attrs={"deployment": self.deployment_name})

    def handle_request(self, method_name: str, *args, **kwargs):
        from ray_tpu_torch.serve import multiplex

        self._trace_queue_wait(kwargs)
        model_id = kwargs.pop("_multiplexed_model_id", "")
        token = multiplex.set_current_model_id(model_id)
        with self._lock:
            self._ongoing += 1
            self._total += 1
        started = time.monotonic()
        try:
            target = self._resolve_method(method_name)
            result = target(*args, **kwargs)
            if inspect.iscoroutine(result):
                import asyncio

                result = asyncio.run(result)
            if inspect.isgenerator(result):
                # materialize sync generators; streaming goes through
                # handle_request_streaming
                return list(result)
            return result
        finally:
            multiplex.reset_current_model_id(token)
            with self._lock:
                self._ongoing -= 1
            self._observe_latency(time.monotonic() - started)

    def _observe_latency(self, elapsed_s: float) -> None:
        """Per-deployment request latency histogram (metrics plane)."""
        from ray_tpu_torch.core.metrics_export import (metrics_enabled,
                                                 serve_request_hist)

        if metrics_enabled():
            serve_request_hist().observe(
                elapsed_s, {"deployment": self.deployment_name})

    def dag_call(self, value):
        """Single-arg data-plane entry for PRECOMPILED pipeline DAGs
        (serve.run_pipeline(compiled=True)): the replica parks in a
        resident compiled-DAG loop reading this method's input from a
        mutable channel instead of taking per-request actor RPCs. Keeps
        the same ongoing/total bookkeeping and latency histogram as
        handle_request so autoscaling metrics and dashboards stay
        truthful."""
        import asyncio

        with self._lock:
            self._ongoing += 1
            self._total += 1
        started = time.monotonic()
        try:
            result = self._resolve_method("__call__")(value)
            if inspect.iscoroutine(result):
                result = asyncio.run(result)
            return result
        finally:
            with self._lock:
                self._ongoing -= 1
            self._observe_latency(time.monotonic() - started)

    def handle_request_streaming(self, method_name: str, *args, **kwargs):
        """Generator method: yields items (streamed via ObjectRefGenerator)."""
        from ray_tpu_torch.serve import multiplex

        self._trace_queue_wait(kwargs)
        model_id = kwargs.pop("_multiplexed_model_id", "")
        token = multiplex.set_current_model_id(model_id)
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            target = self._resolve_method(method_name)
            result = target(*args, **kwargs)
            if inspect.isasyncgen(result):
                import asyncio

                loop = asyncio.new_event_loop()
                try:
                    while True:
                        try:
                            yield loop.run_until_complete(result.__anext__())
                        except StopAsyncIteration:
                            break
                finally:
                    loop.close()
            elif inspect.isgenerator(result):
                yield from result
            else:
                yield result
        finally:
            multiplex.reset_current_model_id(token)
            with self._lock:
                self._ongoing -= 1

    def _resolve_method(self, method_name: str) -> Callable:
        if self._is_function:
            return self._callable
        if method_name == "__call__":
            return self._callable
        return getattr(self._callable, method_name)

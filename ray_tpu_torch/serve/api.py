"""serve.run / serve.shutdown / handles — public control API.

The port's copy of ``ray_tpu/serve/api.py``: walk the bound app graph dependencies-first, deploy each node (bound-handle
args replaced with DeploymentHandles — the composed-app pattern), wait for
replicas, return the ingress handle. The HTTP proxy starts lazily on the
run that asks for it (``_start_proxy``), the gRPC ingress likewise.
``run_pipeline`` deploys a linear chain and precompiles it into resident
DAG lanes (``compiled=True``) or walks it over per-call handles.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.controller import (CONTROLLER_NAME,
                                            get_or_create_controller)
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle

_proxy = None  # module-level HTTP proxy singleton
_grpc_proxy = None  # module-level gRPC proxy singleton
_pipelines: list = []  # live PipelineHandles; torn down in shutdown()


def run(
    app: Application,
    *,
    name: str = "default",
    route_prefix: Optional[str] = "/",
    blocking: bool = False,
    _start_proxy: bool = False,
    http_port: int = 8000,
    _start_grpc_proxy: bool = False,
    grpc_port: int = 0,
) -> DeploymentHandle:
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    controller = get_or_create_controller()

    nodes = app.walk()
    handles: Dict[int, DeploymentHandle] = {}
    for node in nodes:
        dep = node.deployment
        init_args = tuple(
            handles[id(a)] if isinstance(a, Application) else a for a in node.init_args
        )
        init_kwargs = {
            k: handles[id(v)] if isinstance(v, Application) else v
            for k, v in node.init_kwargs.items()
        }
        prefix = dep.route_prefix
        if node is nodes[-1] and prefix is None:
            prefix = route_prefix  # ingress gets the app prefix
        ray_tpu_torch.get(
            controller.deploy.remote(
                dep.name, dep.func_or_class, init_args, init_kwargs, dep.config, prefix
            )
        )
        handles[id(node)] = DeploymentHandle(dep.name, controller)

    ingress = handles[id(nodes[-1])]
    _wait_ready(controller, [n.deployment.name for n in nodes])

    if _start_proxy:
        global _proxy
        if _proxy is None:
            from ray_tpu_torch.serve.proxy import HttpProxy

            _proxy = HttpProxy(controller, port=http_port)
            _proxy.start()
    if _start_grpc_proxy:
        global _grpc_proxy
        if _grpc_proxy is None:
            from ray_tpu_torch.serve.grpc_proxy import GrpcProxy

            _grpc_proxy = GrpcProxy(controller, port=grpc_port)
            _grpc_proxy.start()
    return ingress


def run_pipeline(
    stages,
    *,
    name: str = "pipeline",
    compiled: bool = True,
    channel_type: str = "auto",
    channel_capacity: int = 4 * 1024 * 1024,
    channel_slots: Optional[int] = None,
    lanes: Optional[int] = None,
):
    """Deploy a LINEAR chain of deployments and return its ingress handle.

    ``stages`` is the chain in data-flow order (each stage's ``__call__``
    receives the previous stage's return value). With ``compiled=True``
    the call chain is PRECOMPILED into resident compiled-DAG lanes over the
    stage replicas — one channel write + read per edge per request instead
    of a per-stage actor call; see ``ray_tpu_torch/serve/dag_pipeline.py``
    for the replica-dedication trade-off. With ``compiled=False`` the same
    chain runs over per-call DeploymentHandles. The returned handle's
    ``.remote(value).result()`` surface is identical either way.

    ``lanes`` bounds the number of parallel compiled lanes (default: one
    per replica of the smallest stage). ``channel_slots`` overrides the
    ``dag_channel_slots`` ring depth per edge.
    """
    from ray_tpu_torch.serve.dag_pipeline import (SequentialPipelineHandle,
                                                  build_compiled_pipeline)

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    controller = get_or_create_controller()
    names = []
    for stage in stages:
        if isinstance(stage, Application):
            dep, init_args, init_kwargs = (
                stage.deployment, stage.init_args, stage.init_kwargs)
            if any(isinstance(a, Application)
                   for a in list(init_args) + list(init_kwargs.values())):
                raise TypeError(
                    "run_pipeline stages are a linear data-flow chain; "
                    "composed Application init args belong to serve.run")
        elif isinstance(stage, Deployment):
            dep, init_args, init_kwargs = stage, (), {}
        else:
            raise TypeError(
                "run_pipeline stages must be Deployments (or their bound "
                f"Applications), got {type(stage).__name__}")
        ray_tpu_torch.get(
            controller.deploy.remote(
                dep.name, dep.func_or_class, init_args, init_kwargs,
                dep.config, None
            )
        )
        names.append(dep.name)
    _wait_ready(controller, names)
    if not compiled:
        return SequentialPipelineHandle(
            names, [DeploymentHandle(n, controller) for n in names])
    handle = build_compiled_pipeline(
        controller, names, channel_type=channel_type,
        channel_capacity=channel_capacity, channel_slots=channel_slots,
        lanes=lanes)
    handle._registry = _pipelines
    _pipelines.append(handle)
    return handle


def grpc_proxy_address() -> Optional[str]:
    """Address of the running gRPC ingress (None if not started)."""
    return _grpc_proxy.address if _grpc_proxy is not None else None


_proxy_manager = None


def start_proxies(port: int = 0, grpc: bool = False,
                  grpc_port: int = 0) -> Dict[str, str]:
    """Start (or reconcile) per-node DETACHED proxy actors and return
    node_id -> http address. Unlike the proxy thread of the calling
    process (``_start_proxy=True``), these outlive that process and support
    drain. ``grpc=True`` additionally serves the gRPC ingress from the same
    per-node actors; addresses via :func:`proxy_grpc_addresses`."""
    global _proxy_manager
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    get_or_create_controller()  # proxies resolve it by name
    if _proxy_manager is None:
        from ray_tpu_torch.serve.proxy_state import ProxyManager

        _proxy_manager = ProxyManager(
            CONTROLLER_NAME, port=port,
            grpc_port=grpc_port if grpc else None)
    elif grpc and _proxy_manager._grpc_port is None:
        # Fleet already running HTTP-only: upgrade the live actors in
        # place rather than silently dropping the request.
        addrs = _proxy_manager.sync()
        _proxy_manager.enable_grpc(grpc_port)
        return addrs
    return _proxy_manager.sync()


def proxy_grpc_addresses() -> Dict[str, str]:
    """node_id -> gRPC ingress address of the per-node proxy fleet."""
    if _proxy_manager is None:
        return {}
    return _proxy_manager.grpc_addresses()


def drain_proxy(node_id: str, timeout_s: float = 30.0) -> bool:
    """Drain + remove the proxy on one node (scale-down protocol). Works
    from any process: proxies are DETACHED named actors, so a process that
    didn't start them (or restarted) can still drain before scale-down."""
    if _proxy_manager is not None:
        return _proxy_manager.drain_node(node_id, timeout_s)
    from ray_tpu_torch.serve.proxy_state import ProxyManager

    return ProxyManager.drain_detached(node_id, timeout_s)


def _wait_ready(controller, names, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        info = ray_tpu_torch.get(controller.list_deployments.remote())
        if all(
            n in info and info[n]["num_replicas"] >= max(1, info[n]["target_replicas"])
            for n in names
        ):
            return
        time.sleep(0.02)
    raise TimeoutError(f"deployments {names} not ready within {timeout_s}s")


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name)


def status() -> Dict[str, dict]:
    controller = get_or_create_controller()
    return ray_tpu_torch.get(controller.list_deployments.remote())


def delete(deployment_name: str) -> None:
    controller = get_or_create_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(deployment_name))


def shutdown() -> None:
    global _proxy, _grpc_proxy, _proxy_manager
    if _proxy_manager is not None:
        try:
            _proxy_manager.shutdown()
        except Exception:
            pass
        _proxy_manager = None
    # Stop @serve.batch flusher threads (they'd otherwise wait out their
    # batch window); queued items flush, and a later submit restarts them.
    from ray_tpu_torch.serve import batching

    batching.shutdown_all()
    if _proxy is not None:
        _proxy.stop()
        _proxy = None
    if _grpc_proxy is not None:
        _grpc_proxy.stop()
        _grpc_proxy = None
    # Pipelines first: their replicas are PARKED in resident DAG loops and
    # only exit on the close pill — killing the controller/replicas before
    # teardown would orphan the loops mid-read.
    while _pipelines:
        try:
            _pipelines.pop().shutdown()
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            from ray_tpu_torch.utils.logging import get_logger, log_swallowed

            log_swallowed(get_logger("serve"), "pipeline shutdown")
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote())
        ray_tpu_torch.kill(controller)
    except Exception:
        pass

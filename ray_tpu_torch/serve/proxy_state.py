"""Per-node ingress proxy actors + drain lifecycle.

The port's copy of ``ray_tpu/serve/proxy_state.py``: the ingress data
plane runs as PLACED, DETACHED actors (one per target node), not a thread
of the calling process, and scale-down drains a proxy (reject new, finish in-flight)
before removal. On the port's in-process runtime the nodes are virtual
nodes of one process, so every proxy listens on its own port of this host;
the per-node proxies over a multi-process cluster wait for that cluster.
"""

from __future__ import annotations

from typing import Dict

import ray_tpu_torch
from ray_tpu_torch.core.task_spec import NodeAffinitySchedulingStrategy

PROXY_NAME_PREFIX = "SERVE_PROXY"


class _ProxyActorImpl:
    """Hosts one HttpProxy (and optionally one GrpcProxy) inside a cluster
    worker process — the reference's proxy actor runs both ingress
    protocols in one process the same way
    (``serve/_private/proxy.py:533 gRPCProxy`` beside the HTTP half)."""

    def __init__(self, controller_name: str, port: int = 0,
                 grpc_port: int | None = None):
        from ray_tpu_torch.serve.proxy import HttpProxy

        self._controller = ray_tpu_torch.get_actor(controller_name)
        self._proxy = HttpProxy(self._controller, port=port)
        self._proxy.start()
        self._grpc = None
        if grpc_port is not None:
            from ray_tpu_torch.serve.grpc_proxy import GrpcProxy

            self._grpc = GrpcProxy(self._controller, port=grpc_port)
            self._grpc.start()

    def address(self) -> str:
        # The proxy binds this host; report the interface clients reach the
        # node on (loopback clusters stay loopback).
        host = self._proxy.host
        return f"{host}:{self._proxy.bound_port}"

    def grpc_address(self) -> str | None:
        return self._grpc.address if self._grpc is not None else None

    def ensure_grpc(self, port: int = 0) -> str:
        """Start the gRPC ingress in this (already running) proxy actor if
        it isn't serving yet — the upgrade path for fleets that were
        created HTTP-only."""
        if self._grpc is None:
            from ray_tpu_torch.serve.grpc_proxy import GrpcProxy

            self._grpc = GrpcProxy(self._controller, port=port)
            self._grpc.start()
        return self._grpc.address

    def ready(self) -> bool:
        return self._proxy.bound_port is not None

    def num_in_flight(self) -> int:
        n = self._proxy.num_in_flight
        if self._grpc is not None:
            n += self._grpc.num_in_flight
        return n

    def drain(self, timeout_s: float = 30.0) -> bool:
        # Both protocols stop accepting IMMEDIATELY, then wait on ONE
        # shared deadline (sequential waits would double the caller's
        # timeout under stuck in-flight requests).
        import time as _time

        self._proxy.begin_drain()
        if self._grpc is not None:
            self._grpc.begin_drain()
        deadline = _time.time() + timeout_s
        while _time.time() < deadline:
            if self.num_in_flight() == 0:
                return True
            _time.sleep(0.02)
        return self.num_in_flight() == 0

    def stop(self) -> bool:
        self._proxy.stop()
        if self._grpc is not None:
            self._grpc.stop()
        return True


class ProxyManager:
    """Caller-side view of the proxy fleet.

    ``sync()`` reconciles: one proxy actor per alive node (node-affinity
    placed, detached so it outlives its caller); ``drain_node()`` runs the
    scale-down protocol: drain (reject new, finish in-flight) → stop →
    kill.
    """

    def __init__(self, controller_name: str, port: int = 0,
                 grpc_port: int | None = None):
        self._controller_name = controller_name
        self._port = port
        self._grpc_port = grpc_port
        self._proxies: Dict[str, object] = {}   # node_id -> actor handle
        self._addresses: Dict[str, str] = {}
        self._grpc_addresses: Dict[str, str] = {}

    def sync(self) -> Dict[str, str]:
        """Ensure a proxy on every alive node; returns node_id -> addr."""
        alive = {n["NodeID"]: n for n in ray_tpu_torch.nodes() if n.get("Alive")}
        proxy_cls = ray_tpu_torch.remote(_ProxyActorImpl)
        for node_id in alive:
            if node_id in self._proxies:
                continue
            name = f"{PROXY_NAME_PREFIX}::{node_id[:12]}"
            try:
                handle = ray_tpu_torch.get_actor(name)
            except Exception:  # noqa: BLE001 — not running yet
                handle = proxy_cls.options(
                    name=name,
                    num_cpus=0,
                    lifetime="detached",
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node_id=node_id),
                ).remote(self._controller_name, self._port,
                         grpc_port=self._grpc_port)
            ray_tpu_torch.get(handle.ready.remote(), timeout=60)
            self._proxies[node_id] = handle
            self._addresses[node_id] = ray_tpu_torch.get(handle.address.remote(),
                                                   timeout=30)
            g = ray_tpu_torch.get(handle.grpc_address.remote(), timeout=30)
            if g is None and self._grpc_port is not None:
                # Attached to a pre-existing HTTP-only actor (e.g. started
                # by an earlier process) while this manager wants gRPC:
                # upgrade it in place instead of silently serving nothing.
                g = ray_tpu_torch.get(handle.ensure_grpc.remote(self._grpc_port),
                                timeout=60)
            if g:
                self._grpc_addresses[node_id] = g
        for node_id in list(self._proxies):
            if node_id not in alive:
                self._proxies.pop(node_id, None)
                self._addresses.pop(node_id, None)
                self._grpc_addresses.pop(node_id, None)
        return dict(self._addresses)

    def addresses(self) -> Dict[str, str]:
        return dict(self._addresses)

    def grpc_addresses(self) -> Dict[str, str]:
        return dict(self._grpc_addresses)

    def enable_grpc(self, grpc_port: int = 0) -> Dict[str, str]:
        """Upgrade an HTTP-only fleet in place: every live proxy actor
        starts its gRPC ingress (``ensure_grpc``); new actors get it at
        spawn. Returns node_id -> gRPC address."""
        self._grpc_port = grpc_port
        for node_id, handle in self._proxies.items():
            self._grpc_addresses[node_id] = ray_tpu_torch.get(
                handle.ensure_grpc.remote(grpc_port), timeout=60)
        return dict(self._grpc_addresses)

    def drain_node(self, node_id: str, timeout_s: float = 30.0) -> bool:
        """Scale-down: no new requests, in-flight finish, then the proxy
        exits. True iff fully drained within the timeout."""
        handle = self._proxies.pop(node_id, None)
        self._addresses.pop(node_id, None)
        self._grpc_addresses.pop(node_id, None)
        if handle is None:
            return True
        drained = ray_tpu_torch.get(handle.drain.remote(timeout_s),
                              timeout=timeout_s + 30)
        try:
            ray_tpu_torch.get(handle.stop.remote(), timeout=30)
        finally:
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass
        return bool(drained)

    def shutdown(self) -> None:
        for node_id in list(self._proxies):
            self.drain_node(node_id, timeout_s=5.0)

    @staticmethod
    def drain_detached(node_id: str, timeout_s: float = 30.0) -> bool:
        """Drain a proxy THIS process didn't start: resolve the detached
        actor by its well-known name. True if drained or not running."""
        name = f"{PROXY_NAME_PREFIX}::{node_id[:12]}"
        try:
            handle = ray_tpu_torch.get_actor(name)
        except Exception:  # noqa: BLE001 — no proxy on that node
            return True
        drained = ray_tpu_torch.get(handle.drain.remote(timeout_s),
                              timeout=timeout_s + 30)
        try:
            ray_tpu_torch.get(handle.stop.remote(), timeout=30)
        finally:
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass
        return bool(drained)

"""gRPC proxy — the second ingress data plane.

The port's copy of ``ray_tpu/serve/grpc_proxy.py`` (grpcio, imported when
a proxy is built, so the package imports without it). The ingress speaks
ONE generic service — the JAX package's, under the same name, so a client
of either package talks to both — and needs no protoc step:

    service RayTpuServe {
      rpc Call       (Request) returns (Reply);        // unary
      rpc CallStream (Request) returns (stream Reply); // server streaming
    }
    message Request { bytes payload = 1; }  // JSON (or pickled) body
    message Reply   { bytes payload = 1; }

Routing is by gRPC metadata: ``application`` selects the deployment (same
names as HTTP route prefixes), optional ``method`` the callable's method,
optional ``multiplexed_model_id`` pins a model. Payloads are JSON by
default; ``payload-type: pickle`` metadata switches to pickle for arbitrary
Python values ("content-type" is reserved by the gRPC transport itself).
"""

from __future__ import annotations

import json
import threading
from concurrent import futures
from typing import Any, Dict

from ray_tpu_torch.serve.handle import DeploymentHandle

_PICKLE = "pickle"


def _encode_payload_field(data: bytes) -> bytes:
    """Wire-encode ``message { bytes payload = 1; }`` without protoc:
    field 1, wire type 2 (length-delimited) = tag byte 0x0A + varint len."""
    out = bytearray([0x0A])
    n = len(data)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    out.extend(data)
    return bytes(out)


def _decode_payload_field(message: bytes) -> bytes:
    if not message:
        return b""
    if message[0] != 0x0A:
        raise ValueError("expected field 1 (payload) length-delimited")
    n, shift, i = 0, 0, 1
    while True:
        if i >= len(message):
            raise ValueError("truncated varint in payload field")
        b = message[i]
        n |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            break
        shift += 7
    if i + n > len(message):
        raise ValueError(
            f"payload declares {n} bytes but only {len(message) - i} present")
    return message[i:i + n]


class _GenericServeHandler:
    """grpc.GenericRpcHandler dispatching the two generic methods."""

    SERVICE = "ray_tpu.serve.RayTpuServe"

    def __init__(self, proxy: "GrpcProxy"):
        self._proxy = proxy

    def service(self, handler_call_details):
        import grpc

        method = handler_call_details.method
        if method == f"/{self.SERVICE}/Call":
            return grpc.unary_unary_rpc_method_handler(
                self._proxy._handle_unary,
                request_deserializer=_decode_payload_field,
                response_serializer=_encode_payload_field,
            )
        if method == f"/{self.SERVICE}/CallStream":
            return grpc.unary_stream_rpc_method_handler(
                self._proxy._handle_stream,
                request_deserializer=_decode_payload_field,
                response_serializer=_encode_payload_field,
            )
        return None


class GrpcProxy:
    """Ingress server; routes by metadata to deployment handles.

    ``allow_pickle`` gates the ``application/x-pickle`` content type:
    unpickling network bytes executes arbitrary code, so it is OFF by
    default and should only be enabled on trusted (loopback/mesh-internal)
    ingresses.
    """

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 0,
                 allow_pickle: bool = False):
        import grpc

        self._controller = controller
        self._allow_pickle = allow_pickle
        self._handles: Dict[str, DeploymentHandle] = {}
        self._lock = threading.Lock()
        # Own the handler pool: grpc's Server does not shut down a
        # user-provided executor, so stop() must — 16 parked threads per
        # proxy restart otherwise.
        self._pool = futures.ThreadPoolExecutor(max_workers=16)
        self._server = grpc.server(
            self._pool,
            handlers=(_GenericServeHandler(self),),
        )
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host
        self.address = f"{host}:{self.port}"
        # Drain protocol (reference: serve/_private/proxy_state.py, same
        # semantics as HttpProxy): a draining ingress rejects NEW calls
        # with UNAVAILABLE but lets in-flight ones finish.
        self._draining = False
        self._in_flight = 0
        self._in_flight_lock = threading.Lock()

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        if self._server is None:
            return  # already stopped
        self._server.stop(grace=1.0).wait(timeout=2.0)
        self._pool.shutdown(wait=False, cancel_futures=True)
        # cygrpc keeps the server's epoll/eventfd pair until the Server
        # object is DEALLOCATED, not until stop(): drop our reference and
        # collect so a stopped ingress releases its kernel objects now
        # (proxies restart on every deployment update).
        self._server = None
        import gc

        gc.collect()

    @property
    def num_in_flight(self) -> int:
        with self._in_flight_lock:
            return self._in_flight

    def begin_drain(self) -> None:
        # Under _in_flight_lock: _enter checks the flag and increments
        # under the same lock, so once this returns every accepted call is
        # VISIBLE in num_in_flight — no check-then-act window where a call
        # slips past the drain check but isn't counted yet.
        with self._in_flight_lock:
            self._draining = True

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop accepting new calls; True once none is in flight."""
        import time as _time

        self.begin_drain()
        deadline = _time.time() + timeout_s
        while _time.time() < deadline:
            if self.num_in_flight == 0:
                return True
            _time.sleep(0.02)
        return self.num_in_flight == 0

    def _enter(self, context) -> None:
        import grpc

        with self._in_flight_lock:
            if self._draining:
                draining = True
            else:
                draining = False
                self._in_flight += 1
        if draining:
            context.abort(grpc.StatusCode.UNAVAILABLE, "proxy draining")

    def _exit(self) -> None:
        with self._in_flight_lock:
            self._in_flight -= 1

    # -- request path ---------------------------------------------------------

    def _resolve(self, context) -> tuple:
        import grpc

        import ray_tpu_torch

        meta = {k: v for k, v in (context.invocation_metadata() or [])}
        app = meta.get("application")
        if not app:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "missing 'application' metadata")
        with self._lock:
            handle = self._handles.get(app)
        if handle is None:
            # Existence check first (cheap) so unknown apps fail with
            # NOT_FOUND immediately instead of a blocking Router bootstrap;
            # handle construction happens OUTSIDE the lock (it long-polls
            # the controller) so one cold app can't stall other requests.
            deployments = ray_tpu_torch.get(
                self._controller.list_deployments.remote(), timeout=10.0)
            if app not in deployments:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"no deployment named '{app}'")
            handle = DeploymentHandle(app, controller=self._controller)
            with self._lock:
                handle = self._handles.setdefault(app, handle)
        if meta.get("method"):
            handle = handle.options(method_name=meta["method"])
        if meta.get("multiplexed_model_id"):
            handle = handle.options(
                multiplexed_model_id=meta["multiplexed_model_id"])
        pickled = meta.get("payload-type") == _PICKLE
        if pickled and not self._allow_pickle:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "pickle payloads are disabled on this ingress "
                "(GrpcProxy(allow_pickle=True) opts in; unpickling network "
                "bytes executes arbitrary code)")
        return handle, pickled

    @staticmethod
    def _loads(payload: bytes, pickled: bool) -> Any:
        if pickled:
            from ray_tpu_torch.core import serialization

            return serialization.loads(payload)
        return json.loads(payload.decode()) if payload else None

    @staticmethod
    def _dumps(value: Any, pickled: bool) -> bytes:
        if pickled:
            from ray_tpu_torch.core import serialization

            return serialization.dumps(value)
        return json.dumps(value).encode()

    def _handle_unary(self, payload: bytes, context) -> Any:
        self._enter(context)
        try:
            handle, pickled = self._resolve(context)
            value = self._loads(payload, pickled)
            # Honor the client's RPC deadline so stuck deployments can't pin
            # the ingress thread pool for the full default.
            remaining = context.time_remaining()
            timeout = min(60.0, remaining) if remaining is not None else 60.0
            result = handle.remote(value).result(timeout_s=timeout)
            return self._dumps(result, pickled)
        finally:
            self._exit()

    def _handle_stream(self, payload: bytes, context):
        self._enter(context)
        try:
            yield from self._handle_stream_inner(payload, context)
        finally:
            self._exit()

    def _handle_stream_inner(self, payload: bytes, context):
        """Stream items honoring the client's deadline: a drainer thread
        feeds a BOUNDED queue (backpressure: a fast replica can't flood the
        ingress), and the HANDLER thread (the scarce pool resource) gives up
        only when the client's actual deadline expires — a stuck replica may
        strand the daemon drainer for a while, but never a pool slot."""
        import queue as _queue

        handle, pickled = self._resolve(context)
        value = self._loads(payload, pickled)
        out: "_queue.Queue" = _queue.Queue(maxsize=16)
        done_serving = threading.Event()
        _DONE = object()

        def drain():
            try:
                for item in handle.options(stream=True).remote(value):
                    while not done_serving.is_set():
                        try:
                            out.put(item, timeout=1.0)
                            break
                        except _queue.Full:
                            continue
                    if done_serving.is_set():
                        return  # client gone: stop consuming the replica
                while not done_serving.is_set():
                    try:
                        out.put(_DONE, timeout=1.0)
                        return
                    except _queue.Full:
                        continue
            except BaseException as exc:  # noqa: BLE001 — surface to client
                while not done_serving.is_set():
                    try:
                        out.put(exc, timeout=1.0)
                        return
                    except _queue.Full:
                        continue

        threading.Thread(target=drain, daemon=True).start()
        try:
            while True:
                remaining = context.time_remaining()
                if remaining is not None and remaining <= 0:
                    import grpc

                    context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                  "client deadline expired mid-stream")
                # Poll slices just pace deadline checks — a long gap
                # between items is NOT an error without a client deadline.
                slice_s = (min(5.0, max(0.0, remaining))
                           if remaining is not None else 5.0)
                try:
                    item = out.get(timeout=slice_s)
                except _queue.Empty:
                    continue
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield self._dumps(item, pickled)
        finally:
            done_serving.set()

"""HTTP proxy — the ingress data plane.

The port's copy of ``ray_tpu/serve/proxy.py`` (aiohttp, imported when the
proxy starts, so the package imports without it). Routes by longest
matching ``route_prefix`` from the controller's long-poll snapshot, forwards
to a DeploymentHandle, supports JSON bodies and streaming (chunked) responses
from generator deployments. Runs its own event loop in a daemon thread.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.handle import DeploymentHandle


class HttpProxy:
    def __init__(self, controller, host: str = "127.0.0.1", port: int = 8000):
        self._controller = controller
        self.host = host
        self.port = port          # 0 = ephemeral; see bound_port after start
        self.bound_port: Optional[int] = None
        self._handles: Dict[str, DeploymentHandle] = {}
        self._routes: Dict[str, str] = {}  # prefix -> deployment name
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()
        self._runner = None
        # Drain protocol (reference: serve/_private/proxy_state.py): a
        # draining proxy rejects NEW requests (503 + Connection: close) but
        # lets in-flight ones finish before it reports drained.
        self._draining = False
        self._in_flight = 0
        self._in_flight_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._serve_forever, daemon=True)
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("HTTP proxy failed to start")

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)

    @property
    def num_in_flight(self) -> int:
        with self._in_flight_lock:
            return self._in_flight

    def begin_drain(self) -> None:
        # Set under the in-flight lock so _handle's check+increment (same
        # lock) can't slip a request past the drain check uncounted.
        with self._in_flight_lock:
            self._draining = True

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop accepting new requests; True once no request is in flight."""
        self.begin_drain()
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self.num_in_flight == 0:
                return True
            time.sleep(0.02)
        return self.num_in_flight == 0

    def _serve_forever(self) -> None:
        from aiohttp import web

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, self.host, self.port)
        loop.run_until_complete(site.start())
        socks = getattr(site._server, "sockets", None)
        self.bound_port = socks[0].getsockname()[1] if socks else self.port
        self._runner = runner
        self._started.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(runner.cleanup())
            from ray_tpu_torch.utils.eventloop import drain_and_close_loop

            drain_and_close_loop(loop, "serve.proxy")

    # -- routing -------------------------------------------------------------
    def _refresh_routes(self) -> None:
        _, table = ray_tpu_torch.get(self._controller.get_snapshot.remote(-2, 0.0))
        routes = {}
        for name, entry in table.items():
            if entry.get("route_prefix"):
                routes[entry["route_prefix"]] = name
        self._routes = routes

    def _match(self, path: str) -> Optional[str]:
        best = None
        for prefix, name in self._routes.items():
            if path == prefix or path.startswith(prefix.rstrip("/") + "/") or prefix == "/":
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, name)
        return best[1] if best else None

    async def _handle(self, request):
        from aiohttp import web

        with self._in_flight_lock:
            draining = self._draining
            if not draining:
                self._in_flight += 1
        if draining:
            return web.Response(
                status=503, text="proxy draining",
                headers={"Connection": "close"})
        try:
            return await self._handle_inner(request)
        finally:
            with self._in_flight_lock:
                self._in_flight -= 1

    async def _handle_inner(self, request):
        from aiohttp import web

        self._refresh_routes()
        name = self._match(request.path)
        if name is None:
            return web.Response(status=404, text=f"no route for {request.path}")
        if name not in self._handles:
            self._handles[name] = DeploymentHandle(name, self._controller)
        handle = self._handles[name]

        if request.can_read_body:
            raw = await request.read()
            try:
                payload = json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                payload = raw.decode()
        else:
            payload = dict(request.query)

        loop = asyncio.get_event_loop()
        stream = request.headers.get("X-Serve-Stream") == "1"
        if stream:
            gen = handle.options(stream=True).remote(payload)
            resp = web.StreamResponse()
            resp.headers["Content-Type"] = "text/plain"
            await resp.prepare(request)
            it = iter(gen)
            while True:
                item = await loop.run_in_executor(None, lambda: next(it, _SENTINEL))
                if item is _SENTINEL:
                    break
                await resp.write((json.dumps(_jsonable(item)) + "\n").encode())
            await resp.write_eof()
            return resp

        response = handle.remote(payload)
        result = await loop.run_in_executor(None, response.result)
        return web.json_response(_jsonable(result))


_SENTINEL = object()


def _jsonable(x: Any):
    import numpy as np

    if isinstance(x, (np.generic,)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x

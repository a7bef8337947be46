"""Per-node Serve proxy actors: placement, drain, zero-drop redeploy,
driver-exit survival (reference: serve/_private/proxy.py proxy actors +
proxy_state.py drain protocol).

JAX's ``tests/test_serve_proxy.py`` on the port: the HTTP and gRPC per-node
proxies of ``ray_tpu_torch.serve`` over a real ``ray_tpu_torch`` Cluster."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.core.cluster import Cluster, connect
from ray_tpu_torch.core import runtime as runtime_mod

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


@pytest.fixture()
def mp_serve():
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 3})
    core = connect(cluster.gcs_address)
    yield cluster, core
    try:
        serve.shutdown()
    except Exception:
        pass
    core.shutdown()
    runtime_mod._global_runtime = None
    cluster.shutdown()


def _get(url, timeout=30.0, **kw):
    import httpx

    return httpx.post(url, timeout=timeout, **kw)


def test_per_node_proxies_and_drain_under_load(mp_serve):
    cluster, core = mp_serve

    @serve.deployment(num_replicas=2)
    def slowish(payload):
        time.sleep(0.3)
        return {"v": payload["v"]}

    serve.run(slowish.bind(), route_prefix="/m")
    addrs = serve.start_proxies()
    assert len(addrs) == 2, addrs  # one proxy per node

    # Both proxies serve.
    for addr in addrs.values():
        r = _get(f"http://{addr}/m", json={"v": 1})
        assert r.status_code == 200 and r.json() == {"v": 1}

    # Drain one node while requests are in flight THROUGH it: accepted
    # requests complete; post-drain requests are refused; the other proxy
    # keeps serving.
    victim_node, victim_addr = next(iter(addrs.items()))
    other_addr = next(a for n, a in addrs.items() if n != victim_node)
    results = []

    def fire(i):
        try:
            r = _get(f"http://{victim_addr}/m", json={"v": i})
            results.append((i, r.status_code))
        except Exception as e:  # noqa: BLE001 — refused post-drain
            results.append((i, f"refused:{type(e).__name__}"))

    threads = [threading.Thread(target=fire, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads:
        t.start()
    # Deterministic: drain only once the victim proxy has ACCEPTED at least
    # one request (replica holds it for 0.3s), so the drain provably
    # overlaps in-flight work.
    from ray_tpu_torch.serve import api as serve_api

    victim_handle = serve_api._proxy_manager._proxies[victim_node]
    deadline = time.time() + 30
    while time.time() < deadline:
        if ray_tpu_torch.get(victim_handle.num_in_flight.remote(), timeout=10) > 0:
            break
        time.sleep(0.01)
    else:
        raise AssertionError("no request ever went in flight")
    drained = serve.drain_proxy(victim_node, timeout_s=30)
    for t in threads:
        t.join(timeout=60)
    assert drained is True
    in_flight_ok = [s for _i, s in results if s == 200]
    assert len(in_flight_ok) >= 1, results  # accepted ones completed
    assert all(s in (200, 503) or str(s).startswith("refused")
               for _i, s in results), results

    # Post-drain: victim refuses, the other node still serves.
    with pytest.raises(Exception):
        _get(f"http://{victim_addr}/m", json={"v": 9}, timeout=3)
    r = _get(f"http://{other_addr}/m", json={"v": 2})
    assert r.status_code == 200 and r.json() == {"v": 2}


def test_rolling_redeploy_drops_zero_requests(mp_serve):
    cluster, core = mp_serve

    @serve.deployment(num_replicas=2)
    def versioned(payload):
        return {"version": 1}

    serve.run(versioned.bind(), route_prefix="/v")
    addrs = serve.start_proxies()
    addr = next(iter(addrs.values()))

    stop = threading.Event()
    outcomes = []

    def hammer():
        while not stop.is_set():
            try:
                r = _get(f"http://{addr}/v", json={}, timeout=30)
                outcomes.append(r.status_code)
            except Exception as e:  # noqa: BLE001
                outcomes.append(f"error:{e}")
            time.sleep(0.02)

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    try:
        time.sleep(0.5)

        @serve.deployment(num_replicas=2)
        def versioned(payload):  # noqa: F811 — the new version
            return {"version": 2}

        serve.run(versioned.bind(), route_prefix="/v")
        # Routing switches only once new-version replicas pass READINESS
        # (the reference's rollout gate — requests never land on a replica
        # still in __init__), so takeover is not instantaneous: poll for it
        # while the hammer thread keeps proving zero drops.
        deadline = time.time() + 30.0
        took_over = False
        while time.time() < deadline:
            r = _get(f"http://{addr}/v", json={})
            if r.status_code == 200 and r.json() == {"version": 2}:
                took_over = True
                break
            time.sleep(0.2)
    finally:
        stop.set()
        t.join(timeout=60)
    assert outcomes, "no requests made"
    bad = [o for o in outcomes if o != 200]
    assert not bad, f"dropped {len(bad)}/{len(outcomes)}: {bad[:5]}"
    assert took_over, "new version never took over within 30s"


def test_ingress_survives_driver_exit():
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 3})
    try:
        script = f"""
import os, json
import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.core.cluster import connect

core = connect({cluster.gcs_address!r})

@serve.deployment(num_replicas=2)
def app(payload):
    return {{"pong": payload.get("n", 0)}}

serve.run(app.bind(), route_prefix="/app")
addrs = serve.start_proxies()
print("ADDRS=" + json.dumps(addrs), flush=True)
core.shutdown()
"""
        proc = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True,
            timeout=180,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = next(l for l in proc.stdout.splitlines()
                    if l.startswith("ADDRS="))
        addrs = json.loads(line[len("ADDRS="):])
        assert len(addrs) == 2
        # The driver is GONE; the detached controller + proxy actors +
        # replicas must still serve HTTP.
        time.sleep(1.0)
        for addr in addrs.values():
            r = _get(f"http://{addr}/app", json={"n": 7}, timeout=60)
            assert r.status_code == 200 and r.json() == {"pong": 7}
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------------------
# gRPC half of the per-node ingress (reference: serve/_private/proxy.py:533
# gRPCProxy runs beside the HTTP half in the same proxy actors).
# ---------------------------------------------------------------------------

def _grpc_caller(addr):
    import grpc

    from ray_tpu_torch.serve.grpc_proxy import (
        _decode_payload_field,
        _encode_payload_field,
    )

    channel = grpc.insecure_channel(addr)
    unary = channel.unary_unary(
        "/ray_tpu.serve.RayTpuServe/Call",
        request_serializer=_encode_payload_field,
        response_deserializer=_decode_payload_field,
    )
    return channel, unary


def test_grpc_per_node_proxies_and_drain_under_load(mp_serve):
    import grpc

    cluster, core = mp_serve

    @serve.deployment(num_replicas=2)
    def slowg(payload):
        time.sleep(0.3)
        return {"v": payload["v"]}

    serve.run(slowg.bind(), route_prefix="/g")
    serve.start_proxies(grpc=True)
    gaddrs = serve.proxy_grpc_addresses()
    assert len(gaddrs) == 2, gaddrs  # one gRPC ingress per node

    for addr in gaddrs.values():
        _ch, unary = _grpc_caller(addr)
        reply = unary(json.dumps({"v": 1}).encode(),
                      metadata=(("application", "slowg"),), timeout=60)
        assert json.loads(reply.decode()) == {"v": 1}
        _ch.close()

    victim_node, victim_addr = next(iter(gaddrs.items()))
    other_addr = next(a for n, a in gaddrs.items() if n != victim_node)
    results = []
    vch, vunary = _grpc_caller(victim_addr)

    def fire(i):
        try:
            r = vunary(json.dumps({"v": i}).encode(),
                       metadata=(("application", "slowg"),), timeout=60)
            results.append((i, json.loads(r.decode())["v"]))
        except grpc.RpcError as e:
            results.append((i, f"rpc:{e.code().name}"))

    threads = [threading.Thread(target=fire, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads:
        t.start()
    from ray_tpu_torch.serve import api as serve_api

    victim_handle = serve_api._proxy_manager._proxies[victim_node]
    deadline = time.time() + 30
    while time.time() < deadline:
        if ray_tpu_torch.get(victim_handle.num_in_flight.remote(), timeout=10) > 0:
            break
        time.sleep(0.01)
    else:
        raise AssertionError("no gRPC request ever went in flight")
    drained = serve.drain_proxy(victim_node, timeout_s=30)
    for t in threads:
        t.join(timeout=60)
    assert drained is True
    ok = [v for _i, v in results if isinstance(v, int)]
    assert len(ok) >= 1, results  # accepted calls completed during drain
    assert all(isinstance(v, int) or v in ("rpc:UNAVAILABLE",)
               for _i, v in results), results

    # Post-drain: victim's port is gone; the other node still serves.
    with pytest.raises(grpc.RpcError):
        vunary(b"{}", metadata=(("application", "slowg"),), timeout=3)
    vch.close()
    _ch2, ounary = _grpc_caller(other_addr)
    r = ounary(json.dumps({"v": 2}).encode(),
               metadata=(("application", "slowg"),), timeout=60)
    assert json.loads(r.decode()) == {"v": 2}
    _ch2.close()


def test_grpc_rolling_redeploy_drops_zero_requests(mp_serve):
    import grpc

    cluster, core = mp_serve

    @serve.deployment(num_replicas=2)
    def gversioned(payload):
        return {"version": 1}

    serve.run(gversioned.bind(), route_prefix="/gv")
    serve.start_proxies(grpc=True)
    gaddrs = serve.proxy_grpc_addresses()
    addr = next(iter(gaddrs.values()))
    ch, unary = _grpc_caller(addr)

    stop = threading.Event()
    outcomes = []

    def hammer():
        while not stop.is_set():
            try:
                r = unary(b"{}", metadata=(("application", "gversioned"),),
                          timeout=30)
                outcomes.append(json.loads(r.decode())["version"])
            except grpc.RpcError as e:
                outcomes.append(f"rpc:{e.code().name}")
            time.sleep(0.02)

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    took_over = False
    try:
        time.sleep(0.5)

        @serve.deployment(num_replicas=2)
        def gversioned(payload):  # noqa: F811 — the new version
            return {"version": 2}

        serve.run(gversioned.bind(), route_prefix="/gv")
        deadline = time.time() + 30.0
        while time.time() < deadline:
            try:
                r = unary(b"{}", metadata=(("application", "gversioned"),),
                          timeout=30)
                if json.loads(r.decode()) == {"version": 2}:
                    took_over = True
                    break
            except grpc.RpcError:
                pass
            time.sleep(0.2)
    finally:
        stop.set()
        t.join(timeout=60)
        ch.close()
    assert outcomes, "no requests made"
    bad = [o for o in outcomes if not isinstance(o, int)]
    assert not bad, f"dropped {len(bad)}/{len(outcomes)}: {bad[:5]}"
    assert took_over, "new version never took over on the gRPC ingress"


def test_grpc_ingress_survives_driver_exit():
    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 3})
    try:
        script = f"""
import os, json
import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.core.cluster import connect

core = connect({cluster.gcs_address!r})

@serve.deployment(num_replicas=2)
def gapp(payload):
    return {{"pong": payload.get("n", 0)}}

serve.run(gapp.bind(), route_prefix="/gapp")
serve.start_proxies(grpc=True)
print("GADDRS=" + json.dumps(serve.proxy_grpc_addresses()), flush=True)
core.shutdown()
"""
        proc = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True,
            timeout=180,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = next(l for l in proc.stdout.splitlines()
                    if l.startswith("GADDRS="))
        gaddrs = json.loads(line[len("GADDRS="):])
        assert len(gaddrs) == 2
        # Driver gone; detached proxy actors must still answer gRPC.
        time.sleep(1.0)
        for addr in gaddrs.values():
            _ch, unary = _grpc_caller(addr)
            r = unary(json.dumps({"n": 7}).encode(),
                      metadata=(("application", "gapp"),), timeout=60)
            assert json.loads(r.decode()) == {"pong": 7}
            _ch.close()
    finally:
        cluster.shutdown()

"""JAX's Serve tests (``tests/test_serve.py``) on the port's Serve stack.

Deploy/call/scale/delete lifecycle, composition, routing, autoscaling,
batching, streaming, the HTTP ingress (round trip and 404), multiplexing,
the gRPC ingress (unary and streaming) and the per-call pipeline, each as
JAX's test runs it, on ``ray_tpu_torch.init`` and ``ray_tpu_torch.serve``.

Where the port differs by design the test says so:

- the HTTP proxy listens on an ephemeral port (JAX's test takes 18431,
  which a JAX worker of the same suite may hold at the same time);
- ``run_pipeline`` compiles by default, as JAX's does: JAX's three
  pipeline tests run through ``compiled=True`` (the sequential handle is
  their reference), and one more test holds that ``run_pipeline`` with no
  ``compiled=`` builds the compiled lanes.
"""

import json
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture
def serve_instance():
    ray_tpu_torch.init(resources={"CPU": 4})
    yield serve
    serve.shutdown()
    ray_tpu_torch.shutdown()


class TestDeployLifecycle:
    def test_function_deployment(self, serve_instance):
        @serve.deployment
        def square(x):
            return x["v"] * x["v"]

        h = serve.run(square.bind())
        assert h.remote({"v": 7}).result() == 49

    def test_class_deployment_with_init_args(self, serve_instance):
        @serve.deployment
        class Adder:
            def __init__(self, base):
                self.base = base

            def __call__(self, x):
                return self.base + x["v"]

            def sub(self, x):
                return x["v"] - self.base

        h = serve.run(Adder.bind(100))
        assert h.remote({"v": 5}).result() == 105
        assert h.options(method_name="sub").remote({"v": 5}).result() == -95

    def test_num_replicas_and_scale(self, serve_instance):
        @serve.deployment(num_replicas=3)
        def f(x):
            return 1

        serve.run(f.bind())
        info = serve.status()
        assert info["f"]["num_replicas"] == 3
        serve.delete("f")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and "f" in serve.status():
            time.sleep(0.05)
        assert "f" not in serve.status()

    def test_redeploy_updates(self, serve_instance):
        @serve.deployment
        def g(x):
            return "v1"

        h = serve.run(g.bind())
        assert h.remote({}).result() == "v1"

        @serve.deployment(name="g")
        def g2(x):
            return "v2"

        h2 = serve.run(g2.bind())
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if h2.remote({}).result() == "v2":
                break
            time.sleep(0.1)
        assert h2.remote({}).result() == "v2"

    def test_composition(self, serve_instance):
        @serve.deployment
        class Preprocess:
            def __call__(self, x):
                return x["v"] * 2

        @serve.deployment
        class Ingress:
            def __init__(self, pre):
                self.pre = pre

            def __call__(self, x):
                doubled = self.pre.remote(x).result()
                return doubled + 1

        h = serve.run(Ingress.bind(Preprocess.bind()))
        assert h.remote({"v": 10}).result() == 21

    def test_user_config_reconfigure(self, serve_instance):
        @serve.deployment(user_config={"threshold": 5})
        class Thresh:
            def __init__(self):
                self.threshold = None

            def reconfigure(self, cfg):
                self.threshold = cfg["threshold"]

            def __call__(self, x):
                return x["v"] > self.threshold

        h = serve.run(Thresh.bind())
        assert h.remote({"v": 10}).result() is True
        assert h.remote({"v": 3}).result() is False


class TestRoutingAndScaling:
    def test_pow2_spreads_load(self, serve_instance):
        @serve.deployment(num_replicas=2, max_ongoing_requests=4)
        class Who:
            def __init__(self):
                self.ident = id(self)

            def __call__(self, x):
                time.sleep(0.05)
                return self.ident

        h = serve.run(Who.bind())
        results = []
        threads = [
            # concurrent callers so pow-2 sees real queue depth
            threading.Thread(
                target=lambda: results.append(h.remote({}).result()))
            for _ in range(16)
        ]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        assert not any(t.is_alive() for t in threads)
        assert len(set(results)) == 2, "both replicas should have served"

    def test_autoscaling_up(self, serve_instance):
        @serve.deployment(
            num_replicas="auto",
            autoscaling_config={
                "min_replicas": 1,
                "max_replicas": 4,
                "target_ongoing_requests": 1.0,
            },
            max_ongoing_requests=2,
        )
        def slow(x):
            time.sleep(0.4)
            return 1

        h = serve.run(slow.bind())
        assert serve.status()["slow"]["num_replicas"] == 1
        threads = [
            threading.Thread(target=lambda: h.remote({}).result())
            for _ in range(8)
        ]
        [t.start() for t in threads]
        deadline = time.monotonic() + 10
        scaled = False
        while time.monotonic() < deadline:
            if serve.status()["slow"]["num_replicas"] >= 2:
                scaled = True
                break
            time.sleep(0.05)
        [t.join(timeout=60) for t in threads]
        assert not any(t.is_alive() for t in threads)
        assert scaled, f"autoscaler never scaled up: {serve.status()}"


class TestBatchingAndStreaming:
    def test_batch_decorator(self, serve_instance):
        seen_sizes = []

        @serve.deployment(max_ongoing_requests=64)
        class Model:
            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
            def handle(self, xs):
                seen_sizes.append(len(xs))
                return [x * 10 for x in xs]

            def __call__(self, x):
                return self.handle(x["v"])

        h = serve.run(Model.bind())
        results = {}

        def call(i):
            results[i] = h.remote({"v": i}).result()

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        assert not any(t.is_alive() for t in threads)
        assert results == {i: i * 10 for i in range(8)}

    def test_streaming_response(self, serve_instance):
        @serve.deployment
        def streamer(x):
            for i in range(x["n"]):
                yield {"chunk": i}

        h = serve.run(streamer.bind())
        chunks = list(h.options(stream=True).remote({"n": 4}))
        assert chunks == [{"chunk": i} for i in range(4)]


class TestHttpProxy:
    def test_http_roundtrip_and_404(self, serve_instance):
        import httpx

        from ray_tpu_torch.serve import api

        @serve.deployment
        def model(payload):
            return {"doubled": payload["v"] * 2}

        serve.run(model.bind(), route_prefix="/model", _start_proxy=True,
                  http_port=0)
        base = f"http://127.0.0.1:{api._proxy.bound_port}"
        r = httpx.post(f"{base}/model", json={"v": 21}, timeout=10)
        assert r.status_code == 200
        assert r.json() == {"doubled": 42}
        r = httpx.get(f"{base}/nope", timeout=10)
        assert r.status_code == 404


class TestMultiplexing:
    """Model multiplexing."""

    def test_lru_loading_and_context(self, serve_instance):
        loads = []

        @serve.deployment(num_replicas=1)
        class Models:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                loads.append(model_id)
                return {"id": model_id}

            def __call__(self, payload):
                mid = serve.get_multiplexed_model_id()
                model = self.get_model(mid)
                return {"served_by": model["id"], "ctx": mid}

        handle = serve.run(Models.bind())
        r1 = handle.options(multiplexed_model_id="m1").remote(
            {}).result(timeout_s=60)
        assert r1 == {"served_by": "m1", "ctx": "m1"}
        r2 = handle.options(multiplexed_model_id="m2").remote(
            {}).result(timeout_s=60)
        assert r2["served_by"] == "m2"
        # Cached: repeat m1 loads nothing new.
        handle.options(multiplexed_model_id="m1").remote(
            {}).result(timeout_s=60)
        # Third model evicts the LRU entry (m2 after the m1 re-touch).
        handle.options(multiplexed_model_id="m3").remote(
            {}).result(timeout_s=60)
        handle.options(multiplexed_model_id="m2").remote(
            {}).result(timeout_s=60)
        assert loads == ["m1", "m2", "m3", "m2"]

    def test_missing_model_id_raises(self, serve_instance):
        @serve.deployment(num_replicas=1)
        class M:
            @serve.multiplexed()
            def get_model(self, model_id: str):
                return model_id

            def __call__(self, payload):
                return self.get_model()

        handle = serve.run(M.bind())
        with pytest.raises(Exception, match="no model id"):
            handle.remote({}).result(timeout_s=60)


class TestGrpcIngress:
    """The generic gRPC ingress."""

    def test_unary_and_streaming(self, serve_instance):
        import grpc

        from ray_tpu_torch.serve import api as serve_api
        from ray_tpu_torch.serve.grpc_proxy import (_decode_payload_field,
                                                    _encode_payload_field)

        @serve.deployment(num_replicas=1)
        class Math:
            def __call__(self, payload):
                return {"doubled": payload["x"] * 2}

            def countdown(self, payload):
                for i in range(payload["n"], 0, -1):
                    yield {"i": i}

        serve.run(Math.bind(), _start_grpc_proxy=True)
        addr = serve_api.grpc_proxy_address()
        assert addr is not None

        channel = grpc.insecure_channel(addr)
        unary = channel.unary_unary(
            "/ray_tpu.serve.RayTpuServe/Call",
            request_serializer=_encode_payload_field,
            response_deserializer=_decode_payload_field,
        )
        reply = unary(json.dumps({"x": 21}).encode(),
                      metadata=(("application", "Math"),), timeout=60)
        assert json.loads(reply.decode()) == {"doubled": 42}

        stream = channel.unary_stream(
            "/ray_tpu.serve.RayTpuServe/CallStream",
            request_serializer=_encode_payload_field,
            response_deserializer=_decode_payload_field,
        )
        items = [json.loads(chunk.decode()) for chunk in stream(
            json.dumps({"n": 3}).encode(),
            metadata=(("application", "Math"), ("method", "countdown")),
            timeout=60)]
        assert items == [{"i": 3}, {"i": 2}, {"i": 1}]

        # Missing application metadata -> INVALID_ARGUMENT.
        with pytest.raises(grpc.RpcError) as err:
            unary(b"{}", timeout=30)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        # Unknown application -> prompt NOT_FOUND (no blocking bootstrap).
        with pytest.raises(grpc.RpcError) as err:
            unary(b"{}", metadata=(("application", "NoSuchApp"),), timeout=30)
        assert err.value.code() == grpc.StatusCode.NOT_FOUND
        # Pickle payloads rejected unless the ingress opted in.
        with pytest.raises(grpc.RpcError) as err:
            unary(b"{}", metadata=(("application", "Math"),
                                   ("payload-type", "pickle")),
                  timeout=30)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        channel.close()


class TestCompiledPipeline:
    """serve.run_pipeline: the deployment call chain precompiled into
    resident DAG lanes over the stage replicas (dag_pipeline.py)."""

    def test_compiled_matches_sequential(self, serve_instance):
        @serve.deployment
        class Tokenize:
            def __call__(self, text):
                return text.split()

        @serve.deployment
        class Count:
            def __call__(self, tokens):
                return len(tokens)

        @serve.deployment
        class Format:
            def __call__(self, n):
                return {"tokens": n}

        stages = [Tokenize, Count, Format]
        seq = serve.run_pipeline(stages, compiled=False)
        assert seq.stage_names == ["Tokenize", "Count", "Format"]
        want = [seq.remote(f"a b c {'x ' * i}").result(timeout_s=60)
                for i in range(4)]
        comp = serve.run_pipeline(stages, compiled=True)
        try:
            assert comp.num_lanes == 1
            got = [comp.remote(f"a b c {'x ' * i}").result(timeout_s=60)
                   for i in range(4)]
            assert got == want == [{"tokens": 3 + i} for i in range(4)]
        finally:
            comp.shutdown()

    def test_pipeline_burst_and_replica_bookkeeping(self, serve_instance):
        @serve.deployment
        class AddOne:
            def __call__(self, x):
                return x + 1

        @serve.deployment
        class Double:
            def __call__(self, x):
                return x * 2

        from ray_tpu_torch.core.metrics_export import serve_request_hist

        def add_one_requests():
            return sum(n for k, n in serve_request_hist()._totals.items()
                       if ("deployment", "AddOne") in k)

        before = add_one_requests()
        handle = serve.run_pipeline([AddOne, Double], compiled=True)
        try:
            # Burst ahead of any result(): ticks pipeline through the ring
            # edges and drain FIFO per request.
            resps = [handle.remote(i) for i in range(6)]
            assert [r.result(timeout_s=60) for r in resps] == \
                [(i + 1) * 2 for i in range(6)]
            # The dag_call path keeps the replica latency histogram warm
            # (the metrics plane's serve deployment view stays truthful).
            assert add_one_requests() - before >= 6
        finally:
            handle.shutdown()

    def test_pipeline_function_stage_and_shutdown_idempotent(
            self, serve_instance):
        @serve.deployment
        def upper(s):
            return s.upper()

        @serve.deployment
        def exclaim(s):
            return s + "!"

        handle = serve.run_pipeline([upper, exclaim], compiled=True)
        assert handle.remote("hey").result(timeout_s=60) == "HEY!"
        handle.shutdown()
        handle.shutdown()  # idempotent
        with pytest.raises(RuntimeError, match="shut down"):
            handle.remote("again")

    def test_run_pipeline_compiles_by_default(self, serve_instance):
        from ray_tpu_torch.serve.dag_pipeline import PipelineHandle

        @serve.deployment
        def ident(x):
            return x

        handle = serve.run_pipeline([ident])
        assert isinstance(handle, PipelineHandle) and handle.num_lanes == 1
        assert handle.remote({"k": [1, 2]}).result(timeout_s=60) == \
            {"k": [1, 2]}
        # serve.shutdown() (the fixture's) tears the registered lanes down.
        from ray_tpu_torch.serve import api

        assert api._pipelines == [handle]

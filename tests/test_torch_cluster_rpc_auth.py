"""RPC auth-token handshake (control-plane hardening).

The pickle RPC plane grants code execution to anyone who can connect; with
``RAY_TPU_AUTH_TOKEN`` set (or an explicit ``auth_token``), every connection
must open with a raw token frame the server verifies BEFORE unpickling
anything from the peer.

JAX's ``tests/test_rpc_auth.py`` on the port's ``ray_tpu_torch.core.rpc``.
"""

import pytest

from ray_tpu_torch.core.rpc import RpcClient, RpcConnectionError, RpcServer

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


class _Handler:
    def ping(self):
        return "pong"


def test_auth_token_roundtrip_and_rejection():
    server = RpcServer(_Handler(), name="auth-test", auth_token=b"s3cret")
    try:
        good = RpcClient(server.address, auth_token=b"s3cret")
        assert good.call("ping", timeout=10) == "pong"
        good.close()

        bad = RpcClient(server.address, auth_token=b"wrong")
        with pytest.raises(RpcConnectionError):
            bad.call("ping", timeout=10)
        bad.close()

        # No token at all: the server must also reject (first frame is a
        # pickled request, not the expected raw auth blob).
        naked = RpcClient(server.address, auth_token=b"")
        with pytest.raises(RpcConnectionError):
            naked.call("ping", timeout=10)
        naked.close()
    finally:
        server.stop()


def test_no_token_plain_roundtrip():
    server = RpcServer(_Handler(), name="plain-test", auth_token=b"")
    try:
        client = RpcClient(server.address, auth_token=b"")
        assert client.call("ping", timeout=10) == "pong"
        client.close()
    finally:
        server.stop()


def test_env_token_propagates(monkeypatch):
    """Default token comes from RAY_TPU_AUTH_TOKEN, matching how cluster
    processes inherit it through spawn env."""
    monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", "cluster-secret")
    server = RpcServer(_Handler(), name="env-auth")
    try:
        client = RpcClient(server.address)
        assert client.call("ping", timeout=10) == "pong"
        client.close()
    finally:
        server.stop()

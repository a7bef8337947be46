"""Cluster bootstrap — spawn/connect the multiprocess runtime.

Analog of the reference's process supervisor + test cluster utilities:
``python/ray/_private/node.py`` (``start_gcs_server`` :1121, ``start_raylet``
:1152 — the head process forks every daemon) and
``python/ray/cluster_utils.py:135 Cluster`` / ``add_node`` :201 — the
load-bearing CI trick of running multiple real node daemons on one host with
fake resources, so scheduling/failover logic is tested against real process
boundaries without real machines (SURVEY §4.3).

``start_cluster`` forks a GCS server + N node daemons; ``connect`` installs a
driver-mode :class:`CoreWorker` as the global runtime so the whole
``ray_tpu_torch.api`` surface transparently targets the multiprocess cluster.

The port's copy of ``ray_tpu/core/cluster.py``: every process it starts runs
the port's own modules (``python -m ray_tpu_torch.core.gcs_server`` /
``.node_daemon``, whose workers run ``.worker_main``) with this checkout's
root on ``PYTHONPATH``. A node has the resources it is given: a card is
``{"GPU": 1}`` in ``resources_per_node`` or ``add_node``.
"""

from __future__ import annotations

import atexit
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.config import Config, set_config
from ray_tpu_torch.core.core_worker import CoreWorker
from ray_tpu_torch.core.ids import NodeID
from ray_tpu_torch.core.node_daemon import with_package_path
from ray_tpu_torch.core.rpc import RpcClient, RpcConnectionError
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("cluster")


def _read_tagged_line(proc: subprocess.Popen, tag: str, timeout: float = 30.0) -> str:
    """Scrape ``TAG=value`` from a child's stdout (the bootstrap handshake)."""
    deadline = time.time() + timeout
    assert proc.stdout is not None
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"process exited rc={proc.returncode} before printing {tag}"
            )
        line = proc.stdout.readline()
        if not line:
            time.sleep(0.01)
            continue
        text = line.decode() if isinstance(line, bytes) else line
        if text.startswith(f"{tag}="):
            return text.strip().split("=", 1)[1]
    raise TimeoutError(f"timed out waiting for {tag} from child process")


class NodeHandle:
    def __init__(self, proc: subprocess.Popen, address: str, node_id: NodeID,
                 store_name: str = ""):
        self.proc = proc
        self.address = address
        self.node_id = node_id
        self.store_name = store_name


class Cluster:
    """A local multiprocess cluster: 1 GCS + N node-daemon processes.

    Mirrors ``cluster_utils.Cluster``: each node is a *real* daemon process
    with its own worker pool and shm store, given fake resources; tests
    exercise real RPC, real process death (``kill -9``), and real zero-copy
    shm reads across process boundaries.
    """

    def __init__(self, num_nodes: int = 1,
                 resources_per_node: Optional[Dict[str, float]] = None,
                 snapshot_path: str | None = None,
                 system_config: Dict | None = None):
        self._env = with_package_path(dict(os.environ))
        # Propagate system_config to children via env flags (the reference
        # plumbs _system_config JSON through process command lines).
        for key, value in (system_config or {}).items():
            self._env[f"RAY_TPU_{key.upper()}"] = str(value)
        gcs_cmd = [sys.executable, "-m", "ray_tpu_torch.core.gcs_server"]
        if snapshot_path:
            gcs_cmd += ["--snapshot", snapshot_path]
        self._snapshot_path = snapshot_path
        self.gcs_proc = subprocess.Popen(
            gcs_cmd, stdout=subprocess.PIPE, env=self._env
        )
        self.gcs_address = _read_tagged_line(self.gcs_proc, "GCS_ADDRESS")
        self.nodes: List[NodeHandle] = []
        for _ in range(num_nodes):
            self.add_node(resources_per_node)
        atexit.register(self.shutdown)

    def add_node(self, resources: Optional[Dict[str, float]] = None) -> NodeHandle:
        import json

        cmd = [sys.executable, "-m", "ray_tpu_torch.core.node_daemon",
               "--gcs", self.gcs_address,
               "--resources", json.dumps(resources or {})]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=self._env)
        address = _read_tagged_line(proc, "NODE_ADDRESS")
        node_id = NodeID.from_hex(_read_tagged_line(proc, "NODE_ID"))
        store_name = _read_tagged_line(proc, "STORE_NAME")
        handle = NodeHandle(proc, address, node_id, store_name)
        self.nodes.append(handle)
        return handle

    # -- fault injection (test_utils.py kill_raylet analog) -------------------

    @staticmethod
    def _close_pipe(proc: subprocess.Popen) -> None:
        """Close our end of a dead child's stdout pipe — the parent holds
        one fd per spawned process otherwise (GC closes it eventually, but
        chaos tests churn dozens of processes per run)."""
        if proc.stdout is not None:
            try:
                proc.stdout.close()
            except OSError:
                pass

    def kill_node(self, index: int, sig: int = signal.SIGKILL) -> NodeHandle:
        handle = self.nodes[index]
        handle.proc.send_signal(sig)
        handle.proc.wait(timeout=10)
        self._close_pipe(handle.proc)
        return handle

    def kill_gcs(self, sig: int = signal.SIGKILL) -> None:
        self.gcs_proc.send_signal(sig)
        self.gcs_proc.wait(timeout=10)
        self._close_pipe(self.gcs_proc)

    def restart_gcs(self, restore_from: str | None = None) -> None:
        """Head restart: rebuild tables from the snapshot (GCS FT path —
        ``gcs_server.cc:523-524`` Redis-backed restart analog). Rebinds the
        SAME port so daemons/drivers reconnect without re-discovery.
        ``restore_from``: a daemon address holding a snapshot MIRROR — the
        head-DISK-loss path (local snapshot gone)."""
        port = self.gcs_address.rsplit(":", 1)[1]
        gcs_cmd = [sys.executable, "-m", "ray_tpu_torch.core.gcs_server",
                   "--port", port]
        if self._snapshot_path:
            gcs_cmd += ["--snapshot", self._snapshot_path]
        if restore_from:
            gcs_cmd += ["--restore-from", restore_from]
        self.gcs_proc = subprocess.Popen(
            gcs_cmd, stdout=subprocess.PIPE, env=self._env
        )
        self.gcs_address = _read_tagged_line(self.gcs_proc, "GCS_ADDRESS")

    def worker_pids(self, index: int) -> List[int]:
        """PIDs of worker processes on node ``index`` (via /proc children)."""
        daemon_pid = self.nodes[index].proc.pid
        pids = []
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().split()
                if int(fields[3]) == daemon_pid:
                    pids.append(int(entry))
            except (OSError, IndexError, ValueError):
                continue
        return pids

    def shutdown(self) -> None:
        atexit.unregister(self.shutdown)
        for handle in self.nodes:
            if handle.proc.poll() is None:
                handle.proc.terminate()
        if self.gcs_proc.poll() is None:
            self.gcs_proc.terminate()
        deadline = time.time() + 5
        for proc in [h.proc for h in self.nodes] + [self.gcs_proc]:
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
            self._close_pipe(proc)
        # SIGKILLed daemons can't unlink their shm arenas; sweep them here
        # so chaos tests don't leak /dev/shm across runs.
        for handle in self.nodes:
            if handle.store_name:
                try:
                    os.unlink(f"/dev/shm/{handle.store_name}")
                except OSError:
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def connect(gcs_address: str, namespace: str = "default",
            log_to_driver: bool = False) -> CoreWorker:
    """Attach this process as a driver (``ray.init(address=...)`` analog).

    ``log_to_driver=True`` mirrors every worker's stdout/stderr to this
    process (daemon log tailers → GCS pubsub → long-poll subscriber).
    """
    from ray_tpu_torch.core import runtime as runtime_mod

    # The driver's knobs resolve once, from its environment, as the JAX
    # driver's first config() call resolves them; shutdown clears them.
    set_config(Config())
    core = CoreWorker(gcs_address, namespace=namespace, mode="driver")
    runtime_mod._global_runtime = core
    if log_to_driver:
        core.start_log_mirroring()
    return core

"""Node providers — the cloud seam of the autoscaler.

Analog of the reference's v2 provider layer
(``python/ray/autoscaler/v2/instance_manager/``, cloud plugins under
``python/ray/autoscaler/{gcp,aws,...}``, and the load-bearing test provider
``_private/fake_multi_node/node_provider.py`` — SURVEY §4.3). The
``FakeNodeProvider`` backs autoscaler tests by adding virtual nodes to the
in-process runtime; ``LocalDaemonNodeProvider`` launches real node daemons
against a live multiprocess cluster. The JAX package's GCE TPU-pod provider
has no counterpart here: this package makes no cloud VMs.
"""

from __future__ import annotations

import os
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class NodeType:
    """One launchable instance shape (reference: ``available_node_types`` in
    the cluster YAML — ``autoscaler/ray-schema.json``)."""

    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class NodeInstance:
    instance_id: str
    node_type: str
    resources: Dict[str, float]
    status: str = "RUNNING"  # PENDING | RUNNING | TERMINATED
    node_id: Optional[object] = None  # runtime NodeID once joined


class NodeProvider:
    """Reference: ``autoscaler/node_provider.py`` interface."""

    def create_node(self, node_type: NodeType) -> NodeInstance:
        raise NotImplementedError

    def terminate_node(self, instance: NodeInstance) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[NodeInstance]:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Adds/removes virtual nodes on the live runtime (the single-host
    multi-node trick — ``cluster_utils.py:135 Cluster``)."""

    def __init__(self, runtime=None):
        from ray_tpu_torch.core.runtime import get_runtime

        self._runtime = runtime or get_runtime()
        self._instances: Dict[str, NodeInstance] = {}
        self._lock = threading.Lock()

    def create_node(self, node_type: NodeType) -> NodeInstance:
        node_id = self._runtime.add_node(
            resources=dict(node_type.resources),
            labels={"node-type": node_type.name, **node_type.labels},
        )
        inst = NodeInstance(
            instance_id=f"fake-{uuid.uuid4().hex[:8]}",
            node_type=node_type.name,
            resources=dict(node_type.resources),
            node_id=node_id,
        )
        with self._lock:
            self._instances[inst.instance_id] = inst
        return inst

    def terminate_node(self, instance: NodeInstance) -> None:
        with self._lock:
            inst = self._instances.pop(instance.instance_id, None)
        if inst is not None and inst.node_id is not None:
            self._runtime.remove_node(inst.node_id)
            inst.status = "TERMINATED"

    def non_terminated_nodes(self) -> List[NodeInstance]:
        with self._lock:
            return [i for i in self._instances.values() if i.status == "RUNNING"]


class LocalDaemonNodeProvider(NodeProvider):
    """Launches REAL node-daemon processes against a live multiprocess
    cluster (the in-repo analog of the reference's load-bearing
    ``_private/fake_multi_node`` provider): a scale-up is an actual
    ``ray_tpu_torch.core.node_daemon`` subprocess registering with the GCS; a
    scale-down SIGTERMs it and the health check reaps the membership row."""

    def __init__(self, gcs_address: str):
        self.gcs_address = gcs_address
        self._instances: Dict[str, NodeInstance] = {}
        self._procs: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def create_node(self, node_type: NodeType) -> NodeInstance:
        import json
        import subprocess
        import sys

        from ray_tpu_torch.core.cluster import _read_tagged_line
        from ray_tpu_torch.core.ids import NodeID
        from ray_tpu_torch.core.node_daemon import with_package_path

        labels = {"node-type": node_type.name, **node_type.labels}
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.node_daemon",
             "--gcs", self.gcs_address,
             "--resources", json.dumps(dict(node_type.resources)),
             "--labels", json.dumps(labels)],
            stdout=subprocess.PIPE, env=with_package_path(dict(os.environ)),
        )
        _read_tagged_line(proc, "NODE_ADDRESS")
        node_id = NodeID.from_hex(_read_tagged_line(proc, "NODE_ID"))
        _read_tagged_line(proc, "STORE_NAME")
        inst = NodeInstance(
            instance_id=f"daemon-{uuid.uuid4().hex[:8]}",
            node_type=node_type.name,
            resources=dict(node_type.resources),
            node_id=node_id,
        )
        with self._lock:
            self._instances[inst.instance_id] = inst
            self._procs[inst.instance_id] = proc
        return inst

    def terminate_node(self, instance: NodeInstance) -> None:
        import signal as _signal

        with self._lock:
            inst = self._instances.pop(instance.instance_id, None)
            proc = self._procs.pop(instance.instance_id, None)
        if proc is not None:
            try:
                proc.send_signal(_signal.SIGTERM)
                proc.wait(timeout=15)
            except Exception:  # noqa: BLE001 — already gone / stuck
                proc.kill()
        if inst is not None:
            inst.status = "TERMINATED"

    def non_terminated_nodes(self) -> List[NodeInstance]:
        with self._lock:
            return [i for i in self._instances.values()
                    if i.status == "RUNNING"]

    def shutdown(self) -> None:
        for inst in self.non_terminated_nodes():
            self.terminate_node(inst)

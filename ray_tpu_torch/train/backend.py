"""Training backends — per-framework worker-group setup hooks.

Analog of the reference's ``python/ray/train/backend.py`` (``Backend`` :16,
``BackendConfig`` :32) and its torch implementation
(``train/torch/config.py:34 TorchConfig`` → NCCL process group): a backend
gets ``on_start``/``on_training_start``/``on_shutdown`` hooks against the
WorkerGroup.

Counterpart of ``ray_tpu/train/backend.py``. ``TorchConfig`` takes the place
of ``JaxConfig``: rank 0 reserves the rendezvous address, every worker calls
``torch.distributed.init_process_group(backend, init_method="tcp://...",
world_size, rank)`` with all the calls in flight together, and the train
loop then builds its mesh on that group (``parallel.mesh.make_mesh``). A
torch process group holds one rank per process, so workers that share a
process (the in-process runtime) form none by default, as the JAX package
skips ``jax.distributed`` there, and asking for one raises.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, Optional

from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclass
class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks mirroring the reference's ``Backend`` lifecycle."""

    # The reference shares CUDA_VISIBLE_DEVICES among a node's workers; the
    # port has seen one card a machine, so there is nothing to share yet.
    share_cuda_visible_devices: bool = False

    def on_start(self, worker_group: WorkerGroup, backend_config: BackendConfig) -> None:
        pass

    def on_training_start(self, worker_group: WorkerGroup, backend_config: BackendConfig) -> None:
        pass

    def on_shutdown(self, worker_group: WorkerGroup, backend_config: BackendConfig) -> None:
        pass


@dataclass
class TorchConfig(BackendConfig):
    """Torch backend config.

    init_method_port: port of the ``tcp://`` rendezvous on rank 0's host;
        0 (default) reserves a free port there at start. Set a fixed port
        when inter-host firewalls require one.
    init_distributed: force-enable/disable the process group (default: only
        when the group spans >1 host, the JAX package's rule). Workers that
        share a process cannot form one: asking for it raises.
    backend: the process group's backend; None means ``"nccl"`` when the
        workers hold a ``GPU`` grant and ``"gloo"`` otherwise. A worker
        holding a ``GPU`` grant that sees no card raises (no gloo fallback).
    collective_group: also register an eager (host-side) collective group for
        the workers (``ray_tpu_torch.parallel.collectives``) — the analog of
        ``ray.util.collective`` groups, used for small host-side tensors;
        device tensors go through the process group inside the loop.
    """

    init_method_port: int = 0  # 0 = reserve a free port on rank 0
    init_distributed: Optional[bool] = None
    backend: Optional[str] = None
    collective_group: Optional[str] = "train"

    def backend_cls(self):
        return _TorchBackend


def _reserve_free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank0_address(port: int) -> str:
    """Runs on rank 0: ``host:port`` of the rendezvous — the interface this
    process reaches the GCS through (loopback on one host and in-process)
    and ``port``, or a free one reserved here."""
    from ray_tpu_torch.core.core_worker import _local_host_toward
    from ray_tpu_torch.core.runtime import get_runtime

    gcs = getattr(get_runtime(), "gcs_address", None)
    host = _local_host_toward(gcs) if gcs else "127.0.0.1"
    return f"{host}:{port or _reserve_free_port()}"


# This process's default process group as ``_setup_torch_worker`` formed it
# (the group itself is per process in torch.distributed).
_setup_info: Dict[str, Any] = {}


def process_group_setup() -> Dict[str, Any]:
    """What ``TorchConfig`` formed in this process: ``backend``,
    ``world_size``, ``rank``, ``init_method`` and ``init_ms`` (the
    ``init_process_group`` call), or ``{}`` if it formed none."""
    return dict(_setup_info)


def _destroy_process_group(timeout_s: float) -> None:
    """Destroy this process's default process group, if any, within
    ``timeout_s``: a group whose peer died can block in its destroy."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    errors = []

    def run():
        try:
            dist.destroy_process_group()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t = threading.Thread(target=run, name="rtpu-pg-destroy", daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise RuntimeError(
            f"destroy_process_group did not return in {timeout_s} s (a "
            f"peer of the earlier group is gone); restart the process")
    _setup_info.clear()
    if errors:
        raise errors[0]


def _setup_torch_worker(init_method: str, world_size: int, rank: int,
                        enable: bool, backend: str, timeout_s: float):
    """Runs on every train worker (reference analog:
    ``_setup_torch_process_group`` ``train/torch/config.py:64-100``)."""
    if not enable:
        return None
    import torch
    import torch.distributed as dist

    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "this train worker holds a GPU grant but sees no CUDA device; "
            "NCCL needs the card (no gloo fallback)")
    # Elastic restart: a surviving (pooled) worker process may still hold
    # the PREVIOUS incarnation's group, formed for a world that is gone —
    # the counterpart of jax.distributed.shutdown() before initialize.
    _destroy_process_group(timeout_s)
    kw = {}
    if backend == "nccl":         # form the communicator now, on this card
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s), **kw)
    _setup_info.update(backend=dist.get_backend(),
                       world_size=dist.get_world_size(), rank=dist.get_rank(),
                       init_method=init_method,
                       init_ms=(time.perf_counter() - t0) * 1e3)
    return process_group_setup()


def _collective_timeout_s() -> float:
    from ray_tpu_torch.core.config import config

    return float(config().collective_timeout_s)


class _TorchBackend(Backend):
    _driver_group = False     # a group formed in this (the driver's) process

    def on_start(self, worker_group: WorkerGroup, backend_config: TorchConfig) -> None:
        # Multi-process only when workers actually live on different hosts
        # (the JAX package's rule), unless the config says otherwise.
        mds = worker_group.metadatas
        hosts = {md.hostname for md in mds}
        multiproc = len(hosts) > 1
        enable = (
            backend_config.init_distributed
            if backend_config.init_distributed is not None
            else multiproc
        )
        n = worker_group.num_workers
        if enable and len({(md.hostname, md.pid) for md in mds}) < n:
            raise ValueError(
                f"init_distributed=True with {n} workers in "
                f"{len({(md.hostname, md.pid) for md in mds})} process(es): a "
                f"torch process group holds one rank per process")
        res = worker_group.resources_per_worker
        gpu = res.get("GPU", res.get("TPU", 0))
        backend = backend_config.backend or ("nccl" if gpu else "gloo")
        self._driver_group = enable and any(md.pid == os.getpid() for md in mds)
        import ray_tpu_torch

        init_method = ""
        if enable:
            # Reserve the port ON RANK 0's host so parallel worker groups
            # can't collide; the address then flows to every worker through
            # the control plane. A user-fixed port (firewalls) is honored.
            init_method = "tcp://" + ray_tpu_torch.get(
                worker_group.execute_single_async(
                    0, _rank0_address, backend_config.init_method_port))
        worker_group.execute(
            lambda rank=None: None
        )  # barrier: all actors constructed
        # Every rank's init must be in flight together: the store's
        # rendezvous waits for the whole world.
        timeout_s = _collective_timeout_s()
        results = [
            worker_group.execute_single_async(
                i, _setup_torch_worker, init_method, n, i, enable, backend,
                timeout_s)
            for i in range(n)
        ]
        ray_tpu_torch.get(results)

        if backend_config.collective_group:
            group = backend_config.collective_group

            def join(rank, world, name):
                from ray_tpu_torch.parallel import collectives as c

                c.init_collective_group(world, rank, group_name=name)
                return True

            ray_tpu_torch.get(
                [
                    worker_group.execute_single_async(i, join, i, n, group)
                    for i in range(n)
                ]
            )

    def on_shutdown(self, worker_group: WorkerGroup, backend_config: TorchConfig) -> None:
        # Driver-side destroy: going through the workers would queue behind
        # still-running train loops and block shutdown indefinitely.
        if backend_config.collective_group:
            from ray_tpu_torch.parallel import collectives

            try:
                collectives.destroy_collective_group(backend_config.collective_group)
            except Exception:
                pass
        # A group formed in this very process (an in-process worker) is
        # the driver's to destroy; a worker process's goes with the process
        # or with the next incarnation's setup.
        if self._driver_group:
            _destroy_process_group(_collective_timeout_s())

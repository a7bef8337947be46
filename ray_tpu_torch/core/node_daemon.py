"""Node daemon — one process per node: worker pool + object plane host.

Analog of the reference's raylet (``src/ray/raylet/main.cc:37-96`` daemon
contract, ``node_manager.cc``): registers the node with the GCS, heartbeats,
spawns and reaps **worker processes** (the ``WorkerPool`` of
``src/ray/raylet/worker_pool.cc`` — ``PopWorker`` decl ``worker_pool.h:343``),
forwards leased tasks to workers, hosts the node's shared-memory object store
(the plasma store runs inside the raylet in the reference,
``object_manager.cc:32-40``), and serves object fetches to remote nodes (the
push/pull transfer half of ``src/ray/object_manager/``).

Scheduling itself lives in the GCS (centralized resource truth); the daemon
is the execution plane: lease arrives → pop worker → push task → reply.

Runs standalone::

    python -m ray_tpu_torch.core.node_daemon --gcs HOST:PORT [--resources JSON]

The port's copy of ``ray_tpu/core/node_daemon.py``. The node registers what
``--resources`` names, with ``CPU`` defaulting to the core count, and detects
no accelerator: a card is ``GPU`` when the caller gives it
(``--resources '{"GPU": 1}'``), as the JAX daemon registers no TPU it is not
given. Workers run ``python -m ray_tpu_torch.core.worker_main`` with this
checkout's root on their ``PYTHONPATH``. It reads actor specs with
``serialization.loads_deferred``, so a torch object in an actor's
arguments is imported by the actor's worker alone. The lock-order and leak
checkers' start-up hooks come with those checkers.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import Config, config, set_config
from ray_tpu_torch.core.ids import ActorID, NodeID, WorkerID
from ray_tpu_torch.core.rpc import (
    BoundedSet,
    RpcClient,
    RpcClientPool,
    RpcConnectionError,
    RpcServer,
)
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("node_daemon")

# An actor's worker or build past this is logged as a warning (each step is
# logged at DEBUG); the GCS's _SLOW_SCHEDULING_S, for the same trail.
_SLOW_START_S = 30.0


# The root of the checkout this package was imported from: every process of
# a cluster imports the same ray_tpu_torch, wherever its cwd is.
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def with_package_path(env: Dict[str, str]) -> Dict[str, str]:
    """``env`` with this checkout's root first on ``PYTHONPATH``."""
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if _PACKAGE_ROOT not in parts:
        env["PYTHONPATH"] = os.pathsep.join([_PACKAGE_ROOT] + parts)
    return env


from ray_tpu_torch.core.exceptions import WorkerDiedError


def _memory_usage_fraction() -> Optional[float]:
    """Node memory pressure from /proc/meminfo (1 - available/total)."""
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                parts = line.split()
                if parts[0] in ("MemTotal:", "MemAvailable:"):
                    info[parts[0]] = int(parts[1])
        total = info.get("MemTotal:")
        avail = info.get("MemAvailable:")
        if not total or avail is None:
            return None
        return 1.0 - avail / total
    except OSError:
        return None


class _Worker:
    __slots__ = ("worker_id", "proc", "address", "client", "actor_id",
                 "actor_init", "busy", "env_key", "spawned_at")

    def __init__(self, worker_id: WorkerID, proc: subprocess.Popen,
                 env_key: Optional[str] = None):
        self.worker_id = worker_id
        self.proc = proc
        self.address: Optional[str] = None
        self.client: Optional[RpcClient] = None
        self.actor_id: Optional[ActorID] = None  # dedicated to an actor
        self.actor_init = False  # actor __init__ in flight (not a task)
        self.busy = False
        self.env_key = env_key  # runtime_env hash; None = vanilla pool
        # OOM policy: newest-spawned dies first. Monotonic — a wall-clock
        # step must not invert the ordering.
        self.spawned_at = time.monotonic()


class NodeDaemon:
    """RPC surface called by the GCS (actor starts) and by core workers
    (task pushes, object puts/fetches)."""

    def __init__(self, gcs_address: str, resources: Dict[str, float],
                 labels: Dict[str, str] | None = None,
                 host: str = "127.0.0.1"):
        self.node_id = NodeID.from_random()
        self.gcs_address = gcs_address
        self._gcs = RpcClient(gcs_address)
        self._peers = RpcClientPool()
        cfg = config()

        # --- object plane: C++ shm arena + heap shelf for small objects ----
        self.store_name = f"raytpu-{self.node_id.hex()[:12]}"
        self._shm = None
        try:
            from ray_tpu_torch.core.native_store import NativeObjectStore

            self._shm = NativeObjectStore(
                self.store_name, capacity=cfg.object_store_memory
            )
            # Background page prefault: fresh shm pages fault in ~10x
            # slower than rewrites under memory ballooning — pay that once
            # at boot, off the put path. Runs at SCHED_IDLE on the native
            # side, and is capped to a quarter of MemAvailable so co-hosted
            # daemons (tests: many nodes on one box) don't commit
            # num_nodes x arena of RSS before any object exists.
            cap_bytes = 0
            try:
                with open("/proc/meminfo") as f:
                    for line in f:
                        if line.startswith("MemAvailable:"):
                            cap_bytes = int(line.split()[1]) * 1024 // 4
                            break
            except OSError:
                pass
            threading.Thread(target=self._shm.prefault,
                             kwargs={"max_bytes": cap_bytes},
                             name="shm-prefault", daemon=True).start()
        except Exception as e:  # noqa: BLE001 — heap fallback keeps tests green
            logger.warning("native shm store unavailable (%s); heap fallback", e)
            self.store_name = ""
        self._heap: Dict[bytes, bytes] = {}
        self._heap_lock = threading.Lock()
        # Spill shelf (local_object_manager.cc:110 SpillObjects analog):
        # objects that don't fit the shm arena land on disk, keyed by the
        # same 20-byte id; served back chunk-wise on fetch.
        self._spill_dir = os.path.join(
            cfg.object_spilling_dir
            or os.path.join(tempfile.gettempdir(), "ray_tpu_spill"),
            self.node_id.hex()[:12])
        self._spilled: Dict[bytes, int] = {}  # key -> size
        self._pending_spills: Dict[bytes, float] = {}  # uncommitted uploads
        # Positional-read fd cache for spill-served chunks: striped pulls
        # issue many concurrent chunk reads per object, and an open+seek
        # per chunk would pay path resolution each time. os.pread is
        # thread-safe (no shared file offset), so one fd serves all of an
        # object's concurrent chunk requests.
        self._spill_fds: Dict[bytes, int] = {}
        self._spill_fd_lock = threading.Lock()

        # --- worker pool ----------------------------------------------------
        self._pool_lock = threading.Lock()
        self._pool_cv = threading.Condition(self._pool_lock)
        self._workers: Dict[WorkerID, _Worker] = {}
        self._idle: List[_Worker] = []
        self._spawn_pending = 0  # spawned but not yet registered
        self._demand = 0  # _pop_worker calls currently waiting
        # Worker's CURRENT task lease (may swap during blocked-release).
        self._worker_lease: Dict[WorkerID, Optional[str]] = {}
        # Session log dir: per-worker stdout/stderr files, tailed into the
        # GCS "logs" pubsub channel (log_monitor.py analog).
        self._log_dir = os.path.join(
            tempfile.gettempdir(), "ray_tpu_session_logs",
            self.node_id.hex()[:12])
        os.makedirs(self._log_dir, exist_ok=True)
        self._log_offsets: Dict[str, int] = {}
        num_cpus = resources.get("CPU", os.cpu_count() or 4)
        self._max_workers = max(int(num_cpus) * 2, cfg.max_workers_per_node)

        # Handler pool must exceed the worker cap: every in-flight
        # execute_task occupies one handler for the task's duration, and
        # worker watchdog pings + registrations must never starve behind
        # them (workers self-terminate if pings stall 5s).
        self._server = RpcServer(self, host=host, name="raylet",
                                 max_workers=self._max_workers + 32)
        self.address = self._server.address
        self._resources = resources
        self._labels = labels or {}
        # Live actor records for GCS-restart re-adoption:
        # actor_id -> (spec_bytes, worker_addr)
        self._actor_records: Dict[ActorID, Tuple[bytes, str]] = {}
        # Directly-leased workers (the direct task transport): worker_id ->
        # client_id of the leasing client process, so a client death
        # reclaims its workers (the reference ties leases to the gRPC
        # channel; raylet kills leased workers on client disconnect).
        self._direct_leases: Dict[WorkerID, str] = {}
        self._dead_clients = BoundedSet()
        # Daemon-local scheduling plane: GCS-granted capacity blocks carved
        # into per-task leases here (raylet-side cluster_task_manager
        # analog). Idle capacity flows back on the TTL sweep below.
        from ray_tpu_torch.core.lease_table import LocalLeaseTable

        self._lease_table = LocalLeaseTable()

        reply = self._gcs.call(
            "register_node", self.node_id, self.address, resources,
            self._labels, self.store_name,
        )
        # Adopt the cluster's config so flags set at head apply node-wide
        # (the reference plumbs _system_config through raylet gflags).
        set_config(Config(reply.get("config")))

        self._stopped = threading.Event()
        # Prestart pool workers (worker_pool.cc prestart): interpreter boot
        # is seconds (torch import), so filling the idle pool at daemon start
        # keeps first-burst tasks from serializing behind spawns. Read the
        # ADOPTED cluster config (set_config above), not the boot snapshot.
        prestart = min(int(num_cpus), config().prestart_workers_per_node)
        with self._pool_cv:
            for _ in range(prestart):
                self._spawn_worker()
                self._spawn_pending += 1
        # Metrics plane: export this daemon's registry + store/pool gauges
        # to the GCS (started after set_config so the adopted cluster
        # interval applies from the first tick).
        from ray_tpu_torch.core.metrics_export import MetricsExporter

        self._metrics_exporter = MetricsExporter(
            report=lambda *a: self._gcs.notify("report_metrics", *a),
            node_id=self.node_id.hex(), component="node_daemon",
            collectors=[self._collect_node_metrics]).start()
        threading.Thread(target=self._heartbeat_loop, name="daemon-heartbeat",
                         daemon=True).start()
        threading.Thread(target=self._reaper_loop, name="daemon-reaper",
                         daemon=True).start()
        threading.Thread(target=self._log_tail_loop, name="daemon-logtail",
                         daemon=True).start()
        threading.Thread(target=self._memory_monitor_loop,
                         name="daemon-memmon", daemon=True).start()
        threading.Thread(target=self._capacity_sweep_loop,
                         name="daemon-capsweep", daemon=True).start()

    # ====================== heartbeat / lifecycle ======================

    def _heartbeat_loop(self) -> None:
        period = config().health_check_period_s / 2.0
        while not self._stopped.wait(period):
            sent = time.monotonic()
            try:
                status = self._gcs.call("heartbeat", self.node_id, timeout=5.0)
            except (RpcConnectionError, TimeoutError):
                logger.warning("heartbeat to GCS failed after %.2f s",
                               time.monotonic() - sent)
                continue
            rtt = time.monotonic() - sent
            if rtt > period:      # a late reply: the GCS is slow to answer
                logger.warning("heartbeat reply took %.2f s", rtt)
            if status == "dead" or status is False:
                logger.error("GCS declared this node dead; exiting")
                self.shutdown()
                os._exit(1)
            if status == "unknown":
                # Fresh GCS (head restart): re-register with our live actor
                # records so the new control plane re-adopts them
                # (raylet reconnect-with-backoff, gcs_init_data rebuild).
                logger.info("GCS does not know this node; re-registering")
                with self._pool_lock:
                    hosted = [(aid, rec[0], rec[1])
                              for aid, rec in self._actor_records.items()]
                try:
                    self._gcs.call(
                        "register_node", self.node_id, self.address,
                        self._resources, self._labels, self.store_name,
                        hosted_actors=hosted, timeout=10.0,
                    )
                except (RpcConnectionError, TimeoutError):
                    logger.warning("re-register failed; will retry")

    def ping(self) -> str:
        return "pong"

    def shutdown(self) -> None:
        self._stopped.set()
        self._metrics_exporter.stop()
        with self._pool_lock:
            workers = list(self._workers.values())
        for w in workers:
            try:
                w.proc.kill()
            except OSError:
                pass
        if self._shm is not None:
            try:
                self._shm.destroy()
            except Exception:  # noqa: BLE001
                log_swallowed(logger, "shm store destroy at shutdown")
        # Close the spill-chunk pread fd cache: the spill files are about
        # to be rmtree'd and a daemon that restarts in-process (tests,
        # supervised respawn) must not accumulate dead fds.
        with self._spill_fd_lock:
            spill_fds = list(self._spill_fds.values())
            self._spill_fds.clear()
        for fd in spill_fds:
            try:
                os.close(fd)
            except OSError:
                pass
        import shutil

        shutil.rmtree(self._log_dir, ignore_errors=True)
        shutil.rmtree(self._spill_dir, ignore_errors=True)
        self._server.stop()

    # ====================== worker pool ======================

    # Max age of an in-progress build marker before waiters treat the
    # creator as dead (SIGKILL/OOM) and reclaim the directory. Must exceed
    # the longest untouched build step (the pip install subprocess, 600s).
    _PIP_BUILD_STALE_S = 700.0
    # Waiter patience: > the creator's full worst-case budget (venv 120s +
    # install 600s) so slow-but-succeeding builds don't fail their sharers.
    _PIP_WAIT_S = 900.0
    # Conda builds run up to 1800s in ONE untouched subprocess step, so the
    # staleness horizon and waiter patience both must exceed that.
    _CONDA_BUILD_STALE_S = 2000.0
    _CONDA_WAIT_S = 2100.0

    @staticmethod
    def _pip_env_root() -> str:
        """Per-uid, 0700 cache root (the reference's runtime-env agent
        caches per node the same way): a fixed world-writable path would
        let another local user pre-plant a poisoned env at a known key."""
        root = os.path.join(tempfile.gettempdir(),
                            f"ray_tpu_envs-{os.getuid()}")
        os.makedirs(root, mode=0o700, exist_ok=True)
        st = os.stat(root)
        if st.st_uid != os.getuid() or (st.st_mode & 0o077):
            raise RuntimeError(
                f"pip env cache {root} has unsafe ownership/permissions")
        return root

    def _ensure_pip_env(self, pip_spec) -> str:
        """Build (or reuse) a venv for a pip runtime env; returns its
        python executable. ``pip_spec``: list of requirements, or a dict
        with "packages" (+ "pip_install_options"). Zero-egress images can
        only install LOCAL paths/wheels; failures surface to the
        submitting task."""
        import hashlib
        import shutil as _shutil
        import subprocess

        if isinstance(pip_spec, dict):
            packages = list(pip_spec.get("packages", []))
            # e.g. ["--no-index", "--no-build-isolation"] — how zero-egress
            # deployments install local wheels/trees (the reference's pip
            # spec dict carries pip_install_options the same way).
            pip_options = list(pip_spec.get("pip_install_options", []))
        else:
            packages = list(pip_spec)
            pip_options = []
        key = hashlib.sha1(json.dumps([packages, pip_options],
                                      sort_keys=True).encode()).hexdigest()[:16]
        env_dir = os.path.join(self._pip_env_root(), key)
        python = os.path.join(env_dir, "bin", "python")
        ready = os.path.join(env_dir, ".ready")
        building = os.path.join(env_dir, ".building")
        deadline = time.time() + self._PIP_WAIT_S
        while True:
            if os.path.exists(ready):
                return python
            try:
                # mkdir is the atomic claim: exactly one creator proceeds.
                os.makedirs(env_dir)
            except FileExistsError:
                # A creator claimed it. If its .building marker is ancient
                # (or absent and the dir is old), that creator died without
                # cleanup — reclaim so one crash can't wedge the spec
                # until a human deletes the directory.
                try:
                    age = time.time() - os.stat(building).st_mtime
                except OSError:
                    try:
                        age = time.time() - os.stat(env_dir).st_mtime
                    except OSError:
                        continue  # dir vanished: retry the claim
                if age > self._PIP_BUILD_STALE_S:
                    # Atomic takeover via rename (see the conda path): an
                    # unconditional rmtree could act on an arbitrarily
                    # stale `age` and delete a NEW creator's live claim.
                    reap = f"{env_dir}.reap-{os.getpid()}-{time.time_ns()}"
                    try:
                        os.rename(env_dir, reap)
                    except OSError:
                        continue  # someone else reclaimed first
                    logger.warning("reclaiming stale pip env build %s "
                                   "(creator died?)", key)
                    _shutil.rmtree(reap, ignore_errors=True)
                    continue
                if time.time() > deadline:
                    raise TimeoutError(
                        f"pip env {key} build by another process never "
                        "finished")
                time.sleep(0.5)
                continue
            try:
                open(building, "w").close()
                # --system-site-packages: jax/numpy/the framework stay
                # importable; the venv only ADDS the requested packages.
                subprocess.run([sys.executable, "-m", "venv",
                                "--system-site-packages", env_dir],
                               check=True, capture_output=True, timeout=120)
                # Re-touch the claim marker between the two long build
                # steps: the worst-case untouched stretch is otherwise
                # venv(120s) + pip(600s) > _PIP_BUILD_STALE_S, letting a
                # waiter rmtree a LIVE creator's env mid-install.
                os.utime(building, None)
                # When the daemon itself runs inside a venv (this image
                # does), --system-site-packages chains to the BASE
                # interpreter's site, not the daemon venv's — add a .pth so
                # the parent environment's packages stay visible.
                import sysconfig

                parent_site = sysconfig.get_paths()["purelib"]
                child_site = os.path.join(
                    env_dir, "lib",
                    f"python{sys.version_info.major}."
                    f"{sys.version_info.minor}", "site-packages")
                with open(os.path.join(child_site,
                                       "_rtpu_parent_env.pth"), "w") as f:
                    f.write(parent_site + "\n")
                if packages:
                    out = subprocess.run(
                        [python, "-m", "pip", "install", *pip_options,
                         *packages],
                        capture_output=True, text=True, timeout=600)
                    if out.returncode != 0:
                        raise RuntimeError(
                            f"pip install failed: {out.stderr[-1000:]}")
                open(ready, "w").close()
                return python
            except BaseException:
                import shutil as _shutil

                _shutil.rmtree(env_dir, ignore_errors=True)
                raise

    def _ensure_conda_env(self, conda_spec) -> str:
        """Resolve (or build) a conda env for a conda runtime env; returns
        its python executable (the reference's conda plugin,
        ``_private/runtime_env/conda.py``).

        - str with a path separator: an env PREFIX — ``<prefix>/bin/python``
          must exist (no conda binary needed; venv prefixes work too).
        - other str: a NAMED env under ``$(conda info --base)/envs``.
        - dict: an environment.yml body, built once into a cached prefix
          keyed by spec hash (requires the conda binary).
        """
        import hashlib
        import shutil as _shutil
        import subprocess

        def python_of(prefix: str) -> str:
            py = os.path.join(prefix, "bin", "python")
            if not os.path.exists(py):
                raise RuntimeError(
                    f"conda env prefix {prefix!r} has no bin/python")
            return py

        if isinstance(conda_spec, str):
            if os.sep in conda_spec:
                return python_of(os.path.abspath(conda_spec))
            conda = _shutil.which("conda") or os.environ.get("CONDA_EXE")
            if not conda:
                raise RuntimeError(
                    "runtime_env conda={name!r} needs the conda binary on "
                    "this node (pass an env PREFIX path to use an existing "
                    "environment without conda)".format(name=conda_spec))
            base = subprocess.run([conda, "info", "--base"],
                                  capture_output=True, text=True,
                                  timeout=60).stdout.strip()
            return python_of(os.path.join(base, "envs", conda_spec))

        # dict: build a cached env from the yaml body. Same claim protocol
        # as the pip path: an atomic mkdir claims the prefix, a .building
        # marker (with staleness reclaim) covers creator death, and waiters
        # poll for .ready instead of building — two concurrent spawns can
        # never rmtree each other's in-progress build.
        conda = _shutil.which("conda") or os.environ.get("CONDA_EXE")
        if not conda:
            raise RuntimeError(
                "runtime_env conda environments require the conda binary "
                "on this node")
        key = hashlib.sha1(json.dumps(conda_spec,
                                      sort_keys=True).encode()).hexdigest()[:16]
        prefix = os.path.join(self._pip_env_root(), f"conda-{key}")
        ready = os.path.join(prefix, ".ready")
        # The claim is a SIDECAR dir (conda insists on creating the prefix
        # itself): atomic mkdir elects exactly one creator; the .building
        # marker inside it covers creator death via staleness reclaim.
        claim = prefix + ".claim"
        building = os.path.join(claim, ".building")
        deadline = time.time() + self._CONDA_WAIT_S
        while True:
            if os.path.exists(ready):
                return python_of(prefix)
            try:
                os.makedirs(claim)
            except FileExistsError:
                # A creator holds the claim. Reclaim only if its .building
                # marker is ancient (creator died without cleanup).
                try:
                    age = time.time() - os.stat(building).st_mtime
                except OSError:
                    try:
                        age = time.time() - os.stat(claim).st_mtime
                    except OSError:
                        continue  # claim vanished: retry
                if age > self._CONDA_BUILD_STALE_S:
                    # Atomic takeover: rename the stale claim aside so only
                    # ONE waiter reclaims (a second waiter's rename fails) —
                    # an unconditional rmtree here could fire with an
                    # arbitrarily stale `age` and delete a NEW creator's
                    # live claim/prefix. Prefix debris is cleared by the
                    # next claim OWNER, under the claim lock.
                    reap = f"{claim}.reap-{os.getpid()}-{time.time_ns()}"
                    try:
                        os.rename(claim, reap)
                    except OSError:
                        continue  # someone else reclaimed first
                    logger.warning("reclaiming stale conda env build %s "
                                   "(creator died?)", key)
                    _shutil.rmtree(reap, ignore_errors=True)
                    continue
                if time.time() > deadline:
                    raise TimeoutError(
                        f"conda env {key} build by another process never "
                        "finished")
                time.sleep(0.5)
                continue
            try:
                open(building, "w").close()
                if os.path.exists(ready):
                    # Lost the race benignly: the previous creator finished
                    # between our ready-check and our claim.
                    return python_of(prefix)
                # Claim owner: any leftover prefix is a dead creator's
                # debris (a LIVE creator always holds the claim).
                _shutil.rmtree(prefix, ignore_errors=True)
                import tempfile

                import yaml  # type: ignore[import-untyped]

                with tempfile.NamedTemporaryFile("w", suffix=".yml",
                                                 delete=False) as f:
                    yaml.safe_dump(conda_spec, f)
                    spec_path = f.name
                out = subprocess.run(
                    [conda, "env", "create", "-p", prefix, "-f", spec_path],
                    capture_output=True, text=True, timeout=1800)
                os.unlink(spec_path)
                if out.returncode != 0:
                    raise RuntimeError(
                        f"conda env create failed: {out.stderr[-1000:]}")
                open(ready, "w").close()
                return python_of(prefix)
            except BaseException:
                # Only the claim OWNER ever deletes the prefix.
                _shutil.rmtree(prefix, ignore_errors=True)
                raise
            finally:
                _shutil.rmtree(claim, ignore_errors=True)

    # Env keys forwarded INTO worker containers (docker doesn't inherit the
    # daemon's environment the way a plain subprocess does).
    _CONTAINER_ENV_PREFIXES = ("RAY_TPU_", "CUDA_", "TORCH_", "NVIDIA_",
                               "PYTHONPATH")

    def _container_command(self, container_spec: Dict[str, Any],
                           argv: List[str],
                           env: Dict[str, str]) -> List[str]:
        """Wrap a worker command to run inside a container (the reference's
        container plugin, ``_private/runtime_env/container.py``): host
        networking so the worker reaches the daemon/GCS sockets, /dev/shm
        shared so the object-store arena stays visible, runtime-env keys
        forwarded with ``-e``. The runtime binary comes from
        ``container_spec["runtime"]``, ``$RAY_TPU_CONTAINER_RUNTIME``, or
        podman/docker discovery."""
        import shutil as _shutil

        image = container_spec.get("image")
        if not image:
            raise RuntimeError("runtime_env container spec needs 'image'")
        runtime = (container_spec.get("runtime")
                   or os.environ.get("RAY_TPU_CONTAINER_RUNTIME")
                   or _shutil.which("podman") or _shutil.which("docker"))
        if not runtime:
            raise RuntimeError(
                "runtime_env container requires podman or docker on this "
                "node (or RAY_TPU_CONTAINER_RUNTIME)")
        cmd = [runtime, "run", "--rm", "--network=host", "--ipc=host",
               "-v", "/dev/shm:/dev/shm"]
        for k, v in sorted(env.items()):
            if k.startswith(self._CONTAINER_ENV_PREFIXES):
                cmd += ["-e", f"{k}={v}"]
        cmd += list(container_spec.get("run_options", []))
        cmd.append(image)
        cmd += argv
        return cmd

    def _spawn_worker(self, extra_env: Optional[Dict[str, str]] = None,
                      env_key: Optional[str] = None,
                      python_exe: Optional[str] = None,
                      container_spec: Optional[Dict[str, Any]] = None) -> _Worker:
        worker_id = WorkerID.from_random()
        env = with_package_path(dict(os.environ))
        env["RAY_TPU_WORKER_ID"] = worker_id.hex()
        env["RAY_TPU_DAEMON_ADDRESS"] = self.address
        env["RAY_TPU_GCS_ADDRESS"] = self.gcs_address
        env["RAY_TPU_NODE_ID"] = self.node_id.hex()
        env["RAY_TPU_STORE_NAME"] = self.store_name
        if extra_env:
            env.update({k: str(v) for k, v in extra_env.items()})
        # Worker stdout/stderr land in per-worker session logs (reference:
        # every process writes session/logs/*; the log monitor tails them).
        log_path = os.path.join(self._log_dir,
                                f"worker-{worker_id.hex()[:12]}.log")
        log_file = open(log_path, "ab", buffering=0)
        argv = [python_exe or sys.executable, "-m", "ray_tpu_torch.core.worker_main"]
        if container_spec:
            # Containerized workers run the image's `python` (the image
            # carries its own interpreter + ray_tpu_torch install).
            argv = self._container_command(
                container_spec, ["python", "-m", "ray_tpu_torch.core.worker_main"],
                env)
        proc = subprocess.Popen(
            argv, env=env, stdout=log_file, stderr=subprocess.STDOUT,
        )
        log_file.close()  # the child holds its own fd
        worker = _Worker(worker_id, proc, env_key=env_key)
        self._workers[worker_id] = worker
        flightrec.record("process", f"worker-{worker_id.hex()[:12]}",
                         f"spawn pid={proc.pid}")
        return worker

    def _spawn_dedicated(self, runtime_env: Dict[str, Any],
                         timeout: float = 60.0) -> _Worker:
        """Fresh worker with a per-task/actor runtime environment.

        The reference keys its idle pool by runtime-env hash
        (worker_pool.cc); here env-bearing workers never join the vanilla
        pool at all — they are dedicated (actors) or killed after the task.
        env_vars apply at PROCESS SPAWN, so they land before any import
        (torch's included) runs in the worker;
        ``pip`` specs run the worker inside a cached per-spec venv
        (the runtime-env agent's pip plugin).
        """
        import json

        env_vars = runtime_env.get("env_vars") or {}
        python_exe = None
        if runtime_env.get("pip"):
            python_exe = self._ensure_pip_env(runtime_env["pip"])
        if runtime_env.get("conda"):
            python_exe = self._ensure_conda_env(runtime_env["conda"])
        container_spec = runtime_env.get("container")
        key = json.dumps(runtime_env, sort_keys=True, default=str)
        deadline = time.time() + timeout
        with self._pool_cv:
            # Dedicated spawns don't touch _spawn_pending: that counter
            # gates the VANILLA pool only (a stuck dedicated spawn must not
            # starve ordinary tasks).
            worker = self._spawn_worker(env_vars, env_key=key,
                                        python_exe=python_exe,
                                        container_spec=container_spec)
            try:
                while worker.address is None:
                    if worker.proc.poll() is not None:
                        raise WorkerDiedError(
                            "runtime_env worker exited during startup "
                            f"rc={worker.proc.returncode}")
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise TimeoutError("runtime_env worker failed to start")
                    self._pool_cv.wait(timeout=min(remaining, 1.0))
            except (TimeoutError, WorkerDiedError):
                self._workers.pop(worker.worker_id, None)
                try:
                    worker.proc.kill()
                except OSError:
                    pass
                raise
            worker.busy = True
            return worker

    def update_worker_lease(self, worker_id: WorkerID,
                            lease_id: Optional[str]) -> None:
        """Worker reports a lease swap (blocked-release/reacquire) so a
        mid-task death releases the RIGHT lease. None = worker released it
        itself and holds nothing."""
        with self._pool_lock:
            if worker_id in self._workers:
                self._worker_lease[worker_id] = lease_id

    def register_worker(self, worker_id: WorkerID, address: str) -> None:
        """Called by a freshly started worker process once its server is up."""
        with self._pool_cv:
            worker = self._workers.get(worker_id)
            if worker is None:
                return
            worker.address = address
            worker.client = RpcClient(address)
            if worker.env_key is None:
                # Only vanilla workers join the shared idle pool; dedicated
                # (runtime_env) workers are claimed by their spawner via the
                # address becoming non-None — never by _pop_worker.
                self._spawn_pending = max(0, self._spawn_pending - 1)
                self._idle.append(worker)
            self._pool_cv.notify_all()

    def _pop_worker(self, timeout: float = 60.0) -> _Worker:
        """PopWorker (worker_pool.h:343): reuse an idle worker or spawn.

        Spawn accounting: start new processes only up to the number of
        waiting pops not already covered by in-flight spawns (the
        reference's maximum_startup_concurrency bound in worker_pool.cc).
        """
        deadline = time.time() + timeout
        with self._pool_cv:
            self._demand += 1
            try:
                while True:
                    while self._idle:
                        worker = self._idle.pop()
                        if worker.proc.poll() is None:
                            worker.busy = True
                            return worker
                    # Workers that RELEASED their lease while blocked in a
                    # nested get (map entry is None) don't count against the
                    # cap — otherwise deep nesting wedges on pool slots with
                    # CPUs logically free (the reference grows its pool for
                    # blocked workers the same way).
                    live = sum(
                        1 for w in self._workers.values()
                        if w.proc.poll() is None
                        and self._worker_lease.get(w.worker_id, "idle") is not None)
                    if (live + self._spawn_pending < self._max_workers
                            and self._spawn_pending < self._demand):
                        self._spawn_worker()
                        self._spawn_pending += 1
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise TimeoutError("no worker available")
                    self._pool_cv.wait(timeout=min(remaining, 1.0))
            finally:
                self._demand -= 1

    def _return_worker(self, worker: _Worker) -> None:
        if worker.env_key is not None:
            # Env-contaminated worker: never rejoins the vanilla pool.
            try:
                worker.proc.kill()
            except OSError:
                pass
            return
        with self._pool_cv:
            if (worker.proc.poll() is None and worker.actor_id is None
                    and worker.worker_id in self._workers):
                worker.busy = False
                self._idle.append(worker)
                self._pool_cv.notify_all()

    def _reaper_loop(self) -> None:
        """Detect worker deaths (the raylet learns via child SIGCHLD)."""
        last_spill_sweep = time.time()
        while not self._stopped.wait(0.1):
            if time.time() - last_spill_sweep > 60.0:
                last_spill_sweep = time.time()
                self._sweep_stale_spills()
            dead: List[_Worker] = []
            with self._pool_cv:
                for worker in list(self._workers.values()):
                    if worker.proc.poll() is not None:
                        dead.append(worker)
                        self._workers.pop(worker.worker_id, None)
                        if worker in self._idle:
                            self._idle.remove(worker)
                        if worker.address is None:
                            # Died before registering: un-account the spawn.
                            self._spawn_pending = max(0, self._spawn_pending - 1)
                if dead:
                    self._pool_cv.notify_all()
            for worker in dead:
                rc = worker.proc.returncode
                flightrec.record(
                    "process", f"worker-{worker.worker_id.hex()[:12]}",
                    f"exit rc={rc} pid={worker.proc.pid}")
                with self._pool_lock:
                    orphan_lease = self._worker_lease.pop(worker.worker_id, None)
                if orphan_lease is not None:
                    # Task worker died mid-lease (possibly a swapped one
                    # from blocked-release) — free the resources.
                    self._release(orphan_lease)
                if worker.actor_id is not None:
                    with self._pool_lock:
                        self._actor_records.pop(worker.actor_id, None)
                    cause = (f"worker process for actor "
                             f"{worker.actor_id.hex()[:8]} exited rc={rc}")
                    logger.warning(cause)
                    try:
                        self._gcs.call("report_actor_failure",
                                       worker.actor_id, cause, timeout=10.0)
                    except (RpcConnectionError, TimeoutError):
                        pass
                if worker.client is not None:
                    worker.client.close()

    # ====================== task execution ======================

    def execute_task(self, spec_bytes: bytes, lease_id: str,
                     runtime_env: Optional[Dict[str, Any]] = None) -> dict:
        """Run one task on a pooled worker; returns the worker's result meta.

        The reference pushes tasks from the *driver* straight to the leased
        worker (``direct_task_transport.cc:241 PushNormalTask``); we route
        through the daemon so worker identity stays private to the node and
        worker death maps cleanly to a retriable error for the caller.
        ``runtime_env`` (sent as a sidecar so the daemon never deserializes
        user args) forces a fresh worker process — with env_vars applied at
        spawn and/or a cached pip venv as its interpreter.
        """
        try:
            worker = (self._spawn_dedicated(runtime_env) if runtime_env
                      else self._pop_worker())
        except BaseException as e:  # noqa: BLE001 — lease must not leak
            self._release(lease_id)
            raise WorkerDiedError(f"worker pool exhausted: {e}") from e
        broken = False
        with self._pool_lock:
            self._worker_lease[worker.worker_id] = lease_id
        try:
            result = worker.client.call("run_task", spec_bytes, lease_id,
                                        timeout=None)
            # IN-BAND final lease: blocked-release may have swapped or shed
            # the grant mid-task; the reply says what the worker holds NOW
            # (deterministic — the side-channel notify only races crashes).
            with self._pool_lock:
                self._worker_lease.pop(worker.worker_id, None)
            final = result.pop("final_lease_id", lease_id)
            if final is not None:
                self._release(final)
            return result
        except RpcConnectionError as e:
            broken = True
            raise WorkerDiedError(
                f"worker died while running task: {e}"
            ) from e
        except BaseException:
            broken = True  # unknown channel state: don't reuse the worker
            raise
        finally:
            if broken:
                # Exceptional paths (conn loss, frame errors, pre-task
                # failures): release whatever the side-channel notes last
                # recorded — the lease must never outlive the attempt.
                with self._pool_lock:
                    current = self._worker_lease.pop(worker.worker_id, lease_id)
                if current is not None:
                    self._release(current)
            if broken:
                # Never return a worker whose channel broke: its process is
                # dead or wedged. Kill it so the reaper collects it instead
                # of handing the same corpse to the next pop.
                try:
                    worker.proc.kill()
                except OSError:
                    pass
            else:
                self._return_worker(worker)

    def _release(self, lease_id: str) -> None:
        from ray_tpu_torch.core.lease_table import is_block_lease

        if is_block_lease(lease_id):
            # Carved from a local capacity block: the unit returns to the
            # block's free pool here; the GCS only sees capacity move on
            # the idle-TTL sweep (or client-death revocation).
            self._lease_table.release(lease_id)
            return
        try:
            self._gcs.notify("release_lease", lease_id)
        except RpcConnectionError:
            pass

    # ============ daemon-local lease table (capacity blocks) ============

    def adopt_capacity_block(self, block_id: str, shape: Dict[str, float],
                             total: int, pinned: bool = False) -> None:
        """GCS pushes a fresh block grant (best-effort; the client's first
        lease_worker_block carries the same hint inline). ``pinned`` blocks
        back a gang placement-group reservation: the idle sweep must never
        ship their units back — they leave only via revoke."""
        self._lease_table.adopt(block_id, shape, int(total), pinned=pinned)

    def revoke_capacity_block(self, block_id: str) -> None:
        """GCS reclaimed the block (client death): stop carving; in-flight
        tasks finish but their units never return to the local pool."""
        self._lease_table.revoke(block_id)

    def _carve_one(self, block_id: str, shape: Dict[str, float], total: int,
                   _client_id: str, pop_timeout: float = 60.0):
        """One (block carve → pooled worker) pair, or None when the block
        is exhausted/revoked/unknown. Raises WorkerDiedError when a lease
        was carved but no worker can back it (the unit is released)."""
        lease_id = self._lease_table.carve(block_id, shape, int(total))
        if lease_id is None:
            return None
        try:
            worker = self._pop_worker(timeout=pop_timeout)
        except BaseException as e:  # noqa: BLE001 — carve must not leak
            self._lease_table.release(lease_id)
            raise WorkerDiedError(f"worker pool exhausted: {e}") from e
        refused = False
        with self._pool_lock:
            if _client_id and _client_id in self._dead_clients:
                # Grant-after-death race (see lease_worker).
                self._return_worker_locked_exit(worker)
                refused = True
            else:
                self._worker_lease[worker.worker_id] = lease_id
                self._direct_leases[worker.worker_id] = _client_id
        if refused:
            self._lease_table.release(lease_id)
            raise WorkerDiedError("client is dead; worker lease refused")
        return lease_id, worker.worker_id.binary(), worker.address

    def lease_worker_block(self, block_id: str, shape: Dict[str, float],
                           total: int, _client_id: str = ""):
        """Carve one lease from a capacity block AND grant a pooled worker
        for direct task pushes — the batched sibling of :meth:`lease_worker`
        with zero GCS hops. Returns ``(lease_id, worker_id, worker_addr)``
        or None when the block is exhausted/revoked/unknown (the client
        then re-requests capacity from the GCS)."""
        return self._carve_one(block_id, shape, int(total), _client_id)

    lease_worker_block._rpc_wants_conn = True  # RpcServer injects _client_id

    def lease_worker_block_n(self, block_id: str, shape: Dict[str, float],
                             total: int, n: int, _client_id: str = ""):
        """Carve up to ``n`` (lease, worker) pairs from a capacity block in
        ONE round trip — the client amortizes the daemon hop across a whole
        batch grant the same way the batch grant amortized the GCS hop.
        Returns a possibly-short list of ``(lease_id, worker_id,
        worker_addr)``; empty when the block is exhausted/revoked/unknown.
        The first carve may wait the full worker-spawn timeout; later ones
        wait briefly and return what we have, so one slow spawn never holds
        an entire batch (the client re-requests the remainder)."""
        grants: list = []
        for _ in range(max(1, int(n))):
            try:
                got = self._carve_one(block_id, shape, int(total),
                                      _client_id,
                                      pop_timeout=60.0 if not grants
                                      else 5.0)
            except WorkerDiedError:
                if grants:
                    break  # deliver the partial batch; client retries rest
                raise
            if got is None:
                break
            grants.append(got)
        return grants

    lease_worker_block_n._rpc_wants_conn = True

    def release_block_lease(self, lease_id: str) -> None:
        """Worker blocked-release path for block-carved leases: the daemon
        is the release authority (no GCS hop)."""
        self._lease_table.release(lease_id)

    def _capacity_sweep_loop(self) -> None:
        """Ship idle block capacity back to the GCS (the revocable-grant
        contract: unused units must not sit reserved on this node). A
        failed return is rolled back and retried next tick; an 'unknown
        block' reply means the GCS restarted — drop the stale record."""
        while not self._stopped.wait(0.25):
            for block_id, n in self._lease_table.sweep_idle(
                    config().idle_lease_ttl_s):
                try:
                    known = self._gcs.call("return_block_capacity",
                                           block_id, n, timeout=5.0)
                except (RpcConnectionError, TimeoutError):
                    self._lease_table.unsweep(block_id, n)
                    continue
                if known is False:
                    self._lease_table.revoke(block_id)

    # ============== direct task transport (worker leasing) ==============

    def lease_worker(self, lease_id: str,
                     _client_id: str = "") -> Tuple[bytes, str]:
        """Grant a pooled worker to the calling client for DIRECT task pushes.

        The client (a core worker holding a GCS resource lease) pushes
        ``run_task`` straight to the returned worker address — the daemon is
        out of both the request and reply path, matching the reference's
        ``direct_task_transport.cc:241 PushNormalTask``. The worker stays
        bound to the caller until ``return_leased_worker`` or until the
        caller process dies (then the worker is killed: it may be mid-task,
        so it can't safely rejoin the pool).
        """
        try:
            worker = self._pop_worker()
        except BaseException as e:  # noqa: BLE001 — lease must not leak
            self._release(lease_id)
            raise WorkerDiedError(f"worker pool exhausted: {e}") from e
        refused = False
        with self._pool_lock:
            if _client_id and _client_id in self._dead_clients:
                # Grant-after-death race: _pop_worker can block for a spawn
                # while the client's cleanup runs — handing the worker to a
                # corpse would strand it busy-forever.
                self._return_worker_locked_exit(worker)
                refused = True
            else:
                self._worker_lease[worker.worker_id] = lease_id
                self._direct_leases[worker.worker_id] = _client_id
        if refused:
            self._release(lease_id)
            raise WorkerDiedError("client is dead; worker lease refused")
        return worker.worker_id.binary(), worker.address

    lease_worker._rpc_wants_conn = True  # RpcServer injects _client_id

    def _return_worker_locked_exit(self, worker: _Worker) -> None:
        """Return a just-popped worker while already holding _pool_lock."""
        if (worker.proc.poll() is None and worker.actor_id is None
                and worker.worker_id in self._workers):
            worker.busy = False
            self._idle.append(worker)
            self._pool_cv.notify_all()

    def kill_worker(self, worker_id_bytes: bytes) -> None:
        """Client disposes of a directly-leased worker whose channel state
        is unknown (it may be mid-task): kill it; the reaper releases its
        lease and collects the process."""
        worker_id = WorkerID(worker_id_bytes)
        with self._pool_lock:
            worker = self._workers.get(worker_id)
            self._direct_leases.pop(worker_id, None)
        if worker is not None:
            try:
                worker.proc.kill()
            except OSError:
                pass

    def return_leased_worker(self, worker_id_bytes: bytes) -> None:
        """Client is done with a directly-leased worker; it rejoins the
        vanilla idle pool. GCS leases are released by the client at the
        GCS; block-carved leases are released HERE (daemon authority)."""
        from ray_tpu_torch.core.lease_table import is_block_lease

        worker_id = WorkerID(worker_id_bytes)
        with self._pool_lock:
            worker = self._workers.get(worker_id)
            held = self._worker_lease.pop(worker_id, None)
            self._direct_leases.pop(worker_id, None)
        if is_block_lease(held):
            self._lease_table.release(held)
        if worker is not None:
            self._return_worker(worker)

    def on_client_opened(self, client_id: str) -> None:
        """(Re)connect lifts any death ban (see GcsService.on_client_opened)."""
        with self._pool_lock:
            self._dead_clients.discard(client_id)

    def on_client_closed(self, client_id: str) -> None:
        """Reclaim workers leased by a now-dead client process (fired by
        RpcServer after the grace period). The worker may be mid-task for
        the dead client, so kill it — its lease is released by the reaper
        via ``_worker_lease``."""
        if not client_id:
            return
        with self._pool_lock:
            self._dead_clients.add(client_id)
            orphans = [wid for wid, cid in self._direct_leases.items()
                       if cid == client_id]
            for wid in orphans:
                self._direct_leases.pop(wid, None)
            workers = [self._workers.get(wid) for wid in orphans]
        for worker in workers:
            if worker is None:
                continue
            logger.info("reclaiming directly-leased worker pid %s after "
                        "client death", worker.proc.pid)
            try:
                worker.proc.kill()
            except OSError:
                pass

    # ====================== actors ======================

    def start_actor(self, spec_bytes: bytes, lease_id: str) -> str:
        """Dedicate a worker process to an actor; returns the worker address.

        The lease is held for the actor's lifetime (its resources stay
        allocated), released when the worker dies or the actor is killed.
        Actors with ``runtime_env={"env_vars": ...}`` get a FRESH process
        with those vars applied at spawn (the reference's runtime-env agent
        path; env must precede interpreter-level imports).
        """
        from ray_tpu_torch.core import serialization

        spec = serialization.loads_deferred(spec_bytes)
        from ray_tpu_torch.runtime_env import needs_dedicated_worker

        renv = spec.options.runtime_env
        name = spec.actor_id.hex()[:8]
        t0 = time.monotonic()
        try:
            worker = (self._spawn_dedicated(dict(renv))
                      if needs_dedicated_worker(renv)
                      else self._pop_worker())
        except BaseException as e:  # noqa: BLE001 — lease must not leak
            self._release(lease_id)
            raise WorkerDiedError(f"actor worker spawn failed: {e}") from e
        waited = time.monotonic() - t0
        (logger.warning if waited > _SLOW_START_S else logger.debug)(
            "actor %s: worker %s (%s) after %.2f s", name, worker.worker_id,
            "dedicated" if needs_dedicated_worker(renv) else "pool", waited)
        # Mark the worker actor-bound BEFORE the (possibly seconds-long)
        # __init__ RPC: a busy worker with actor_id unset reads as a
        # retriable TASK worker to the memory monitor's OOM policy, which
        # may SIGKILL it mid-init under pressure (actor creation is not
        # retriable-by-lease the way tasks are).
        worker.actor_init = True
        try:
            worker.client.call("start_actor", spec_bytes, timeout=None)
        except RpcConnectionError as e:
            self._release(lease_id)
            try:
                worker.proc.kill()
            except OSError:
                pass
            raise WorkerDiedError(f"worker died during actor init: {e}") from e
        except Exception:
            self._release(lease_id)
            worker.actor_init = False  # init failed: back to the task pool
            self._return_worker(worker)
            raise
        with self._pool_lock:
            worker.actor_id = spec.actor_id  # set before actor_init drops
            worker.actor_init = False
            self._actor_records[spec.actor_id] = (spec_bytes, worker.address)
        built = time.monotonic() - t0
        (logger.warning if built > _SLOW_START_S else logger.debug)(
            "actor %s: built in %.2f s", name, built)
        return worker.address

    def kill_actor_worker(self, actor_id: ActorID,
                          no_restart: bool = True) -> bool:
        with self._pool_lock:
            target = next((w for w in self._workers.values()
                           if w.actor_id == actor_id), None)
            if target is not None and no_restart:
                # Forget the actor binding so the reaper doesn't report this
                # intentional kill as a failure needing restart. With
                # no_restart=False the binding stays: the reaper reports the
                # death and the GCS restart ladder (which also releases the
                # lifetime lease) runs exactly as for a crash.
                target.actor_id = None
                self._actor_records.pop(actor_id, None)
        if target is None:
            return False
        try:
            target.proc.kill()
        except OSError:
            pass
        return True

    # ====================== object plane ======================

    def put_object(self, object_id: bytes, payload: bytes,
                   lineage: bytes | None = None) -> None:
        """Seal an object into this node's store and register its location."""
        self._store_local(object_id, payload)
        self._gcs.notify("add_object_location", object_id, self.node_id,
                         len(payload), lineage)

    def _store_local(self, object_id: bytes, payload) -> None:
        mv = memoryview(payload).cast("B")
        if self._shm is not None and len(mv) >= config().native_store_threshold:
            try:
                self._shm.put(self._shm_key(object_id), mv)
                return
            except Exception:  # noqa: BLE001 — arena full → spill to disk
                self._spill(object_id, mv)
                return
        if len(mv) >= config().native_store_threshold:
            # No shm arena at all (heap-fallback node): big payloads still
            # must not pile up in daemon RAM.
            self._spill(object_id, mv)
            return
        with self._heap_lock:
            self._heap[object_id] = bytes(mv)

    def _spill(self, object_id: bytes, mv: memoryview) -> None:
        """Spill an object that doesn't fit the arena to disk
        (``local_object_manager.cc:110 SpillObjects``); a failed disk write
        falls back to daemon heap rather than silently losing the object."""
        path = self._spill_path(object_id)
        try:
            os.makedirs(self._spill_dir, exist_ok=True)
            with open(path, "wb") as f:
                f.write(mv)
        except OSError:
            logger.exception("spill of %s failed; keeping in heap",
                             object_id.hex()[:12])
            with self._heap_lock:
                self._heap[object_id] = bytes(mv)
            return
        with self._heap_lock:
            self._spilled[object_id] = len(mv)
        logger.info("spilled object %s (%d bytes) to %s",
                    object_id.hex()[:12], len(mv), path)

    def _spill_path(self, object_id: bytes) -> str:
        return os.path.join(self._spill_dir, object_id.hex())

    def object_meta(self, object_id: bytes) -> Optional[dict]:
        """Size + residency of a local replica — the chunked-pull handshake
        (the reference's pull manager asks for object size up front to
        budget chunk requests, ``pull_manager.cc``)."""
        if self._shm is not None:
            view = self._shm.get(self._shm_key(object_id))
            if view is not None:
                try:
                    return {"size": len(view), "where": "shm"}
                finally:
                    self._shm.release(self._shm_key(object_id))
        with self._heap_lock:
            blob = self._heap.get(object_id)
            if blob is not None:
                return {"size": len(blob), "where": "heap"}
            size = self._spilled.get(object_id)
            if size is not None:
                return {"size": size, "where": "spill"}
        return None

    def fetch_or_meta(self, object_id: bytes,
                      max_bytes: int) -> Optional[dict]:
        """Single-round-trip fetch handshake: the whole payload when the
        replica fits ``max_bytes``, else its size so the caller opens a
        chunked pull. Halves control-plane round trips vs the split
        object_meta + fetch_object protocol for small daemon-resident
        objects."""
        meta = self.object_meta(object_id)
        if meta is None:
            return None
        if meta["size"] <= max_bytes:
            payload = self.fetch_object(object_id)
            if payload is None:  # raced a deletion between meta and read
                return None
            return {"payload": payload}
        return {"size": meta["size"]}

    def fetch_object_chunk(self, object_id: bytes, offset: int, length: int):
        """One chunk of a replica (``object_manager.cc:812`` chunked
        transfer): bounded frames instead of one object-sized frame.
        EVERY residency serves the chunk as an out-of-band :class:`Raw`
        buffer — shm views straight out of the arena (refcount held until
        the frame is on the wire), heap blobs as zero-copy memoryviews, and
        spill files via cached-fd ``pread`` — so the socket write is the
        only copy this process makes and the puller's registered
        destination receives the bytes directly (no in-band pickle copy on
        either side)."""
        from ray_tpu_torch.core.rpc import Raw

        if self._shm is not None:
            key = self._shm_key(object_id)
            view = self._shm.get(key)
            if view is not None:
                return Raw(view[offset:offset + length],
                           release=lambda k=key: self._shm.release(k))
        with self._heap_lock:
            blob = self._heap.get(object_id)
            if blob is not None:
                # The Raw view pins the blob until the frame is written —
                # a racing free_object can pop the dict entry safely.
                return Raw(memoryview(blob)[offset:offset + length])
            spilled = object_id in self._spilled
        if spilled:
            chunk = self._spill_pread(object_id, offset, length)
            if chunk is not None:
                return Raw(chunk)
        return None

    _SPILL_FD_CAP = 32

    def _spill_pread(self, object_id: bytes, offset: int,
                     length: int) -> Optional[bytes]:
        """Positional read from a spilled object via the bounded fd cache."""
        # The read happens under the lock so an eviction/free can never
        # close an fd another thread is mid-pread on. pread of a
        # page-cached chunk is a memcpy with the GIL released; spill is the
        # cold tier, so serializing its reads per daemon is an acceptable
        # price for a race-free cache.
        with self._spill_fd_lock:
            fd = self._spill_fds.get(object_id)
            if fd is None:
                try:
                    fd = os.open(self._spill_path(object_id), os.O_RDONLY)
                except OSError:
                    return None
                self._spill_fds[object_id] = fd
                while len(self._spill_fds) > self._SPILL_FD_CAP:
                    _oid, old = next(iter(self._spill_fds.items()))
                    del self._spill_fds[_oid]
                    try:
                        os.close(old)
                    except OSError:
                        pass
            try:
                return os.pread(fd, length, offset)
            except OSError:
                self._spill_fds.pop(object_id, None)
                try:
                    os.close(fd)
                except OSError:
                    pass
                return None

    def _drop_spill_fd(self, object_id: bytes) -> None:
        with self._spill_fd_lock:
            fd = self._spill_fds.pop(object_id, None)
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass

    def begin_spill_put(self, object_id: bytes, size: int) -> bool:
        """Open a chunked UPLOAD straight to the spill shelf — how clients
        store an object larger than the shm arena without either side ever
        holding it whole in memory (create_request_queue.cc's fallback
        allocation, done chunk-wise over the wire)."""
        os.makedirs(self._spill_dir, exist_ok=True)
        self._drop_spill_fd(object_id)  # stale fd from a prior incarnation
        with open(self._spill_path(object_id), "wb") as f:
            f.truncate(size)
        with self._heap_lock:
            self._pending_spills[object_id] = time.time()
        return True

    def spill_put_chunk(self, object_id: bytes, offset: int, data: bytes) -> None:
        with open(self._spill_path(object_id), "r+b") as f:
            f.seek(offset)
            f.write(data)

    def commit_spill_put(self, object_id: bytes, size: int,
                         lineage: bytes | None = None) -> None:
        with self._heap_lock:
            self._pending_spills.pop(object_id, None)
            self._spilled[object_id] = size
        # The GCS directory keys by the full ObjectID — the caller
        # registers the location itself.

    def abort_spill_put(self, object_id: bytes) -> None:
        """Failed upload: drop the partial file now (uncommitted uploads
        are also swept after _PENDING_SPILL_TTL_S in the reaper, covering
        clients that died mid-push)."""
        with self._heap_lock:
            self._pending_spills.pop(object_id, None)
        self._drop_spill_fd(object_id)
        try:
            os.remove(self._spill_path(object_id))
        except OSError:
            pass

    _PENDING_SPILL_TTL_S = 600.0

    def _sweep_stale_spills(self) -> None:
        now = time.time()
        with self._heap_lock:
            stale = [k for k, t in self._pending_spills.items()
                     if now - t > self._PENDING_SPILL_TTL_S]
            for k in stale:
                self._pending_spills.pop(k, None)
        for k in stale:
            logger.warning("dropping stale uncommitted spill upload %s",
                           k.hex()[:12])
            try:
                os.remove(self._spill_path(k))
            except OSError:
                pass

    def fetch_object(self, object_id: bytes) -> Optional[bytes]:
        """Serve an object's bytes whole (small objects; chunked pulls use
        object_meta + fetch_object_chunk)."""
        if self._shm is not None:
            view = self._shm.get(self._shm_key(object_id))
            if view is not None:
                try:
                    return bytes(view)
                finally:
                    self._shm.release(self._shm_key(object_id))
        with self._heap_lock:
            blob = self._heap.get(object_id)
            if blob is not None:
                return blob
            spilled = object_id in self._spilled
        if spilled:
            try:
                with open(self._spill_path(object_id), "rb") as f:
                    return f.read()
            except OSError:
                return None
        return None

    def has_object(self, object_id: bytes) -> bool:
        if self._shm is not None and self._shm.contains(self._shm_key(object_id)):
            return True
        with self._heap_lock:
            return object_id in self._heap or object_id in self._spilled

    def free_object(self, object_id: bytes) -> None:
        if self._shm is not None:
            self._shm.delete(self._shm_key(object_id))
        with self._heap_lock:
            self._heap.pop(object_id, None)
            spilled = self._spilled.pop(object_id, None)
        if spilled is not None:
            self._drop_spill_fd(object_id)
            try:
                os.remove(self._spill_path(object_id))
            except OSError:
                pass

    @staticmethod
    def _shm_key(object_id: bytes) -> bytes:
        # ObjectID is 28 bytes; the native arena keys are 20. Use the task-id
        # tail + return index — unique because the task-id tail is random.
        return object_id[-20:]

    # ====================== logs (log_monitor.py analog) ======================

    def _log_tail_loop(self) -> None:
        """Tail worker log files; publish new lines to the GCS "logs"
        channel so drivers can mirror them (GcsLogSubscriber analog)."""
        while not self._stopped.wait(0.5):
            try:
                batch = self._collect_new_log_lines()
            except OSError:
                continue
            if batch:
                try:
                    self._gcs.notify("publish", "logs", batch)
                except RpcConnectionError:
                    pass

    _LOG_WINDOW = 256 * 1024

    def _collect_new_log_lines(self) -> List[dict]:
        batch: List[dict] = []
        for fname in os.listdir(self._log_dir):
            path = os.path.join(self._log_dir, fname)
            offset = self._log_offsets.get(fname, 0)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if size <= offset:
                continue
            with open(path, "rb") as f:
                f.seek(offset)
                chunk = f.read(self._LOG_WINDOW)
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                if len(chunk) < self._LOG_WINDOW:
                    continue  # partial line still being written — wait
                # A single line larger than the window: force-advance past
                # the whole chunk (never livelock on it) and mark the cut.
                self._log_offsets[fname] = offset + len(chunk)
                lines = [chunk.decode("utf-8", "replace")
                         + " …[line truncated by log tailer]"]
            else:
                # Offset advances exactly over the lines we publish — lines
                # are never skipped, the window just paces throughput.
                self._log_offsets[fname] = offset + last_nl + 1
                lines = chunk[:last_nl].decode("utf-8", "replace").splitlines()
            batch.append({
                "node_id": self.node_id.hex(),
                "worker": fname.rsplit(".", 1)[0],
                "lines": lines,
            })
        return batch

    # -- GCS snapshot mirror (head-disk-loss HA; gcs_server._mirror_snapshot)

    def store_gcs_snapshot(self, seq: int, blob: bytes) -> None:
        """Keep the newest GCS snapshot replica on this node's disk."""
        path = os.path.join(self._log_dir, "gcs_snapshot.mirror")
        current = getattr(self, "_gcs_mirror_seq", -1)
        if seq <= current:
            return
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(int(seq).to_bytes(8, "big"))
            f.write(bytes(blob))
        os.replace(tmp, path)
        self._gcs_mirror_seq = seq

    def fetch_gcs_snapshot(self):
        """(seq, blob) of the newest mirrored GCS snapshot, or None."""
        path = os.path.join(self._log_dir, "gcs_snapshot.mirror")
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        if len(raw) < 8:
            return None
        return int.from_bytes(raw[:8], "big"), raw[8:]

    def tail_worker_logs(self, max_bytes: int = 64 * 1024) -> Dict[str, str]:
        """Last chunk of every worker's log (state API / debugging)."""
        out = {}
        for fname in os.listdir(self._log_dir):
            path = os.path.join(self._log_dir, fname)
            try:
                size = os.path.getsize(path)
                with open(path, "rb") as f:
                    f.seek(max(0, size - max_bytes))
                    out[fname] = f.read().decode("utf-8", "replace")
            except OSError:
                continue
        return out

    # ====================== memory monitor / OOM policy ======================

    def _memory_monitor_loop(self) -> None:
        """Node OOM protection (memory_monitor.h:52 + the retriable-FIFO
        worker killing policy): when the node crosses the usage threshold,
        kill the NEWEST busy task worker — its task retries elsewhere via
        the normal WorkerDiedError path — never parked actors first."""
        threshold = config().memory_monitor_threshold
        if threshold >= 1.0:
            return  # disabled
        while not self._stopped.wait(config().memory_monitor_period_s):
            usage = _memory_usage_fraction()
            if usage is None or usage < threshold:
                continue
            victim = None
            with self._pool_lock:
                busy_tasks = [w for w in self._workers.values()
                              if w.busy and w.actor_id is None
                              and not w.actor_init
                              and w.proc.poll() is None]
                if busy_tasks:
                    # Spawn timestamp, not pid: pids wrap around and pid
                    # namespaces reuse, so max(pid) can pick an old worker.
                    victim = max(busy_tasks, key=lambda w: w.spawned_at)
            if victim is not None:
                logger.warning(
                    "node memory %.0f%% >= %.0f%% — killing newest task "
                    "worker pid %d (task will retry)",
                    usage * 100, threshold * 100, victim.proc.pid)
                try:
                    victim.proc.kill()
                except OSError:
                    pass

    def _collect_node_metrics(self) -> None:
        """Store occupancy + worker-pool gauges for the exporter tick."""
        from ray_tpu_torch.core.metrics_export import gauge, mirror_stats_gauge

        st = self.stats()
        mirror_stats_gauge(
            "ray_tpu_node_store",
            "Node object-plane occupancy (shm bytes in use, store "
            "capacity, heap objects, spilled objects)",
            {"shm_bytes": st["shm_bytes"],
             "capacity_bytes": self._shm.capacity() if self._shm else 0,
             "heap_objects": st["heap_objects"],
             "spilled_objects": len(self._spilled)})
        w = gauge("ray_tpu_node_workers",
                  "Worker-pool occupancy on this node",
                  tag_keys=("state",))
        w.set(float(st["workers"]), {"state": "total"})
        w.set(float(st["idle"]), {"state": "idle"})

    def stats(self) -> dict:
        with self._pool_lock:
            n_workers = len(self._workers)
            n_idle = len(self._idle)
        return {
            "node_id": self.node_id,
            "workers": n_workers,
            "idle": n_idle,
            "shm_bytes": self._shm.bytes_in_use() if self._shm else 0,
            "heap_objects": len(self._heap),
        }

    def node_stats(self) -> dict:
        """Per-node system + store telemetry (the reference's per-node
        dashboard/reporter agent sampling psutil — dashboard/agent.py +
        modules/reporter)."""
        out = self.stats()
        out["node_id"] = self.node_id.hex()
        out["address"] = self.address
        out["store_capacity"] = self._shm.capacity() if self._shm else 0
        out["store_objects"] = self._shm.num_objects() if self._shm else 0
        out["spilled_objects"] = len(self._spilled)
        try:
            import psutil

            out["cpu_percent"] = psutil.cpu_percent(interval=None)
            vm = psutil.virtual_memory()
            out["mem_total"] = vm.total
            out["mem_available"] = vm.available
            me = psutil.Process(os.getpid())
            out["daemon_rss"] = me.memory_info().rss
        except Exception:  # noqa: BLE001 — psutil optional
            log_swallowed(logger, "psutil node stats")
        return out


def main(argv=None) -> int:
    from ray_tpu_torch.devtools.lockcheck import maybe_install

    maybe_install()  # lock_order_check_enabled: instrument before any locks
    from ray_tpu_torch.devtools.leakcheck import maybe_install as _leak_install

    _leak_install()  # leak_check_enabled: stamp allocation sites early
    import faulthandler

    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)
    except (AttributeError, ValueError):
        pass
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args(argv)
    resources = json.loads(args.resources)
    # Only what --resources names, plus CPU: no card is detected here.
    if "CPU" not in resources:
        resources["CPU"] = float(os.cpu_count() or 4)
    from ray_tpu_torch.util import flightrec

    flightrec.init("node_daemon")
    daemon = NodeDaemon(args.gcs, resources, json.loads(args.labels),
                        host=args.host)
    print(f"NODE_ADDRESS={daemon.address}", flush=True)
    print(f"NODE_ID={daemon.node_id.hex()}", flush=True)
    print(f"STORE_NAME={daemon.store_name}", flush=True)

    stop = threading.Event()

    def _flush_tails():
        # Orderly deaths lose zero buffered observability (SIGKILL losses
        # are what the mmap'd flight-recorder ring is for).
        daemon.shutdown()
        from ray_tpu_torch.util import tracing

        tracing.flush()
        flightrec.close()

    import atexit

    atexit.register(_flush_tails)

    def handle(sig, frame):
        _flush_tails()
        stop.set()

    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)
    while not stop.wait(timeout=60.0):
        pass  # timed slices: signal handlers still interrupt immediately
    return 0


if __name__ == "__main__":
    sys.exit(main())

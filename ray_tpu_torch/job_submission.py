"""Job submission — run driver scripts as supervised jobs.

Analog of the reference's job API (``dashboard/modules/job/`` —
``JobManager`` :529 spawning a ``JobSupervisor`` actor :142 that runs the
entrypoint command; REST surface ``submit_job`` :875). The supervisor is an
actor holding the subprocess; status/logs/stop flow through it; job metadata
lives in the GCS job table: the supervisor adds the job under its submission
id when the entrypoint starts and records its end state, so
``util.state.list_jobs``, the dashboard's ``/api/jobs`` and ``ray-tpu-torch
list jobs`` show submitted jobs beside drivers.
"""

from __future__ import annotations

import os
import signal
import subprocess
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.gcs import JobInfo
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("job_submission")

# stop_job sends SIGTERM to the job's process group, then SIGKILL to what is
# left of it after this long (the reference's JobSupervisor does the same).
_STOP_WAIT_S = 3.0


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


def _job_table(op: str, *args) -> None:
    """``add_job``/``finish_job`` on this process's view of the GCS (the
    in-process store, or the cluster GCS over RPC from a worker)."""
    from ray_tpu_torch.core.runtime import get_runtime

    try:
        getattr(get_runtime().gcs, op)(*args)
    except Exception:  # noqa: BLE001 — the job runs on without its row
        log_swallowed(logger, f"job table {op}")


class _JobSupervisor:
    """Reference: ``job_manager.py:142 JobSupervisor`` — owns the driver
    subprocess for one job."""

    def __init__(self, job_id: str, entrypoint: str, env: Dict[str, str],
                 log_path: str, working_dir: Optional[str] = None):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.log_path = log_path
        self.status = JobStatus.PENDING
        self.returncode: Optional[int] = None
        # The child dups the log fd at spawn; close the parent's copy right
        # away instead of holding one fd per running job until exit.
        log_file = open(log_path, "wb")
        try:
            child_env = {**os.environ, **env, "RAY_TPU_JOB_ID": job_id}
            if working_dir:
                # working_dir first, before the env_vars' PYTHONPATH or else
                # this process's own (the checkout a cluster worker runs).
                child_env["PYTHONPATH"] = os.pathsep.join(
                    p for p in (working_dir, child_env.get("PYTHONPATH"))
                    if p)
            self._proc = subprocess.Popen(
                entrypoint,
                shell=True,
                stdout=log_file,
                stderr=subprocess.STDOUT,
                env=child_env,
                start_new_session=True,
            )
        finally:
            log_file.close()
        self.status = JobStatus.RUNNING
        _job_table("add_job", JobInfo(job_id=job_id, driver_pid=self._proc.pid,
                                      entrypoint=entrypoint,
                                      metadata={"type": "SUBMISSION"}))
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self):
        self.returncode = self._proc.wait()
        if self.status != JobStatus.STOPPED:
            self.status = (
                JobStatus.SUCCEEDED if self.returncode == 0 else JobStatus.FAILED
            )
        _job_table("finish_job", self.job_id, self.status)

    def get_status(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "status": self.status,
            "entrypoint": self.entrypoint,
            "returncode": self.returncode,
        }

    def get_logs(self) -> str:
        try:
            with open(self.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def stop(self) -> bool:
        if self.status == JobStatus.RUNNING:
            self.status = JobStatus.STOPPED
            try:
                pgid = os.getpgid(self._proc.pid)
                os.killpg(pgid, signal.SIGTERM)
            except Exception:
                self._proc.terminate()
                return True
            threading.Thread(target=self._kill_after_grace, args=(pgid,),
                             daemon=True).start()
            return True
        return False

    def _kill_after_grace(self, pgid: int) -> None:
        deadline = time.monotonic() + _STOP_WAIT_S
        while time.monotonic() < deadline:
            try:
                os.killpg(pgid, 0)
            except ProcessLookupError:
                return
            time.sleep(0.05)
        logger.warning("job %s: process group %d outlived SIGTERM by %.1f s "
                       "(%s); SIGKILL", self.job_id, pgid, _STOP_WAIT_S,
                       group_members(pgid))
        try:
            os.killpg(pgid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def group_members(pgid: int) -> List[Dict[str, Any]]:
    """The processes of group ``pgid`` as ``/proc`` shows them: pid, name,
    state, parent, and the blocked / ignored / pending signal masks."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            with open(f"/proc/{name}/status") as f:
                masks = {k: v.strip() for k, v in
                         (ln.split(":", 1) for ln in f)
                         if k in ("SigPnd", "ShdPnd", "SigBlk", "SigIgn")}
        except OSError:
            continue            # exited meanwhile
        fields = stat.rsplit(")", 1)[1].split()
        if int(fields[2]) == pgid:
            out.append({"pid": int(name),
                        "comm": stat[stat.index("(") + 1:stat.rindex(")")],
                        "state": fields[0], "ppid": int(fields[1]), **masks})
    return out


class JobSubmissionClient:
    """Reference: ``ray.job_submission.JobSubmissionClient`` surface
    (submit_job / get_job_status / get_job_logs / stop_job / list_jobs /
    wait — address-free: talks to the in-runtime supervisor actors)."""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._supervisors: Dict[str, Any] = {}
        self._log_dir = os.path.join(tempfile.gettempdir(), "ray_tpu_jobs")
        os.makedirs(self._log_dir, exist_ok=True)

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[Dict] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:16]}"
        env_vars = dict((runtime_env or {}).get("env_vars", {}))
        working_dir = (runtime_env or {}).get("working_dir")
        if working_dir:
            entrypoint = f"cd {working_dir} && {entrypoint}"
        log_path = os.path.join(self._log_dir, f"{job_id}.log")
        supervisor_cls = ray_tpu_torch.remote(_JobSupervisor)
        sup = supervisor_cls.options(num_cpus=0, name=f"_job_supervisor_{job_id}").remote(
            job_id, entrypoint, env_vars, log_path, working_dir
        )
        self._supervisors[job_id] = sup
        return job_id

    def _sup(self, job_id: str):
        if job_id in self._supervisors:
            return self._supervisors[job_id]
        return ray_tpu_torch.get_actor(f"_job_supervisor_{job_id}")

    def get_job_status(self, job_id: str) -> str:
        return ray_tpu_torch.get(self._sup(job_id).get_status.remote())["status"]

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        return ray_tpu_torch.get(self._sup(job_id).get_status.remote())

    def get_job_logs(self, job_id: str) -> str:
        return ray_tpu_torch.get(self._sup(job_id).get_logs.remote())

    def stop_job(self, job_id: str) -> bool:
        return ray_tpu_torch.get(self._sup(job_id).stop.remote())

    def list_jobs(self) -> List[Dict[str, Any]]:
        return [
            ray_tpu_torch.get(sup.get_status.remote()) for sup in self._supervisors.values()
        ]

    def wait_until_finish(self, job_id: str, timeout_s: float = 120.0) -> str:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(0.1)
        raise TimeoutError(f"job {job_id} not finished in {timeout_s}s")

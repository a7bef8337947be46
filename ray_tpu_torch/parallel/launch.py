"""Start a world of CPU ranks and run one function on each.

torch runs SPMD as one process per rank, so the port's counterpart of JAX's
virtual CPU mesh is a world of processes:

    results = run_world(fn, 8, arg, ...)

runs ``fn(rank, world_size, *args)`` in ``world_size`` fresh interpreters
(``python -m ray_tpu_torch.parallel.launch``), each inside a started
process group, and returns the ranks' return values in rank order. ``fn``
is pickled by reference: it must be a module-level function of a module
the ranks can import (they get this process's ``sys.path``); arguments and
results are pickled.

Rendezvous is a ``FileStore`` in a fresh temporary directory, never a fixed
port, so several worlds can run side by side. A gloo collective whose peer
died waits forever; so every collective carries ``timeout_s``, the world
has a deadline, and when one rank fails, or the deadline passes, every
rank is killed and the call raises with the failed rank's traceback.

The deadline has two parts. Each rank marks its join once its process
group is up; ``_STARTUP_S`` bounds the spawn up to the last join (cold
interpreters importing torch under a loaded host), and ``timeout_s`` counts
from that last join, so the time a world may run ``fn`` does not shrink
with a slow start.
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import Any, Callable, List

_POLL_S = 0.05
_STARTUP_S = 120.0      # spawn to the last rank's join


class WorldError(RuntimeError):
    """A rank of a world failed, or the world outlived its deadline."""


def run_world(fn: Callable, world_size: int, *args, backend: str = "gloo",
              timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on every rank of a new world and
    return the results in rank order. Raises ``WorldError`` (every rank
    killed) when a rank fails, when not every rank has joined within
    ``_STARTUP_S`` of the spawn, or when the world is not done within
    ``timeout_s`` of the last join."""
    with tempfile.TemporaryDirectory(prefix="rtpu-world-") as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((fn, args, backend, timeout_s), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            os.path.abspath(p) if p else os.getcwd() for p in sys.path)
        env.setdefault("OMP_NUM_THREADS", "1")
        procs = []
        try:
            for rank in range(world_size):
                with open(os.path.join(tmp, f"stderr{rank}.txt"), "wb") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "ray_tpu_torch.parallel.launch",
                         tmp, str(rank), str(world_size)],
                        env=env, stdout=subprocess.DEVNULL, stderr=err,
                        start_new_session=True))
            return _collect(procs, tmp, timeout_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
            for p in procs:
                # raylint: ignore[untimed-wait] — reaps a rank that exited
                # or was just SIGKILLed, which no process can ignore.
                p.wait()


def _joined(tmp: str, rank: int) -> bool:
    return os.path.exists(os.path.join(tmp, f"joined{rank}"))


def _collect(procs, tmp: str, timeout_s: float) -> List[Any]:
    startup_deadline = time.monotonic() + _STARTUP_S
    deadline = None     # timeout_s from the last join, once every rank joined
    while any(p.poll() is None for p in procs):
        failed = [r for r, p in enumerate(procs)
                  if p.poll() not in (None, 0)]
        if failed:
            raise WorldError(_failure(procs, tmp, failed[0]))
        now = time.monotonic()
        if deadline is None:
            waiting = [r for r in range(len(procs)) if not _joined(tmp, r)]
            if not waiting:
                deadline = now + timeout_s
            elif now > startup_deadline:
                _dump_stacks(procs, waiting)
                raise WorldError(f"world of {len(procs)} not started within "
                                 f"{_STARTUP_S} s; ranks {waiting} not joined; "
                                 f"rank {waiting[0]}'s stacks:\n"
                                 f"{_stderr_tail(tmp, waiting[0])}")
        elif now > deadline:
            stuck = [r for r, p in enumerate(procs) if p.poll() is None]
            _dump_stacks(procs, stuck)
            raise WorldError(f"world of {len(procs)} not done within "
                             f"{timeout_s} s of its last join; ranks {stuck} "
                             f"still running; rank {stuck[0]}'s stacks:\n"
                             f"{_stderr_tail(tmp, stuck[0])}")
        time.sleep(_POLL_S)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise WorldError(_failure(procs, tmp, failed[0]))
    out = []
    for rank in range(len(procs)):
        with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _dump_stacks(procs, ranks) -> None:
    for r in ranks:             # each rank dumps its stacks (faulthandler)
        if procs[r].poll() is None:
            os.kill(procs[r].pid, signal.SIGUSR1)
    time.sleep(1.0)


def _failure(procs, tmp: str, rank: int) -> str:
    path = os.path.join(tmp, f"error{rank}.txt")
    if os.path.exists(path):
        with open(path) as f:
            return f"rank {rank} failed:\n{f.read()}"
    return (f"rank {rank} exited with {procs[rank].returncode}:\n"
            f"{_stderr_tail(tmp, rank)}")


def _stderr_tail(tmp: str, rank: int) -> str:
    with open(os.path.join(tmp, f"stderr{rank}.txt"), "rb") as f:
        return f.read().decode(errors="replace")[-4000:]


def _rank_main(tmp: str, rank: int, world_size: int) -> None:
    import faulthandler
    import traceback

    # Before torch's import, so a rank still importing dumps its stacks too.
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    import torch
    import torch.distributed as dist

    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        fn, args, backend, timeout_s = pickle.load(f)
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
        open(os.path.join(tmp, f"joined{rank}"), "w").close()
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    part = os.path.join(tmp, f"result{rank}.pkl.part")
    with open(part, "wb") as f:
        pickle.dump(result, f)
    os.replace(part, os.path.join(tmp, f"result{rank}.pkl"))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

"""Runtime resource-leak validator — the dynamic half of raylint's
lifecycle checks.

The static passes (raylint's ``thread-leak`` / ``resource-leak``; this
package has no copy of the static lint yet) prove that every acquire SITE
has a reachable release; this module proves the release actually RAN:
snapshot the process's live threads, open fds, and native-store shm
segments before a test, diff after teardown, and name every survivor with
its allocation site. Daemon threads pass the static check (they can't
wedge interpreter exit) but still hold sockets, fds, and GCS poll slots —
at pod scale a daemon-restart path that abandons one exporter thread per
restart is a slow OOM. The diff is what keeps shutdown paths honest.

Enabled, :func:`install`

- wraps ``threading.Thread.__init__`` to stamp every thread with the
  ``file:line`` that constructed it (``_leakcheck_site``),
- wraps ``os.open`` / ``os.pipe`` and ``socket.socket`` to record fd
  allocation sites in a best-effort fd→site table (fd numbers recycle;
  the table is advisory, the ``/proc/self/fd`` diff is ground truth),
- leaves everything else untouched — snapshots read ``threading
  .enumerate()``, ``/proc/self/fd`` and ``/dev/shm``.

Enable with the ``leak_check_enabled`` knob
(``RAY_TPU_LEAK_CHECK_ENABLED=1`` — the env form propagates to spawned
cluster processes; ``ray_tpu_torch/__init__`` installs at the very top of the
package import, mirroring lockcheck, so threads created during module
import are stamped too). A caller snapshots before the work and calls
:func:`check` after its teardown (a job's driver after ``shutdown()``).

Caveats (by design):

- fd sites are recorded only for ``os.open``/``os.pipe``/``socket``
  constructions that happen after install; other acquires (dup, accept,
  mmap, C extensions) are still CAUGHT by the ``/proc/self/fd`` diff but
  identified only by their readlink target.
- Asynchronous teardown (executor workers draining, daemon pollers
  noticing a closed connection) is real shutdown, not a leak —
  :func:`check` polls the diff for a settle window before declaring one.
- Child processes are out of scope: each cluster process self-installs
  off the propagated env var and polices its own resources.
"""

from __future__ import annotations

import os
import socket
import threading
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

__all__ = [
    "install", "uninstall", "installed", "maybe_install",
    "Snapshot", "snapshot", "diff", "check",
]

_ENV_KNOB = "RAY_TPU_LEAK_CHECK_ENABLED"

_REAL_THREAD_INIT = threading.Thread.__init__
_REAL_OS_OPEN = os.open
_REAL_OS_PIPE = os.pipe
_REAL_SOCKET = socket.socket

#: fd -> human-readable allocation site (best effort; fds recycle)
_fd_sites: Dict[int, str] = {}

_SHM_DIR = "/dev/shm"


def _caller_site() -> str:
    """file:line of the first stack frame outside this module (and outside
    threading/socket internals)."""
    here = os.path.normcase(__file__)
    for frame in traceback.extract_stack()[::-1]:
        fn = os.path.normcase(frame.filename)
        base = os.path.basename(fn)
        if fn != here and base not in ("threading.py", "socket.py"):
            return f"{base}:{frame.lineno} in {frame.name}"
    return "<unknown>"


# -- instrumentation ---------------------------------------------------------


def _thread_init(self, *args, **kwargs):
    _REAL_THREAD_INIT(self, *args, **kwargs)
    self._leakcheck_site = _caller_site()


def _os_open(path, flags, *args, **kwargs):
    fd = _REAL_OS_OPEN(path, flags, *args, **kwargs)
    _fd_sites[fd] = f"os.open({path!r}) at {_caller_site()}"
    return fd


def _os_pipe():
    r, w = _REAL_OS_PIPE()
    site = _caller_site()
    _fd_sites[r] = f"os.pipe()[read] at {site}"
    _fd_sites[w] = f"os.pipe()[write] at {site}"
    return r, w


class _CheckedSocket(_REAL_SOCKET):
    """socket.socket that records its allocation site. Subclassing (not
    wrapping) keeps isinstance checks, accept()'s re-construction and
    ssl-wrapping working unchanged."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        try:
            _fd_sites[self.fileno()] = f"socket at {_caller_site()}"
        except OSError:  # already detached/closed
            pass


_installed = False


def install() -> None:
    """Stamp allocation sites onto threads/fds/sockets. Idempotent."""
    global _installed
    if _installed:
        return
    threading.Thread.__init__ = _thread_init
    os.open = _os_open
    os.pipe = _os_pipe
    socket.socket = _CheckedSocket
    _installed = True


def uninstall() -> None:
    global _installed
    threading.Thread.__init__ = _REAL_THREAD_INIT
    os.open = _REAL_OS_OPEN
    os.pipe = _REAL_OS_PIPE
    socket.socket = _REAL_SOCKET
    _installed = False


def installed() -> bool:
    return _installed


def maybe_install() -> bool:
    """Install iff the ``leak_check_enabled`` knob is on (env var first —
    process entry points run before the config table exists)."""
    on = os.environ.get(_ENV_KNOB)
    if on is not None:
        enabled = on.lower() in ("1", "true", "yes", "on")
    else:
        try:
            from ray_tpu_torch.core.config import config

            enabled = config().leak_check_enabled
        except Exception:  # noqa: BLE001 — config unavailable: stay off
            enabled = False
    if enabled:
        install()
    return enabled


# -- snapshots ---------------------------------------------------------------


@dataclass
class Snapshot:
    """Live resources of this process at one instant. Thread objects are
    held by STRONG reference for the snapshot's lifetime: an id()-only set
    would let a start-time thread die, its address recycle onto a leaked
    thread, and the leak pass as clean."""
    threads: Set[threading.Thread] = field(default_factory=set)
    fds: Set[int] = field(default_factory=set)
    shm: Set[str] = field(default_factory=set)  # /dev/shm names we own


def _own_shm_names() -> Set[str]:
    """Names under /dev/shm whose embedded owner pid is THIS process
    (``rtpu_store_<pid>_...`` — the native store's naming scheme)."""
    marker = f"_{os.getpid()}_"
    try:
        return {n for n in os.listdir(_SHM_DIR)
                if n.startswith("rtpu_") and marker in n}
    except OSError:
        return set()


def snapshot() -> Snapshot:
    fds: Set[int] = set()
    try:
        for name in os.listdir("/proc/self/fd"):
            try:
                fd = int(name)
            except ValueError:
                continue
            # Drop the listing's own transient fd (closed by now): baking
            # it into `before` would mask a later acquire that recycles
            # the same number.
            try:
                os.readlink(f"/proc/self/fd/{fd}")
            except OSError:
                continue
            fds.add(fd)
    except OSError:
        pass
    return Snapshot(
        threads=set(threading.enumerate()),
        fds=fds,
        shm=_own_shm_names(),
    )


def _describe_thread(t: threading.Thread) -> str:
    site = getattr(t, "_leakcheck_site", None)
    kind = "daemon thread" if t.daemon else "non-daemon thread"
    return (f"{kind} '{t.name}' (started at {site})" if site
            else f"{kind} '{t.name}'")


def _describe_fd(fd: int) -> Optional[str]:
    """None when the fd no longer exists (a transient — not a leak)."""
    try:
        target = os.readlink(f"/proc/self/fd/{fd}")
    except OSError:
        return None
    site = _fd_sites.get(fd)
    return (f"fd {fd} -> {target} (opened {site})" if site
            else f"fd {fd} -> {target}")


def diff(before: Snapshot) -> List[str]:
    """Resources live NOW that were not live at ``before`` — each rendered
    with its allocation site where known."""
    leaks: List[str] = []
    for t in threading.enumerate():
        if t not in before.threads and t.is_alive():
            leaks.append(_describe_thread(t))
    now = snapshot()
    for fd in sorted(now.fds - before.fds):
        desc = _describe_fd(fd)  # re-verify: listdir's own fd is transient
        if desc is not None:
            leaks.append(desc)
    for name in sorted(now.shm - before.shm):
        leaks.append(f"shm segment /dev/shm/{name}")
    return leaks


def check(before: Snapshot, settle_s: float = 3.0,
          poll_s: float = 0.05) -> List[str]:
    """Diff against ``before``, giving asynchronous teardown (executor
    workers draining, daemon pollers noticing a closed socket) up to
    ``settle_s`` to finish. Returns the leaks that survived the window."""
    import time

    deadline = time.monotonic() + settle_s
    leaks = diff(before)
    while leaks and time.monotonic() < deadline:
        time.sleep(poll_s)
        leaks = diff(before)
    return leaks

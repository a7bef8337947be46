"""Runtime lock-order validator — the dynamic half of raylint.

The static pass (raylint; this package has no copy of it yet) sees nesting
it can prove from the AST; this module catches what it can't: orders
established across threads, through callbacks, and through locks on other
objects. Enabled, it replaces ``threading.Lock`` / ``RLock`` /
``Condition`` with instrumented wrappers that

- record each thread's **held-set** (which locks it currently holds),
- maintain a process-global **acquisition-order graph** keyed by the lock's
  allocation site (``file:line`` of construction — the lockdep "lock class"
  trick: one edge per code-level ordering, not per instance pair),
- on every acquire with locks held, add ``held → acquiring`` edges and
  check for a path in the REVERSE direction: if some other thread ever
  acquired these locks in the opposite order, the program contains a
  potential deadlock — report it NOW, deterministically, instead of hanging
  one run in a thousand at pod scale,
- detect guaranteed self-deadlock (re-acquiring a held non-reentrant Lock).

Violations raise :class:`LockOrderError` at the acquire site AND are
recorded in a process-global list (``violations()``) so test harnesses can
assert emptiness even when a daemon thread swallowed the raise.

Enable with the ``lock_order_check_enabled`` config knob
(``RAY_TPU_LOCK_ORDER_CHECK_ENABLED=1`` — the env form propagates to every
spawned cluster process, whose entry points call :func:`maybe_install`).
A harness asserts that :func:`violations` stays empty.

Caveats (by design):

- Locks created BEFORE :func:`install` (module-import locks of the stdlib)
  are not instrumented — install as early as possible. With the env knob
  set, ``ray_tpu_torch/__init__`` installs at the very top of the package import,
  so every ray_tpu_torch module-level lock is covered in every process.
- Edges between two instances from the SAME allocation site are skipped:
  many-instance classes (per-connection senders, per-actor mailboxes) would
  otherwise self-cycle on instance order no analysis can fix. Same-site
  ordering bugs need the static pass or an explicit two-site repro.
- The graph only grows; a once-seen order is never forgotten. That is the
  point: an inversion is reported even if the two orders never overlap in
  time in this run.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderError", "install", "uninstall", "maybe_install",
    "violations", "clear_violations", "Lock", "RLock", "Condition",
]

_ENV_KNOB = "RAY_TPU_LOCK_ORDER_CHECK_ENABLED"

# Originals captured at import so wrappers survive install/uninstall cycles.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition


class LockOrderError(RuntimeError):
    """A lock acquisition that inverts a previously-observed order (or
    re-acquires a held non-reentrant lock)."""


# -- global state -----------------------------------------------------------

# site -> set of successor sites (edges: "site A held while B acquired").
_graph: Dict[str, Set[str]] = {}
# (a, b) -> human-readable provenance of the first observation of that edge
_edge_where: Dict[Tuple[str, str], str] = {}
_violations: List[str] = []
# Guards _graph/_edge_where/_violations. Deliberately a REAL lock (never
# instrumented) and always a leaf: nothing else is ever acquired under it.
_state_lock = _REAL_LOCK()

_tls = threading.local()  # .held: List[_CheckedBase] (outermost first)


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _caller_site() -> str:
    """file:line of the first stack frame outside this module."""
    here = os.path.normcase(__file__)
    for frame in traceback.extract_stack()[::-1]:
        if os.path.normcase(frame.filename) != here:
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return "<unknown>"


def _has_path(src: str, dst: str) -> bool:
    """DFS reachability src -> dst in the order graph (caller holds
    _state_lock)."""
    stack, seen = [src], {src}
    while stack:
        node = stack.pop()
        if node == dst:
            return True
        for nxt in _graph.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


def violations() -> List[str]:
    """Messages of every inversion observed so far in this process."""
    with _state_lock:
        return list(_violations)


def clear_violations() -> None:
    with _state_lock:
        _violations.clear()


def _reset_graph() -> None:
    with _state_lock:
        _graph.clear()
        _edge_where.clear()
        _violations.clear()


# -- instrumented primitives -------------------------------------------------


class _CheckedBase:
    """Shared acquire/release bookkeeping for Lock and RLock wrappers."""

    _reentrant = False

    def __init__(self):
        self._site = _caller_site()
        self._inner = self._make_inner()

    def _make_inner(self):
        raise NotImplementedError

    # -- the check ----------------------------------------------------------

    def _check_order(self) -> None:
        held = _held()
        if not held:
            return
        if held[-1] is self and not self._reentrant:
            msg = (f"self-deadlock: re-acquiring non-reentrant lock "
                   f"{self._site} already held by this thread")
            with _state_lock:
                _violations.append(msg)
            raise LockOrderError(msg)
        me = self._site
        new_edges = []
        for other in held:
            if other is self or other._site == me:
                continue  # same site: skip (see module docstring)
            new_edges.append(other._site)
        if not new_edges:
            return
        where = _where()
        with _state_lock:
            for prev in new_edges:
                if me in _graph.get(prev, ()):  # edge already known
                    continue
                if _has_path(me, prev):
                    first = _edge_where.get(self._first_back_edge(me, prev),
                                            "<earlier>")
                    msg = (f"lock-order inversion: acquiring {me} while "
                           f"holding {prev} at {where}, but the opposite "
                           f"order was established at {first}")
                    _violations.append(msg)
                    raise LockOrderError(msg)
                _graph.setdefault(prev, set()).add(me)
                _edge_where[(prev, me)] = where

    @staticmethod
    def _first_back_edge(me: str, prev: str) -> Tuple[str, str]:
        """Best-effort provenance: the direct back edge if present, else any
        edge out of `me` on a path to `prev` (caller holds _state_lock)."""
        if prev in _graph.get(me, ()):
            return (me, prev)
        for nxt in _graph.get(me, ()):
            if nxt == prev or _has_path(nxt, prev):
                return (me, nxt)
        return (me, prev)

    def _note_acquired(self) -> None:
        _held().append(self)

    def _note_released(self) -> None:
        held = _held()
        # release in any order (condition _release_save, manual release)
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                return

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        # Order-check BEFORE the (possibly blocking) inner acquire: a real
        # deadlock must be reported, not merely entered.
        if blocking:
            self._check_order()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._note_acquired()
        return ok

    def release(self) -> None:
        self._inner.release()
        self._note_released()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # stdlib protocol (os.register_at_fork users): fresh inner lock in
        # the child; the child's held-set starts empty anyway (new thread).
        self._inner = self._make_inner()

    def __repr__(self):
        return f"<{type(self).__name__} site={self._site}>"


def _where() -> str:
    here = os.path.normcase(os.path.dirname(__file__))
    for frame in traceback.extract_stack()[::-1]:
        d = os.path.normcase(os.path.dirname(frame.filename))
        if d != here and "threading" not in os.path.basename(frame.filename):
            return (f"{os.path.basename(frame.filename)}:{frame.lineno} "
                    f"in {frame.name}")
    return "<unknown>"


class CheckedLock(_CheckedBase):
    _reentrant = False

    def _make_inner(self):
        return _REAL_LOCK()

    # threading.Condition support: full release/restore + ownership probe.
    def _release_save(self):
        self.release()

    def _acquire_restore(self, _state) -> None:
        self.acquire()

    def _is_owned(self) -> bool:
        # Mirrors threading's plain-Lock heuristic ("held by someone").
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


class CheckedRLock(_CheckedBase):
    _reentrant = True

    def __init__(self):
        super().__init__()
        self._owner: Optional[int] = None
        self._count = 0

    def _make_inner(self):
        return _REAL_RLOCK()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        me = threading.get_ident()
        if self._owner != me and blocking:
            self._check_order()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if self._count == 0:
                self._owner = me
                self._note_acquired()
            self._count += 1
        return ok

    __enter__ = acquire

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise RuntimeError("cannot release un-acquired lock")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            self._note_released()
        self._inner.release()

    def __exit__(self, *exc) -> None:
        self.release()

    # threading.Condition support (full-depth release, exactly like the
    # stdlib _RLock._release_save).
    def _release_save(self):
        count = self._count
        self._count = 0
        self._owner = None
        self._note_released()
        for _ in range(count):
            self._inner.release()
        return count

    def _acquire_restore(self, count: int) -> None:
        # Waiters re-acquiring after a wait() re-check order like any fresh
        # acquire.
        self._check_order()
        for _ in range(count):
            self._inner.acquire()
        self._count = count
        self._owner = threading.get_ident()
        self._note_acquired()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _at_fork_reinit(self) -> None:
        self._inner = self._make_inner()
        self._owner = None
        self._count = 0


def Lock():  # noqa: N802 — drop-in for threading.Lock
    return CheckedLock()


def RLock():  # noqa: N802 — drop-in for threading.RLock
    return CheckedRLock()


def Condition(lock=None):  # noqa: N802 — drop-in for threading.Condition
    """A real threading.Condition over a checked lock: wait() releases the
    lock through `_release_save` (held-set stays truthful through the park)
    and the re-acquire after wakeup is order-checked like any other."""
    if lock is None:
        lock = CheckedRLock()
    return _REAL_CONDITION(lock)


# -- install / uninstall ------------------------------------------------------

_installed = False


def install(fresh_graph: bool = True) -> None:
    """Monkeypatch ``threading.Lock/RLock/Condition`` with the checked
    versions. Locks created before this call stay plain. Idempotent."""
    global _installed
    if _installed:
        return
    if fresh_graph:
        _reset_graph()
    threading.Lock = Lock
    threading.RLock = RLock
    threading.Condition = Condition
    _installed = True


def uninstall() -> None:
    """Restore the real primitives (already-created checked locks keep
    working — they wrap real locks)."""
    global _installed
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    _installed = False


def installed() -> bool:
    return _installed


def maybe_install() -> bool:
    """Install iff the ``lock_order_check_enabled`` knob is on. Called from
    process entry points (gcs_server / node_daemon / worker_main mains) so
    spawned cluster processes self-instrument when the env var propagates.
    Reads the env var directly first — entry points call this BEFORE the
    config table exists."""
    on = os.environ.get(_ENV_KNOB)
    if on is not None:
        enabled = on.lower() in ("1", "true", "yes", "on")
    else:
        try:
            from ray_tpu_torch.core.config import config

            enabled = config().lock_order_check_enabled
        except Exception:  # noqa: BLE001 — config unavailable: stay off
            enabled = False
    if enabled:
        install()
    return enabled

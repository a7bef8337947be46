"""raylint — concurrency & contract static analysis for the port's tree.

The port's twin of ``ray_tpu/devtools/lint.py``: the same nine checks, the
same ``check|path|scope|detail[#k]`` fingerprints, the same
``# raylint: ignore[...]`` pragma and the same baseline workflow, run over
``ray_tpu_torch/`` against its own ``lint_baseline.txt``. The runtime got
concurrent faster than anything checks it: coalescing frame senders,
fan-out batched gets, striped pulls, hierarchical collectives — all of it
hinges on lock discipline and string-resolved contracts (RPC methods
dispatched by ``getattr`` in ``core/rpc.py``, config knobs resolved by
``_Flag`` name). One lock inversion or one silently-swallowed daemon
exception is a hung training step. This module is the correctness floor:
an AST pass over the whole tree, run as a tier-1 test. It imports only the
standard library.

Checks
======
``lock-order``
    Per-class nested-acquisition graph (interprocedural through ``self``
    method calls) with cycle detection: a cycle means two code paths take
    the same locks in opposite orders — a potential deadlock. Re-entering a
    plain (non-R) ``Lock`` while holding it is reported as a guaranteed
    self-deadlock.
``blocking-under-lock``
    Socket ``send*``/``recv*``/``accept``/``connect``, RPC ``.call(...)``,
    ``.wait(...)`` on a condition that does NOT wrap the held lock,
    ``time.sleep``, ``subprocess`` use, ``open(...)`` and ``Future.result``
    reached while a ``with <lock>`` frame is open. (Waiting on the held
    lock's own condition is fine — ``wait`` releases it.)
``untimed-wait``
    ``Condition.wait()`` / ``Event.wait()`` with no timeout and
    ``Future.result()`` with no timeout: a lost peer parks the thread
    forever.
``swallowed-exception``
    ``except Exception: pass`` (and bare/BaseException variants) — in a
    daemon or thread body this turns a real failure into a silent hang.
``rpc-surface``
    Every method name a client proxy dispatches as a string
    (``.call("name")`` / ``.call_async`` / ``.notify``) must resolve to a
    public method on an RPC service handler class (discovered from
    ``RpcServer(handler)`` instantiations, refined by a client→service
    table).
``config-knob``
    Every ``cfg.<name>`` / ``config().<name>`` / ``_get_config().<name>``
    access must resolve to a declared ``_Flag`` (the port imports
    ``config`` as ``_get_config`` where a local would shadow it); every declared ``_Flag`` must be referenced
    somewhere and carry a doc comment.
``rpc-cycle``
    Cross-process wait-cycle analysis. The rpc-surface pass already knows
    which service class each string-dispatched client call lands on; this
    check lifts those edges to the INTER-process call graph — nodes are
    ``Service.handler`` methods, an edge means "while serving this handler
    the process issues a blocking ``.call`` that the target service's
    handler serves" (interprocedural through ``self`` calls, like the
    lock-order pass). Flagged:

    - handler→handler cycles: A's handler blocks on an RPC whose serving
      handler can call back into A — when both sides serve synchronously
      this is a distributed deadlock (each process is parked in ``.call``
      waiting for the other's reply);
    - blocking RPC edges issued while holding a lock, when that edge
      participates in such a cycle OR the remote handler chain can RPC
      back into a method of the caller's class that needs the held lock
      (the per-class lock graph composed with the RPC edges).

    One-way ``notify`` / ``call_async`` dispatches don't park the caller
    and do not create wait edges.
``thread-leak``
    Every ``threading.Thread(...)`` must either be daemonized
    (``daemon=True`` at the ctor or ``t.daemon = True`` before start) or
    have a reachable ``join()``: for ``self._t``-stored threads a join in
    a method reachable from a shutdown-path entry point (``close`` /
    ``shutdown`` / ``stop`` / ``__exit__`` / ...); for function-local
    threads a join in the same function. A non-daemon thread with no
    reachable join outlives its owner and wedges interpreter exit.
``resource-leak``
    Every OS-resource acquire site stored on the owner — sockets, mmaps,
    ``os.open`` fds (including dict fd-caches), shm segments /
    ``NativeObjectStore`` handles — must have a release (``close`` /
    ``destroy`` / ``unlink`` / ``os.close``) reachable from a
    shutdown-path method, or be ``with``-managed. Function-local sockets/
    fds/mmaps that neither escape nor close in-function are flagged too.

``host-sync`` / ``compile-churn``
    The torch-aware tier — implicit device→host reads inside the declared
    hot scopes, and per-call ``torch.compile`` construction. Implemented in
    ``ray_tpu_torch.devtools.torchlint`` (same AST cache, pragmas and
    baseline; runtime counterpart: ``ray_tpu_torch.devtools.jitcheck``).

Baseline workflow
=================
Findings are fingerprinted WITHOUT line numbers
(``check|path|scope|detail[#k]``) so unrelated edits don't churn, and
diffed against ``lint_baseline.txt`` next to this module: only findings
absent from the baseline fail the run. Intentionally accepted findings are
recorded with ``--update-baseline``; fixed findings disappear from the
rewritten baseline automatically.

Usage::

    python -m ray_tpu_torch.devtools.lint                    # tree vs baseline
    python -m ray_tpu_torch.devtools.lint --check-baseline   # same (CI gate)
    python -m ray_tpu_torch.devtools.lint --update-baseline
    python -m ray_tpu_torch.devtools.lint --no-baseline path/  # raw findings
    python -m ray_tpu_torch.devtools.lint --profile          # per-check time
    ray-tpu-torch-lint --check-baseline                      # console script
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

#: attribute names that read as "this is a lock / condition / semaphore"
#: even when we can't see the ``threading.X()`` construction (locks on other
#: objects: ``with st["lock"]``, ``with state.generator_cv`` ...).
_LOCKISH_NAMES = {"lock", "cv", "cond", "condition", "mutex", "mu", "sem",
                  "slots"}
_LOCKISH_SUFFIXES = ("_lock", "_cv", "_cond", "_mutex", "_sem", "_slots")

_SOCKET_METHODS = {"send", "sendall", "sendmsg", "recv", "recv_into",
                   "recvmsg", "accept", "connect", "connect_ex"}

#: dispatch methods whose first string argument is an RPC method name
_DISPATCH_METHODS = {"call", "call_async", "notify"}

#: method names RpcServer resolves outside getattr dispatch
_RPC_SPECIAL = {"register_spec_template", "on_client_opened",
                "on_client_closed"}

#: receiver-substring → service-class-name refinement for the rpc-surface
#: check.  Applied only when the named service class was actually discovered
#: in the scanned tree; otherwise the union of all services is used.
_CLIENT_TABLE: List[Tuple[str, str]] = [
    ("_gcs", "GcsService"),
    ("gcs_rpc", "GcsService"),
    ("_daemons", "NodeDaemon"),
    ("daemon", "NodeDaemon"),
    ("_owner", "_OwnerService"),
    ("owner", "_OwnerService"),
    ("_peers", "_MemberService"),
    ("peer", "_MemberService"),
    ("worker.client", "WorkerService"),
]

#: config attribute accesses that are API, not knobs
_CONFIG_NON_FLAGS = {"to_dict"}

#: method names that read as "this is a shutdown path" for the lifecycle
#: checks: joins/releases reachable from one of these count as reachable.
_SHUTDOWN_ENTRY_NAMES = {"close", "shutdown", "stop", "join", "destroy",
                         "disconnect", "teardown", "terminate", "kill",
                         "cleanup", "clear", "drain", "release", "reset",
                         "__exit__", "__del__", "__aexit__", "close_all",
                         "uninstall", "abort"}

#: method names that release the resource they're called on
_RELEASE_METHODS = {"close", "shutdown", "unlink", "destroy", "release",
                    "terminate", "stop", "detach", "munmap", "closerange",
                    "close_all"}


@dataclass
class Finding:
    check: str
    path: str  # scan-root-relative, '/'-separated
    line: int
    scope: str
    message: str
    detail: str  # stable fingerprint component (no line numbers)
    fingerprint: str = ""  # filled after dedup-counter assignment

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.check}] {self.scope}: "
                f"{self.message}")


@dataclass(frozen=True)
class _RpcSite:
    """One string-dispatched client call observed inside a method body."""
    recv: str  # receiver expression text (client lookup chain)
    method: str  # dispatched RPC method name
    kind: str  # 'call' | 'call_async' | 'notify'
    held: Optional[str]  # canonical lock token held at the site, if any
    line: int
    via: str  # self-call chain from the summarized method to the site


@dataclass
class _MethodSummary:
    """What one method does with locks, for the interprocedural pass."""
    acquires: Set[str] = field(default_factory=set)  # canonical lock tokens
    calls: Set[str] = field(default_factory=set)  # self.X() / module fn names
    # direct nested acquisitions observed: (held, acquired, line)
    nested: List[Tuple[str, str, int]] = field(default_factory=list)
    # self-calls made while holding a lock: (held, callee, line)
    held_calls: List[Tuple[str, str, int]] = field(default_factory=list)
    # string-dispatched RPC client calls made directly in this method
    rpc_calls: List[_RpcSite] = field(default_factory=list)


@dataclass
class _ThreadSite:
    """One ``threading.Thread(...)`` construction stored on the owner."""
    attr: str  # self attribute the thread is assigned to
    line: int
    scope: str
    daemon: bool  # daemon=True at the ctor


@dataclass
class _ResourceSite:
    """One OS-resource acquire assigned to an owner attribute."""
    attr: str
    line: int
    scope: str
    kind: str  # 'socket' | 'fd' | 'mmap' | 'shm' | 'file'
    is_dict: bool  # acquired into self.attr[key] (an fd/handle cache)


@dataclass
class _ClassInfo:
    name: str
    path: str
    line: int = 0
    locks: Dict[str, str] = field(default_factory=dict)  # attr -> kind
    cond_alias: Dict[str, str] = field(default_factory=dict)  # cond -> lock
    methods: Dict[str, _MethodSummary] = field(default_factory=dict)
    public_methods: Set[str] = field(default_factory=set)
    # lifecycle bookkeeping (thread-leak / resource-leak)
    thread_sites: List[_ThreadSite] = field(default_factory=list)
    resource_sites: List[_ResourceSite] = field(default_factory=list)
    # method -> thread attrs it joins / resource attrs it releases
    joins: Dict[str, Set[str]] = field(default_factory=dict)
    releases: Dict[str, Set[str]] = field(default_factory=dict)
    daemon_attrs: Set[str] = field(default_factory=set)  # self.X.daemon=True
    # coarse release evidence: methods containing ANY close-ish call, and
    # every self attr each method references (release of a dict fd-cache
    # rarely names `self._fds.close()` — it pops entries and os.close's
    # the values, so "mentions the attr + closes something" must count)
    release_methods: Set[str] = field(default_factory=set)
    method_refs: Dict[str, Set[str]] = field(default_factory=dict)


def _is_threading_ctor(node: ast.expr) -> Optional[str]:
    """'lock' | 'rlock' | 'cond' | 'event' | 'sem' if node constructs a
    threading primitive, else None."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = None
    if isinstance(fn, ast.Attribute):
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    return {"Lock": "lock", "RLock": "rlock", "Condition": "cond",
            "Event": "event", "Semaphore": "sem",
            "BoundedSemaphore": "sem"}.get(name)


def _self_attr(node: ast.expr) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _expr_text(node: ast.expr) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — unparse is best-effort for messages
        return "<expr>"


def _lockish(node: ast.expr) -> bool:
    """Heuristic: does this expression look like a lock/cv/semaphore?"""
    name = None
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Subscript):
        sl = node.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            name = sl.value
    if name is None:
        return False
    low = name.lower()
    return low in _LOCKISH_NAMES or low.endswith(_LOCKISH_SUFFIXES)


def _assign_targets(stmt: ast.stmt) -> List[Tuple[ast.expr, ast.expr]]:
    """(target, value) pairs for plain, annotated, and chained assignments
    — `self._t: Thread = Thread(...)` and `self.a = self.b = ctor()` must
    be visible to the lifecycle checks like any other acquire."""
    if isinstance(stmt, ast.Assign):
        return [(t, stmt.value) for t in stmt.targets]
    if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        return [(stmt.target, stmt.value)]
    return []


def _is_thread_ctor(node: ast.expr) -> Optional[bool]:
    """Whether daemon=True was passed at a Thread construction. None when
    the node is not a Thread ctor — or when ``daemon=`` is a non-constant
    expression (statically unknown: skip rather than flag a thread that
    may well be daemonized at runtime)."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    if name != "Thread":
        return None
    for kw in node.keywords:
        if kw.arg == "daemon":
            if isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
            return None
    return False


def _resource_ctor(node: ast.expr) -> Optional[str]:
    """Resource kind ('socket'|'fd'|'mmap'|'shm'|'file') if the expression
    acquires an OS resource needing an explicit release, else None."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        recv, attr = fn.value.id, fn.attr
        if recv == "socket" and attr in ("socket", "create_connection",
                                         "create_server", "socketpair"):
            return "socket"
        if recv == "mmap" and attr == "mmap":
            return "mmap"
        if recv == "os" and attr in ("open", "fdopen", "dup",
                                     "memfd_create", "eventfd"):
            return "fd"
        if attr == "SharedMemory":
            return "shm"
        if recv == "NativeObjectStore" and attr == "open":
            return "shm"
    elif isinstance(fn, ast.Name):
        if fn.id == "SharedMemory":
            return "shm"
        if fn.id == "NativeObjectStore":
            return "shm"
        if fn.id == "open":
            return "file"
    return None


# ---------------------------------------------------------------------------
# per-function walker
# ---------------------------------------------------------------------------


class _FunctionWalker:
    """Walks one function body tracking the stack of held locks."""

    def __init__(self, linter: "Linter", path: str, cls: _ClassInfo,
                 scope: str, summary: _MethodSummary):
        self.linter = linter
        self.path = path
        self.cls = cls  # class (or module pseudo-class) we're inside
        self.scope = scope
        self.summary = summary
        self.held: List[str] = []  # canonical tokens, outermost first
        # local var -> canonical lock token (x = threading.Condition(self._y))
        self.local_alias: Dict[str, str] = {}

    # -- canonicalization ---------------------------------------------------

    def _canon(self, node: ast.expr) -> Optional[str]:
        """Canonical token for a lock expression, resolving condition
        aliases; None when the expression isn't a self/module/local lock."""
        attr = _self_attr(node)
        if attr is not None and attr in self.cls.locks:
            attr = self.cls.cond_alias.get(attr, attr)
            return f"{self.cls.name}.{attr}"
        if isinstance(node, ast.Name):
            if node.id in self.local_alias:
                return self.local_alias[node.id]
            if node.id in self.cls.locks and self.cls.name == "<module>":
                attr = self.cls.cond_alias.get(node.id, node.id)
                return f"<module>.{attr}"
        return None

    def _kind(self, token: str) -> str:
        attr = token.split(".", 1)[1]
        return self.cls.locks.get(attr, "lock")

    # -- statement walk -----------------------------------------------------

    def walk(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.With):
            self._with(stmt)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs execute later, under unknown locks
        if isinstance(stmt, ast.Assign):
            kind = _is_threading_ctor(stmt.value)
            if kind == "cond":
                args = stmt.value.args  # type: ignore[union-attr]
                wrapped = self._canon(args[0]) if args else None
                if wrapped is not None:
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            self.local_alias[tgt.id] = wrapped
        if isinstance(stmt, ast.Try):
            self.walk(stmt.body)
            for h in stmt.handlers:
                self._except(h)
                self.walk(h.body)
            self.walk(stmt.orelse)
            self.walk(stmt.finalbody)
            return
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._expr_scan(node)
            elif isinstance(node, ast.stmt):
                self._stmt(node)
            elif isinstance(node, (ast.ExceptHandler,)):
                self._except(node)
                self.walk(node.body)

    def _with(self, stmt: ast.With) -> None:
        pushed = 0
        for item in stmt.items:
            ctx = item.context_expr
            self._expr_scan(ctx, is_with_ctx=True)
            token = self._canon(ctx)
            if token is not None:
                self._on_acquire(token, ctx.lineno)
                self.held.append(token)
                pushed += 1
            elif _lockish(ctx):
                # A lock on another object: counts as "a lock is held" for
                # blocking-under-lock, but takes no part in this class's
                # order graph.
                self.held.append(f"?{_expr_text(ctx)}")
                pushed += 1
        self.walk(stmt.body)
        for _ in range(pushed):
            self.held.pop()

    def _except(self, handler: ast.ExceptHandler) -> None:
        is_broad = handler.type is None or (
            isinstance(handler.type, ast.Name)
            and handler.type.id in ("Exception", "BaseException"))
        body_is_pass = all(isinstance(s, ast.Pass) for s in handler.body)
        if is_broad and body_is_pass:
            what = (handler.type.id if isinstance(handler.type, ast.Name)
                    else "bare except")
            self.linter.add(Finding(
                "swallowed-exception", self.path, handler.lineno, self.scope,
                f"`except {what}: pass` swallows failures silently — use "
                "log_swallowed(logger, context) or narrow the except",
                "except-pass"))

    # -- acquisition & call handling ----------------------------------------

    def _on_acquire(self, token: str, line: int) -> None:
        self.summary.acquires.add(token)
        if self.held:
            top = self.held[-1]
            if not top.startswith("?"):
                self.summary.nested.append((top, token, line))
                if token == top and self._kind(token) == "lock":
                    self.linter.add(Finding(
                        "lock-order", self.path, line, self.scope,
                        f"re-acquiring non-reentrant {token} while already "
                        "held: guaranteed self-deadlock",
                        f"self-deadlock:{token}"))

    def _expr_scan(self, node: ast.expr, is_with_ctx: bool = False) -> None:
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            self._call(call)

    def _call(self, call: ast.Call) -> None:
        fn = call.func
        fn_name = None
        recv = None
        if isinstance(fn, ast.Attribute):
            fn_name = fn.attr
            recv = fn.value
        elif isinstance(fn, ast.Name):
            fn_name = fn.id

        # explicit .acquire() counts as an acquisition for the graph
        if fn_name == "acquire" and recv is not None:
            token = self._canon(recv)
            if token is not None:
                self._on_acquire(token, call.lineno)

        # interprocedural bookkeeping: self.m(...) / module fn(...)
        callee = None
        if recv is not None and isinstance(recv, ast.Name) and \
                recv.id == "self":
            callee = fn_name
        elif isinstance(fn, ast.Name) and self.cls.name == "<module>":
            callee = fn_name
        if callee is not None and callee in self.cls.methods:
            self.summary.calls.add(callee)
            if self.held and not self.held[-1].startswith("?"):
                self.summary.held_calls.append(
                    (self.held[-1], callee, call.lineno))

        # RPC dispatch surface (+ wait-cycle edge bookkeeping)
        if fn_name in _DISPATCH_METHODS and recv is not None and call.args:
            arg0 = call.args[0]
            if isinstance(arg0, ast.Constant) and isinstance(arg0.value, str):
                self.linter.rpc_sites.append(
                    (self.path, call.lineno, self.scope,
                     _expr_text(recv), arg0.value))
                held = next((h for h in reversed(self.held)
                             if not h.startswith("?")), None)
                self.summary.rpc_calls.append(_RpcSite(
                    _expr_text(recv), arg0.value, fn_name, held,
                    call.lineno, self.scope))

        # untimed waits (held or not)
        self._untimed(call, fn_name, recv)

        # blocking calls under a held lock
        if self.held:
            self._blocking(call, fn_name, recv)

    def _untimed(self, call: ast.Call, fn_name, recv) -> None:
        if recv is None or fn_name not in ("wait", "result"):
            return
        if call.args or call.keywords:
            return
        if fn_name == "wait":
            self.linter.add(Finding(
                "untimed-wait", self.path, call.lineno, self.scope,
                f"`{_expr_text(recv)}.wait()` has no timeout — a lost peer "
                "parks this thread forever (use internal_wait_timeout_s / "
                "collective_timeout_s)",
                f"wait:{_expr_text(recv)}"))
        elif fn_name == "result":
            self.linter.add(Finding(
                "untimed-wait", self.path, call.lineno, self.scope,
                f"`{_expr_text(recv)}.result()` has no timeout — a lost "
                "peer parks this thread forever",
                f"result:{_expr_text(recv)}"))

    def _blocking(self, call: ast.Call, fn_name, recv) -> None:
        held_txt = self.held[-1].lstrip("?")

        def flag(kind: str, msg: str) -> None:
            self.linter.add(Finding(
                "blocking-under-lock", self.path, call.lineno, self.scope,
                f"{msg} while holding {held_txt}",
                f"{kind}:{_expr_text(call.func)}"))

        if fn_name == "sleep":
            # `time.sleep`, `_time.sleep` (import alias), bare `sleep`
            is_time_sleep = recv is None or (
                isinstance(recv, ast.Name) and "time" in recv.id.lower())
            if is_time_sleep:
                flag("sleep", "time.sleep()")
            return
        if fn_name in _SOCKET_METHODS and recv is not None:
            flag("socket", f"socket `{fn_name}`")
            return
        if fn_name == "call" and recv is not None:
            flag("rpc", "blocking RPC `.call(...)`")
            return
        if fn_name == "result" and recv is not None:
            flag("future", "`Future.result(...)`")
            return
        if fn_name == "wait" and recv is not None:
            token = self._canon(recv)
            held_real = [h for h in self.held if not h.startswith("?")]
            if token is not None and token in held_real:
                return  # waiting on the held lock's own condition: releases
            if token is None and _expr_text(recv) in (
                    h.lstrip("?") for h in self.held):
                return  # `with st["lock"]: ... st["lock"].wait()` style
            flag("wait", f"`{_expr_text(recv)}.wait(...)` on a condition "
                         "that does not wrap the held lock")
            return
        if isinstance(recv, ast.Name) and recv.id == "subprocess":
            flag("subprocess", f"subprocess.{fn_name}()")
            return
        if fn_name == "Popen":
            flag("subprocess", "subprocess.Popen()")
            return
        if fn_name == "open" and recv is None:
            flag("file-io", "file `open(...)`")
            return


# ---------------------------------------------------------------------------
# the Linter
# ---------------------------------------------------------------------------


#: (abspath) -> (stat key, parsed tree, source) — shared across Linter
#: instances (each check family used to re-read and re-parse the tree; the
#: tests alone construct dozens of Linters over the same files)
_AST_CACHE: Dict[str, Tuple[Tuple[int, int], ast.Module, str]] = {}


def _parse_cached(path: str) -> Tuple[ast.Module, str]:
    st = os.stat(path)
    key = (st.st_mtime_ns, st.st_size)
    hit = _AST_CACHE.get(path)
    if hit is not None and hit[0] == key:
        return hit[1], hit[2]
    with open(path, "r", encoding="utf-8") as fh:
        src = fh.read()
    tree = ast.parse(src, filename=path)
    _AST_CACHE[path] = (key, tree, src)
    return tree, src


class Linter:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.timings: Dict[str, float] = {}
        self.findings: List[Finding] = []
        # (path, line, scope, receiver_text, method_name)
        self.rpc_sites: List[Tuple[str, int, str, str, str]] = []
        self.services: Dict[str, _ClassInfo] = {}  # class name -> info
        self.classes: List[_ClassInfo] = []
        # config flags: name -> (line, documented)
        self.flags: Dict[str, Tuple[int, bool]] = {}
        self.flag_path: str = ""
        # (path, line, scope, attr) accesses on config objects
        self.cfg_accesses: List[Tuple[str, int, str, str]] = []
        # path -> source lines, for pragma suppression
        self.src_lines: Dict[str, List[str]] = {}

    def add(self, f: Finding) -> None:
        if self._suppressed(f):
            return
        self.findings.append(f)

    def _suppressed(self, f: Finding) -> bool:
        """`# raylint: ignore` / `# raylint: ignore[check-a,check-b]` on the
        finding's line or an immediately preceding comment line suppresses
        it — for reviewed FALSE POSITIVES; accepted real findings belong in
        the baseline instead."""
        lines = self.src_lines.get(f.path)
        if not lines or not (1 <= f.line <= len(lines)):
            return False
        i = f.line - 1
        candidates = [lines[i]]
        while i > 0 and lines[i - 1].lstrip().startswith("#"):
            i -= 1
            candidates.append(lines[i])
        for text in candidates:
            idx = text.find("raylint: ignore")
            if idx < 0:
                continue
            rest = text[idx + len("raylint: ignore"):]
            if not rest.startswith("["):
                return True  # blanket ignore
            checks = rest[1:rest.find("]")] if "]" in rest else ""
            if f.check in {c.strip() for c in checks.split(",")}:
                return True
        return False

    # -- scan ---------------------------------------------------------------

    def _timed(self, phase: str, fn) -> None:
        t0 = time.perf_counter()
        fn()
        self.timings[phase] = self.timings.get(phase, 0.0) \
            + time.perf_counter() - t0

    def run(self) -> List[Finding]:
        t0 = time.perf_counter()
        files = self._collect_files()
        parsed: List[Tuple[str, ast.Module, str]] = []
        for path in files:
            rel = os.path.relpath(path, self.root).replace(os.sep, "/")
            try:
                tree, src = _parse_cached(path)
            except (SyntaxError, UnicodeDecodeError, OSError) as e:
                self.add(Finding("parse-error", rel, getattr(e, "lineno", 0)
                                 or 0, "<file>", f"cannot parse: {e}",
                                 "parse-error"))
                continue
            parsed.append((rel, tree, src))
            self.src_lines[rel] = src.splitlines()
        self.timings["parse"] = time.perf_counter() - t0

        def scan():
            for rel, tree, src in parsed:
                self._scan_config_decls(rel, tree, src)
            for rel, tree, _src in parsed:
                self._scan_module(rel, tree)

        # The per-file scan feeds every check from the cached ASTs in two
        # traversals per function (the lock walker + one lifecycle
        # bucketing walk); inline checks — blocking-under-lock,
        # untimed-wait, swallowed-exception, local lifecycle leaks — fire
        # during it, the graph checks below reuse its summaries.
        self._timed("scan", scan)
        self._timed("lock-order", self._check_lock_order)
        self._timed("rpc-surface", self._check_rpc_surface)
        self._timed("rpc-cycle", self._check_rpc_cycle)
        self._timed("thread-leak", self._check_thread_leaks)
        self._timed("resource-leak", self._check_resource_leaks)
        self._timed("config-knob", self._check_config_knobs)
        # The torch-aware checks live in devtools.torchlint (imported
        # lazily: torchlint imports Finding from this module at its top
        # level) and ride the same AST cache, pragmas and baseline.
        from ray_tpu_torch.devtools import torchlint
        self._timed("host-sync",
                    lambda: torchlint.check_host_sync(self, parsed))
        self._timed("compile-churn",
                    lambda: torchlint.check_compile_churn(self, parsed))
        self._assign_fingerprints()
        self.findings.sort(key=lambda f: (f.path, f.line, f.check, f.detail))
        self.timings["total"] = time.perf_counter() - t0
        return self.findings

    def _collect_files(self) -> List[str]:
        if os.path.isfile(self.root):
            path = self.root
            self.root = os.path.abspath(os.path.dirname(path) or ".")
            return [path]
        out = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", "_native", ".git")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
        return out

    # -- config declarations ------------------------------------------------

    def _scan_config_decls(self, rel: str, tree: ast.Module, src: str) -> None:
        """Find the _Flag registry: a class named Config whose body assigns
        ``name = _Flag(...)``. ``documented`` = a comment line directly
        above the assignment."""
        lines = src.splitlines()
        for node in tree.body:
            if not isinstance(node, ast.ClassDef) or node.name != "Config":
                continue
            found = {}
            for stmt in node.body:
                if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and isinstance(stmt.value, ast.Call)
                        and isinstance(stmt.value.func, ast.Name)
                        and stmt.value.func.id == "_Flag"):
                    name = stmt.targets[0].id
                    prev = lines[stmt.lineno - 2].strip() \
                        if stmt.lineno >= 2 else ""
                    documented = prev.startswith("#") or prev.startswith("...")
                    found[name] = (stmt.lineno, documented)
            if found:
                self.flags = found
                self.flag_path = rel

    # -- per-module scan ----------------------------------------------------

    def _scan_module(self, rel: str, tree: ast.Module) -> None:
        # module pseudo-class: top-level functions + module-level locks
        mod = _ClassInfo(name="<module>", path=rel)
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                kind = _is_threading_ctor(node.value)
                if kind:
                    self._register_lock(mod, node.targets[0].id, kind,
                                        node.value)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mod.methods.setdefault(node.name, _MethodSummary())

        classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
        for cls_node in classes:
            info = _ClassInfo(name=cls_node.name, path=rel,
                              line=cls_node.lineno)
            for item in cls_node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.methods.setdefault(item.name, _MethodSummary())
                    if not item.name.startswith("_"):
                        info.public_methods.add(item.name)
            # lock attributes: any `self.X = threading.Lock()` in any method
            for sub in ast.walk(cls_node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    attr = _self_attr(sub.targets[0])
                    kind = _is_threading_ctor(sub.value)
                    if attr is not None and kind:
                        self._register_lock(info, attr, kind, sub.value)
            self.classes.append(info)
            # walk method bodies
            for item in cls_node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scope = f"{cls_node.name}.{item.name}"
                    walker = _FunctionWalker(self, rel, info, scope,
                                             info.methods[item.name])
                    walker.walk(item.body)
                    self._scan_fn_lifecycle(rel, info, item.name, scope, item)
            # service discovery: RpcServer(self, ...) inside the class
            for sub in ast.walk(cls_node):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id == "RpcServer" and sub.args
                        and isinstance(sub.args[0], ast.Name)
                        and sub.args[0].id == "self"):
                    self.services[cls_node.name] = info

        # module-level function bodies (pseudo-class walk)
        self.classes.append(mod)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = node.name
                walker = _FunctionWalker(self, rel, mod, scope,
                                         mod.methods[node.name])
                walker.walk(node.body)
                self._scan_fn_lifecycle(rel, mod, node.name, scope, node)

        # service discovery: RpcServer(<Name or Call>, ...) anywhere
        by_name = {c.name: c for c in self.classes if c.path == rel}
        assigned: Dict[str, str] = {}  # var -> class name (x = Cls(...))
        for sub in ast.walk(tree):
            if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                    and isinstance(sub.targets[0], ast.Name)
                    and isinstance(sub.value, ast.Call)
                    and isinstance(sub.value.func, ast.Name)):
                assigned[sub.targets[0].id] = sub.value.func.id
        for sub in ast.walk(tree):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id == "RpcServer" and sub.args):
                continue
            arg0 = sub.args[0]
            cls_name = None
            if isinstance(arg0, ast.Call) and isinstance(arg0.func, ast.Name):
                cls_name = arg0.func.id
            elif isinstance(arg0, ast.Name):
                cls_name = assigned.get(arg0.id, arg0.id)
            if cls_name and cls_name in by_name:
                self.services[cls_name] = by_name[cls_name]

        # config accesses in this module
        self._scan_config_accesses(rel, tree)

    def _register_lock(self, info: _ClassInfo, attr: str, kind: str,
                       ctor: ast.expr) -> None:
        info.locks[attr] = kind
        if kind == "cond" and isinstance(ctor, ast.Call) and ctor.args:
            wrapped = _self_attr(ctor.args[0])
            if wrapped is None and isinstance(ctor.args[0], ast.Name) and \
                    info.name == "<module>":
                wrapped = ctor.args[0].id
            if wrapped is not None:
                info.cond_alias[attr] = wrapped
                # the condition's kind follows the wrapped lock where known
                if wrapped in info.locks:
                    info.locks[attr] = info.locks[wrapped]

    # -- lifecycle scan (thread-leak / resource-leak raw material) -----------

    def _scan_fn_lifecycle(self, rel: str, info: _ClassInfo, name: str,
                           scope: str, fn: ast.AST) -> None:
        """Collect thread/resource acquire, join, daemonize and release
        evidence from one function body (class method or module function),
        and flag function-LOCAL leaks immediately."""
        local_threads: Dict[str, Dict] = {}  # var -> {daemon, joined, line}
        local_res: Dict[str, Dict] = {}  # var -> {kind, line, closed}
        escaped: Set[str] = set()
        refs: Set[str] = set()

        # ONE traversal buckets everything the passes below need: with-
        # managed context ids, (target, value) assignment pairs, calls,
        # self-attr reads, and returned/yielded expressions.
        with_ctxs: Set[int] = set()
        assigns: List[Tuple[ast.expr, ast.expr, int]] = []
        calls: List[ast.Call] = []
        escape_exprs: List[ast.expr] = []
        for sub in ast.walk(fn):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    with_ctxs.add(id(item.context_expr))
            elif isinstance(sub, ast.Call):
                calls.append(sub)
            elif isinstance(sub, ast.Attribute):
                a = _self_attr(sub)
                if a is not None:
                    refs.add(a)
            elif isinstance(sub, (ast.Return, ast.Yield, ast.YieldFrom)):
                if sub.value is not None:
                    escape_exprs.append(sub.value)
            for tgt, val in _assign_targets(sub):
                assigns.append((tgt, val, sub.lineno))

        # pass 1: direct constructions
        for tgt, val, lineno in assigns:
            if id(val) in with_ctxs:
                continue
            daemon = _is_thread_ctor(val)
            kind = _resource_ctor(val) if daemon is None else None
            if daemon is None and kind is None:
                continue
            attr = _self_attr(tgt)
            sub_attr = (_self_attr(tgt.value)
                        if isinstance(tgt, ast.Subscript) else None)
            if daemon is not None:
                if attr is not None:
                    info.thread_sites.append(
                        _ThreadSite(attr, lineno, scope, daemon))
                elif isinstance(tgt, ast.Name):
                    local_threads[tgt.id] = {"daemon": daemon, "joined": False,
                                             "line": lineno}
            else:
                if attr is not None:
                    info.resource_sites.append(_ResourceSite(
                        attr, lineno, scope, kind, is_dict=False))
                elif sub_attr is not None:
                    info.resource_sites.append(_ResourceSite(
                        sub_attr, lineno, scope, kind, is_dict=True))
                elif isinstance(tgt, ast.Name) and kind != "file":
                    # plain local `open()` file handles are everywhere and
                    # usually short-lived; flag only kernel-object locals
                    local_res[tgt.id] = {"kind": kind, "line": lineno,
                                         "closed": False}
        # pass 2a: stores of tracked locals onto self + daemonization
        for tgt, val, _lineno in assigns:
            # self.X = t / self.X[k] = fd promotes a local to an attr site
            if isinstance(val, ast.Name):
                attr = _self_attr(tgt)
                sub_attr = (_self_attr(tgt.value)
                            if isinstance(tgt, ast.Subscript) else None)
                if val.id in local_threads and attr is not None:
                    t = local_threads.pop(val.id)
                    info.thread_sites.append(
                        _ThreadSite(attr, t["line"], scope, t["daemon"]))
                elif val.id in local_res and (attr is not None
                                              or sub_attr is not None):
                    r = local_res.pop(val.id)
                    info.resource_sites.append(_ResourceSite(
                        attr or sub_attr, r["line"], scope, r["kind"],
                        is_dict=attr is None))
                elif val.id in local_threads or val.id in local_res:
                    escaped.add(val.id)  # aliased somewhere we can't see
            # t.daemon = True / self.X.daemon = True
            if (isinstance(tgt, ast.Attribute) and tgt.attr == "daemon"
                    and isinstance(val, ast.Constant) and val.value):
                inner = tgt.value
                a = _self_attr(inner)
                if a is not None:
                    info.daemon_attrs.add(a)
                elif isinstance(inner, ast.Name) and \
                        inner.id in local_threads:
                    local_threads[inner.id]["daemon"] = True
        # pass 2b: joins, releases, escapes through calls
        for call in calls:
            f = call.func
            if isinstance(f, ast.Attribute):
                recv = f.value
                recv_attr = _self_attr(recv)
                recv_name = recv.id if isinstance(recv, ast.Name) else None
                # `Thread(...).start()` never bound anywhere: joinable by
                # nobody — must be a daemon
                if f.attr == "start" and _is_thread_ctor(recv) is False:
                    self.add(Finding(
                        "thread-leak", rel, call.lineno, scope,
                        "anonymous non-daemon `Thread(...).start()` — no "
                        "reference survives to join it; pass daemon=True "
                        "or keep a handle and join on shutdown",
                        "anonymous-thread"))
                # os.close/os.closerange BEFORE the generic release branch
                # ("close" is in _RELEASE_METHODS): the released object is
                # the ARGUMENT here, not the receiver
                if recv_name == "os" and f.attr in ("close", "closerange"):
                    info.release_methods.add(name)
                    for arg in call.args:
                        for deep in ast.walk(arg):
                            da = _self_attr(deep)
                            if da is not None:
                                info.releases.setdefault(name,
                                                         set()).add(da)
                            if isinstance(deep, ast.Name) and \
                                    deep.id in local_res:
                                local_res[deep.id]["closed"] = True
                    continue  # os.close(v) is a release, not an escape
                if f.attr == "join":
                    if recv_attr is not None:
                        info.joins.setdefault(name, set()).add(recv_attr)
                    elif recv_name in local_threads:
                        local_threads[recv_name]["joined"] = True
                elif f.attr in _RELEASE_METHODS:
                    info.release_methods.add(name)
                    # precise: the release call's receiver names self.X
                    for deep in ast.walk(f.value):
                        da = _self_attr(deep)
                        if da is not None:
                            info.releases.setdefault(name, set()).add(da)
                    if recv_name in local_res:
                        local_res[recv_name]["closed"] = True
            # a tracked local passed as an ARGUMENT may be retained by the
            # callee — ownership is unclear, don't flag
            for arg in list(call.args) + [kw.value for kw in call.keywords]:
                for deep in ast.walk(arg):
                    if isinstance(deep, ast.Name) and (
                            deep.id in local_threads or deep.id in local_res):
                        escaped.add(deep.id)
        for expr in escape_exprs:
            for deep in ast.walk(expr):
                if isinstance(deep, ast.Name):
                    escaped.add(deep.id)
        info.method_refs[name] = refs

        for var, t in local_threads.items():
            if var in escaped or t["daemon"] or t["joined"]:
                continue
            self.add(Finding(
                "thread-leak", rel, t["line"], scope,
                f"local thread `{var}` is neither daemonized nor joined in "
                "this function — it outlives its owner and wedges "
                "interpreter exit",
                f"local:{var}"))
        for var, r in local_res.items():
            if var in escaped or r["closed"]:
                continue
            self.add(Finding(
                "resource-leak", rel, r["line"], scope,
                f"local {r['kind']} `{var}` is never closed in this "
                "function and does not escape — leaked on every call",
                f"local:{r['kind']}:{var}"))

    # -- lock-order graph ----------------------------------------------------

    def _lock_closure(self, info: _ClassInfo) -> Dict[str, Set[str]]:
        """Interprocedural (through ``self`` calls) closure of the lock
        tokens each method's call tree can acquire."""
        closure: Dict[str, Set[str]] = {
            m: set(s.acquires) for m, s in info.methods.items()}
        changed = True
        while changed:
            changed = False
            for m, s in info.methods.items():
                for callee in s.calls:
                    extra = closure.get(callee, set()) - closure[m]
                    if extra:
                        closure[m] |= extra
                        changed = True
        return closure

    def _check_lock_order(self) -> None:
        for info in self.classes:
            edges: Dict[str, Set[str]] = {}
            edge_site: Dict[Tuple[str, str], Tuple[int, str]] = {}
            # interprocedural closure: all locks a method's call tree takes
            closure = self._lock_closure(info)
            for m, s in info.methods.items():
                for held, acquired, line in s.nested:
                    if held != acquired:
                        edges.setdefault(held, set()).add(acquired)
                        edge_site.setdefault((held, acquired),
                                             (line, f"{info.name}.{m}"))
                for held, callee, line in s.held_calls:
                    for acquired in closure.get(callee, ()):  # transitive
                        if acquired != held:
                            edges.setdefault(held, set()).add(acquired)
                            edge_site.setdefault(
                                (held, acquired),
                                (line, f"{info.name}.{m}→{callee}"))
            # cycle detection (DFS)
            for cycle in _find_cycles(edges):
                line, scope = edge_site.get((cycle[0], cycle[1]), (info.line,
                                                                   info.name))
                pretty = " -> ".join(cycle + [cycle[0]])
                self.add(Finding(
                    "lock-order", info.path, line, scope,
                    f"lock-order cycle (potential deadlock): {pretty}",
                    "cycle:" + "->".join(sorted(set(cycle)))))

    # -- rpc surface ---------------------------------------------------------

    def _check_rpc_surface(self) -> None:
        if not self.services:
            return
        union: Set[str] = set(_RPC_SPECIAL)
        for svc in self.services.values():
            union |= svc.public_methods
        for path, line, scope, recv, method in self.rpc_sites:
            svc_name = None
            for pattern, candidate in _CLIENT_TABLE:
                if pattern in recv and candidate in self.services:
                    svc_name = candidate
                    break
            if svc_name is not None:
                surface = (self.services[svc_name].public_methods
                           | _RPC_SPECIAL)
                where = f"service {svc_name}"
            else:
                surface = union
                where = "any known RPC service"
            if method.startswith("_"):
                self.add(Finding(
                    "rpc-surface", path, line, scope,
                    f"dispatching private method '{method}' — RpcServer "
                    "refuses names starting with '_'",
                    f"private:{method}"))
            elif method not in surface:
                self.add(Finding(
                    "rpc-surface", path, line, scope,
                    f"'{method}' (via `{recv}`) does not resolve to a "
                    f"public method on {where}",
                    f"unknown:{method}"))

    # -- cross-process wait cycles -------------------------------------------

    def _resolve_service(self, recv: str) -> Optional[str]:
        for pattern, candidate in _CLIENT_TABLE:
            if pattern in recv and candidate in self.services:
                return candidate
        return None

    def _service_rpc_closure(self, info: _ClassInfo) \
            -> Dict[str, List[_RpcSite]]:
        """Per-method set of RPC dispatch sites reachable through ``self``
        calls, propagating the held-lock context: a site reached via a
        call made under lock L inherits L when the site itself recorded
        no held lock."""
        closure: Dict[str, Dict[Tuple, _RpcSite]] = {
            m: {(r.recv, r.method, r.kind, r.held): r
                for r in s.rpc_calls}
            for m, s in info.methods.items()}
        changed = True
        while changed:
            changed = False
            for m, s in info.methods.items():
                held_by_callee: Dict[str, str] = {}
                for held, callee, _line in s.held_calls:
                    held_by_callee.setdefault(callee, held)
                for callee in s.calls:
                    for site in list(closure.get(callee, {}).values()):
                        held = site.held or held_by_callee.get(callee)
                        key = (site.recv, site.method, site.kind, held)
                        if key not in closure[m]:
                            closure[m][key] = _RpcSite(
                                site.recv, site.method, site.kind, held,
                                site.line, f"{info.name}.{m} → {site.via}")
                            changed = True
        return {m: list(d.values()) for m, d in closure.items()}

    def _check_rpc_cycle(self) -> None:
        if not self.services:
            return
        # node = "Service.handler"; edge = blocking .call issued while
        # serving the source handler, landing on the target handler. One
        # representative site per (src, dst, held) — a second call site on
        # the same edge under a DIFFERENT lock is a distinct deadlock
        # candidate and must not be collapsed away.
        edges: Dict[str, Set[str]] = {}
        edge_sites: Dict[Tuple[str, str],
                         Dict[Optional[str], Tuple[str, _RpcSite]]] = {}
        lock_closures: Dict[str, Dict[str, Set[str]]] = {}
        for svc, info in self.services.items():
            lock_closures[svc] = self._lock_closure(info)
            sites = self._service_rpc_closure(info)
            for m in sorted(info.public_methods):
                for site in sites.get(m, ()):
                    if site.kind != "call":
                        continue  # notify/call_async don't park the caller
                    target = self._resolve_service(site.recv)
                    if target is None:
                        continue
                    if site.method not in \
                            self.services[target].public_methods:
                        continue
                    src, dst = f"{svc}.{m}", f"{target}.{site.method}"
                    edges.setdefault(src, set()).add(dst)
                    edge_sites.setdefault((src, dst), {}).setdefault(
                        site.held, (svc, site))

        in_cycle_edges: Set[Tuple[str, str]] = set()
        for cycle in _find_cycles(edges):
            pairs = list(zip(cycle, cycle[1:] + [cycle[0]]))
            in_cycle_edges.update(pairs)
            svc, site = next(iter(edge_sites[pairs[0]].values()))
            pretty = " -> ".join(cycle + [cycle[0]])
            self.add(Finding(
                "rpc-cycle", self.services[svc].path, site.line, cycle[0],
                f"cross-process RPC wait cycle: {pretty} — each handler "
                "blocks in .call until the next replies; when the chain "
                "lands back on the origin process both sides park forever "
                "(make one hop a notify/call_async, or move the work off "
                "the handler)",
                "cycle:" + "->".join(sorted(set(cycle)))))
        # lock-held blocking edges: flagged when the edge participates in a
        # handler cycle, or when the remote handler chain can RPC back into
        # a method of the CALLER's class that needs the held lock (the
        # per-class lock graph composed with the RPC edges)
        for (src, dst), by_held in sorted(edge_sites.items()):
            for held, (svc, site) in sorted(
                    by_held.items(), key=lambda kv: kv[0] or ""):
                if held is None:
                    continue
                path = self.services[svc].path
                if (src, dst) in in_cycle_edges:
                    self.add(Finding(
                        "rpc-cycle", path, site.line, src,
                        f"blocking RPC to {dst} issued while holding "
                        f"{held} participates in a handler wait cycle — "
                        "the reply this thread is parked on can itself "
                        f"need {held}",
                        f"lock-held:{held}->{dst}"))
                    continue
                for node in self._reachable(edges, dst):
                    tsvc, tm = node.split(".", 1)
                    if tsvc == svc and held in \
                            lock_closures[svc].get(tm, ()):
                        self.add(Finding(
                            "rpc-cycle", path, site.line, src,
                            f"blocking RPC to {dst} issued while holding "
                            f"{held}; the serving side can call back "
                            f"into {node}, which acquires {held} — "
                            "distributed deadlock when both block",
                            f"lock-rpc:{held}:{dst}=>{node}"))
                        break

    @staticmethod
    def _reachable(edges: Dict[str, Set[str]], start: str) -> Set[str]:
        out, stack = {start}, [start]
        while stack:
            for nxt in edges.get(stack.pop(), ()):
                if nxt not in out:
                    out.add(nxt)
                    stack.append(nxt)
        return out

    # -- thread / resource lifecycle -----------------------------------------

    def _shutdown_reachable(self, info: _ClassInfo) -> Set[str]:
        """Methods reachable (via ``self`` calls) from a shutdown-path
        entry point."""
        reach = {m for m in info.methods
                 if m in _SHUTDOWN_ENTRY_NAMES
                 or any(k in m for k in ("shutdown", "close", "stop",
                                         "teardown", "cleanup", "clear",
                                         "destroy"))}
        changed = True
        while changed:
            changed = False
            for m in list(reach):
                for callee in info.methods[m].calls:
                    if callee in info.methods and callee not in reach:
                        reach.add(callee)
                        changed = True
        return reach

    def _check_thread_leaks(self) -> None:
        for info in self.classes:
            if not info.thread_sites:
                continue
            reach = self._shutdown_reachable(info)
            joined_reachable: Set[str] = set()
            joined_anywhere: Set[str] = set()
            for m, attrs in info.joins.items():
                joined_anywhere |= attrs
                if m in reach:
                    joined_reachable |= attrs
            for site in info.thread_sites:
                if site.daemon or site.attr in info.daemon_attrs:
                    continue
                if site.attr in joined_reachable:
                    continue
                if site.attr in joined_anywhere:
                    msg = (f"non-daemon thread `self.{site.attr}` is "
                           "joined, but not from any shutdown-path method "
                           f"({'/'.join(sorted(reach)) or 'none found'}) — "
                           "a shutdown that skips that path leaks it")
                else:
                    msg = (f"non-daemon thread `self.{site.attr}` has no "
                           "reachable join() — pass daemon=True or join "
                           "it from close()/shutdown()")
                self.add(Finding("thread-leak", info.path, site.line,
                                 site.scope, msg, f"unjoined:{site.attr}"))

    def _check_resource_leaks(self) -> None:
        for info in self.classes:
            if not info.resource_sites or info.name == "<module>":
                continue
            reach = self._shutdown_reachable(info)
            seen: Set[str] = set()
            for site in info.resource_sites:
                if site.attr in seen:
                    continue  # one finding per attr, not per acquire site
                seen.add(site.attr)
                released = False
                for m in reach:
                    if site.attr in info.releases.get(m, ()):
                        released = True  # precise: self.X.close() et al.
                        break
                    if m in info.release_methods and \
                            site.attr in info.method_refs.get(m, ()):
                        released = True  # coarse: fd-cache drain loops
                        break
                if released:
                    continue
                what = (f"{site.kind} cache `self.{site.attr}`" if
                        site.is_dict else
                        f"{site.kind} `self.{site.attr}`")
                self.add(Finding(
                    "resource-leak", info.path, site.line, site.scope,
                    f"{what} has no release reachable from a shutdown-path "
                    "method (close/shutdown/stop/__exit__ ...) — leaked "
                    "on owner teardown",
                    f"unreleased:{site.kind}:{site.attr}"))

    # -- config knobs --------------------------------------------------------

    def _scan_config_accesses(self, rel: str, tree: ast.Module) -> None:
        # names assigned from config() calls — and names assigned from
        # anything else (a conflicted name is skipped entirely)
        cfg_names: Set[str] = set()
        other_names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                v = node.value
                if (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                        and v.func.id in ("config", "Config",
                                          "_get_config")):
                    cfg_names.add(name)
                else:
                    other_names.add(name)
        cfg_names -= other_names
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            v = node.value
            is_cfg = (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                      and v.func.id in ("config", "_get_config"))
            is_cfg = is_cfg or (isinstance(v, ast.Name) and v.id in cfg_names)
            if is_cfg:
                self.cfg_accesses.append(
                    (rel, node.lineno, "<module>", node.attr))

    def _check_config_knobs(self) -> None:
        if not self.flags:
            return
        used: Set[str] = set()
        for path, line, scope, attr in self.cfg_accesses:
            if path == self.flag_path:
                continue  # the registry's own reflection
            if attr in self.flags:
                used.add(attr)
                continue
            if attr in _CONFIG_NON_FLAGS or attr.startswith("_"):
                continue
            self.add(Finding(
                "config-knob", path, line, scope,
                f"`cfg.{attr}` does not resolve to any declared _Flag "
                f"(see {self.flag_path})",
                f"unknown:{attr}"))
        for name, (line, documented) in sorted(self.flags.items()):
            if name not in used:
                self.add(Finding(
                    "config-knob", self.flag_path, line, "Config",
                    f"_Flag '{name}' is declared but never referenced",
                    f"unused:{name}"))
            if not documented:
                self.add(Finding(
                    "config-knob", self.flag_path, line, "Config",
                    f"_Flag '{name}' has no doc comment above its "
                    "declaration",
                    f"undocumented:{name}"))

    # -- fingerprints --------------------------------------------------------

    def _assign_fingerprints(self) -> None:
        counts: Dict[str, int] = {}
        for f in sorted(self.findings, key=lambda x: (x.path, x.line)):
            base = f"{f.check}|{f.path}|{f.scope}|{f.detail}"
            n = counts.get(base, 0)
            counts[base] = n + 1
            f.fingerprint = base if n == 0 else f"{base}#{n + 1}"


def _find_cycles(edges: Dict[str, Set[str]]) -> List[List[str]]:
    """Simple cycles in a small digraph, each reported once (rotated so the
    lexicographically-smallest node leads)."""
    seen: Set[Tuple[str, ...]] = set()
    out: List[List[str]] = []

    def dfs(start: str, node: str, path: List[str], visiting: Set[str]):
        for nxt in sorted(edges.get(node, ())):
            if nxt == start:
                cycle = path[:]
                i = cycle.index(min(cycle))
                canon = tuple(cycle[i:] + cycle[:i])
                if canon not in seen:
                    seen.add(canon)
                    out.append(list(canon))
            elif nxt not in visiting and nxt > start:
                # only explore nodes > start: each cycle found exactly once
                # from its smallest node
                visiting.add(nxt)
                dfs(start, nxt, path + [nxt], visiting)
                visiting.discard(nxt)

    for start in sorted(edges):
        dfs(start, start, [start], {start})
    return out


# ---------------------------------------------------------------------------
# baseline + CLI
# ---------------------------------------------------------------------------

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "lint_baseline.txt")


def load_baseline(path: str) -> Set[str]:
    if not os.path.exists(path):
        return set()
    with open(path, "r", encoding="utf-8") as fh:
        return {line.strip() for line in fh
                if line.strip() and not line.startswith("#")}


def write_baseline(path: str, findings: List[Finding]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# raylint baseline — accepted findings, one fingerprint "
                 "per line.\n")
        fh.write("# Regenerate with: python -m ray_tpu_torch.devtools.lint "
                 "--update-baseline\n")
        for fp in sorted({f.fingerprint for f in findings}):
            fh.write(fp + "\n")


def lint_tree(root: str) -> List[Finding]:
    """Programmatic entry point: all findings for a tree (no baseline)."""
    return Linter(root).run()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint",
        description="raylint: concurrency & contract static analysis")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to scan (default: the ray_tpu_torch "
                             "tree)")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline with current findings")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding; exit 1 if any")
    parser.add_argument("--check-baseline", action="store_true",
                        help="explicit CI mode: diff findings against the "
                             "baseline and exit 1 on anything new (this is "
                             "also the default behavior)")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="baseline file (default: %(default)s)")
    parser.add_argument("--profile", action="store_true",
                        help="print per-check wall time")
    parser.add_argument("-q", "--quiet", action="store_true")
    args = parser.parse_args(argv)

    roots = args.paths or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    findings: List[Finding] = []
    timings: Dict[str, float] = {}
    for root in roots:
        linter = Linter(root)
        findings.extend(linter.run())
        for phase, dt in linter.timings.items():
            timings[phase] = timings.get(phase, 0.0) + dt

    if args.profile:
        for phase, dt in sorted(timings.items(), key=lambda kv: -kv[1]):
            print(f"  {phase:<14} {dt * 1000:8.1f} ms", file=sys.stderr)

    if args.update_baseline:
        write_baseline(args.baseline, findings)
        print(f"baseline updated: {len(findings)} accepted findings -> "
              f"{args.baseline}")
        return 0

    if args.no_baseline:
        new = findings
    else:
        accepted = load_baseline(args.baseline)
        new = [f for f in findings if f.fingerprint not in accepted]

    if not args.quiet:
        for f in new:
            print(f.render())
    by_check: Dict[str, int] = {}
    for f in findings:
        by_check[f.check] = by_check.get(f.check, 0) + 1
    summary = ", ".join(f"{k}={v}" for k, v in sorted(by_check.items()))
    if new:
        print(f"raylint: {len(new)} NEW finding(s) "
              f"({len(findings)} total: {summary})", file=sys.stderr)
        print("(accept intentionally with --update-baseline)",
              file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"raylint: clean ({len(findings)} baselined: {summary or '0'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""raylint on the port (``ray_tpu_torch.devtools.lint``) and its torch tier
(``ray_tpu_torch.devtools.torchlint``).

The first half is ``test_devtools_lint.py``'s and ``test_devtools_lint2.py``'s
lint tests on the port's linter: each seeded snippet trips its check, and
the port's tree is clean against ``ray_tpu_torch/devtools/lint_baseline.txt``
(the tier-1 gate: a new lock inversion, blocking call under a lock, untimed
wait, swallowed exception, RPC-surface typo, unknown knob or hot-path host
read anywhere in ``ray_tpu_torch/`` fails until fixed or accepted with
``--update-baseline``). The whole-tree tests share one lint of the tree (a
module fixture). The second half holds the torch checks: ``host-sync`` sinks
in a hot scope, the ``jitcheck.device_get`` twin clean, cold files not
patrolled, the coverage guard, a nested generator walked, ``compile-churn``
on a local ``torch.compile`` and clean on a cached one, pragma, baseline and
profile phases. Last, the gate runs in a fresh interpreter with ``jax`` and
``ray_tpu`` blocked from import.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest

from ray_tpu_torch.devtools import lint, torchlint

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ROOT = os.path.join(ROOT, "ray_tpu_torch")


def _write(tmp_path, rel, src):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return p


@pytest.fixture(scope="module")
def tree():
    """One lint of the port's tree for every whole-tree test: the linter,
    its findings and the CPU seconds the run took."""
    linter = lint.Linter(PORT_ROOT)
    cpu0 = time.process_time()
    findings = linter.run()
    return linter, findings, time.process_time() - cpu0


# ---------------------------------------------------------------------------
# seeded fixture snippets — each must trip its check (test_devtools_lint.py)
# ---------------------------------------------------------------------------


def test_lock_order_cycle_detected(tmp_path):
    _write(tmp_path, "mod.py", """
        import threading

        class Inverted:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def path1(self):
                with self._a:
                    with self._b:
                        pass

            def path2(self):
                with self._b:
                    self._helper()   # interprocedural: _helper takes _a

            def _helper(self):
                with self._a:
                    pass
        """)
    findings = lint.lint_tree(str(tmp_path))
    cycles = [f for f in findings if f.check == "lock-order"]
    assert cycles, findings
    assert "Inverted._a" in cycles[0].message
    assert "Inverted._b" in cycles[0].message


def test_self_deadlock_detected(tmp_path):
    _write(tmp_path, "mod.py", """
        import threading

        class Re:
            def __init__(self):
                self._l = threading.Lock()
                self._cv = threading.Condition(self._l)

            def bad(self):
                with self._l:
                    with self._cv:   # same underlying non-reentrant lock
                        pass
        """)
    findings = lint.lint_tree(str(tmp_path))
    assert any(f.check == "lock-order" and "self-deadlock" in f.detail
               for f in findings), findings


def test_blocking_under_lock_detected(tmp_path):
    _write(tmp_path, "mod.py", """
        import subprocess
        import threading
        import time

        class B:
            def __init__(self):
                self._lock = threading.Lock()
                self._other = threading.Condition()
                self.sock = None
                self.peer = None

            def bad(self):
                with self._lock:
                    time.sleep(0.1)
                    self.sock.recv(4096)
                    self.peer.call("ping")
                    self._other.wait(1.0)
                    subprocess.check_output(["true"])
                    open("/tmp/x")
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "blocking-under-lock"]
    kinds = {f.detail.split(":")[0] for f in findings}
    assert {"sleep", "socket", "rpc", "wait", "subprocess",
            "file-io"} <= kinds, findings


def test_wait_on_own_condition_not_flagged(tmp_path):
    _write(tmp_path, "mod.py", """
        import threading

        class Ok:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)

            def fine(self):
                with self._lock:
                    self._cv.wait(timeout=1.0)  # releases _lock: not blocking
        """)
    findings = lint.lint_tree(str(tmp_path))
    assert not [f for f in findings if f.check == "blocking-under-lock"], \
        findings


def test_untimed_wait_detected(tmp_path):
    _write(tmp_path, "mod.py", """
        import threading

        class W:
            def __init__(self):
                self._ev = threading.Event()

            def park(self, fut):
                self._ev.wait()
                return fut.result()
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "untimed-wait"]
    assert len(findings) == 2, findings
    assert {f.detail.split(":")[0] for f in findings} == {"wait", "result"}


def test_swallowed_exception_detected_and_log_swallowed_not(tmp_path):
    _write(tmp_path, "mod.py", """
        def loop():
            try:
                step()
            except Exception:
                pass

        def fixed(logger):
            try:
                step()
            except Exception:
                log_swallowed(logger, "step in loop")
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "swallowed-exception"]
    assert len(findings) == 1 and findings[0].scope == "loop", findings


def test_rpc_surface_unknown_method_detected(tmp_path):
    _write(tmp_path, "svc.py", """
        class FooService:
            def ping(self):
                return "pong"

        def serve():
            service = FooService()
            return RpcServer(service, name="foo")

        def use(client):
            client.call("ping")               # resolves
            client.call("not_a_method")       # typo: flagged
            client.notify("_private")         # private: flagged
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "rpc-surface"]
    details = {f.detail for f in findings}
    assert details == {"unknown:not_a_method", "private:_private"}, findings


def test_config_knob_checks(tmp_path):
    _write(tmp_path, "core/config.py", """
        class _Flag:
            def __init__(self, default):
                self.default = default

        class Config:
            # a documented, used knob
            good_knob = _Flag(1)
            orphan_knob = _Flag(2)
            # read only in the port's `_get_config().<name>` form
            aliased_knob = _Flag(3)
        """)
    _write(tmp_path, "user.py", """
        from core.config import config
        from core.config import config as _get_config

        def f():
            cfg = config()
            return cfg.good_knob + cfg.not_a_knob

        def g():
            return _get_config().aliased_knob + _get_config().typo_knob
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "config-knob"]
    details = {f.detail for f in findings}
    assert "unknown:not_a_knob" in details, findings
    assert "unused:orphan_knob" in details, findings
    assert "undocumented:orphan_knob" in details, findings
    assert not any("good_knob" in d for d in details), findings
    # the `_get_config()` form resolves, both ways
    assert "unknown:typo_knob" in details, findings
    assert not any("aliased_knob" in d for d in details), findings


def test_pragma_suppresses_reviewed_false_positive(tmp_path):
    _write(tmp_path, "mod.py", """
        import threading
        import time

        class P:
            def __init__(self):
                self._lock = threading.Lock()

            def reviewed(self):
                with self._lock:
                    # raylint: ignore[blocking-under-lock] — bounded 1ms
                    time.sleep(0.001)
        """)
    findings = lint.lint_tree(str(tmp_path))
    assert not [f for f in findings if f.check == "blocking-under-lock"], \
        findings


# ---------------------------------------------------------------------------
# baseline workflow + the tier-1 gate
# ---------------------------------------------------------------------------


def test_baseline_update_then_clean(tmp_path):
    _write(tmp_path, "mod.py", """
        def loop():
            try:
                step()
            except Exception:
                pass
        """)
    baseline = tmp_path / "baseline.txt"
    # dirty against an empty baseline
    rc = lint.main([str(tmp_path), "--baseline", str(baseline), "-q"])
    assert rc == 1
    # accept, then clean
    rc = lint.main([str(tmp_path), "--baseline", str(baseline),
                    "--update-baseline"])
    assert rc == 0
    rc = lint.main([str(tmp_path), "--baseline", str(baseline), "-q"])
    assert rc == 0
    # a NEW finding fails again; the accepted one stays accepted
    _write(tmp_path, "mod2.py", """
        def loop2():
            try:
                step()
            except Exception:
                pass
        """)
    rc = lint.main([str(tmp_path), "--baseline", str(baseline), "-q"])
    assert rc == 1


def test_tree_is_clean_against_checked_in_baseline(tree):
    """THE tier-1 gate: every finding on the port's tree is in the committed
    baseline (what `python -m ray_tpu_torch.devtools.lint` checks)."""
    _linter, findings, _cpu = tree
    accepted = lint.load_baseline(lint.DEFAULT_BASELINE)
    new = [f.render() for f in findings if f.fingerprint not in accepted]
    assert not new, ("raylint found NEW violations in ray_tpu_torch/ — fix "
                     "them or accept deliberately with --update-baseline:\n"
                     + "\n".join(new))
    # and nothing stale: every accepted line is still found
    assert accepted == {f.fingerprint for f in findings}


def test_tree_scan_covers_known_hot_modules(tree):
    """The scan actually sees the concurrency-heavy modules (guards against
    a silently-wrong default scan root)."""
    linter, _findings, _cpu = tree
    scanned = set(linter.src_lines)
    assert {"core/gcs_server.py", "core/core_worker.py", "core/rpc.py",
            "parallel/collectives.py", "core/object_store.py"} <= scanned
    # the RPC surface map found every service handler
    assert {"GcsService", "NodeDaemon", "WorkerService", "_OwnerService",
            "_MemberService"} <= set(linter.services)
    # the knob registry was located
    assert linter.flags and linter.flag_path == "core/config.py"


def test_default_root_is_the_port():
    assert os.path.samefile(
        os.path.dirname(os.path.dirname(os.path.abspath(lint.__file__))),
        PORT_ROOT)


# ---------------------------------------------------------------------------
# rpc-cycle (test_devtools_lint2.py)
# ---------------------------------------------------------------------------

_CYCLE_SRC = """
    import threading

    class GcsService:
        def __init__(self):
            self._daemons = Pool()
            self._server = RpcServer(self)

        def kill_node(self, addr):
            # handler blocks on an RPC whose handler can call back here
            return self._daemons.get(addr).call("drain")

    class NodeDaemon:
        def __init__(self):
            self._gcs = Client()
            self._lock = threading.Lock()
            self._server = RpcServer(self)

        def drain(self):
            return self._helper()

        def _helper(self):
            with self._lock:
                return self._gcs.call("kill_node", "self")
    """


def test_rpc_cycle_detected(tmp_path):
    _write(tmp_path, "svc.py", _CYCLE_SRC)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "rpc-cycle"]
    cycles = [f for f in findings if f.detail.startswith("cycle:")]
    assert cycles, findings
    assert "GcsService.kill_node" in cycles[0].message
    assert "NodeDaemon.drain" in cycles[0].message
    # the interprocedural hop (drain -> _helper -> .call) was followed, and
    # the lock held across the in-cycle RPC edge is flagged too
    held = [f for f in findings if f.detail.startswith("lock-held:")]
    assert held and "NodeDaemon._lock" in held[0].message, findings


def test_rpc_cycle_notify_edge_is_not_a_wait_edge(tmp_path):
    _write(tmp_path, "svc.py", _CYCLE_SRC.replace(
        '.call("drain")', '.notify("drain")'))
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "rpc-cycle"]
    # one hop became fire-and-forget: nobody parks, no cycle
    assert not [f for f in findings if f.detail.startswith("cycle:")], \
        findings


def test_rpc_lock_composition_without_handler_cycle(tmp_path):
    _write(tmp_path, "svc.py", """
        import threading

        class GcsService:
            def __init__(self):
                self._daemons = Pool()
                self._lock = threading.Lock()
                self._server = RpcServer(self)

            def update(self):
                with self._lock:
                    return self._daemons.get("x").call("apply")

            def read_state(self):
                with self._lock:
                    return 1

        class NodeDaemon:
            def __init__(self):
                self._gcs = Client()
                self._server = RpcServer(self)

            def apply(self):
                return self._gcs.call("read_state")
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "rpc-cycle"]
    # no handler->handler cycle (read_state has no outgoing edge) ...
    assert not [f for f in findings if f.detail.startswith("cycle:")]
    # ... but update blocks on apply while holding _lock, and apply calls
    # back into read_state, which NEEDS _lock: composed deadlock
    lock_rpc = [f for f in findings if f.detail.startswith("lock-rpc:")]
    assert lock_rpc, findings
    assert "GcsService._lock" in lock_rpc[0].message
    assert "GcsService.read_state" in lock_rpc[0].message


def test_rpc_cycle_lock_held_site_not_shadowed_by_unlocked_site(tmp_path):
    # the SAME edge dispatched twice — once lock-free, once under a lock:
    # collapsing to the first site must not hide the lock-held finding
    _write(tmp_path, "svc.py", """
        import threading

        class GcsService:
            def __init__(self):
                self._daemons = Pool()
                self._lock = threading.Lock()
                self._server = RpcServer(self)

            def kill_node(self, addr):
                self._daemons.get(addr).call("drain")   # lock-free first
                with self._lock:
                    return self._daemons.get(addr).call("drain")

        class NodeDaemon:
            def __init__(self):
                self._gcs = Client()
                self._server = RpcServer(self)

            def drain(self):
                return self._gcs.call("kill_node", "self")
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "rpc-cycle"]
    held = [f for f in findings if f.detail.startswith("lock-held:")]
    assert held and "GcsService._lock" in held[0].message, findings


def test_rpc_cycle_pragma_suppression(tmp_path):
    _write(tmp_path, "svc.py", _CYCLE_SRC.replace(
        'return self._daemons.get(addr).call("drain")',
        '# raylint: ignore[rpc-cycle] — reviewed: daemon never calls back\n'
        '            return self._daemons.get(addr).call("drain")'))
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "rpc-cycle" and f.detail.startswith("cycle:")]
    assert not findings, findings


# ---------------------------------------------------------------------------
# thread-leak
# ---------------------------------------------------------------------------


def test_unjoined_nondaemon_attr_thread_detected(tmp_path):
    _write(tmp_path, "mod.py", """
        import threading

        class Leaky:
            def __init__(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                pass
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "thread-leak"]
    assert len(findings) == 1 and findings[0].detail == "unjoined:_t", \
        findings


def test_annotated_assign_thread_site_is_seen(tmp_path):
    _write(tmp_path, "mod.py", """
        import threading

        class Typed:
            def __init__(self):
                self._t: threading.Thread = threading.Thread(target=print)
                self._t.start()
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "thread-leak"]
    assert len(findings) == 1 and findings[0].detail == "unjoined:_t", \
        findings


def test_joined_daemonized_and_local_threads(tmp_path):
    _write(tmp_path, "mod.py", """
        import threading

        class Fine:
            def __init__(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()
                self._d = threading.Thread(target=self._run, daemon=True)
                self._late = threading.Thread(target=self._run)
                self._late.daemon = True

            def _run(self):
                pass

            def shutdown(self):
                self._stop()

            def _stop(self):
                self._t.join(timeout=2.0)   # reachable via shutdown()

        def local_joined():
            t = threading.Thread(target=print)
            t.start()
            t.join()

        def local_leaky():
            t = threading.Thread(target=print)
            t.start()

        def anonymous_leaky():
            threading.Thread(target=print).start()
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "thread-leak"]
    details = {f.detail for f in findings}
    assert details == {"local:t", "anonymous-thread"}, findings
    assert {f.scope for f in findings} == {"local_leaky",
                                           "anonymous_leaky"}, findings


# ---------------------------------------------------------------------------
# resource-leak
# ---------------------------------------------------------------------------


def test_shm_acquire_without_release_detected(tmp_path):
    _write(tmp_path, "mod.py", """
        from multiprocessing.shared_memory import SharedMemory

        class Seg:
            def __init__(self):
                self._seg = SharedMemory(name="x", create=True, size=64)
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "resource-leak"]
    assert len(findings) == 1
    assert findings[0].detail == "unreleased:shm:_seg", findings


def test_released_resources_and_fd_cache_are_clean(tmp_path):
    _write(tmp_path, "mod.py", """
        import os
        import socket
        from multiprocessing.shared_memory import SharedMemory

        class Fine:
            def __init__(self):
                self._seg = SharedMemory(name="x", create=True, size=64)
                self._sock = socket.socket()
                self._fds = {}
                self._fds["k"] = os.open("/tmp/x", os.O_RDONLY)

            def _open_more(self, key):
                fd = os.open(key, os.O_RDONLY)
                self._fds[key] = fd

            def close(self):
                self._seg.close()
                self._seg.unlink()
                self._sock.close()
                for fd in self._fds.values():
                    os.close(fd)
                self._fds.clear()

        def local_closed():
            s = socket.socket()
            s.close()

        def local_escapes():
            s = socket.socket()
            return s
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "resource-leak"]
    assert not findings, findings


def test_local_socket_leak_detected_and_pragma(tmp_path):
    _write(tmp_path, "mod.py", """
        import socket

        def leaky():
            s = socket.socket()
            s.connect(("127.0.0.1", 1))

        def reviewed():
            # raylint: ignore[resource-leak] — reviewed: process-lifetime
            s = socket.socket()
            s.connect(("127.0.0.1", 1))
        """)
    findings = [f for f in lint.lint_tree(str(tmp_path))
                if f.check == "resource-leak"]
    assert len(findings) == 1 and findings[0].scope == "leaky", findings
    assert findings[0].detail == "local:socket:s"


def test_baseline_round_trip_new_checks(tmp_path):
    _write(tmp_path, "svc.py", _CYCLE_SRC)
    baseline = tmp_path / "baseline.txt"
    rc = lint.main([str(tmp_path), "--baseline", str(baseline), "-q"])
    assert rc == 1  # dirty vs empty baseline
    assert lint.main([str(tmp_path), "--baseline", str(baseline),
                      "--update-baseline"]) == 0
    assert lint.main([str(tmp_path), "--baseline", str(baseline),
                      "--check-baseline", "-q"]) == 0  # accepted
    _write(tmp_path, "mod2.py", """
        import threading

        class Leaky2:
            def __init__(self):
                self._t = threading.Thread(target=print)
                self._t.start()
        """)
    rc = lint.main([str(tmp_path), "--baseline", str(baseline), "-q"])
    assert rc == 1  # the NEW thread-leak fails; accepted cycle stays quiet


# ---------------------------------------------------------------------------
# report runtime: shared AST cache + --profile timings
# ---------------------------------------------------------------------------


def test_ast_cache_and_profile_timings(tmp_path, tree):
    p = _write(tmp_path, "mod.py", "x = 1\n")
    t1, _ = lint._parse_cached(str(p))
    t2, _ = lint._parse_cached(str(p))
    assert t1 is t2  # cached: same tree object, no re-parse
    p.write_text("x = 2\n")
    t3, _ = lint._parse_cached(str(p))
    assert t3 is not t1  # edit invalidates

    linter, _findings, cpu_s = tree
    assert {"parse", "scan", "lock-order", "rpc-cycle", "thread-leak",
            "resource-leak", "config-knob", "host-sync", "compile-churn",
            "total"} <= set(linter.timings)
    # the full-tree lint stays cheap enough to run inside tier-1; bounded
    # by the linter's own CPU time, which a loaded parallel suite does not
    # stretch as it stretches wall time
    assert cpu_s < 15.0, (cpu_s, linter.timings)


# ---------------------------------------------------------------------------
# coverage guard: the lifecycle and RPC passes see the port's hot modules
# ---------------------------------------------------------------------------


def test_new_checks_cover_hot_modules(tree):
    linter, findings, _cpu = tree

    by_name = {}
    for c in linter.classes:
        by_name.setdefault(c.name, c)

    # resource scan saw the daemon's spill-chunk fd cache — and the
    # shutdown path releases it
    nd = by_name["NodeDaemon"]
    assert any(s.attr == "_spill_fds" and s.is_dict and s.kind == "fd"
               for s in nd.resource_sites)
    assert not any(f.check == "resource-leak" and "_spill_fds" in f.detail
                   for f in findings)

    # thread scan saw the metrics exporter thread
    exp = by_name["MetricsExporter"]
    assert any(s.attr == "_thread" for s in exp.thread_sites)

    # the inter-process graph has real blocking edges between the services
    edges = set()
    for svc, info in linter.services.items():
        for m, sites in linter._service_rpc_closure(info).items():
            if m not in info.public_methods:
                continue
            for site in sites:
                tgt = linter._resolve_service(site.recv)
                if tgt and site.kind == "call" and \
                        site.method in linter.services[tgt].public_methods:
                    edges.add((f"{svc}.{m}", f"{tgt}.{site.method}"))
    assert ("NodeDaemon.execute_task", "WorkerService.run_task") in edges
    assert any(src.startswith("GcsService.") for src, _ in edges)

    # and the whole tree is currently wait-cycle free
    assert not [f for f in findings if f.check == "rpc-cycle"], \
        [f.render() for f in findings if f.check == "rpc-cycle"]


def test_hot_scopes_resolve_in_the_port(tree):
    """Every declared hot scope exists in the port's tree (``infer``
    included): the coverage guard is silent, and the one accepted hot-path
    read is the oracle's per-token one."""
    linter, findings, _cpu = tree
    for path in torchlint.HOT_SCOPES:
        assert path in linter.src_lines, path
    assert not [f for f in findings if "hot-scope-missing" in f.detail]
    assert [f.fingerprint for f in findings if f.check == "host-sync"] == [
        "host-sync|models/generate.py|Generator.generate|coerce:int"]
    assert torchlint.HOT_SCOPES["rllib/inference.py"] == ("infer",)


# ---------------------------------------------------------------------------
# host-sync (torch)
# ---------------------------------------------------------------------------

_HOT_HEADER = """
    import numpy as np
    import torch

    from ray_tpu_torch.devtools import jitcheck

    class Engine:
        def _run_decode(self, active):
            return self._decode(self.params, active)

"""


def _torch_findings(tmp_path, check=None):
    found = [f for f in lint.lint_tree(str(tmp_path))
             if f.check in torchlint.TORCH_CHECKS]
    if check is not None:
        found = [f for f in found if f.check == check]
    return found


class TestHostSync:
    def test_sinks_flagged_in_hot_scope(self, tmp_path):
        _write(tmp_path, "serve/llm.py", _HOT_HEADER + """
        def _step_inner(self):
            toks = self._run_decode(self._active)
            host = np.asarray(toks)         # implicit read
            first = float(toks[0])          # coercion read
            n = toks.sum().item()           # .item() read
            rows = toks.tolist()            # .tolist() read
            if toks.any():                  # truthiness read
                pass
            on_host = toks.cpu()            # copy to the host
            arr = toks.numpy()              # copy to the host
            head = rows[:toks.max()]        # __index__ of a tensor
            return host, first, n, on_host, arr, head
        """)
        found = _torch_findings(tmp_path, "host-sync")
        assert {f.detail for f in found} == {
            "np-sync:np.asarray", "coerce:float", "item:item", "item:tolist",
            "truthiness", "copy:cpu", "copy:numpy", "index"}, found
        assert {f.scope for f in found} == {"Engine._step_inner"}

    def test_taint_sources(self, tmp_path):
        _write(tmp_path, "serve/llm.py", _HOT_HEADER + """
        def _step_inner(self):
            a = torch.arange(4, device=self.device)     # torch.* call
            b = a.float().softmax(-1)                   # tensor methods
            c = self.model.forward_inference(self.params, a)  # device fn
            d = self._pick(b, 0.0)                      # tensor in, out
            n = torch.cuda.device_count()               # host-safe
            k = int(n)                                  # host value: fine
            w = int(b.shape[0]) + int(b.size(0))        # metadata: fine
            if d is None:                               # identity: fine
                pass
            return int(a[0]), bool(c), float(d)
        """)
        found = _torch_findings(tmp_path, "host-sync")
        assert {f.detail for f in found} == {
            "coerce:int", "coerce:bool", "coerce:float"}, found
        assert len(found) == 3 and {f.line for f in found} == {found[0].line}

    def test_device_get_twin_clean(self, tmp_path):
        _write(tmp_path, "serve/llm.py", _HOT_HEADER + """
        def _step_inner(self):
            toks = self._run_decode(self._active)
            host = jitcheck.device_get(toks)    # the sanctioned read
            first = float(host[0])
            n = host.sum().item()
            rows = host.tolist()
            if host.any():
                pass
            arr = host.numpy()
            return host, first, n, rows, arr[:host.max()]
        """)
        assert _torch_findings(tmp_path, "host-sync") == []

    def test_cold_files_not_patrolled(self, tmp_path):
        _write(tmp_path, "util/cold.py", """
            import torch

            def checkpoint(params):
                return torch.stack(params).cpu().numpy()  # cold path: fine
            """)
        assert _torch_findings(tmp_path, "host-sync") == []

    def test_coverage_guard_fires_on_missing_scope(self, tmp_path):
        _write(tmp_path, "rllib/inference.py", """
            class InferenceActor:
                def _run_batch(self, requests):   # the JAX actor's name
                    return None
            """)
        found = _torch_findings(tmp_path, "host-sync")
        assert len(found) == 1
        assert "infer" in found[0].message
        assert "torchlint.HOT_SCOPES" in found[0].message
        assert found[0].detail == "hot-scope-missing:infer"

    def test_nested_generator_is_walked(self, tmp_path):
        _write(tmp_path, "models/generate.py", _HOT_HEADER + """
        def generate(self, prompt):
            last = self._prefill(self.params, torch.as_tensor(prompt))

            def run():
                nxt = last
                while True:
                    yield int(nxt[0])       # per-token read in the closure
            return run()
        """)
        found = _torch_findings(tmp_path, "host-sync")
        assert [f.detail for f in found] == ["coerce:int"]
        assert found[0].scope == "Engine.generate"


# ---------------------------------------------------------------------------
# compile-churn
# ---------------------------------------------------------------------------


class TestCompileChurn:
    def test_local_compile_flagged(self, tmp_path):
        _write(tmp_path, "mod.py", """
            import torch

            class Model:
                def evaluate(self, xs):
                    fwd = torch.compile(self.forward)   # rebuilt per call
                    return [fwd(x) for x in xs]
            """)
        found = _torch_findings(tmp_path, "compile-churn")
        assert len(found) == 1 and "fwd" in found[0].message
        assert found[0].scope == "Model.evaluate"
        assert found[0].detail == "local-compile:fwd"

    def test_immediate_and_partial_forms_flagged(self, tmp_path):
        _write(tmp_path, "mod.py", """
            import functools
            import torch

            def step(f, x):
                return torch.compile(f)(x)   # compile-and-discard per call

            def run(f, x):
                g = functools.partial(torch.compile, mode="max-autotune")(f)
                return g(x)

            def nested(x):
                @torch.compile
                def inner(y):
                    return y * 2
                return inner(x)
            """)
        found = _torch_findings(tmp_path, "compile-churn")
        assert {f.scope for f in found} == {"step", "run", "nested"}, found
        assert {f.detail.split(":")[0] for f in found} == {
            "immediate-compile-call", "local-compile"}

    def test_cached_factory_and_module_scope_clean(self, tmp_path):
        _write(tmp_path, "mod.py", """
            import torch

            top = torch.compile(lambda x: x)     # module scope: once

            class Model:
                def __init__(self):
                    self._fwd = torch.compile(self.forward)   # cached

                def lazy(self):
                    if self._fwd is None:
                        self._fwd = torch.compile(self.forward)
                    return self._fwd

                def build(self):
                    return torch.compile(self.forward)  # one-shot factory

                def build2(self):
                    f = torch.compile(self.forward)     # escapes via return
                    return f

                def register(self, table):
                    f = torch.compile(self.forward)     # escapes into a call
                    table.add(f)

                def cache_slot(self, table, k):
                    f = torch.compile(self.forward)     # escapes via slot
                    table[k] = f
            """)
        assert _torch_findings(tmp_path, "compile-churn") == []

    def test_builtin_compile_is_not_torch_compile(self, tmp_path):
        _write(tmp_path, "mod.py", """
            def run(src):
                code = compile(src, "<s>", "exec")   # Python's builtin
                return code
            """)
        assert _torch_findings(tmp_path, "compile-churn") == []


# ---------------------------------------------------------------------------
# pragmas, baseline, profile
# ---------------------------------------------------------------------------


class TestSuppression:
    def test_pragma_suppresses_torch_checks(self, tmp_path):
        _write(tmp_path, "mod.py", """
            import torch

            def churn(f, x):
                # raylint: ignore[compile-churn]
                g = torch.compile(f)
                return g(x)
            """)
        _write(tmp_path, "models/generate.py", _HOT_HEADER + """
        def generate(self, prompt):
            nxt = torch.as_tensor(prompt)
            return int(nxt[0])  # raylint: ignore[host-sync] — reviewed
        """)
        assert _torch_findings(tmp_path) == []

    def test_baseline_round_trip(self, tmp_path):
        _write(tmp_path, "models/generate.py", _HOT_HEADER + """
        def generate(self, prompt):
            nxt = torch.as_tensor(prompt)
            return int(nxt[0])
        """)
        baseline = tmp_path / "baseline.txt"
        assert lint.main([str(tmp_path), "--baseline", str(baseline),
                          "-q"]) == 1
        assert lint.main([str(tmp_path), "--baseline", str(baseline),
                          "--update-baseline"]) == 0
        assert baseline.read_text().splitlines()[2:] == [
            "host-sync|models/generate.py|Engine.generate|coerce:int"]
        assert lint.main([str(tmp_path), "--baseline", str(baseline),
                          "-q"]) == 0
        # fingerprints are line-free: shifting the finding keeps it accepted
        p = tmp_path / "models" / "generate.py"
        p.write_text("# moved\n" + p.read_text())
        assert lint.main([str(tmp_path), "--baseline", str(baseline),
                          "-q"]) == 0

    def test_profile_reports_torch_phases(self, tmp_path, capsys):
        _write(tmp_path, "mod.py", "x = 1\n")
        linter = lint.Linter(str(tmp_path))
        linter.run()
        for phase in torchlint.TORCH_CHECKS:
            assert phase in linter.timings
        assert lint.main([str(tmp_path), "--no-baseline", "--profile"]) == 0
        err = capsys.readouterr().err
        for phase in torchlint.TORCH_CHECKS + ("scan", "total"):
            assert f"  {phase} " in err, err


# ---------------------------------------------------------------------------
# the gate with the JAX package out of reach
# ---------------------------------------------------------------------------


def test_gate_runs_with_jax_and_ray_tpu_blocked():
    """``lint.main(["--check-baseline"])`` in a fresh interpreter that
    refuses ``jax`` and ``ray_tpu``: the port's lint needs neither (nor
    torch), and passes."""
    code = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu'):
                    raise ImportError('blocked: ' + name)
        sys.meta_path.insert(0, Block())
        from ray_tpu_torch.devtools import lint
        rc = lint.main(["--check-baseline"])
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'ray_tpu', 'torch'))
        print('RC', rc, 'MODULES', bad)
        sys.exit(rc)
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "RC 0 MODULES []" in out.stdout, out.stdout
    assert "raylint: clean" in out.stdout, out.stdout

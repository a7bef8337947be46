"""The port's raylint (``ray_tpu_torch.devtools.lint``) held finding for
finding against the JAX package's (``ray_tpu.devtools.lint``), on the CPU.

(a) Every seeded fixture of ``test_devtools_lint.py`` and
    ``test_devtools_lint2.py`` (read out of those files: the ``_write``
    calls of each test) gives the same findings under both linters.
(b) Over the JAX tree ``ray_tpu/`` the port's ``Linter`` gives exactly the
    JAX ``Linter``'s findings for the nine shared checks, and sees the same
    services and knobs.
(c) Every line of the port's baseline is the twin of a JAX baseline line
    under :data:`RENAMES`, or a named design difference
    (:data:`BY_DESIGN`); every JAX line without a twin is named with its
    reason (:data:`JAX_ONLY`).
(d) The port's ``host-sync`` finding on ``Generator.generate`` (the
    oracle's per-token ``int(nxt[0])``) has the JAX finding's fingerprint.
"""

import ast
import shutil
import textwrap
from pathlib import Path

import pytest

from ray_tpu.devtools import lint as jax_lint
from ray_tpu_torch.devtools import lint as port_lint

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent

#: the nine checks both linters run (plus the parse failure both report)
SHARED = ("lock-order", "blocking-under-lock", "untimed-wait",
          "swallowed-exception", "rpc-surface", "config-knob", "rpc-cycle",
          "thread-leak", "resource-leak", "parse-error")

#: port name -> JAX name, for the baseline's twins
RENAMES = {"_TorchBackend": "_JaxBackend"}

#: port baseline lines that are design differences, with the reason
BY_DESIGN = {
    "config-knob|core/config.py|Config|unused:rl_inference_max_batch":
        "kept for a shared configuration; the port's InferenceActor fuses "
        "no requests (a fused CPU forward breaks bit-identity with "
        "runner-local sampling)",
    "config-knob|core/config.py|Config|unused:rl_inference_window_s":
        "as rl_inference_max_batch: no batching window to wait out",
}

#: JAX baseline lines with no port twin, with the reason
JAX_ONLY = {
    "swallowed-exception|autoscaler/node_provider.py|"
    "TPUPodNodeProvider._bind_node_id|except-pass":
        "the port has no TPU pod node provider",
    "swallowed-exception|dag/device_channel.py|"
    "DeviceChannel._complete_pending_ack|except-pass":
        "JAX waits out a donated array's DMA; the port's device channel "
        "holds its tensor and swallows nothing",
    "swallowed-exception|train/backend.py|_setup_jax_worker|except-pass":
        "the port's _setup_torch_worker swallows nothing",
}


def _render(findings, checks=SHARED):
    return sorted((f.check, f.path, f.line, f.scope, f.message, f.fingerprint)
                  for f in findings if f.check in checks)


# ---------------------------------------------------------------------------
# (a) the seeded fixtures of the JAX lint tests
# ---------------------------------------------------------------------------


def _seeded_fixtures():
    """(id, [(rel, source)]) for every test function of the JAX lint tests
    that writes files through ``_write``; module-level string constants
    (``_CYCLE_SRC``) are evaluated so ``.replace(...)`` variants resolve."""
    out = []
    for name in ("test_devtools_lint.py", "test_devtools_lint2.py"):
        tree = ast.parse((TESTS / name).read_text())
        ns = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, (ast.Constant, ast.BinOp)):
                exec(compile(ast.Module([node], []), name, "exec"), ns)
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            files = []
            for call in ast.walk(fn):
                if (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Name)
                        and call.func.id == "_write"):
                    rel, src = (eval(compile(ast.Expression(a), name, "eval"),
                                     dict(ns)) for a in call.args[1:3])
                    files.append((rel, src))
            if files:
                out.append((f"{name[:-3]}::{fn.name}", files))
    return out


_FIXTURES = _seeded_fixtures()


def test_every_seeded_fixture_is_read():
    # 23 of the 26 lint tests write a fixture (the three whole-tree tests
    # do not)
    assert len(_FIXTURES) == 23, [i for i, _ in _FIXTURES]


@pytest.mark.parametrize("files", [f for _, f in _FIXTURES],
                         ids=[i for i, _ in _FIXTURES])
def test_seeded_fixture_same_findings(tmp_path, files):
    for rel, src in files:
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    jax_found = jax_lint.lint_tree(str(tmp_path))
    port_found = port_lint.lint_tree(str(tmp_path))
    assert _render(port_found) == _render(jax_found)
    # and neither tier adds anything here: whole fingerprint sets agree
    assert sorted(f.fingerprint for f in port_found) == \
        sorted(f.fingerprint for f in jax_found)


# ---------------------------------------------------------------------------
# (b) the JAX tree under both linters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tree():
    root = str(ROOT / "ray_tpu")
    jl, pl = jax_lint.Linter(root), port_lint.Linter(root)
    return jl, jl.run(), pl, pl.run()


def test_jax_tree_same_findings_for_shared_checks(jax_tree):
    jl, jax_found, pl, port_found = jax_tree
    assert _render(port_found) == _render(jax_found)
    assert _render(jax_found), "the JAX tree has baselined findings"


def test_jax_tree_same_model(jax_tree):
    jl, _jf, pl, _pf = jax_tree
    assert set(pl.services) == set(jl.services)
    assert pl.flags == jl.flags and pl.flag_path == jl.flag_path
    assert sorted(pl.rpc_sites) == sorted(jl.rpc_sites)
    assert set(pl.src_lines) == set(jl.src_lines)


# ---------------------------------------------------------------------------
# (c) the port's baseline: twins and named differences
# ---------------------------------------------------------------------------


def _twin(line: str) -> str:
    for port_name, jax_name in RENAMES.items():
        line = line.replace(port_name, jax_name)
    return line


def test_port_baseline_lines_are_jax_twins_or_by_design():
    port = port_lint.load_baseline(port_lint.DEFAULT_BASELINE)
    jax = jax_lint.load_baseline(jax_lint.DEFAULT_BASELINE)
    assert port, "the port's baseline exists"
    unexplained = sorted(line for line in port
                         if line not in BY_DESIGN and _twin(line) not in jax)
    assert not unexplained, unexplained
    assert set(BY_DESIGN) <= port
    twins = {_twin(line) for line in port if line not in BY_DESIGN}
    assert sorted(jax - twins) == sorted(JAX_ONLY)


# ---------------------------------------------------------------------------
# (d) the oracle's per-token read
# ---------------------------------------------------------------------------


def test_generate_host_sync_has_jax_fingerprint(tmp_path):
    found = {}
    for pkg, mod in (("ray_tpu", jax_lint), ("ray_tpu_torch", port_lint)):
        dst = tmp_path / pkg / "models" / "generate.py"
        dst.parent.mkdir(parents=True)
        shutil.copy(ROOT / pkg / "models" / "generate.py", dst)
        found[pkg] = sorted(f.fingerprint
                            for f in mod.lint_tree(str(tmp_path / pkg))
                            if f.check == "host-sync")
    assert found["ray_tpu_torch"] == found["ray_tpu"] == [
        "host-sync|models/generate.py|Generator.generate|coerce:int"]

"""The import audit: nothing a run loads is JAX or the JAX package, and the
reference loads nothing of the port. Top-level module names are compared
whole: ``ray_tpu_torch`` begins with ``ray_tpu`` and is the port.

Each check runs in a fresh interpreter with ``jax`` and ``ray_tpu`` blocked
in ``sys.modules``, so an import of either fails loudly instead of passing
unseen; then the loaded modules are listed by top-level name."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap

import pytest

from portbench.tests.conftest import REPO

BLOCK = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "flax", "ray_tpu"):
        sys.modules[name] = None
    sys.path.insert(0, {repo!r})
""")


def _python(code: str, cwd=None):
    return subprocess.run([sys.executable, "-c", BLOCK.format(repo=str(REPO))
                           + textwrap.dedent(code)], capture_output=True,
                          text=True, timeout=600, cwd=cwd)


def _tops(stdout: str):
    return set(json.loads(stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tmp_path):
    """Both tiny cells run end to end, metrics read, with JAX blocked."""
    code = f"""
    import json, sys
    sys.path.insert(0, {str(REPO / 'portbench' / 'tests')!r})
    from pathlib import Path
    import conftest
    from portbench import run
    root = conftest.make_checkout(Path({str(tmp_path)!r}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell in ("tiny.train", "tiny.serve"):
        for trace in (False, True):
            r, line = run.run_cell(root, bench, cell, 2**35 + 1, 0.5, trace,
                                   "cpu")
            assert line["correct"], line
    import portbench.calibrate
    assert run.loaded_forbidden() == [], run.loaded_forbidden()
    print(json.dumps(sorted({{m.split(".")[0]
                              for m, v in sys.modules.items() if v}})))
    """
    p = _python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = _tops(p.stdout)
    assert "ray_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "ray_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    p = _python("""
    import json, sys
    import portbench.reference.gpt2, portbench.check, portbench.roofline
    import portbench.weights, portbench.traffic.train, portbench.traffic.serve
    print(json.dumps(sorted({m.split(".")[0]
                              for m, v in sys.modules.items() if v})))
    """)
    assert p.returncode == 0, p.stderr[-3000:]
    assert not _tops(p.stdout) & {"jax", "jaxlib", "flax", "ray_tpu",
                                  "ray_tpu_torch"}


@pytest.mark.parametrize("path", sorted(
    (REPO / "portbench").rglob("*.py"), key=str), ids=lambda p: str(
        p.relative_to(REPO)))
def test_no_source_imports_jax(path):
    """Every module of the benchmark, by its import statements; the
    reference also imports nothing of the port."""
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif (isinstance(node, ast.ImportFrom) and node.module
              and not node.level):
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "flax", "ray_tpu"}
    if "reference" in path.parts:
        assert "ray_tpu_torch" not in tops


def test_the_command_refuses_without_a_card(tmp_path):
    """No CUDA card (this host): exit code 2 and no result line."""
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "gpt2-xl.train", "--seed", str(2**33), "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_the_command_fails_with_the_benchmark_alone(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ has no
    program to run: a non-zero exit and no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "gpt2-xl.serve-decode", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.gpu
def test_tiny_cells_on_the_card(tmp_path):
    """Both tiny cells through the harness on the card, traced: the
    profiler's window reads device time."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(REPO / "portbench" / "tests"))
    import conftest

    from portbench import run

    root = conftest.make_checkout(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell in ("tiny.train", "tiny.serve"):
        r, line = run.run_cell(root, bench, cell, 2**35 + 3, 1.0, True, "cuda")
        assert line["correct"], line["check"]
        assert line["device"]["busy_s"] > 0
        assert 0 <= line["metrics"][f"device_idle_share.{cell[5:]}"][
            "value"] <= 100

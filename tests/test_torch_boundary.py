"""The port's import boundary: ``ray_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX and nothing of the JAX package ``ray_tpu``.

Every ``.py`` file is walked with ``ast`` (imports inside functions count
too), and the runtime, serving and training entry modules are imported in a
fresh interpreter with ``jax`` blocked from import (the Serve stack's
ingress modules too: they import aiohttp and grpcio only when a proxy
starts). The same walk holds the port's device rule: no function of the
port takes a ``device`` that defaults to the CPU (entry points run on the
card unless asked otherwise).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401 — the suite's files import both frameworks
import numpy as np  # noqa: F401
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in FORBIDDEN


def test_port_files_exist():
    files = _port_files()
    assert all(f.is_file() for f in files), [f for f in files
                                             if not f.is_file()]
    assert len(files) > 10


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_imports(path):
    bad = [(ln, m) for ln, m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _cpu_device_defaults(path: Path):
    """(line, function) of every parameter named ``device`` whose default
    is the string ``"cpu"``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = node.args
        positional = args.posonlyargs + args.args
        pairs = list(zip(positional[len(positional) - len(args.defaults):],
                         args.defaults))
        pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            if (arg.arg == "device" and isinstance(default, ast.Constant)
                    and default.value == "cpu"):
                yield node.lineno, node.name


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_device_defaults_to_the_cpu(path):
    bad = list(_cpu_device_defaults(path))
    assert not bad, f"{path.relative_to(ROOT)}: device='cpu' defaults {bad}"


def test_cpu_default_rule_sees_both_forms(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def a(x, device='cpu'): pass\n"
                 "def b(*, device='cpu'): pass\n"
                 "def c(device=None): pass\n")
    assert [n for _, n in _cpu_device_defaults(f)] == ["a", "b"]


def test_forbidden_rule_keeps_the_port_prefix():
    assert not _forbidden("ray_tpu_torch.serve.llm")
    assert _forbidden("ray_tpu.serve.llm")
    assert _forbidden("ray_tpu")
    assert _forbidden("jax.numpy")


def test_serving_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'flax', 'optax', 'ray_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import ray_tpu_torch, ray_tpu_torch.core.placement_group\n"
        "import ray_tpu_torch.util.state, ray_tpu_torch.devtools.jitcheck\n"
        "import ray_tpu_torch.accelerators, ray_tpu_torch.core.native_store\n"
        "import ray_tpu_torch.serve.llm, ray_tpu_torch.models.convert\n"
        "import ray_tpu_torch.ops.paged_attention\n"
        "import ray_tpu_torch.ops.flash_attention\n"
        "import ray_tpu_torch.models.transformer, ray_tpu_torch.models.training\n"
        "import ray_tpu_torch.serve.dag_pipeline, ray_tpu_torch.dag.channel\n"
        "import ray_tpu_torch.util.tracing, ray_tpu_torch.util.flightrec\n"
        "import ray_tpu_torch.core.metrics_export\n"
        "import ray_tpu_torch.core.serialization\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.serve.proxy\n"
        "import ray_tpu_torch.serve.grpc_proxy, ray_tpu_torch.serve.proxy_state\n"
        "import ray_tpu_torch.utils.eventloop\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"

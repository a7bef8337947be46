"""The port's import boundary: ``ray_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX, nothing of the JAX package ``ray_tpu`` and no ``ml_dtypes``
(the card's machine does not list it: bf16 travels as torch tensors or raw
16-bit words).

Every ``.py`` file is walked with ``ast`` (imports inside functions count
too), and the runtime, serving and training entry modules are imported in a
fresh interpreter with ``jax`` blocked from import (the Serve stack's
ingress modules too: they import aiohttp and grpcio only when a proxy
starts). The same walk holds the port's device rule: no function of the
port takes a ``device`` that defaults to the CPU (entry points run on the
card unless asked otherwise).

Processes are started by module name, so a string is a boundary too: no
string constant of the port or of ``chip_smoke.py`` (docstrings aside) may
name a module of the JAX package (a ``-m ray_tpu.core.worker_main`` target,
an ``importlib`` path). A port ``Cluster`` is started with an import blocker
in every process it spawns (a ``sitecustomize`` on their ``PYTHONPATH``):
its GCS, node daemons and workers run the port's modules (their
``/proc/<pid>/cmdline``) and import no ``jax`` and no ``ray_tpu``.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401 — the suite's files import both frameworks
import numpy as np  # noqa: F401
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu", "ml_dtypes")


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


# A whole dotted name; a file path (``ray_tpu/ops/...``, the TPU kernels
# the kernels line names) or the head of a longer name is not one.
_MODULE_NAME = re.compile(r"\bray_tpu(?:\.[A-Za-z_]\w*)*(?![\w./])")


def _names_jax_package_module(text: str):
    """The dotted names in ``text`` that are modules of the JAX package
    (``ray_tpu``, ``ray_tpu.core.worker_main``: a file or a package under
    ``ray_tpu/``). A name that only starts like one (``ray_tpu.serve.
    RayTpuServe``, a gRPC service name) is not."""
    for m in _MODULE_NAME.finditer(text):
        parts = m.group(0).split(".")
        base = ROOT.joinpath(*parts)
        if base.with_suffix(".py").is_file() or (base / "__init__.py").is_file():
            yield m.group(0)


def _module_name_strings(path: Path):
    """(line, name) of every string constant, docstrings aside, that names
    a module of the JAX package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docstrings.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            for name in _names_jax_package_module(node.value):
                yield node.lineno, name


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_names_a_jax_package_module(path):
    bad = list(_module_name_strings(path))
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_module_string_rule_sees_targets_not_lookalikes(tmp_path):
    f = tmp_path / "m.py"
    f.write_text('"""Docs may say ray_tpu.core.worker_main."""\n'
                 'a = [sys.executable, "-m", "ray_tpu.core.worker_main"]\n'
                 'b = importlib.import_module("ray_tpu.serve.llm")\n'
                 'c = "python -m ray_tpu.core.gcs_server --port 0"\n'
                 'd = "ray_tpu"\n'
                 'e = "-m ray_tpu_torch.core.worker_main"\n'
                 'f = "/ray_tpu.serve.RayTpuServe/Call"\n'
                 'g = "ray_tpu_serve_tokens_total"\n'
                 'h = "ray_tpu/ops/paged_attention.py:49"\n')
    assert sorted(ln for ln, _ in _module_name_strings(f)) == [2, 3, 4, 5]


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
    assert _forbidden("ml_dtypes")


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
        "import ray_tpu_torch.core.gcs_server, ray_tpu_torch.core.node_daemon\n"
        "import ray_tpu_torch.core.worker_main, ray_tpu_torch.core.cluster\n"
        "import ray_tpu_torch.core.core_worker, ray_tpu_torch.core.rpc\n"
        "import ray_tpu_torch.core.object_transfer\n"
        "import ray_tpu_torch.core.sim_cluster, ray_tpu_torch.core.health\n"
        "import ray_tpu_torch.core.gcs_shards, ray_tpu_torch.core.ingest\n"
        "import ray_tpu_torch.core.lease_table, ray_tpu_torch.runtime_env\n"
        "import ray_tpu_torch.parallel.mesh, ray_tpu_torch.parallel.sharding\n"
        "import ray_tpu_torch.parallel.spmd, ray_tpu_torch.parallel.launch\n"
        "import ray_tpu_torch.parallel.ring_attention\n"
        "import ray_tpu_torch.parallel.pipeline, ray_tpu_torch.entry\n"
        "import ray_tpu_torch.ops.moe, ray_tpu_torch.models.mlp\n"
        "import ray_tpu_torch.train, ray_tpu_torch.tune\n"
        "import ray_tpu_torch.tune.experiment_state\n"
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


_BLOCKER = """
import os, sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "ray_tpu"):
            with open(os.environ["BOUNDARY_LOG"], "a") as f:
                f.write(f"{os.getpid()} {name}\\n")
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, _Block())
"""


def test_cluster_processes_import_no_jax_or_ray_tpu(tmp_path, monkeypatch):
    """A port ``Cluster`` whose every process starts with the blocker: the
    GCS, the daemons and their workers run the port's modules, a task and
    an actor run in workers, and no process tries to import JAX or the
    JAX package."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    log = tmp_path / "blocked.log"
    monkeypatch.setenv("BOUNDARY_LOG", str(log))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(site)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.cluster import Cluster

    def cmdline(pid):
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().split(b"\0")

    def modules():
        import sys as _sys

        return os.getpid(), sorted({m.split(".")[0] for m in _sys.modules})

    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 1})
    try:
        rt.init(address=cluster.gcs_address)
        try:
            pid, tops = rt.get(rt.remote(modules).remote(), timeout=120)
            actor = rt.remote(type("Probe", (), {
                "modules": lambda self: modules()})).remote()
            apid, atops = rt.get(actor.modules.remote(), timeout=120)
            workers = [p for i in range(2) for p in cluster.worker_pids(i)]
        finally:
            rt.shutdown()
        targets = {
            cluster.gcs_proc.pid: b"ray_tpu_torch.core.gcs_server",
            **{h.proc.pid: b"ray_tpu_torch.core.node_daemon"
               for h in cluster.nodes},
            **{w: b"ray_tpu_torch.core.worker_main" for w in workers}}
        assert pid in workers and apid in workers
        for p, module in targets.items():
            argv = cmdline(p)
            assert argv[1:3] == [b"-m", module], (p, argv)
    finally:
        cluster.shutdown()
    for t in (tops, atops):
        assert "ray_tpu_torch" in t
        assert not {"jax", "jaxlib", "flax", "optax", "ray_tpu"} & set(t), t
    assert not log.exists(), log.read_text()

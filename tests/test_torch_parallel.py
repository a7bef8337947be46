"""The port's parallel layer (``ray_tpu_torch/parallel``) against JAX's
``tests/test_parallel.py``: mesh construction, logical shardings, ring and
Ulysses attention, the GPipe pipeline.

torch runs SPMD as one process per rank, so the port's side runs in one
world of 8 gloo CPU ranks (``parallel/launch.py``) for the whole module,
every case in turn (``tests/torch_mesh_cases.py``); JAX's side runs here on
its 8 virtual CPU devices, meanwhile, on the same numpy inputs. Tolerances
are JAX's own (2e-5 on attention, 1e-5 on the pipeline), in f32. Then the
port's own: a world-1 mesh with no process group, the launcher's deadline
and its failure report.
"""

import concurrent.futures
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import jax
import torch_mesh_cases
import jax.numpy as jnp

from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import cpu_mesh as jcpu_mesh
from ray_tpu.parallel.pipeline import make_pipeline as jmake_pipeline
from ray_tpu.parallel.ring_attention import (
    make_ring_attention as jmake_ring,
    make_ulysses_attention as jmake_ulysses,
    reference_attention as jreference,
)
from ray_tpu.parallel.sharding import ShardingRules as JRules
from ray_tpu.parallel.sharding import logical_sharding as jlogical_sharding
from ray_tpu_torch.parallel.launch import WorldError, run_world
from ray_tpu_torch.parallel.mesh import MeshSpec, mesh_shape

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

WORLD = 8


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _pipeline_inputs():
    n_stages, n_mb, mb, dim = 4, 6, 4, 8
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(n_stages, dim, dim)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(n_stages, dim)) * 0.1).astype(np.float32)
    x = rng.normal(size=(mb, n_mb, dim)).astype(np.float32)
    return w, b, x, n_mb


@pytest.fixture(scope="module")
def results():
    ring_in = _qkv(0, (2, 32, 4, 16))
    heads_in = _qkv(1, (2, 16, 4, 8))
    uly_in = _qkv(2, (2, 16, 4, 8))
    w, b, x, n_mb = _pipeline_inputs()
    cases = [
        ("construction", "mesh_construction", dict(spec=dict(data=2, tensor=4))),
        ("wildcard", "mesh_construction", dict(spec=dict(data=-1, tensor=2))),
        ("mismatch", "mesh_mismatch", dict(spec=dict(data=3, tensor=5))),
        ("rules", "logical_rules", dict(spec=dict(data=2, tensor=4))),
        ("shard_tree", "shard_tree", dict(spec=dict(data=2, tensor=4))),
    ]
    for causal in (False, True):
        q, k, v = ring_in
        cases.append((f"ring_{causal}", "ring", dict(
            spec=dict(seq=8), q=q, k=k, v=v, causal=causal)))
        q, k, v = uly_in
        cases.append((f"ulysses_{causal}", "ulysses", dict(
            spec=dict(seq=4), q=q, k=k, v=v, causal=causal)))
    q, k, v = heads_in
    cases.append(("ring_heads", "ring", dict(
        spec=dict(seq=4, tensor=2), q=q, k=k, v=v, causal=True)))
    cases.append(("pipeline", "pipeline", dict(
        spec=dict(pipe=4, data=2), params=(w, b), x=x, num_microbatches=n_mb)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(torch_mesh_cases.run_world_in_turn,
                            _run_cases, WORLD, cases,
                            timeout_s=240)
        ref = {}
        for causal in (False, True):
            ref[f"ring_{causal}"] = jax.jit(jmake_ring(
                jcpu_mesh(JMeshSpec(seq=8)), causal=causal))(*ring_in)
            ref[f"ulysses_{causal}"] = jax.jit(jmake_ulysses(
                jcpu_mesh(JMeshSpec(seq=4)), causal=causal))(*uly_in)
        ref["ring_heads"] = jax.jit(jmake_ring(
            jcpu_mesh(JMeshSpec(seq=4, tensor=2)), causal=True))(*heads_in)
        ref["pipeline"] = jax.jit(jmake_pipeline(
            lambda p, h: jnp.tanh(h @ p[0] + p[1]),
            jcpu_mesh(JMeshSpec(pipe=4, data=2)),
            num_microbatches=n_mb))((w, b), x)
        # JAX's own oracles, as its tests hold them
        oracle = {k: jreference(*ring_in, causal=c)
                  for k, c in (("ring_False", False), ("ring_True", True))}
        oracle.update({f"ulysses_{c}": jreference(*uly_in, causal=c)
                       for c in (False, True)})
        oracle["ring_heads"] = jreference(*heads_in, causal=True)
        got = world.result()[0]
    return got, ref, oracle


def _run_cases(rank, world, cases):
    import torch_mesh_cases

    return torch_mesh_cases.run_cases(rank, world, cases)


def _ok(res, name):
    r = res[0][name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(f"{name} failed on the ranks:\n{r['error']}")
    return r


def test_mesh_construction(results):
    r = _ok(results, "construction")
    assert r["shape"]["data"] == 2 and r["shape"]["tensor"] == 4
    assert int(np.prod(list(r["shape"].values()))) == 8
    jmesh = jcpu_mesh(JMeshSpec(data=2, tensor=4))
    assert r["names"] == tuple(jmesh.axis_names)
    assert r["shape"] == dict(zip(jmesh.axis_names, jmesh.devices.shape))


def test_mesh_wildcard(results):
    assert _ok(results, "wildcard")["shape"]["data"] == 4
    assert MeshSpec(data=-1, tensor=2).resolve(8) == MeshSpec(data=4, tensor=2)


def test_mesh_mismatch_raises(results):
    msg = _ok(results, "mismatch")
    assert msg is not None and "devices" in msg
    with pytest.raises(ValueError, match="devices"):
        MeshSpec(data=3, tensor=5).resolve(8)


def test_logical_sharding_rules(results):
    r = _ok(results, "rules")
    jmesh = jcpu_mesh(JMeshSpec(data=2, tensor=4))
    for logical in (("embed", "mlp"), ("batch", None, "heads")):
        axes, placements = r[logical]
        assert axes == tuple(jlogical_sharding(jmesh, JRules(), logical).spec)
    # On the active sub-mesh (data=2, tensor=4): fsdp has size 1.
    assert r[("embed", "mlp")][1] == ("R", "S(1)")
    assert r[("batch", None, "heads")][1] == ("S(0)", "S(2)")
    assert "unknown logical axis" in r["bogus"]


def test_shard_pytree_places_arrays(results):
    r = _ok(results, "shard_tree")
    assert r["w_placements"] == ("R", "S(1)")
    assert r["w_local"] == (16, 8)
    np.testing.assert_array_equal(r["w"], np.ones((16, 32)))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_oracle(results, causal):
    out = _ok(results, f"ring_{causal}")
    _, ref, oracle = results
    np.testing.assert_allclose(out, np.asarray(ref[f"ring_{causal}"]),
                               atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(oracle[f"ring_{causal}"]),
                               atol=2e-5)


def test_ring_attention_with_tensor_heads(results):
    out = _ok(results, "ring_heads")
    _, ref, oracle = results
    np.testing.assert_allclose(out, np.asarray(ref["ring_heads"]), atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(oracle["ring_heads"]),
                               atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_oracle(results, causal):
    out = _ok(results, f"ulysses_{causal}")
    _, ref, oracle = results
    np.testing.assert_allclose(out, np.asarray(ref[f"ulysses_{causal}"]),
                               atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(oracle[f"ulysses_{causal}"]),
                               atol=2e-5)


def test_pipeline_matches_serial(results):
    out = _ok(results, "pipeline")
    _, ref, _ = results
    w, b, x, _ = _pipeline_inputs()
    expect = x
    for s in range(4):
        expect = np.tanh(expect @ w[s] + b[s])
    np.testing.assert_allclose(out, np.asarray(ref["pipeline"]), atol=1e-5)
    np.testing.assert_allclose(out, expect, atol=1e-5)


def test_mesh_shape_and_tiers_match_jax():
    from ray_tpu.parallel import mesh as jm
    from ray_tpu_torch.parallel import mesh as tm

    assert tm.AXIS_ORDER == jm.AXIS_ORDER and tm.AXIS_TIER == jm.AXIS_TIER
    for spec in (dict(data=-1), dict(data=2, tensor=-1), dict(pipe=2, seq=4)):
        assert (tm.MeshSpec(**spec).resolve(8).sizes()
                == jm.MeshSpec(**spec).resolve(8).sizes())
        assert (tm.MeshSpec(**spec).resolve(8).axis_names()
                == jm.MeshSpec(**spec).resolve(8).axis_names())
    assert mesh_shape is tm.mesh_shape


def test_world_of_one_without_process_group():
    """make_mesh over one device starts a world-1 group itself (gloo on
    the CPU); best_devices refuses the card where there is none."""
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        from torch.distributed.tensor import DTensor
        from ray_tpu_torch.parallel.mesh import (MeshSpec, best_devices,
            compute_mesh, make_mesh, mesh_shape)
        from ray_tpu_torch.parallel.sharding import ShardingRules, shard_pytree
        assert not dist.is_initialized()
        mesh = make_mesh(MeshSpec(data=-1), device_type="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert mesh_shape(mesh) == dict(data=1, fsdp=1, expert=1, pipe=1,
                                        seq=1, tensor=1), mesh_shape(mesh)
        p = shard_pytree({"w": torch.ones(4, 8)}, {"w": ("embed", "mlp")},
                         mesh, ShardingRules())
        assert isinstance(p["w"], DTensor)
        assert compute_mesh(mesh).mesh_dim_names == ("data",)
        y = (p["w"] * 2).full_tensor()
        assert torch.equal(y, torch.full((4, 8), 2.0))
        if not torch.cuda.is_available():
            try:
                best_devices()
            except RuntimeError as e:
                assert "no CUDA device" in str(e)
            else:
                raise AssertionError("best_devices found no card and said nothing")
        dist.destroy_process_group()
        print("OK")
    """)
    root = str(Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), \
        out.stderr[-3000:]


def _hang_rank(rank, world, pid_dir):
    import torch_mesh_cases

    return torch_mesh_cases.hang_rank(rank, world, pid_dir)


def _fail_rank(rank, world):
    import torch_mesh_cases

    return torch_mesh_cases.fail_rank(rank, world)


def test_launcher_kills_a_hung_world_within_its_deadline():
    with tempfile.TemporaryDirectory() as pid_dir:
        t0 = time.monotonic()
        with pytest.raises(WorldError, match="not done within"):
            run_world(_hang_rank, 2, pid_dir, timeout_s=15)
        assert time.monotonic() - t0 < 30
        pids = [int(open(os.path.join(pid_dir, f)).read())
                for f in sorted(os.listdir(pid_dir))]
        assert len(pids) == 2
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="KeyError: 'rank one fails'"):
        run_world(_fail_rank, 2, timeout_s=120)
    assert time.monotonic() - t0 < 60

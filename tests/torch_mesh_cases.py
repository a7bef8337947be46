"""Per-rank bodies of the port's mesh tests (``test_torch_parallel.py``,
``test_torch_models_sharded.py``, ``test_torch_moe_pipeline.py``).

Each world of gloo CPU ranks (``ray_tpu_torch.parallel.launch.run_world``)
runs :func:`run_cases` once: every rank runs every case in order, and rank
0 returns ``{case name: result}`` (numpy arrays and plain values; a case
that raised gives ``{"error": traceback}``). Inputs arrive as numpy arrays
made by the tests, the same ones the JAX functions get. No JAX here: the
ranks import torch only.
"""

import contextlib
import fcntl
import os
import tempfile
import time
import traceback

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def one_world_at_a_time():
    """Worlds of 8 ranks take turns across the test workers of one run
    (an exclusive lock on a file in the shared temporary directory): the
    host carries one world's 8 busy processes at a time, not one per
    worker, beside the rest of the suite."""
    path = os.path.join(tempfile.gettempdir(), "rtpu-test-worlds.lock")
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_world_in_turn(fn, world_size, *args, timeout_s):
    """``run_world`` once this worker holds the turn."""
    from ray_tpu_torch.parallel.launch import run_world

    with one_world_at_a_time():
        return run_world(fn, world_size, *args, timeout_s=timeout_s)


def run_cases(rank, world, cases):
    os.nice(10)     # the ranks yield the host to the rest of the suite
    out = {}
    for name, fn, kwargs in cases:
        try:
            out[name] = globals()[fn](rank, **kwargs)
        except Exception:     # reported per case; the other cases still run
            out[name] = {"error": traceback.format_exc()}
    return out if rank == 0 else None


def _full(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().numpy()


def _mesh(spec):
    from ray_tpu_torch.parallel.mesh import MeshSpec, cpu_mesh

    return cpu_mesh(MeshSpec(**spec))


def _t(a):
    return torch.tensor(np.asarray(a))


# -- parallel layer (test_torch_parallel.py) ---------------------------------
def mesh_construction(rank, spec):
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh, mesh_shape

    mesh = make_mesh(MeshSpec(**spec), list(range(8)), device_type="cpu")
    return {"shape": mesh_shape(mesh), "names": tuple(mesh.mesh_dim_names)}


def mesh_mismatch(rank, spec):
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    try:
        make_mesh(MeshSpec(**spec), list(range(8)), device_type="cpu")
    except ValueError as e:
        return str(e)
    return None


def logical_rules(rank, spec):
    from ray_tpu_torch.parallel.sharding import (ShardingRules,
                                                 logical_sharding)

    mesh = _mesh(spec)
    rules = ShardingRules()
    out = {}
    for logical in (("embed", "mlp"), ("batch", None, "heads")):
        out[logical] = (rules.mesh_axes(logical),
                        tuple(str(p) for p in logical_sharding(
                            mesh, rules, logical)))
    try:
        logical_sharding(mesh, rules, ("bogus",))
    except ValueError as e:
        out["bogus"] = str(e)
    return out


def shard_tree(rank, spec):
    from ray_tpu_torch.parallel.sharding import ShardingRules, shard_pytree

    mesh = _mesh(spec)
    placed = shard_pytree({"w": torch.ones(16, 32), "b": torch.ones(32)},
                          {"w": ("embed", "mlp"), "b": ("mlp",)}, mesh,
                          ShardingRules())
    return {"w_placements": tuple(str(p) for p in placed["w"].placements),
            "w_local": tuple(placed["w"].to_local().shape),
            "w": _full(placed["w"])}


def ring(rank, spec, q, k, v, causal):
    from ray_tpu_torch.parallel.ring_attention import make_ring_attention

    mesh = _mesh(spec)
    return _full(make_ring_attention(mesh, causal=causal)(_t(q), _t(k),
                                                          _t(v)))


def ulysses(rank, spec, q, k, v, causal):
    from ray_tpu_torch.parallel.ring_attention import make_ulysses_attention

    mesh = _mesh(spec)
    if mesh.get_coordinate() is None:        # a rank outside the mesh
        return None
    return _full(make_ulysses_attention(mesh, causal=causal)(_t(q), _t(k),
                                                             _t(v)))


def pipeline(rank, spec, params, x, num_microbatches):
    from ray_tpu_torch.parallel.pipeline import make_pipeline

    mesh = _mesh(spec)

    def stage_fn(p, h):
        if isinstance(p, dict):
            return torch.tanh(h @ p["w"] + p["b"])
        w, b = p
        return torch.tanh(h @ w + b)

    if isinstance(params, dict):
        params = {k: _t(v) for k, v in params.items()}
    else:
        params = tuple(_t(v) for v in params)
    pipe = make_pipeline(stage_fn, mesh, num_microbatches=num_microbatches)
    return _full(pipe(params, _t(x)))


# -- models (test_torch_models_sharded.py) -----------------------------------
def _cfg(kw):
    from ray_tpu_torch.models import transformer

    return transformer.tiny(**kw)


def sharded_forward(rank, spec, cfg_kw, params, tokens):
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.sharding import ShardingRules

    cfg = _cfg(cfg_kw)
    mesh = _mesh(spec)
    rules = ShardingRules()
    placed = transformer.shard_params(
        params_from_numpy(params, "cpu"), transformer.logical_axes(cfg),
        mesh, rules)
    with torch.no_grad():
        logits = transformer.forward(placed, _t(tokens), cfg, mesh=mesh,
                                     rules=rules)
    return {"logits": _full(logits),
            "placements": tuple(str(p) for p in logits.placements)}


def train_steps(rank, spec, cfg_kw, params, batches, loss, lr,
                batch_logical, num_microbatches=None):
    """Train steps through the sharded factory from the JAX package's
    parameters; the losses and grad norms, and the placements of a
    parameter and its AdamW moments right after ``init``."""
    from ray_tpu_torch.models import training, transformer
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.sharding import (ShardingRules,
                                                 logical_sharding)

    cfg = _cfg(cfg_kw)
    mesh = _mesh(spec)
    rules = ShardingRules()
    if loss == "pp":
        loss_fn = lambda p, b: transformer.pp_lm_loss(   # noqa: E731
            p, b, cfg, mesh=mesh, rules=rules,
            num_microbatches=num_microbatches)
    else:
        loss_fn = lambda p, b: transformer.lm_loss(      # noqa: E731
            p, b, cfg, mesh=mesh, rules=rules)
    bundle = training.make_train_step(
        loss_fn=loss_fn,
        init_params_fn=lambda seed: params_from_numpy(params, "cpu"),
        logical_params=transformer.logical_axes(cfg), mesh=mesh, rules=rules,
        optimizer=training.adamw(lr), batch_logical=batch_logical)
    p, opt = bundle.init(0)
    w_up = p["blocks"]["w_up"]
    state = opt.state[w_up]
    out = {"param": tuple(str(x) for x in w_up.placements),
           "rule": tuple(str(x) for x in logical_sharding(
               mesh, rules, transformer.logical_axes(cfg)["blocks"]["w_up"])),
           "mu": tuple(str(x) for x in state["exp_avg"].placements),
           "nu": tuple(str(x) for x in state["exp_avg_sq"].placements),
           "losses": [], "grad_norms": []}
    for tokens in batches:
        p, opt, m = bundle.step(p, opt, {"tokens": _t(tokens)})
        out["losses"].append(m["loss"].item())
        out["grad_norms"].append(m["grad_norm"].item())
    ev = training.make_eval_step(
        loss_fn=loss_fn, param_shardings=bundle.param_shardings,
        batch_sharding=bundle.batch_sharding, mesh=mesh)
    out["eval"] = ev(p, {"tokens": _t(batches[0])}).item()
    return out


# -- MoE (test_torch_moe_pipeline.py) ----------------------------------------
def moe_parallel(rank, spec, cfg_kw, params, x):
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.parallel.mesh import compute_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules, shard_pytree
    from torch.distributed.tensor import DTensor, Replicate

    cfg = moe.MoEConfig(**cfg_kw)
    mesh = _mesh(spec)
    placed = shard_pytree(params_from_numpy(params, "cpu"),
                          moe.logical_axes(cfg), mesh, ShardingRules())
    cm = compute_mesh(mesh)
    xd = DTensor.from_local(_t(x), cm, [Replicate()] * cm.ndim)
    with torch.no_grad():
        y, metrics = moe.moe_ffn(placed, xd, cfg)
    return {"y": _full(y),
            "w_up": tuple(str(p) for p in placed["w_up"].placements),
            "dropped": float(_full(metrics["dropped_fraction"]))}


# -- the launcher (test_torch_models_sharded.py) -----------------------------
def hang_rank(rank, world, pid_dir):
    with open(os.path.join(pid_dir, f"{rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    if rank == 1:
        time.sleep(3600)
    return rank


def fail_rank(rank, world):
    if rank == 1:
        raise KeyError("rank one fails")
    time.sleep(3600)

"""The port's Train and Tune held against the JAX package on the CPU.

- Checkpoints in both directions: one tree of f32, f16 and integer arrays,
  JSON scalars and ``None`` saved by each package gives the same
  ``tree.json`` and byte-equal arrays, and each package loads the other's
  (f32 leaves byte-equal); a port bf16 leaf reaches JAX as its 16-bit
  words. The port's AdamW state tree has the layout of optax's state
  (``restore_pytree`` of a port checkpoint into ``optax.adamw(...).init``).
- A JAX ``(params, optax adamw state)`` after 2 steps of ``tiny()`` (f32,
  dense attention) checkpointed by the JAX package resumes in the port
  (``params_from_numpy``, ``adamw_state_from_numpy``,
  ``load_adamw_state_tree``): the third step's loss and the parameters
  after it equal JAX's within 1e-5 (f32 sums in another order; a dropped
  count or moment would move every parameter by ~lr = 1e-3).
- ``ScalingConfig``'s resources, ``TPU`` read as ``GPU``.
- The same seeded search spaces give the same variants; TPE's suggestions
  and HyperBand's decisions are equal on the same observations.
- ASHA, median-stopping and PBT decisions (PBT's mutated configs and donor
  checkpoints too) are equal on the same recorded result sequences.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import train as jtrain_lib
from ray_tpu import tune as jtune
from ray_tpu.models import training as jtrain
from ray_tpu.models import transformer as jtf
from ray_tpu.parallel.mesh import MeshSpec, cpu_mesh
from ray_tpu.parallel.sharding import ShardingRules
from ray_tpu.tune import experiment as jexp
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import search as jsearch
from ray_tpu_torch import train as ttrain_lib
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import adamw_state_from_numpy, params_from_numpy
from ray_tpu_torch.tune import experiment as texp
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

torch.backends.cuda.matmul.allow_tf32 = False


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "h": rng.standard_normal((4,)).astype(np.float16),
        "ids": rng.integers(-9, 9, (2, 3)).astype(np.int32),
        "step": np.int64(7),
        "nested": [{"b": rng.standard_normal(2).astype(np.float32),
                    "none": None}, ("x", 3, 2.5, True)],
    }


def _files(d):
    spec = json.load(open(os.path.join(d, "state.tree.json")))
    with np.load(os.path.join(d, "state.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return spec, arrays


def _assert_same_leaves(a, b):
    if isinstance(a, dict):
        assert list(sorted(a)) == list(sorted(b))
        for k in a:
            _assert_same_leaves(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_leaves(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def test_same_tree_same_files(tmp_path):
    tree = _tree()
    jtrain_lib.save_pytree(tree, str(tmp_path / "j"))
    ttrain_lib.save_pytree(tree, str(tmp_path / "t"))
    (jspec, jarr), (tspec, tarr) = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert jspec == tspec
    assert sorted(jarr) == sorted(tarr)
    for k in jarr:
        assert jarr[k].dtype == tarr[k].dtype
        assert jarr[k].tobytes() == tarr[k].tobytes()


def test_checkpoints_cross_both_ways(tmp_path):
    tree = _tree(1)
    # JAX writes (jax arrays), the port reads.
    jtree = jax.tree.map(lambda a: jnp.asarray(a) if isinstance(a, np.ndarray)
                         and a.dtype != np.float16 else a, tree)
    jtrain_lib.save_pytree(jtree, str(tmp_path / "j"))
    _assert_same_leaves(ttrain_lib.load_pytree(str(tmp_path / "j")),
                        jtrain_lib.load_pytree(str(tmp_path / "j")))
    got = ttrain_lib.restore_pytree(
        {"w": torch.zeros(3, 5), "h": torch.zeros(4, dtype=torch.float16),
         "ids": torch.zeros(2, 3, dtype=torch.int32), "step": 0,
         "nested": [{"b": torch.zeros(2), "none": None}, ("", 0, 0.0, False)]},
        str(tmp_path / "j"))
    assert got["w"].numpy().tobytes() == tree["w"].tobytes()
    assert got["h"].numpy().tobytes() == tree["h"].tobytes()
    assert got["ids"].dtype == torch.int32
    assert got["nested"][1] == ("x", 3, 2.5, True)
    # The port writes (torch tensors), JAX reads.
    ttree = {"w": torch.from_numpy(tree["w"]), "ids": torch.from_numpy(tree["ids"]),
             "bf": torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
             "meta": {"n": 3, "none": None}}
    ttrain_lib.save_pytree(ttree, str(tmp_path / "t"))
    back = jtrain_lib.load_pytree(str(tmp_path / "t"))
    assert back["w"].dtype == np.float32
    assert back["w"].tobytes() == tree["w"].tobytes()
    assert back["ids"].tobytes() == tree["ids"].tobytes()
    assert back["meta"] == {"n": 3, "none": None}
    # numpy has no bf16: JAX's loader (it reads only "kind") sees the words.
    assert back["bf"].tobytes() == ttree["bf"].view(torch.int16).numpy().tobytes()


def test_port_adamw_tree_restores_into_optax_state(tmp_path):
    params = {"a": torch.randn(3, 2, requires_grad=True),
              "b": [{"w": torch.randn(4, requires_grad=True)}]}
    opt = ttrain.adamw(1e-3).init(params)
    for p in ttrain._leaves(params):
        p.grad = torch.ones_like(p)
    opt.step()
    opt.step()
    ttrain_lib.save_pytree(ttrain.adamw_state_tree(opt, params),
                           str(tmp_path / "opt"))
    jparams = jax.tree.map(lambda t: jnp.zeros(t.shape),
                           ttrain._tree_map(lambda t: t.detach(), params))
    target = optax.adamw(1e-3).init(jparams)
    restored = jtrain_lib.restore_pytree(target, str(tmp_path / "opt"))
    assert type(restored[0]).__name__ == "ScaleByAdamState"
    assert int(restored[0].count) == 2
    np.testing.assert_array_equal(restored[0].mu["a"],
                                  opt.state[params["a"]]["exp_avg"].numpy())
    np.testing.assert_array_equal(restored[0].nu["b"][0]["w"],
                                  opt.state[params["b"][0]["w"]]["exp_avg_sq"].numpy())


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jcfg = jtf.tiny(attn_impl="dense")
    tcfg = ttf.tiny(attn_impl="dense")
    mesh = cpu_mesh(MeshSpec(data=1), n=1)
    rules = ShardingRules()
    bundle = jtrain.make_train_step(
        loss_fn=lambda p, b: jtf.lm_loss(p, b, jcfg, mesh=mesh, rules=rules),
        init_params_fn=lambda k: jtf.init_params(jcfg, k),
        logical_params=jtf.logical_axes(jcfg), mesh=mesh, rules=rules,
        optimizer=optax.adamw(1e-3, weight_decay=0.1))
    jparams, jopt = bundle.init(jax.random.key(0))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, jcfg.vocab_size, (2, 32)) for _ in range(3)]
    for b in batches[:2]:
        jparams, jopt, _ = bundle.step(jparams, jopt,
                                       {"tokens": jnp.asarray(b, jnp.int32)})
    d = str(tmp_path / "jax-ckpt")
    jtrain_lib.save_pytree({"params": jparams, "opt": jopt, "step": 2}, d)
    jparams, jopt, jm = bundle.step(jparams, jopt,
                                    {"tokens": jnp.asarray(batches[2], jnp.int32)})
    want = jax.tree.map(np.asarray, jparams)

    state = ttrain_lib.load_pytree(d)
    assert state["step"] == 2
    tb = ttrain.make_train_step(
        loss_fn=lambda p, b: ttf.lm_loss(p, b, tcfg),
        init_params_fn=lambda seed: params_from_numpy(state["params"], "cpu"),
        optimizer=ttrain.adamw(1e-3, weight_decay=0.1), device="cpu")
    tparams, topt = tb.init(0)
    ttrain.load_adamw_state_tree(topt, tparams,
                                 adamw_state_from_numpy(state["opt"], "cpu"))
    assert all(float(topt.state[p]["step"]) == 2.0
               for p in ttrain._leaves(tparams))
    tparams, topt, tm = tb.step(tparams, topt,
                                {"tokens": torch.tensor(batches[2])})
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    n = 0
    for k, w in want.items():
        for name, leaf in (_named(w, k)):
            got = _at(tparams, name).detach().numpy()
            np.testing.assert_allclose(got, leaf, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            n += 1
    assert n == len(list(ttrain._leaves(tparams)))


def _named(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _at(tree, name):
    for part in name.split("/"):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


@pytest.mark.parametrize("kw", [
    {}, {"use_tpu": True}, {"tpus_per_worker": 2.0}, {"cpus_per_worker": 3.0},
    {"use_tpu": True, "cpus_per_worker": 0.5, "num_workers": 4},
    {"resources_per_worker": {"TPU": 1, "disk": 2}},
])
def test_scaling_config_resources(kw):
    want = jtrain_lib.ScalingConfig(**kw).worker_resources()
    got = ttrain_lib.ScalingConfig(**kw).worker_resources()
    if "resources_per_worker" not in kw:
        want = {("GPU" if k == "TPU" else k): v for k, v in want.items()}
    assert got == want


SPACE = {
    "lr": ("loguniform", 1e-5, 1e-1), "wd": ("uniform", 0.0, 0.3),
    "n": ("randint", 1, 9), "kind": ("choice", ["sgd", "adam", "lion"]),
    "q": ("quniform", 0.0, 1.0, 0.25), "z": ("randn", 0.0, 2.0),
}


def _space(mod, with_grid=False):
    s = {k: getattr(mod, v[0])(*v[1:]) for k, v in SPACE.items()}
    s["nested"] = {"d": mod.choice([16, 32, 64]), "fixed": 7}
    if with_grid:
        s["g"] = mod.grid_search([1, 2, 3])
    return s


@pytest.mark.parametrize("with_grid", [False, True])
def test_basic_variants_equal(with_grid):
    j = jsearch.BasicVariantGenerator(_space(jtune, with_grid), num_samples=4, seed=3)
    t = tsearch.BasicVariantGenerator(_space(ttune, with_grid), num_samples=4, seed=3)
    assert j.total_variants == t.total_variants
    for i in range(j.total_variants):
        assert j.suggest(str(i)) == t.suggest(str(i))


def _objective(cfg):
    return ((np.log10(cfg["lr"]) + 3) ** 2 + cfg["wd"] + 0.1 * cfg["n"]
            + (0.0 if cfg["kind"] == "adam" else 0.5))


def test_tpe_suggestions_equal():
    space_keys = ("lr", "wd", "n", "kind")

    def space(mod):
        return {k: getattr(mod, SPACE[k][0])(*SPACE[k][1:]) for k in space_keys}

    j = jsearch.TPESearcher(space(jtune), metric="obj", mode="min",
                            n_initial=5, seed=11)
    t = tsearch.TPESearcher(space(ttune), metric="obj", mode="min",
                            n_initial=5, seed=11)
    for i in range(20):
        cj, ct = j.suggest(f"t{i}"), t.suggest(f"t{i}")
        assert cj == ct, i
        j.on_trial_complete(f"t{i}", result={"obj": _objective(cj)})
        t.on_trial_complete(f"t{i}", result={"obj": _objective(ct)})


def _results(n_trials, n_iters, seed):
    """Recorded result sequences: per round, each live trial's metrics."""
    rng = np.random.default_rng(seed)
    quality = rng.uniform(0, 1, n_trials)
    return [[{"training_iteration": it, "score": float(
        quality[i] * it + rng.normal(0, 0.3))} for it in range(1, n_iters + 1)]
        for i in range(n_trials)]


def _drive(sched, exp_mod, ckpt_cls, seqs, tmp):
    """Feed the sequences round-robin; returns every decision and, for PBT,
    the trials' configs and restore paths after each RESTART."""
    trials = [exp_mod.Trial(config={"lr": 0.1 * (i + 1)}, trial_id=f"t{i}")
              for i in range(len(seqs))]
    out, live = [], set(range(len(seqs)))
    for it in range(len(seqs[0])):
        for i in sorted(live):
            trial = trials[i]
            trial.latest_checkpoint = ckpt_cls(os.path.join(tmp, f"t{i}-{it}"))
            d = sched.on_trial_result(trial, seqs[i][it])
            rec = [trial.trial_id, it, d]
            if d == "RESTART":
                rec += [trial.config, trial.restore_checkpoint.path]
            if d == "STOP":
                live.discard(i)
            out.append(rec)
    return out


@pytest.mark.parametrize("name", ["asha", "median", "pbt", "hyperband"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_decisions_equal(name, seed, tmp_path):
    def make(mod, smod):
        if name == "asha":
            return smod.ASHAScheduler(metric="score", mode="max", max_t=16,
                                      grace_period=1, reduction_factor=2)
        if name == "median":
            return smod.MedianStoppingRule(metric="score", mode="max",
                                           grace_period=2)
        if name == "hyperband":
            return smod.HyperBandScheduler(metric="score", mode="max",
                                           max_t=9, reduction_factor=3)
        return smod.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=3,
            quantile_fraction=0.25, seed=seed,
            hyperparam_mutations={"lr": mod.uniform(0.01, 1.0),
                                  "mom": [0.8, 0.9, 0.99]})

    seqs = _results(8, 12, seed)
    tmp = str(tmp_path)
    j = _drive(make(jtune, jsched), jexp, jtrain_lib.Checkpoint, seqs, tmp)
    t = _drive(make(ttune, tsched), texp, ttrain_lib.Checkpoint, seqs, tmp)
    assert j == t
    assert any(r[2] != "CONTINUE" for r in j), "no decision was exercised"

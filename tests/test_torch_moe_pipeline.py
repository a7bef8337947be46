"""The port's Switch MoE (``ops/moe.py``) and pipeline-parallel training
against JAX's ``tests/test_moe_and_pipeline.py``, all 8 tests.

The MoE's one-device tests run here on the JAX package's parameters and
inputs (drawn by ``jax.random``, carried across as numpy). The mesh cases
(expert parallelism, the GPipe schedule, pipelined training on
pipe x data x fsdp and pipe x seq x tensor) run in one world of 8 gloo CPU
ranks for the module (``tests/torch_mesh_cases.py``); JAX computes its
side here meanwhile. Tolerances are JAX's own: 1e-4 relative (1e-5
absolute) on the MoE, 1e-5 on the pipeline, 2e-4 and 1e-3 relative on the
pipelined losses against JAX's non-pipelined oracle step.
"""

import concurrent.futures

import numpy as np
import optax
import pytest
import torch

import jax
import torch_mesh_cases
import jax.numpy as jnp

from ray_tpu.models import training as jtraining
from ray_tpu.models import transformer as jtf
from ray_tpu.ops import moe as jmoe
from ray_tpu.ops.layers import gelu as jgelu
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import cpu_mesh as jcpu_mesh
from ray_tpu.parallel.pipeline import make_pipeline as jmake_pipeline
from ray_tpu.parallel.sharding import ShardingRules as JRules
from ray_tpu_torch.models import training as ttraining
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops import moe as tmoe

torch.backends.cuda.matmul.allow_tf32 = False

WORLD = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _moe_setup(E=4, D=16, F=32, B=2, S=8, seed=0):
    kw = dict(d_model=D, d_ff=F, num_experts=E, capacity_factor=2.0)
    params = jmoe.init_params(jmoe.MoEConfig(**kw), jax.random.key(seed))
    x = jax.random.normal(jax.random.key(seed + 1), (B, S, D))
    return kw, params, x


def _stage_inputs():
    n_stages, n_micro, D = 4, 8, 16
    ks = jax.random.split(jax.random.key(0), n_stages)
    stage_params = {
        "w": jnp.stack([jax.random.normal(k, (D, D)) * 0.5 for k in ks]),
        "b": jnp.zeros((n_stages, D)),
    }
    x = jax.random.normal(jax.random.key(1), (4, n_micro, D))
    return stage_params, x, n_micro


def _pp_setup(n_layers, token_key, param_key, batch):
    cfg = jtf.tiny(n_layers=n_layers)
    tokens = np.asarray(jax.random.randint(
        jax.random.key(token_key), (batch, cfg.max_seq_len), 0,
        cfg.vocab_size, jnp.int32))
    params = jtf.init_params(cfg, jax.random.key(param_key))
    return cfg, tokens, params


def _jax_oracle_losses(cfg, params, tokens):
    """JAX's non-pipelined step on its data=2 mesh, two steps, from
    ``params``: the oracle both JAX's pipelined tests hold to."""
    mesh = jcpu_mesh(JMeshSpec(data=2))
    rules = JRules()
    bundle = jtraining.make_train_step(
        loss_fn=lambda p, b: jtf.lm_loss(p, b, cfg, mesh=mesh, rules=rules),
        init_params_fn=lambda k: params,
        logical_params=jtf.logical_axes(cfg), mesh=mesh, rules=rules,
        optimizer=optax.adamw(1e-3))
    p, opt = bundle.init(jax.random.key(0))
    losses = []
    for _ in range(2):
        p, opt, m = bundle.step(p, opt, {"tokens": jnp.asarray(tokens)})
        losses.append(float(m["loss"]))
    return losses


def _run_cases(rank, world, cases):
    import torch_mesh_cases

    return torch_mesh_cases.run_cases(rank, world, cases)


@pytest.fixture(scope="module")
def results():
    moe_kw, moe_params, moe_x = _moe_setup(E=4, B=2, S=16)
    stage_params, stage_x, n_micro = _stage_inputs()
    pp = _pp_setup(4, 0, 42, 16)
    composed = _pp_setup(2, 3, 7, 8)
    cases = [
        ("moe", "moe_parallel", dict(spec=dict(data=2, expert=4),
                                     cfg_kw=moe_kw, params=_np(moe_params),
                                     x=np.asarray(moe_x))),
        ("pipeline", "pipeline", dict(spec=dict(pipe=4, data=2),
                                      params=_np(stage_params),
                                      x=np.asarray(stage_x),
                                      num_microbatches=n_micro)),
    ]
    for name, (cfg, tokens, params), spec, m in (
            ("pp", pp, dict(pipe=2, data=2, fsdp=2), 4),
            ("composed", composed, dict(pipe=2, seq=2, tensor=2), 2)):
        cases.append((name, "train_steps", dict(
            spec=spec, cfg_kw=dict(n_layers=cfg.n_layers),
            params=_np(params), batches=[tokens] * 2, loss="pp", lr=1e-3,
            batch_logical=("batch", None), num_microbatches=m)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(torch_mesh_cases.run_world_in_turn,
                            _run_cases, WORLD, cases,
                            timeout_s=300)
        ref = {"moe": np.asarray(jmoe.moe_ffn(
            moe_params, moe_x, jmoe.MoEConfig(**moe_kw))[0])}
        h = stage_x
        for i in range(4):
            h = jnp.tanh(h @ stage_params["w"][i] + stage_params["b"][i])
        ref["sequential"] = np.asarray(h)
        ref["pipeline"] = np.asarray(jmake_pipeline(
            lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
            jcpu_mesh(JMeshSpec(pipe=4, data=2)),
            num_microbatches=n_micro)(stage_params, stage_x))
        ref["pp"] = _jax_oracle_losses(pp[0], pp[2], pp[1])
        ref["composed"] = _jax_oracle_losses(composed[0], composed[2],
                                             composed[1])
        got = world.result()[0]
    return got, ref


def _ok(results, name):
    r = results[0][name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(f"{name} failed on the ranks:\n{r['error']}")
    return r


def _port(params):
    return params_from_numpy(_np(params), "cpu")


class TestMoE:
    def test_forward_shapes_and_finite(self):
        kw, params, x = _moe_setup()
        cfg = tmoe.MoEConfig(**kw)
        y, metrics = tmoe.moe_ffn(_port(params), torch.tensor(np.asarray(x)),
                                  cfg)
        assert y.shape == x.shape
        assert torch.isfinite(y).all()
        assert float(metrics["dropped_fraction"]) == 0.0  # ample capacity
        jy, jm = jmoe.moe_ffn(params, x, jmoe.MoEConfig(**kw))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(float(metrics["aux_loss"]),
                                   float(jm["aux_loss"]), rtol=1e-5)
        assert tmoe.logical_axes(cfg) == jmoe.logical_axes(
            jmoe.MoEConfig(**kw))

    def test_single_expert_equals_dense_ffn(self):
        """E=1 routes every token to the one expert with gate 1: the
        result is a plain FFN with those weights."""
        kw, params, x = _moe_setup(E=1, B=1, S=4)
        tp = _port(params)
        xt = torch.tensor(np.asarray(x))
        y, _ = tmoe.moe_ffn(tp, xt, tmoe.MoEConfig(**kw))
        h = torch.einsum("bsd,df->bsf", xt, tp["w_up"][0])
        expected = torch.einsum("bsf,fd->bsd", gelu_port(h), tp["w_down"][0])
        np.testing.assert_allclose(y.numpy(), expected.numpy(), rtol=1e-4,
                                   atol=1e-5)
        jh = jnp.einsum("bsd,df->bsf", x, params["w_up"][0])
        jexpected = jnp.einsum("bsf,fd->bsd", jgelu(jh), params["w_down"][0])
        np.testing.assert_allclose(y.numpy(), np.asarray(jexpected),
                                   rtol=1e-4, atol=1e-5)

    def test_capacity_drops_overflow(self):
        kw = dict(d_model=8, d_ff=16, num_experts=4, capacity_factor=0.1)
        params = jmoe.init_params(jmoe.MoEConfig(**kw), jax.random.key(0))
        x = jax.random.normal(jax.random.key(1), (4, 32, 8))
        y, metrics = tmoe.moe_ffn(_port(params), torch.tensor(np.asarray(x)),
                                  tmoe.MoEConfig(**kw))
        assert float(metrics["dropped_fraction"]) > 0
        jy, jm = jmoe.moe_ffn(params, x, jmoe.MoEConfig(**kw))
        assert float(metrics["dropped_fraction"]) == pytest.approx(
            float(jm["dropped_fraction"]))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-5)

    def test_expert_parallel_parity(self, results):
        """Splitting the experts over the ``expert`` axis does not change
        the math."""
        r = _ok(results, "moe")
        assert r["w_up"] == ("R", "S(0)")       # (data, expert) sub-mesh
        assert r["dropped"] == 0.0
        np.testing.assert_allclose(r["y"], results[1]["moe"], rtol=1e-4,
                                   atol=1e-5)

    def test_trainable_end_to_end(self):
        """Router and experts learn: reconstruct targets through the MoE,
        step for step with JAX."""
        kw, params, x = _moe_setup(E=2, D=8, F=16, B=4, S=8)
        cfg, jcfg = tmoe.MoEConfig(**kw), jmoe.MoEConfig(**kw)
        target = jax.random.normal(jax.random.key(9), x.shape)
        opt = optax.adam(1e-2)
        state = opt.init(params)

        def jloss(p):
            y, m = jmoe.moe_ffn(p, x, jcfg)
            return jnp.mean((y - target) ** 2) + 0.01 * m["aux_loss"]

        def tloss(p, b):
            y, m = tmoe.moe_ffn(p, b["x"], cfg)
            return ((y - b["t"]) ** 2).mean() + 0.01 * m["aux_loss"]

        tb = ttraining.make_train_step(
            loss_fn=tloss, init_params_fn=lambda seed: _port(params),
            optimizer=ttraining.adamw(1e-2, weight_decay=0.0), device="cpu")
        tp, topt = tb.init(0)
        batch = {"x": torch.tensor(np.asarray(x)),
                 "t": torch.tensor(np.asarray(target))}
        grad_fn = jax.jit(jax.value_and_grad(jloss))
        jl, tl = [], []
        for _ in range(31):
            l, g = grad_fn(params)
            jl.append(float(l))
            upd, state = opt.update(g, state)
            params = optax.apply_updates(params, upd)
            tp, topt, m = tb.step(tp, topt, batch)
            tl.append(m["loss"].item())
        assert tl[-1] < tl[0] * 0.9
        np.testing.assert_allclose(tl[:5], jl[:5], rtol=1e-4)


def gelu_port(x):
    from ray_tpu_torch.ops.layers import gelu

    return gelu(x)


class TestPipelineIntegration:
    def test_pipeline_matches_sequential(self, results):
        """The GPipe schedule over pipe equals the stages one after
        another."""
        out = _ok(results, "pipeline")
        np.testing.assert_allclose(out, results[1]["sequential"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(out, results[1]["pipeline"], rtol=1e-4,
                                   atol=1e-5)


class TestPipelineTransformerTraining:
    """Differentiate THROUGH the GPipe schedule on the real model: the
    losses must track JAX's non-pipelined oracle step for step (step 2's
    loss depends on step 1's update, so the gradients crossed the
    pipeline)."""

    def test_pp_train_step_matches_oracle(self, results):
        r = _ok(results, "pp")
        np.testing.assert_allclose(r["losses"], results[1]["pp"], rtol=2e-4)
        assert r["losses"][1] < r["losses"][0]

    def test_pp_sp_tp_composed_matches_oracle(self, results):
        """pipe x seq x tensor in one train step: blocks pipelined over
        pipe, ring attention over seq and megatron reductions over tensor
        inside the pipeline's per-rank region."""
        r = _ok(results, "composed")
        np.testing.assert_allclose(r["losses"], results[1]["composed"],
                                   rtol=1e-3)
        assert r["losses"][1] < r["losses"][0]

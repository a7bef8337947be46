"""The port's sharded model path against JAX's ``tests/test_models.py``:
``logical_axes``, the sharded forward over four meshes, ring attention in
the model, the sharded train-step factory, the MLP; and the port's own:
remat policy "dots".

The mesh cases run in one world of 8 gloo CPU ranks for the module
(``tests/torch_mesh_cases.py``) on the JAX package's parameters (carried
across by ``params_from_numpy``); JAX computes its side here meanwhile.
Tolerances are JAX's: 2e-4 on the sharded logits (f32 sums in another
order over the shards); the train steps' losses and grad norms 1e-4
relative, as ``test_torch_train.py``'s five AdamW steps.
"""

import concurrent.futures

import numpy as np
import optax
import pytest
import torch

import jax
import torch_mesh_cases
import jax.numpy as jnp

from ray_tpu.models import mlp as jmlp
from ray_tpu.models import training as jtraining
from ray_tpu.models import transformer as jtf
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import cpu_mesh as jcpu_mesh
from ray_tpu.parallel.sharding import ShardingRules as JRules
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.models import training as ttraining
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

torch.backends.cuda.matmul.allow_tf32 = False

WORLD = 8
FORWARD_MESHES = [dict(data=8), dict(data=2, tensor=4), dict(fsdp=4, tensor=2),
                  dict(data=2, seq=2, tensor=2)]
TRAIN_MESH = dict(data=2, tensor=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, cfg.max_seq_len)).astype(
        np.int32)


def _run_cases(rank, world, cases):
    import torch_mesh_cases

    return torch_mesh_cases.run_cases(rank, world, cases)


@pytest.fixture(scope="module")
def results():
    fwd_kw = dict(n_heads=4, d_ff=128)
    fwd_cfg = jtf.tiny(**fwd_kw)
    fwd_params = jtf.init_params(fwd_cfg, jax.random.key(1))
    fwd_tokens = _tokens(fwd_cfg, 8, 1)
    ring_kw = dict(n_heads=4)
    ring_cfg = jtf.tiny(**ring_kw)
    ring_params = jtf.init_params(ring_cfg, jax.random.key(2))
    ring_tokens = _tokens(ring_cfg, 4, 2)
    train_cfg = jtf.tiny()
    train_params = jtf.init_params(train_cfg, jax.random.key(0))
    train_tokens = _tokens(train_cfg, 8, 0)

    cases = [(f"forward_{i}", "sharded_forward", dict(
        spec=spec, cfg_kw=fwd_kw, params=_np(fwd_params), tokens=fwd_tokens))
        for i, spec in enumerate(FORWARD_MESHES)]
    cases.append(("ring", "sharded_forward", dict(
        spec=dict(data=2, seq=4), cfg_kw=dict(ring_kw, attn_impl="ring"),
        params=_np(ring_params), tokens=ring_tokens)))
    cases.append(("train", "train_steps", dict(
        spec=TRAIN_MESH, cfg_kw={}, params=_np(train_params),
        batches=[train_tokens] * 6, loss="lm", lr=1e-3, batch_logical=None)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(torch_mesh_cases.run_world_in_turn,
                            _run_cases, WORLD, cases,
                            timeout_s=300)
        ref = {"forward": np.asarray(jtf.forward(
                   fwd_params, jnp.asarray(fwd_tokens), fwd_cfg), np.float32),
               "ring": np.asarray(jtf.forward(
                   ring_params, jnp.asarray(ring_tokens), ring_cfg),
                   np.float32)}
        mesh = jcpu_mesh(JMeshSpec(**TRAIN_MESH))
        rules = JRules()
        bundle = jtraining.make_train_step(
            loss_fn=lambda p, b: jtf.lm_loss(p, b, train_cfg, mesh=mesh,
                                             rules=rules),
            init_params_fn=lambda k: jtf.init_params(train_cfg, k),
            logical_params=jtf.logical_axes(train_cfg), mesh=mesh,
            rules=rules, optimizer=optax.adamw(1e-3), batch_logical=None)
        params, opt = bundle.init(jax.random.key(0))
        ref["mu_spec"] = opt[0].mu["blocks"]["w_up"].sharding.spec
        ref["losses"], ref["grad_norms"] = [], []
        for _ in range(6):
            params, opt, m = bundle.step(params, opt,
                                         {"tokens": jnp.asarray(train_tokens)})
            ref["losses"].append(float(m["loss"]))
            ref["grad_norms"].append(float(m["grad_norm"]))
        got = world.result()[0]
    return got, ref


def _ok(results, name):
    r = results[0][name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(f"{name} failed on the ranks:\n{r['error']}")
    return r


class TestTransformer:
    def test_logical_axes_match_params(self):
        for kw in (dict(), dict(pos="rope", tie_embeddings=False)):
            cfg = ttf.tiny(**kw)
            params = ttf.init_params(cfg, 0, device="cpu")
            axes = ttf.logical_axes(cfg)
            jaxes = jtf.logical_axes(jtf.tiny(**kw))
            assert axes == jaxes
            flat = dict(ttraining._tree_map(lambda p: p, params))
            for k, v in axes.items():
                sub = v if isinstance(v, dict) else {None: v}
                leaves = flat[k] if isinstance(v, dict) else {None: flat[k]}
                for name, logical in sub.items():
                    assert len(logical) == leaves[name].ndim, (k, name)

    @pytest.mark.parametrize("mesh_index", range(len(FORWARD_MESHES)),
                             ids=[str(m) for m in FORWARD_MESHES])
    def test_sharded_forward_parity(self, results, mesh_index):
        """Any mesh layout computes JAX's single-device logits, taking
        the DTensor leaves' layers by one unbind."""
        r = _ok(results, f"forward_{mesh_index}")
        np.testing.assert_allclose(r["logits"], results[1]["forward"],
                                   rtol=2e-4, atol=2e-4)
        assert r["unbound_forwards"] == 1

    def test_ring_attention_model_parity(self, results):
        """attn_impl='ring' under a seq-split mesh matches JAX's dense."""
        r = _ok(results, "ring")
        np.testing.assert_allclose(r["logits"], results[1]["ring"],
                                   rtol=2e-4, atol=2e-4)


class TestTrainStepFactory:
    def test_sharded_train_step_descends_and_matches_dp(self, results):
        r = _ok(results, "train")
        ref = results[1]
        assert r["losses"][-1] < r["losses"][0]
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4)
        np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"],
                                   rtol=1e-4)
        # the eval step sees the trained parameters: below the first loss
        assert r["eval"] < r["losses"][0]

    def test_opt_state_sharded_like_params(self, results):
        r = _ok(results, "train")
        # AdamW's moments for w_up are split on the mlp dim like the param
        assert r["mu"] == r["nu"] == r["param"] == r["rule"]
        assert r["param"] == ("R", "S(2)")      # (data, tensor) sub-mesh
        assert tuple(results[1]["mu_spec"]) == ("pipe", "fsdp", "tensor")

    def test_sharded_step_emits_phase_spans(self, results):
        """The mesh path runs the same step, so the same spans, nested the
        same way, one set a step, inside the caller's trace."""
        r = _ok(results, "train")
        phases = [("lm.forward", "train.step", True),
                  ("lm.loss", "train.step", True),
                  ("train.backward", "train.step", True),
                  ("train.optimizer", "train.step", True),
                  ("train.step", "fit", True)]
        assert [tuple(s) for s in r["spans"]] == (
            phases * len(r["losses"]) + [("fit", None, True)])


class TestMLP:
    def test_mlp_descends(self):
        cfg_kw = dict(in_dim=16, hidden=(32,), n_classes=4)
        jcfg, tcfg = jmlp.MLPConfig(**cfg_kw), tmlp.MLPConfig(**cfg_kw)
        jparams = jmlp.init_params(jcfg, jax.random.key(0))
        rng = np.random.default_rng(0)
        x = rng.normal(size=(64, 16)).astype(np.float32)
        y = rng.integers(0, 4, 64).astype(np.int32)
        jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        tparams = params_from_numpy(_np(jparams), "cpu")
        np.testing.assert_allclose(
            tmlp.forward(tparams, torch.tensor(x), tcfg).numpy(),
            np.asarray(jmlp.forward(jparams, jbatch["x"], jcfg)),
            rtol=1e-5, atol=1e-5)
        opt = optax.adam(1e-2)
        state = opt.init(jparams)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: jmlp.classifier_loss(p, b, jcfg)))
        tb = ttraining.make_train_step(
            loss_fn=lambda p, b: tmlp.classifier_loss(p, b, tcfg),
            init_params_fn=lambda seed: tparams,
            optimizer=ttraining.adamw(1e-2, weight_decay=0.0), device="cpu")
        tp, topt = tb.init(0)
        tbatch = {"x": torch.tensor(x), "y": torch.tensor(y)}
        jl, tl = [], []
        for _ in range(21):
            l, g = grad_fn(jparams, jbatch)
            upd, state = opt.update(g, state)
            jparams = optax.apply_updates(jparams, upd)
            tp, topt, m = tb.step(tp, topt, tbatch)
            jl.append(float(l))
            tl.append(m["loss"].item())
        assert tl[-1] < tl[0] - 0.3
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        assert sum(p.numel() for p in ttraining._leaves(tp)) == sum(
            int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
        assert tmlp.logical_axes(tcfg) == jmlp.logical_axes(jcfg)


class _MmCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts matrix products (``aten.mm``) dispatched while on."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


class TestRematDots:
    """remat_policy="dots" keeps the projection GEMMs' outputs (JAX's
    ``dots_with_no_batch_dims_saveable``) and recomputes the rest."""

    def _run(self, policy, remat=True, attn="dense"):
        jcfg = jtf.tiny(max_seq_len=128, attn_impl=attn)
        cfg = ttf.tiny(max_seq_len=128, attn_impl=attn, remat=remat,
                       remat_policy=policy)
        params = ttraining._tree_map(
            lambda t: t.requires_grad_(True),
            params_from_numpy(_np(jtf.init_params(jcfg, jax.random.key(4))),
                              "cpu"))
        tokens = torch.tensor(_dots_tokens(cfg))
        fwd, bwd = _MmCounter(), _MmCounter()
        with fwd:
            loss = ttf.lm_loss(params, {"tokens": tokens}, cfg)
        with bwd:
            loss.backward()
        return loss.item(), params, fwd.mm, bwd.mm

    @pytest.mark.parametrize("attn", ["dense", "flash"])
    def test_dots_gives_full_gradients_without_rerunning_gemms(self, attn):
        l_none, p_none, f_none, b_none = self._run("full", remat=False,
                                                   attn=attn)
        l_full, p_full, f_full, b_full = self._run("full", attn=attn)
        l_dots, p_dots, f_dots, b_dots = self._run("dots", attn=attn)
        assert l_none == l_full == l_dots
        for a, b, c in zip(ttraining._leaves(p_none),
                           ttraining._leaves(p_full),
                           ttraining._leaves(p_dots)):
            assert torch.equal(a.grad, b.grad) and torch.equal(a.grad, c.grad)
        assert f_none == f_full == f_dots
        # "full" re-runs a block's forward GEMMs in the backward (q, k, v,
        # out, up: the recompute stops once it has what the backward
        # saved, before the down projection); "dots" re-runs none: its
        # backward has exactly no-remat's GEMMs.
        assert f_none - 1 == 6 * 2          # 2 blocks and the logits GEMM
        assert b_full == b_none + 5 * 2
        assert b_dots == b_none

    def test_dots_matches_jax(self):
        jcfg = jtf.tiny(max_seq_len=128, remat=True, remat_policy="dots")
        jparams = jtf.init_params(jcfg, jax.random.key(4))
        tokens = jnp.asarray(_dots_tokens(jcfg), jnp.int32)
        jloss, jgrads = jax.value_and_grad(
            lambda p: jtf.lm_loss(p, {"tokens": tokens}, jcfg))(jparams)
        loss, params, _, _ = self._run("dots")
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        floor = 1e-3 * max(float(np.abs(g).max())
                           for g in jax.tree.leaves(jgrads))
        n = 0
        for name, jg, tp in _leaf_pairs(jgrads, params):
            scale = max(float(np.abs(jg).max()), floor)
            err = float(np.abs(tp.grad.numpy() - jg).max())
            assert err <= 1e-4 * scale, (name, err, scale)
            n += 1
        assert n == len(jax.tree.leaves(jparams))


def _dots_tokens(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32))


def _leaf_pairs(jtree, ttree, path=()):
    if isinstance(jtree, dict):
        for k in jtree:
            yield from _leaf_pairs(jtree[k], ttree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(jtree), ttree

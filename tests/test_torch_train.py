"""The port's training forward, loss, gradients and train step against JAX.

``forward`` and ``lm_loss`` run on ``tiny()`` in f32 with the JAX package's
weights carried across by ``params_from_numpy``, for learned positions and
for ``pos="rope", tie_embeddings=False``, with dense attention and with
flash attention (``max_seq_len=128`` and ``attn_impl="flash"``, so that
``_make_attention`` takes it; JAX runs its Pallas kernels in interpret mode,
the port its plain versions). TF32 is off.

Tolerances: logits 1e-4 (as the serving forwards': f32 matmuls and softmaxes
summed in another order through two layers); the loss 1e-5; each gradient
leaf 1e-4 relative to that leaf's largest entry (the same sums, one
backward pass deeper), floored at 1e-3 of the model's largest entry (bk's
gradient is 0 in exact arithmetic, so it is rounding noise in both); remat
on and off give bit-identical gradients (the same ops recomputed in the
same order). Over five AdamW steps the losses and ``grad_norm`` agree to
1e-4 relative: Adam divides each moment by its own scale, so a gradient
entry that is ~0 in both packages still moves by up to ``lr`` — that noise
reaches the loss only at second order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import training as jtrain
from ray_tpu.models import transformer as jtf
from ray_tpu.parallel.mesh import MeshSpec, cpu_mesh
from ray_tpu.parallel.sharding import ShardingRules
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_numpy

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

torch.backends.cuda.matmul.allow_tf32 = False

VARIANTS = {
    "learned": dict(),
    "rope-untied": dict(pos="rope", tie_embeddings=False),
}


def _configs(variant, attn, **kw):
    cfg = dict(VARIANTS[variant], max_seq_len=128, attn_impl=attn, **kw)
    return jtf.tiny(**cfg), ttf.tiny(**cfg)


def _tokens(cfg, b=2, l=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, l))


def _leaf_pairs(jtree, ttree, path=()):
    if isinstance(jtree, dict):
        for k in jtree:
            yield from _leaf_pairs(jtree[k], ttree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(jtree), ttree


def _port_params(jparams, grad=False):
    p = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    if grad:
        p = ttrain._tree_map(lambda t: t.requires_grad_(True), p)
    return p


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_loss_and_grads_match_jax(variant, attn):
    jcfg, tcfg = _configs(variant, attn)
    jparams = jtf.init_params(jcfg, jax.random.key(0))
    tokens = _tokens(jcfg)
    jlogits = jtf.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.lm_loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)},
                              jcfg))(jparams)

    tparams = _port_params(jparams, grad=True)
    ttokens = torch.tensor(tokens)
    with torch.no_grad():
        logits = ttf.forward(tparams, ttokens, tcfg)
    assert logits.shape == (2, 32, tcfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    loss = ttf.lm_loss(tparams, {"tokens": ttokens}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    n = 0
    floor = 1e-3 * max(float(np.abs(g).max())
                       for g in jax.tree.leaves(jgrads))
    for name, jg, tp in _leaf_pairs(jgrads, tparams):
        scale = max(float(np.abs(jg).max()), floor)
        err = float(np.abs(tp.grad.numpy() - jg).max())
        assert err <= 1e-4 * scale, (name, err, scale)
        n += 1
    assert n == len(jax.tree.leaves(jparams))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_remat_gives_the_same_gradients(attn):
    grads = []
    for remat in (False, True):
        jcfg, tcfg = _configs("learned", attn, remat=remat)
        tparams = _port_params(jtf.init_params(jcfg, jax.random.key(1)),
                               grad=True)
        ttf.lm_loss(tparams, {"tokens": torch.tensor(_tokens(jcfg))},
                    tcfg).backward()
        grads.append([p.grad for p in ttrain._leaves(tparams)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


REMATS = {"off": dict(remat=False), "full": dict(remat=True),
          "dots": dict(remat=True, remat_policy="dots")}


def _route_case(remat, seed=0):
    """``tiny(n_layers=4)`` under ``REMATS[remat]``, its parameters as
    gradient leaves and a batch."""
    cfg = ttf.tiny(n_layers=4, **REMATS[remat])
    params = ttrain._tree_map(lambda t: t.requires_grad_(True),
                              ttf.init_params(cfg, seed, device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(seed))
    return cfg, params, tokens


def _indexed_lm_loss(params, tokens, cfg):
    """``lm_loss`` with each layer's parameters taken as ``v[layer]`` from
    the stacked leaves: the route before the one-unbind take."""
    cstr = ttf._constrainer(None, None)
    h = ttf._embed(params, tokens, cfg, cstr)
    block = ttf._remat(ttf.make_block_fn(cfg), cfg)
    for layer in range(cfg.n_layers):
        h = block(h, {k: v[layer] for k, v in params["blocks"].items()})
    logits = ttf._logits(params, h, cfg).to(cfg.dtype)
    return ttf._next_token_loss(logits, tokens, {"tokens": tokens}, cstr)


@pytest.mark.parametrize("remat", list(REMATS))
def test_unbound_layers_give_the_indexed_gradients(remat):
    """Each slice of the stacked gradient is the tensor that indexing adds
    to exact zeros: loss and every leaf's gradient are bit-equal."""
    cfg, unbound, tokens = _route_case(remat)
    _, indexed, _ = _route_case(remat)
    loss_u = ttf.lm_loss(unbound, {"tokens": tokens}, cfg)
    loss_i = _indexed_lm_loss(indexed, tokens, cfg)
    assert torch.equal(loss_u, loss_i)
    loss_u.backward()
    loss_i.backward()
    for a, b in zip(ttrain._leaves(unbound), ttrain._leaves(indexed)):
        assert torch.equal(a.grad, b.grad)


class _StackedOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts, by op, the results shaped like a whole stacked leaf."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.ops = shapes, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and tuple(out.shape) in self.shapes:
            self.ops[func] = self.ops.get(func, 0) + 1
        return out


@pytest.mark.parametrize("remat", ["off", "full"])
def test_backward_stacks_each_leaf_once(remat):
    """The backward writes each stacked gradient with one ``stack`` of its
    layers' gradients: no zero-filled whole-stack buffer a layer
    (``select_backward``) and no adds of them, which grow as layers²."""
    cfg, params, tokens = _route_case(remat)
    blocks = params["blocks"]
    loss = ttf.lm_loss(params, {"tokens": tokens}, cfg)
    counter = _StackedOps({tuple(v.shape) for v in blocks.values()})
    with counter:
        loss.backward()
    aten = torch.ops.aten
    assert counter.ops.get(aten.stack.default) == len(blocks)
    assert not {aten.zeros.default, aten.new_zeros.default,
                aten.zeros_like.default, aten.select_backward.default,
                aten.add.Tensor, aten.add_.Tensor} & set(counter.ops)


def test_forward_counts_unbound_forwards():
    """Each forward, bare or under ``lm_loss``, adds one to
    ``unbound_forwards``."""
    cfg, params, tokens = _route_case("off")
    before = ttf.unbound_forwards
    with torch.no_grad():
        ttf.forward(params, tokens, cfg)
        assert ttf.unbound_forwards == before + 1
        ttf.lm_loss(params, {"tokens": tokens}, cfg)
    assert ttf.unbound_forwards == before + 2


def test_loss_mask_and_unported_options():
    jcfg, tcfg = _configs("learned", "dense")
    jparams = jtf.init_params(jcfg, jax.random.key(2))
    tokens = _tokens(jcfg, seed=3)
    mask = (np.arange(32)[None, :] < np.array([[20], [32]])).astype(np.int32)
    want = jtf.lm_loss(jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                                 "loss_mask": jnp.asarray(mask)}, jcfg)
    got = ttf.lm_loss(_port_params(jparams),
                      {"tokens": torch.tensor(tokens),
                       "loss_mask": torch.tensor(mask)}, tcfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    # Without a mesh JAX takes the dense path; the port refuses.
    with pytest.raises(ValueError, match="needs a device mesh"):
        ttf.forward(_port_params(jparams), torch.tensor(tokens),
                    tcfg.replace(attn_impl="ring"))
    dots = dict(remat=True, remat_policy="dots")
    want = jtf.lm_loss(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                       jcfg.replace(**dots))
    got = ttf.lm_loss(_port_params(jparams, grad=True),
                      {"tokens": torch.tensor(tokens)}, tcfg.replace(**dots))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)


def test_make_attention_picks_flash_as_jax_does():
    for seq, impl, block in ((1024, "flash", 512), (2048, "flash", 512),
                             (1280, "flash", 256), (512, "dense", None),
                             (1000, "dense", None)):
        attn = ttf._make_attention(ttf.gpt2_small(max_seq_len=seq))
        if impl == "flash":
            assert attn.func is ttf.flash_attention, seq
            assert attn.keywords["block_q"] == attn.keywords["block_k"] == block
        else:
            assert attn.func is ttf._dense_attention, seq


def test_five_adamw_steps_match_jax():
    jcfg, tcfg = _configs("learned", "flash")
    mesh = cpu_mesh(MeshSpec(data=1), n=1)
    rules = ShardingRules()
    bundle = jtrain.make_train_step(
        loss_fn=lambda p, b: jtf.lm_loss(p, b, jcfg, mesh=mesh, rules=rules),
        init_params_fn=lambda k: jtf.init_params(jcfg, k),
        logical_params=jtf.logical_axes(jcfg), mesh=mesh, rules=rules,
        optimizer=optax.adamw(1e-3, weight_decay=0.1))
    jparams, jopt = bundle.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, jparams)     # before donation
    tb = ttrain.make_train_step(
        loss_fn=lambda p, b: ttf.lm_loss(p, b, tcfg),
        init_params_fn=lambda seed: params_from_numpy(start, "cpu"),
        optimizer=ttrain.adamw(1e-3, weight_decay=0.1), device="cpu")
    tparams, topt = tb.init(0)
    for step in range(5):
        tokens = _tokens(jcfg, seed=10 + step)
        jparams, jopt, jm = bundle.step(
            jparams, jopt, {"tokens": jnp.asarray(tokens, jnp.int32)})
        tparams, topt, tm = tb.step(tparams, topt,
                                    {"tokens": torch.tensor(tokens)})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} @ {step}")


def test_adamw_defaults_are_optax():
    opt = ttrain.adamw(3e-4)
    assert (opt.b1, opt.b2, opt.eps, opt.weight_decay) == (0.9, 0.999, 1e-8,
                                                           1e-4)
    t = torch.zeros(3, requires_grad=True)
    torch_opt = opt.init({"w": t})
    group = torch_opt.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8


def test_eval_step_matches_loss_without_grad():
    jcfg, tcfg = _configs("learned", "dense")
    tparams = _port_params(jtf.init_params(jcfg, jax.random.key(3)),
                           grad=True)
    batch = {"tokens": torch.tensor(_tokens(jcfg, seed=4))}
    ev = ttrain.make_eval_step(loss_fn=lambda p, b: ttf.lm_loss(p, b, tcfg))
    got = ev(tparams, batch)
    assert got.grad_fn is None
    assert got.item() == ttf.lm_loss(tparams, batch, tcfg).item()

"""The port's LFM2-MoE (``models/lfm2.py``) and its dropless top-k layer
(``ops/moe.py:moe_topk``) against the plain reference
``tests/lfm2_moe_reference.py`` (the same file as the benchmark's
``portbench/reference/lfm2_moe.py``; it imports nothing of either package)
on seeded random weights at a tiny size.

In f32 the forward, the loss and every leaf's gradient agree within 1e-5
(relative to each leaf's largest entry), and three AdamW steps with the
expert-bias update agree in the losses, the parameters and the bias. In
bf16 (the card's compute dtype over f32 masters) the losses agree within
2e-3 and each gradient within 5 % of its leaf's largest entry: bf16 keeps
8 bits of mantissa and a routing choice that rounding flips moves a few
tokens' experts. ``moe_topk`` is held to its own loop and to the reference
layer: the shares of disjoint held ranges add up to the uncut layer, no
assignment is dropped under a bias that sends every token to one expert,
the bias only chooses; the router enters it as its f32 master. The conv
is causal and is ``nn.Conv1d``; GQA's expansion is per-group attention;
the spans nest, open only inside a trace, and open again in the recompute
on a thread with no trace context; remat changes no gradient. Tests
marked ``gpu`` run the grouped route on the card (``-m gpu
--noconftest``).
"""

import copy
import json
import statistics
import threading
from pathlib import Path

import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test process)

import lfm2_moe_reference as ref
from ray_tpu_torch.core import config as cfg_mod
from ray_tpu_torch.models import lfm2, training, transformer
from ray_tpu_torch.ops import moe
from ray_tpu_torch.util import tracing

# The reference's configuration keys (LFM2's published names): 2 conv and 2
# attention layers, 1 dense and 3 MoE FFNs, 8 routed experts, 4 held.
CFG = {
    "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 4,
    "layer_types": ["conv", "full_attention", "conv", "full_attention"],
    "num_attention_heads": 4, "num_key_value_heads": 2, "conv_L_cache": 3,
    "conv_bias": False, "intermediate_size": 96, "moe_intermediate_size": 32,
    "num_experts": 4, "published": {"num_experts": 8}, "experts_held": [2, 6],
    "num_experts_per_tok": 2, "num_dense_layers": 1, "norm_topk_prob": True,
    "routed_scaling_factor": 1.0, "norm_eps": 1e-5, "rope_theta": 1e6,
    "max_position_embeddings": 64, "use_expert_bias": True,
    "expert_bias_rate": 1e-3, "dtype": "float32", "param_dtype": "float32",
}
B, L = 2, 40
OPT = {"lr": 3e-3, "weight_decay": 0.1, "b1": 0.9, "b2": 0.999, "eps": 1e-8}
REPO = Path(__file__).resolve().parents[1]


def _cfg(**kw):
    return lfm2.config_from_dict(CFG, **kw)


def _params(c, seed=0):
    return lfm2.init_params(c, seed, device="cpu")


def _tokens(i=0, b=B, length=L):
    g = torch.Generator().manual_seed(100 + i)
    return torch.randint(0, CFG["vocab_size"], (b, length), generator=g)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _grad_params(tree):
    return {k: ({a: t.detach().clone().requires_grad_() for a, t in v.items()}
                if isinstance(v, dict) else v.detach().clone().requires_grad_())
            for k, v in tree.items()}


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _bias(c, seed=7, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(c.n_moe, c.num_experts, generator=g) * scale


def _loss_and_grads(c, params, tokens, bias):
    p = _grad_params(params)
    state = lfm2.LFM2State(c, tokens.device)
    state.expert_bias.copy_(bias)
    loss = lfm2.lm_loss(p, {"tokens": tokens}, c, state)
    loss.backward()
    return loss.detach(), {n: t.grad for n, t in _leaves(p)}, state


def _ref_loss_and_grads(params, tokens, bias, cfg=CFG):
    p = _grad_params(params)
    with ref.no_tf32():
        logits = ref.forward(p, tokens, cfg, bias)[:, :-1]
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, tokens[:, 1:, None])[..., 0]
        loss = nll.mean()
        loss.backward()
    return loss.detach(), {n: t.grad for n, t in _leaves(p)}


def test_reference_is_the_benchmarks_reference():
    assert (REPO / "tests" / "lfm2_moe_reference.py").read_bytes() == (
        REPO / "portbench" / "reference" / "lfm2_moe.py").read_bytes()


def test_the_benchmarks_config_is_lfm2_8b_a1b_on_8_experts():
    cfg = json.loads((REPO / "portbench" / "configs" / "lfm2-8b-a1b.json")
                     .read_text())
    c = lfm2.config_from_dict(cfg)
    assert (c.n_conv, c.n_attn, c.n_moe, c.head_dim) == (18, 6, 22, 64)
    assert c.num_experts == 32 and c.experts_held == range(0, 8)
    assert c == lfm2.lfm2_8b_a1b(experts_held=range(0, 8))
    with pytest.raises(ValueError):
        lfm2.config_from_dict(dict(CFG, num_hidden_layers=5))


@pytest.mark.parametrize("remat", [False, True])
def test_f32_logits_loss_and_grads_match_reference(remat):
    c = _cfg(remat=remat)
    params, tokens, bias = _params(c), _tokens(), _bias(c)
    p = _grad_params(params)
    state = lfm2.LFM2State(c, "cpu")
    state.expert_bias.copy_(bias)
    with ref.no_tf32():
        want = ref.forward(params, tokens, CFG, bias)
    assert _rel(lfm2.forward(p, tokens, c, state).detach(), want) <= 1e-5
    loss, grads, _ = _loss_and_grads(c, params, tokens, bias)
    rloss, rgrads = _ref_loss_and_grads(params, tokens, bias)
    assert abs(float(loss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    assert set(grads) == set(rgrads)
    for name, g in grads.items():
        assert _rel(g, rgrads[name]) <= 1e-5, name


def _bf16_gaps(grads, rgrads):
    """Each leaf's ``|g - g_ref|`` over ``max(|g_ref|, the median leaf's)``
    (norms; a norm gain's gradient is a sum that cancels)."""
    med = statistics.median(float(g.norm()) for g in rgrads.values())
    return {n: float((g.float() - rgrads[n]).norm())
            / max(float(rgrads[n].norm()), med) for n, g in grads.items()}


def test_bf16_matches_reference_within_tolerance():
    """Loss within 1e-4 (6 batches read <= 3.4e-5); each leaf's gradient
    within 5 % (read <= 2 %), the experts' within 25 % (read <= 11.3 %):
    of 80 tokens' top-2 picks a few flip under bf16 rounding, and a flip
    moves a token's whole share from one expert to another."""
    c = _cfg(dtype=torch.bfloat16)
    params, bias = _params(c), _bias(c)
    for i in range(3):
        tokens = _tokens(i)
        loss, grads, _ = _loss_and_grads(c, params, tokens, bias)
        rloss, rgrads = _ref_loss_and_grads(params, tokens, bias)
        assert abs(float(loss) - float(rloss)) <= 1e-4 * float(rloss)
        for name, gap in _bf16_gaps(grads, rgrads).items():
            assert gap <= (0.25 if name in ("moe.w13", "moe.w2")
                           else 5e-2), name


def test_training_with_the_bias_update_matches_reference():
    """Three AdamW steps through ``make_train_step`` with ``end_step`` as
    the post-step hook against the reference's ``train``: losses, the
    first gradient's norms, every leaf's change and the final bias."""
    c = _cfg()
    params = _params(c)
    state = lfm2.LFM2State(c, "cpu")
    bundle = training.make_train_step(
        loss_fn=lambda p, b: lfm2.lm_loss(p, b, c, state),
        init_params_fn=lambda seed: copy.deepcopy(params),
        optimizer=training.adamw(OPT["lr"], weight_decay=OPT["weight_decay"]),
        device="cpu", after_step=lambda: lfm2.end_step(state, c))
    p, opt = bundle.init(0)
    batches = [_tokens(i) for i in range(3)]
    losses = []
    for i, tokens in enumerate(batches):
        p, opt, m = bundle.step(p, opt, {"tokens": tokens})
        losses.append(float(m["loss"]))
        if i == 0:
            mu = training.adamw_state_tree(opt, p)[0].mu
            grad_norms = {n: float(t.norm()) / (1 - OPT["b1"])
                          for n, t in _leaves(mu)}
    got = ref.train(params, batches, CFG, OPT, rows_per_pass=1)
    for a, b in zip(losses, got["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for name, norm in grad_norms.items():
        assert abs(norm - got["grad_norms"][name]) <= 1e-4 * max(
            got["grad_norms"][name], 1e-6), name
    p0 = dict(_leaves(params))
    for name, t in _leaves(p):
        change = float((t.detach() - p0[name]).norm())
        assert abs(change - got["change_norms"][name]) <= 1e-3 * max(
            got["change_norms"][name], 1e-9), name
    assert torch.equal(state.expert_bias, got["bias"])
    assert state.expert_bias.abs().max() > 0
    assert state.steps == 3


# -- moe_topk ---------------------------------------------------------------

def _moe_inputs(T=48, D=32, Fe=24, E=8, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, D, generator=g).to(dtype)
    full = {"router": torch.randn(D, E, generator=g) * 0.3,
            "w13": (torch.randn(E, D, 2 * Fe, generator=g) * 0.1).to(dtype),
            "w2": (torch.randn(E, Fe, D, generator=g) * 0.1).to(dtype)}
    return x, full


def _share(full, held):
    return {"router": full["router"],
            "w13": full["w13"][held.start:held.stop],
            "w2": full["w2"][held.start:held.stop]}


def _ref_moe(x, full, bias, k, held):
    """The reference's MoE layer on ``x`` [T, D] with experts ``held``."""
    cfg = dict(CFG, num_experts_per_tok=k, moe_intermediate_size=(
        full["w13"].shape[-1] // 2), experts_held=[held.start, held.stop])
    p = _share(full, held)
    with ref.no_tf32():
        return ref._moe(x[None].float(), {a: t.float() for a, t in p.items()},
                        bias, cfg, False, None, None)[0]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_moe_shares_of_disjoint_held_ranges_add_up(k):
    x, full = _moe_inputs()
    bias = torch.zeros(8)
    whole = moe.moe_topk(full, x, bias, top_k=k, held=range(0, 8))
    parts = sum(moe.moe_topk(_share(full, h), x, bias, top_k=k, held=h)
                for h in (range(0, 2), range(2, 4), range(4, 6), range(6, 8)))
    assert _rel(parts, whole) <= 1e-5
    assert _rel(whole, _ref_moe(x, full, bias, k, range(0, 8))) <= 1e-5


def test_moe_drops_nothing_under_forced_imbalance():
    """A bias that sends every token to held expert 3: every assignment is
    computed (the layer equals the reference's), and the loads say so."""
    x, full = _moe_inputs(T=64)
    bias = torch.zeros(8)
    bias[3] = 10.0
    load = torch.zeros(8, dtype=torch.int64)
    held = range(2, 6)
    y = moe.moe_topk(_share(full, held), x, bias, top_k=2, held=held,
                     load_out=load)
    assert load[3] == 64 and int(load.sum()) == 128
    assert _rel(y, _ref_moe(x, full, bias, 2, held)) <= 1e-5


def test_moe_bias_only_chooses():
    """The weights come from the scores alone: a bias that keeps the choice
    (a constant) changes nothing, and one that changes it gives the
    reference's picks weighted by their unbiased scores."""
    x, full = _moe_inputs()
    held = range(0, 8)
    base = moe.moe_topk(full, x, torch.zeros(8), top_k=2, held=held)
    same = moe.moe_topk(full, x, torch.full((8,), 0.7), top_k=2, held=held)
    assert torch.equal(base, same)
    bias = torch.linspace(-0.2, 0.2, 8)
    idx, w = moe.route_topk(x, full["router"], bias, 2)
    s = torch.sigmoid(x @ full["router"])
    assert torch.equal(idx, torch.topk(s + bias, 2).indices)
    picked = s.gather(1, idx)
    assert torch.allclose(w, picked / (picked.sum(-1, keepdim=True) + 1e-6))
    y = moe.moe_topk(full, x, bias, top_k=2, held=held)
    assert _rel(y, _ref_moe(x, full, bias, 2, held)) <= 1e-5
    router = full["router"].clone().requires_grad_()
    moe.moe_topk(dict(full, router=router), x, bias.requires_grad_(),
                 top_k=2, held=held).sum().backward()
    assert bias.grad is None and router.grad.abs().sum() > 0


def test_end_step_moves_the_bias_by_the_sign_of_the_load_gap():
    c = _cfg()
    state = lfm2.LFM2State(c, "cpu")
    loads = torch.tensor([[8, 2, 2, 2, 2, 2, 2, 12]] * c.n_moe)  # mean 4
    loads[0] = 4
    state.loads.copy_(loads)
    lfm2.end_step(state, c)
    rate = c.expert_bias_rate
    assert torch.equal(state.expert_bias[0], torch.zeros(8))
    want = torch.tensor([-1, 1, 1, 1, 1, 1, 1, -1.0]) * rate
    assert torch.allclose(state.expert_bias[1], want)
    stats = lfm2.moe_stats(state, c)
    # held experts 2..5: 4 a layer 0, 8 in the other two
    assert stats["held"] == 16 + 2 * 8 and stats["held_total"] == 32
    assert stats["load_max_sum"] == pytest.approx((1 + 0.5 + 0.5) / 3)
    lfm2.end_step(state, c)
    assert torch.allclose(state.expert_bias[1], 2 * want)


@pytest.mark.parametrize("seed,held,force", [
    (0, range(0, 8), None), (1, range(2, 6), None), (2, range(2, 6), 3),
    (3, range(0, 1), 0), (4, range(6, 8), 1)])
def test_grouped_route_equals_the_loop(seed, held, force):
    """bf16, values and gradients: the sorted, padded buffer and its two
    gathers against one product pair an expert (``torch._grouped_mm`` on
    the CPU), including a range no token picks."""
    x, full = _moe_inputs(T=50, dtype=torch.bfloat16, seed=seed)
    bias = torch.zeros(8)
    if force is not None:
        bias[force] = 10.0
    got = {}
    for route in ("grouped", "loop"):
        xs = x.clone().requires_grad_()
        p = {a: t.clone().requires_grad_() for a, t in
             _share(full, held).items()}
        y = moe.moe_topk(p, xs, bias, top_k=3, held=held, route=route)
        (y.float() ** 2).sum().backward()
        got[route] = [y.float(), xs.grad.float(), p["w13"].grad.float(),
                      p["w2"].grad.float(), p["router"].grad]
    for a, b in zip(got["grouped"], got["loop"]):
        assert _rel(a, b) <= 1e-2 if b.abs().max() > 0 else a.abs().max() == 0


def test_held_layout_groups_every_held_assignment():
    idx = torch.tensor([[0, 3], [3, 5], [1, 3], [7, 6], [3, 2]])
    rows, assign, ends = moe._held_layout(idx, range(2, 6))
    A = moe.GROUP_ALIGN
    R = 5 * 2 + 4 * (A - 1)
    assert assign.shape == (R,) and ends.dtype == torch.int32
    # expert 2: 1 assignment, 3: 4, 4: none, 5: 1 -> groups of 16, 16, 0, 16
    assert ends.tolist() == [A, 2 * A, 2 * A, 3 * A]
    held = (idx >= 2) & (idx < 6)
    assert (rows[~held] == R).all()
    for t, j in held.nonzero().tolist():
        r = int(rows[t, j])
        assert int(assign[r]) == t * 2 + j
        g = int(idx[t, j]) - 2
        assert (0 if g == 0 else int(ends[g - 1])) <= r < int(ends[g])
    assert int((assign < 10).sum()) == int(held.sum())


def test_load_counts_are_written_not_added_under_remat():
    c = _cfg(remat=True)
    params = _grad_params(_params(c))
    state = lfm2.LFM2State(c, "cpu")
    lfm2.lm_loss(params, {"tokens": _tokens()}, c, state).backward()
    k = c.num_experts_per_tok
    assert (state.loads.sum(-1) == B * L * k).all()


def test_counters_count_forwards_and_calls():
    c = lfm2.tiny_lfm2(experts_held=range(2, 6))
    f0, m0 = lfm2.forwards, moe.topk_calls
    lfm2.forward(_params(c), _tokens(), c)
    assert lfm2.forwards - f0 == 1 and moe.topk_calls - m0 == c.n_moe


# -- the short conv, GQA ----------------------------------------------------

def test_conv_is_causal_and_is_a_depthwise_conv1d():
    c = _cfg()
    lp = {k: v[0] for k, v in _params(c)["conv"].items()}
    x = torch.randn(2, 24, c.d_model)
    y = lfm2._conv_mix(x, lp, c)
    x2 = x.clone()
    x2[:, 13:] = torch.randn(2, 11, c.d_model)
    assert torch.equal(lfm2._conv_mix(x2, lp, c)[:, :13], y[:, :13])
    assert not torch.allclose(lfm2._conv_mix(x2, lp, c)[:, 13:], y[:, 13:])
    conv = torch.nn.Conv1d(c.d_model, c.d_model, c.conv_L_cache,
                           groups=c.d_model, padding=c.conv_L_cache - 1,
                           bias=False)
    conv.weight.data.copy_(lp["conv"][:, None, :])
    b, gate, v = (x @ lp["in_proj"]).chunk(3, dim=-1)
    z = conv((b * v).transpose(1, 2))[..., :24].transpose(1, 2)
    want = (gate * z) @ lp["out_proj"]
    assert _rel(y, want) <= 1e-5
    with ref.no_tf32():
        assert _rel(y, ref._short_conv(x, lp, CFG, False)) <= 1e-5


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_gqa_expansion_is_per_group_attention(impl):
    c = _cfg(attn_impl=impl)
    g = torch.Generator().manual_seed(3)
    H, KV, Dh, T = c.n_heads, c.n_kv_heads, c.head_dim, 32
    q = torch.randn(2, T, H, Dh, generator=g)
    k = torch.randn(2, T, KV, Dh, generator=g)
    v = torch.randn(2, T, KV, Dh, generator=g)
    attend = transformer._make_attention(c)
    got = attend(q, k.repeat_interleave(H // KV, 2),
                 v.repeat_interleave(H // KV, 2))
    mask = torch.ones(T, T, dtype=torch.bool).tril()
    for h in range(H):
        s = q[:, :, h] @ k[:, :, h // (H // KV)].transpose(1, 2) / Dh ** 0.5
        o = torch.softmax(s.masked_fill(~mask, -torch.inf), -1) @ v[
            :, :, h // (H // KV)]
        assert _rel(got[:, :, h], o) <= 1e-5


def test_remat_full_and_none_give_equal_gradients():
    params, tokens, bias = _params(_cfg()), _tokens(), _bias(_cfg())
    _, plain, _ = _loss_and_grads(_cfg(), params, tokens, bias)
    _, full, _ = _loss_and_grads(_cfg(remat=True), params, tokens, bias)
    for name, g in plain.items():
        assert torch.allclose(full[name], g, rtol=0, atol=1e-7), name


# -- spans ------------------------------------------------------------------

@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(cfg_mod, "_global", None)
    monkeypatch.delenv("RAY_TPU_TRACE_ENABLED", raising=False)
    monkeypatch.delenv("RAY_TPU_TRACE_SAMPLE_RATE", raising=False)
    got = []
    tracing.set_sink(got.append)
    yield got
    tracing.set_sink(None)


def _loss(c, state=None):
    return lfm2.lm_loss(_params(c), {"tokens": _tokens()}, c, state)


def test_spans_open_only_inside_a_trace(spans):
    _loss(_cfg(dtype=torch.bfloat16))
    assert spans == []


def _nested(spans, inner, outer):
    """Every span named ``inner*`` lies inside its parent, one of ``outer``;
    how many lie in each."""
    by_id = {s["task_id"]: s for s in spans}
    where = {}
    for s in spans:
        if s["name"].startswith(inner):
            parent = by_id[s["parent_span_id"]]
            assert parent["name"] in outer
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
            where[parent["name"]] = where.get(parent["name"], 0) + 1
    return where


def test_spans_nest_inside_the_forward_and_the_recompute(spans):
    """On the CPU autograd recomputes on the calling thread, in the trace's
    context: the spans open again inside ``train.backward``."""
    c = lfm2.tiny_lfm2(remat=True)
    with tracing.span("fit"):
        loss = lfm2.lm_loss(_grad_params(_params(c)), {"tokens": _tokens()},
                            c)
        with tracing.step_span("train.backward"):
            loss.backward()
    names = [s["name"] for s in spans]
    # The loop route (f32 on the CPU) has no combine of its own.
    assert names.count("conv.mix") == 2 * c.n_conv
    assert names.count("moe.route") == names.count("moe.experts") \
        == 2 * c.n_moe
    one = c.n_conv + 2 * c.n_moe
    assert _nested(spans, ("moe.", "conv."), ("lm.forward",
                                             "train.backward")) == {
        "lm.forward": one, "train.backward": one}


def test_recompute_on_a_thread_without_context_opens_the_spans(spans):
    """A backward run on a thread with no trace context (as autograd's
    device thread on the card) recomputes each layer in the forward's
    context: the spans open again, inside the backward's time, under the
    forward's span."""
    c = lfm2.tiny_lfm2(remat=True)
    with tracing.span("fit"):
        loss = lfm2.lm_loss(_grad_params(_params(c)), {"tokens": _tokens()},
                            c)
        with tracing.step_span("train.backward"):
            worker = threading.Thread(target=loss.backward)
            worker.start()
            worker.join()
    back = next(s for s in spans if s["name"] == "train.backward")
    names = [s["name"] for s in spans]
    assert names.count("conv.mix") == 2 * c.n_conv
    assert names.count("moe.route") == 2 * c.n_moe
    recomputed = [s for s in spans if s["name"] in ("conv.mix", "moe.route")
                  and s["start_ns"] >= back["start_ns"]]
    assert len(recomputed) == c.n_conv + c.n_moe
    assert all(s["end_ns"] <= back["end_ns"] for s in recomputed)
    forward = next(s for s in spans if s["name"] == "lm.forward")
    assert {s["parent_span_id"] for s in recomputed} == {forward["task_id"]}
    assert tracing.current_context() is None or \
        tracing.current_context()[1] != forward["task_id"]


def test_router_enters_the_moe_as_its_f32_master(monkeypatch):
    """In bf16 compute the router reaches ``moe_topk`` as the f32 master
    (the config's ``assumed.router``), the experts in bf16; its gradient
    reaches the master."""
    c = _cfg(dtype=torch.bfloat16, remat=True)
    seen = []
    topk = moe.moe_topk

    def spy(params, x, *a, **kw):
        seen.append((params["router"].dtype, params["w13"].dtype, x.dtype))
        return topk(params, x, *a, **kw)

    monkeypatch.setattr(moe, "moe_topk", spy)
    params = _params(c)
    _, grads, _ = _loss_and_grads(c, params, _tokens(), _bias(c))
    assert seen and set(seen) == {(torch.float32, torch.bfloat16,
                                   torch.bfloat16)}
    assert grads["moe.router"].dtype == torch.float32
    assert float(grads["moe.router"].abs().max()) > 0


def test_grouped_route_spans(spans):
    x, full = _moe_inputs(dtype=torch.bfloat16)
    with tracing.span("layer"):
        moe.moe_topk(full, x, torch.zeros(8), top_k=2, held=range(0, 8),
                     route="grouped")
    assert [s["name"] for s in spans] == ["moe.route", "moe.experts",
                                          "moe.combine", "layer"]
    _nested(spans, "moe.", "layer")


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("T,force", [(4096, None), (4096, 3), (1000, None),
                                     (8, 0)])
def test_grouped_route_on_the_card(cuda, T, force):
    """``torch._grouped_mm`` on the card against the loop, values and
    gradients, with a bias forcing every token to one held expert, an
    uneven T and a T smaller than a group's padding."""
    x, full = _moe_inputs(T=T, D=256, Fe=128, E=32, dtype=torch.bfloat16)
    bias = torch.zeros(32, device=cuda)
    if force is not None:
        bias[force] = 10.0
    held = range(0, 8)
    got = {}
    for route in ("grouped", "loop"):
        xs = x.to(cuda).requires_grad_()
        p = {a: t.to(cuda).requires_grad_()
             for a, t in _share(full, held).items()}
        y = moe.moe_topk(p, xs, bias, top_k=4, held=held, route=route)
        y.float().square().sum().backward()
        got[route] = [y.float(), xs.grad.float(), p["w13"].grad.float(),
                      p["w2"].grad.float(), p["router"].grad]
    for a, b in zip(got["grouped"], got["loop"]):
        assert torch.isfinite(a).all()
        assert _rel(a, b) <= 2e-2


@pytest.mark.gpu
def test_grouped_route_makes_no_host_sync(cuda):
    x, full = _moe_inputs(T=2048, D=256, Fe=128, E=32, dtype=torch.bfloat16)
    xs = x.to(cuda).requires_grad_()
    p = {a: t.to(cuda).requires_grad_()
         for a, t in _share(full, range(0, 8)).items()}
    bias = torch.zeros(32, device=cuda)
    load = torch.zeros(32, dtype=torch.int64, device=cuda)
    moe.moe_topk(p, xs, bias, top_k=4, held=range(0, 8)).sum().backward()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe.moe_topk(p, xs, bias, top_k=4, held=range(0, 8),
                         load_out=load)
        y.float().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(load.sum()) == 2048 * 4


@pytest.mark.gpu
def test_bf16_step_on_the_card_matches_reference(cuda):
    """Flash K1-K3 (head_dim 32) and the grouped route under remat."""
    cfg = dict(CFG, hidden_size=128, dtype="bfloat16")
    c = lfm2.config_from_dict(cfg, attn_impl="flash", remat=True)
    params = {k: ({a: t.to(cuda) for a, t in v.items()}
                  if isinstance(v, dict) else v.to(cuda))
              for k, v in _params(c).items()}
    tokens = _tokens(length=128).to(cuda)
    bias = _bias(c).to(cuda)
    loss, grads, _ = _loss_and_grads(c, params, tokens, bias)
    rloss, rgrads = _ref_loss_and_grads(params, tokens, bias, cfg)
    assert abs(float(loss) - float(rloss)) <= 1e-4 * float(rloss)
    for name, gap in _bf16_gaps(grads, rgrads).items():
        assert gap <= (0.25 if name in ("moe.w13", "moe.w2") else 5e-2), name

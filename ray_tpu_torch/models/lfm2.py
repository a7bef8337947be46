"""LFM2-MoE (LiquidAI's LFM2-8B-A1B family): a hybrid of gated short-conv
and GQA attention layers with a dropless top-k sigmoid mixture of experts;
config, parameters, the training forward and the loss.

Every layer is ``h = x + op(RMSNorm(x))``, ``out = h + ffn(RMSNorm(h))``,
``op`` by ``layer_types``:

- ``conv``: ``[B, C, x] = split3(in_proj(h))``, ``y = C * conv(B * x)``
  with ``conv`` a causal depthwise convolution of ``conv_L_cache`` taps,
  then ``out_proj`` (no biases);
- ``full_attention``: ``n_heads`` query heads over ``n_kv_heads`` K/V heads
  (query head ``h`` reads K/V head ``h // (n_heads / n_kv_heads)``), a
  per-head RMSNorm on q and k, RoPE on halves at ``rope_theta``, causal
  softmax at ``1/sqrt(head_dim)``, ``o_proj`` (no biases).

``ffn`` is a dense SwiGLU ``w2(silu(w1 h) * w3 h)`` in the first
``num_dense_layers`` layers, then :func:`ops.moe.moe_topk` over
``num_experts`` experts with ``num_experts_per_tok`` picked a token, of
which the layer computes the share of ``experts_held`` (one card's part of
an expert-parallel layer). A final RMSNorm precedes the head, tied to the
token embedding.

Parameters are a dict of stacks, one per kind of sublayer, each on a
leading layer dim in layer order: ``conv`` [n_conv, ...], ``attn``
[n_attn, ...], ``dense`` [num_dense_layers, ...], ``moe`` [n_moe, ...]
(experts [n_moe, n_held, ...]); every sublayer's pre-norm sits in its own
stack. The expert bias is not a parameter: it lives in :class:`LFM2State`
with the loads the router counted, gets no gradient and no AdamW, and
:func:`end_step` moves it after each optimizer step (the post-step hook
``models.training.make_train_step`` takes).

:func:`forward` unbinds each stacked leaf once, before the layers and
outside the remat wrapper (as ``models/transformer.forward`` does), and
runs each layer under ``transformer._remat``'s policy. Compute is in
``dtype`` over the ``param_dtype`` masters, but for the router, which
enters :func:`ops.moe.route_topk` as its master (its logits and scores are
f32). Attention is
``transformer._make_attention``'s (flash K1-K3 where a block divides the
sequence) with K and V expanded to the query heads; autograd sums the
groups' gradients. ``forwards`` counts forwards; ``conv.mix`` is the span
of a conv layer's mixing (in_proj through out_proj), opened only inside a
trace someone asked for (``tracing.step_span``). Under remat a layer
carries the forward's trace context into its recomputation, so ``conv.mix``
and the MoE's spans open again inside the backward, on whatever thread
autograd recomputes it (on the card its device thread, which has no
context of its own: there they name the forward's span as their parent).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import transformer
from ray_tpu_torch.ops import moe
from ray_tpu_torch.ops.layers import linear, matmul_f32, rms_norm, rope
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils.device import resolve_device

# Forwards since import (or since a caller reset it to 0), bumped under the
# lock: several threads run forwards at once.
forwards = 0
_count_lock = threading.Lock()

LFM2_8B_A1B_LAYERS = (
    "conv", "conv", "full_attention", "conv", "conv", "conv",
    "full_attention", "conv", "conv", "conv", "full_attention", "conv",
    "conv", "conv", "full_attention", "conv", "conv", "conv",
    "full_attention", "conv", "conv", "full_attention", "conv", "conv")


@dataclass(frozen=True)
class LFM2Config:
    vocab_size: int = 65536
    d_model: int = 2048
    layer_types: Tuple[str, ...] = LFM2_8B_A1B_LAYERS
    n_heads: int = 32
    n_kv_heads: int = 8
    conv_L_cache: int = 3
    intermediate_size: int = 7168          # the dense layers' SwiGLU
    moe_intermediate_size: int = 1792      # each expert's SwiGLU
    num_experts: int = 32                  # routed over, all of them
    num_experts_per_tok: int = 4
    num_dense_layers: int = 2
    experts_held: range = range(0, 32)     # computed here
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    expert_bias_rate: float = 1e-3         # end_step's step size
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    max_seq_len: int = 128000
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # storage dtype
    attn_impl: str = "auto"                    # auto | dense | flash
    remat: bool = False
    remat_policy: str = "full"                 # "full" | "dots"

    @property
    def n_layers(self) -> int:
        return len(self.layer_types)

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def n_conv(self) -> int:
        return self.layer_types.count("conv")

    @property
    def n_attn(self) -> int:
        return self.layer_types.count("full_attention")

    @property
    def n_moe(self) -> int:
        return self.n_layers - self.num_dense_layers


def lfm2_8b_a1b(**kw) -> LFM2Config:
    """LFM2-8B-A1B at its published sizes (all 32 experts held unless
    ``experts_held`` says otherwise)."""
    return LFM2Config(**kw)


def tiny_lfm2(**kw) -> LFM2Config:
    """Test-sized config (runs in ms on CPU): one layer of each kind of
    mixing and of FFN, and experts split 8 over 4 held."""
    defaults = dict(
        vocab_size=256, d_model=64,
        layer_types=("conv", "full_attention", "conv", "full_attention"),
        n_heads=4, n_kv_heads=2, intermediate_size=96,
        moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2,
        num_dense_layers=1, experts_held=range(0, 8), max_seq_len=64,
        dtype=torch.float32)
    defaults.update(kw)
    return LFM2Config(**defaults)


def config_from_dict(cfg: Dict, **kw) -> LFM2Config:
    """The config of a published ``config.json`` (``model_type``
    ``lfm2_moe``), keys by their published names. Where the experts held
    here are fewer than the router's (``experts_held`` = [lo, hi),
    ``num_experts`` = hi - lo), the routed count is ``published``'s
    ``num_experts``. ``dtype``/``param_dtype`` name torch dtypes;
    ``expert_bias_rate`` sets :func:`end_step`'s step; ``kw`` overrides."""
    routed = cfg.get("published", {}).get("num_experts", cfg["num_experts"])
    held = cfg.get("experts_held", (0, routed))
    args = dict(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        layer_types=tuple(cfg["layer_types"]),
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        conv_L_cache=cfg["conv_L_cache"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        num_experts=routed, num_experts_per_tok=cfg["num_experts_per_tok"],
        num_dense_layers=cfg["num_dense_layers"],
        experts_held=range(held[0], held[1]),
        norm_topk_prob=cfg["norm_topk_prob"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]),
        norm_eps=cfg["norm_eps"], rope_theta=float(cfg["rope_theta"]),
        max_seq_len=cfg["max_position_embeddings"])
    for key in ("dtype", "param_dtype"):
        if key in cfg:
            args[key] = getattr(torch, cfg[key])
    if "expert_bias_rate" in cfg:
        args["expert_bias_rate"] = cfg["expert_bias_rate"]
    if len(args["layer_types"]) != cfg["num_hidden_layers"]:
        raise ValueError("layer_types does not list num_hidden_layers layers")
    args.update(kw)
    return LFM2Config(**args)


def init_params(config: LFM2Config,
                generator: Union[torch.Generator, int],
                device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Matrices normal(0, 0.02), conv taps normal(0, 1/sqrt(taps)), norm
    gains 1, drawn on the CPU from ``generator`` (or an int seed for one)
    and then moved, so one seed gives the same weights on every device."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    c = config
    D, Dh, V = c.d_model, c.head_dim, c.vocab_size
    n, Fe, Fd = len(c.experts_held), c.moe_intermediate_size, \
        c.intermediate_size

    def nrm(shape, s=0.02):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (x * s).to(device=dev, dtype=c.param_dtype)

    def ones(shape):
        return torch.ones(shape, dtype=c.param_dtype, device=dev)

    Lc, La, Ld, Lm = c.n_conv, c.n_attn, c.num_dense_layers, c.n_moe
    return {
        "tok_embed": nrm((V, D)),
        "conv": {"norm": ones((Lc, D)), "in_proj": nrm((Lc, D, 3 * D)),
                 "conv": nrm((Lc, D, c.conv_L_cache),
                             c.conv_L_cache ** -0.5),
                 "out_proj": nrm((Lc, D, D))},
        "attn": {"norm": ones((La, D)), "wq": nrm((La, D, c.n_heads * Dh)),
                 "wk": nrm((La, D, c.n_kv_heads * Dh)),
                 "wv": nrm((La, D, c.n_kv_heads * Dh)),
                 "q_norm": ones((La, Dh)), "k_norm": ones((La, Dh)),
                 "wo": nrm((La, c.n_heads * Dh, D))},
        "dense": {"norm": ones((Ld, D)), "w1": nrm((Ld, D, Fd)),
                  "w3": nrm((Ld, D, Fd)), "w2": nrm((Ld, Fd, D))},
        "moe": {"norm": ones((Lm, D)), "router": nrm((Lm, D, c.num_experts)),
                "w13": nrm((Lm, n, D, 2 * Fe)), "w2": nrm((Lm, n, Fe, D))},
        "final_norm": ones((D,)),
    }


class LFM2State:
    """Model state beside the parameters, on the device:

    - ``expert_bias`` [n_moe, E] f32: the selection-only router bias;
    - ``loads`` [n_moe, E] int64: each MoE layer's assignments per expert
      in the last forward, written by copy (``moe_topk``'s ``load_out``);
    - ``held_total`` (int64) and ``load_max_sum`` (f32): over the steps
      :func:`end_step` closed, the assignments to the experts held, and
      the sum of each step's largest held load over the mean load
      (averaged over the MoE layers); ``steps`` counts those steps;
    - ``routes``: None, or [n_moe, B * L, k] int64 that the next forward's
      MoE layers write their picks into (by copy)."""

    def __init__(self, config: LFM2Config, device=None):
        dev = resolve_device(device)
        shape = (config.n_moe, config.num_experts)
        self.expert_bias = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.loads = torch.zeros(shape, dtype=torch.int64, device=dev)
        self.held_total = torch.zeros((), dtype=torch.int64, device=dev)
        self.load_max_sum = torch.zeros((), dtype=torch.float32, device=dev)
        self.steps = 0
        self.routes: Optional[torch.Tensor] = None


@torch.no_grad()
def end_step(state: LFM2State, config: LFM2Config) -> None:
    """After an optimizer step: ``b_e += rate * sign(mean_load - load_e)``
    per MoE layer from that step's loads over all experts (DeepSeek-V3's
    loss-free balancing, arXiv:2412.19437), and the running sums of
    :class:`LFM2State`. Device ops only."""
    loads = state.loads.float()
    mean = loads.mean(dim=-1, keepdim=True)
    state.expert_bias.add_(torch.sign(mean - loads),
                           alpha=config.expert_bias_rate)
    h = config.experts_held
    held = state.loads[:, h.start:h.stop]
    state.held_total.add_(held.sum())
    state.load_max_sum.add_((held.float().amax(dim=-1) / mean[:, 0]).mean())
    state.steps += 1


def moe_stats(state: LFM2State, config: LFM2Config) -> Dict:
    """The state's counts on the host, after a synchronise: the last
    forward's ``loads`` [n_moe, E] and its assignments ``held`` here, and
    the running ``held_total``, ``load_max_sum`` and ``steps``."""
    if state.loads.is_cuda:
        torch.cuda.synchronize(state.loads.device)
    h = config.experts_held
    loads = state.loads.cpu()
    return {"loads": loads.tolist(),
            "held": int(loads[:, h.start:h.stop].sum()),
            "held_total": int(state.held_total.cpu()),
            "load_max_sum": float(state.load_max_sum.cpu()),
            "steps": state.steps}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv_mix(x, lp, c: LFM2Config):
    """The gated short conv: ``out_proj(C * conv(B * x))``."""
    with tracing.step_span("conv.mix"):
        b, gate, v = linear(x, lp["in_proj"]).chunk(3, dim=-1)
        L = x.shape[1]
        y = F.conv1d((b * v).transpose(1, 2), lp["conv"][:, None, :],
                     padding=c.conv_L_cache - 1, groups=c.d_model)
        return linear(gate * y[..., :L].transpose(1, 2), lp["out_proj"])


def _attention(x, lp, c: LFM2Config, attend):
    """GQA with per-head q/k RMSNorm and RoPE; ``attend(q, k, v)`` takes
    [B, L, H, Dh] with K and V expanded to the query heads."""
    B, L, _ = x.shape
    H, KV, Dh = c.n_heads, c.n_kv_heads, c.head_dim
    q = rms_norm(linear(x, lp["wq"]).view(B, L, H, Dh), lp["q_norm"],
                 c.norm_eps)
    k = rms_norm(linear(x, lp["wk"]).view(B, L, KV, Dh), lp["k_norm"],
                 c.norm_eps)
    v = linear(x, lp["wv"]).view(B, L, KV, Dh)
    pos = torch.arange(L, device=x.device)
    q = rope(q, pos, base=c.rope_theta)
    k = rope(k, pos, base=c.rope_theta)
    o = attend(q, k.repeat_interleave(H // KV, dim=2),
               v.repeat_interleave(H // KV, dim=2))
    return linear(o.reshape(B, L, H * Dh), lp["wo"])


def _dense_ffn(x, lp):
    return linear(F.silu(linear(x, lp["w1"])) * linear(x, lp["w3"]),
                  lp["w2"])


def _moe_ffn(x, lp, c: LFM2Config):
    return moe.moe_topk(
        lp, x, lp["bias"], top_k=c.num_experts_per_tok,
        held=c.experts_held, scaling=c.routed_scaling_factor,
        norm=c.norm_topk_prob, load_out=lp.get("load"),
        route_out=lp.get("route"))


# A MoE layer's leaves that enter it as they are: the router's f32 master
# (the config's ``assumed.router``) and its state, which is no parameter.
_UNCAST = ("router", "bias", "load", "route")


def _layer(h, lp, *, c: LFM2Config, op: str, ffn: str, attend):
    """One layer; ``lp`` holds the mixing's (``op``) and the FFN's
    (``ffn``) parameters, cast to the compute dtype here, but for the
    ``_UNCAST`` leaves."""
    cast = lambda d: {k: (v if k in _UNCAST else v.to(c.dtype))
                      for k, v in d.items()}
    mix, ff = cast(lp["op"]), cast(lp["ffn"])
    x = rms_norm(h, mix["norm"], c.norm_eps)
    if op == "conv":
        h = h + _conv_mix(x, mix, c)
    else:
        h = h + _attention(x, mix, c, attend)
    x = rms_norm(h, ff["norm"], c.norm_eps)
    return h + (_dense_ffn(x, ff) if ffn == "dense" else _moe_ffn(x, ff, c))


def _in_context(fn, ctx):
    """``fn`` run in trace context ``ctx`` wherever it runs with none of
    its own: the remat recompute, on autograd's device thread on the card.
    Where a context is open (the forward; the backward on the CPU, which
    recomputes on the calling thread) that one holds."""
    if ctx is None:
        return fn

    def run(*args):
        if tracing.current_context() is not None:
            return fn(*args)
        tracing.set_context(ctx)
        try:
            return fn(*args)
        finally:
            tracing.set_context(None)
    return run


def _check_held(c: LFM2Config):
    h = c.experts_held
    if h.step != 1 or not 0 <= h.start < h.stop <= c.num_experts:
        raise ValueError(f"experts_held {h} is not a range of expert ids "
                         f"in [0, {c.num_experts})")


def forward(params: Dict, tokens: torch.Tensor, config: LFM2Config,
            state: Optional[LFM2State] = None) -> torch.Tensor:
    """tokens [B, L] -> logits [B, L, vocab] in the compute dtype. The MoE
    layers route with ``state.expert_bias`` and write their loads into
    ``state.loads`` and, where set, their picks into ``state.routes`` (a
    zero bias without a state)."""
    global forwards
    c = config
    _check_held(c)
    h = F.embedding(tokens, params["tok_embed"].to(c.dtype))
    attend = transformer._make_attention(c)
    # Outside the remat wrapper, so the recompute does not repeat it.
    stacks = {kind: {k: v.unbind(0) for k, v in params[kind].items()}
              for kind in ("conv", "attn", "dense", "moe")}
    if state is None:
        state = LFM2State(c, tokens.device)
    bias, loads = state.expert_bias.unbind(0), state.loads.unbind(0)
    with _count_lock:
        forwards += 1
    ctx = tracing.current_context() if c.remat else None
    seen = {"conv": 0, "attn": 0, "dense": 0, "moe": 0}
    for i, kind in enumerate(c.layer_types):
        op = "conv" if kind == "conv" else "attn"
        ffn = "dense" if i < c.num_dense_layers else "moe"
        mix = {k: v[seen[op]] for k, v in stacks[op].items()}
        ff = {k: v[seen[ffn]] for k, v in stacks[ffn].items()}
        if ffn == "moe":
            j = seen[ffn]
            ff.update(bias=bias[j], load=loads[j])
            if state.routes is not None:
                ff["route"] = state.routes[j]
        seen[op] += 1
        seen[ffn] += 1
        layer = transformer._remat(_in_context(functools.partial(
            _layer, c=c, op=op, ffn=ffn, attend=attend), ctx), c)
        h = layer(h, {"op": mix, "ffn": ff})
    h = rms_norm(h, params["final_norm"].to(c.dtype), c.norm_eps)
    return matmul_f32(h, params["tok_embed"].to(c.dtype).T).to(c.dtype)


def lm_loss(params: Dict, batch: Dict[str, torch.Tensor],
            config: LFM2Config,
            state: Optional[LFM2State] = None) -> torch.Tensor:
    """Next-token LM loss (``transformer``'s: f32 cross-entropy, optional
    ``loss_mask``). Opens the spans ``lm.forward`` and ``lm.loss`` inside a
    trace that was asked for (``step_span``)."""
    tokens = batch["tokens"]
    with tracing.step_span("lm.forward"):
        logits = forward(params, tokens, config, state)
    with tracing.step_span("lm.loss"):
        return transformer._next_token_loss(logits, tokens, batch,
                                            transformer._no_constraint)

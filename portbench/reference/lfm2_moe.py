"""Plain LFM2-MoE in PyTorch: the forward pass, the next-token loss, its
gradients, AdamW and the expert-bias update, in float32 with TF32 off.

This is the yardstick the port's LFM2 is judged by. It imports nothing of
the port or of JAX and takes nothing the port made: the caller hands it the
weights and the tokens (made from a seed) and it routes every token from
its own scores.

The model follows LiquidAI's LFM2-MoE (``model_type`` ``lfm2_moe``, the
configuration's keys by their published names). Every layer is
``h = x + op(rms(x))``, ``out = h + ffn(rms(h))``:

- ``conv`` layers: ``[B, C, x] = split3(x @ in_proj)``,
  ``y[t] = sum_j conv[:, j] * (B * x)[t - L_cache + 1 + j]`` (causal,
  depthwise, zeros before the row), ``(C * y) @ out_proj``;
- ``full_attention`` layers: GQA, each group of ``heads / kv_heads`` query
  heads over its own K/V head, RMSNorm over each head of q and k, RoPE on
  halves (``theta ** (-2i / head_dim)``), causal softmax at
  ``1/sqrt(head_dim)`` over the whole row, ``@ wo``;
- the first ``num_dense_layers`` FFNs: ``(silu(x @ w1) * (x @ w3)) @ w2``;
- the rest: ``s = sigmoid(x @ router)`` over every routed expert
  (``published.num_experts``), the top ``num_experts_per_tok`` of
  ``s + expert_bias`` picked (the bias chooses, it does not weigh), weights
  the picked ``s`` over their sum plus 1e-6 (``norm_topk_prob``) times
  ``routed_scaling_factor``; each expert in ``experts_held`` adds its
  weighted SwiGLU (``w13`` holds w1 then w3) for the tokens that picked
  it, one expert at a time. Experts not held add nothing: this is the
  share of one card of an expert-parallel layer, as the program computes.
- a final RMSNorm and the head tied to the token embedding.

Departures, none of which changes a value: attention runs in blocks of
``QUERY_BLOCK`` queries over the keys up to each block's end, and each
layer runs under ``torch.utils.checkpoint`` (recomputed in the backward),
so that a row of 8192 fits beside the optimizer state. Packed documents
attend across their boundaries, as the program's do.

``fp8=True`` is the lower-precision control: every product with a weight
(in_proj, out_proj, q, k, v, o, the dense FFN, the experts and the head;
the router stays in float32, as the program keeps it) takes both operands
rounded to float8 e4m3 with one scale a tensor, and in the backward the
incoming gradient rounded to float8 e5m2. Everything else stays float32.

The expert bias moves after each optimizer step by
``expert_bias_rate * sign(mean load - load)`` per layer, from the step's
loads over every routed expert and every row of the batch.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F8_FWD = torch.float8_e4m3fn
F8_BWD = torch.float8_e5m2
QUERY_BLOCK = 1024


@contextlib.contextmanager
def no_tf32():
    """Full float32 products: TF32 off for matmuls and cuDNN, restored
    after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def quantize(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under one scale that maps its largest
    magnitude onto the format's largest value, returned in float32."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = torch.finfo(fmt).max / amax
    return (x * scale).to(fmt).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w):
        aq, wq = quantize(a, F8_FWD), quantize(w, F8_FWD)
        ctx.save_for_backward(aq, wq)
        return aq @ wq

    @staticmethod
    def backward(ctx, g):
        aq, wq = ctx.saved_tensors
        gq = quantize(g, F8_BWD)
        ga = gq @ wq.T
        gw = aq.reshape(-1, aq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return ga, gw


def _mm(a: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """``a @ w`` for ``a`` [..., K] and ``w`` [K, N]."""
    return _Fp8Matmul.apply(a, w) if fp8 else a @ w


def routed_experts(cfg: Dict) -> int:
    """The experts the router scores: the published count."""
    return cfg.get("published", {}).get("num_experts", cfg["num_experts"])


def held_experts(cfg: Dict) -> range:
    lo, hi = cfg["experts_held"]
    return range(lo, hi)


def moe_layers(cfg: Dict) -> int:
    return cfg["num_hidden_layers"] - cfg["num_dense_layers"]


def _rms(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def _rope(x, theta):
    """Rotate the halves of ``x`` [B, T, H, Dh] at positions 0..T-1."""
    T, Dh = x.shape[1], x.shape[-1]
    half = Dh // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) * 2 / Dh)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _short_conv(x, p, cfg, fp8):
    D, K = cfg["hidden_size"], cfg["conv_L_cache"]
    b, c, v = _mm(x, p["in_proj"], fp8).split(D, dim=-1)
    z = F.pad(b * v, (0, 0, K - 1, 0))
    T = x.shape[1]
    y = sum(z[:, j:j + T] * p["conv"][:, j] for j in range(K))
    return _mm(c * y, p["out_proj"], fp8)


def _attention(x, p, cfg, fp8):
    B, T, D = x.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh, eps = D // H, cfg["norm_eps"]
    q = _rms(_mm(x, p["wq"], fp8).view(B, T, H, Dh), p["q_norm"], eps)
    k = _rms(_mm(x, p["wk"], fp8).view(B, T, KV, Dh), p["k_norm"], eps)
    v = _mm(x, p["wv"], fp8).view(B, T, KV, Dh)
    q = _rope(q, cfg["rope_theta"]).view(B, T, KV, H // KV, Dh)
    k = _rope(k, cfg["rope_theta"])
    outs = []
    for t0 in range(0, T, QUERY_BLOCK):
        t1 = min(T, t0 + QUERY_BLOCK)
        s = torch.einsum("bqgrd,bkgd->bgrqk", q[:, t0:t1], k[:, :t1])
        s = s / math.sqrt(Dh)
        keep = (torch.arange(t0, t1, device=x.device)[:, None]
                >= torch.arange(t1, device=x.device)[None])
        prob = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(torch.einsum("bgrqk,bkgd->bqgrd", prob, v[:, :t1]))
    o = torch.cat(outs, dim=1).reshape(B, T, D)
    return _mm(o, p["wo"], fp8)


def _dense(x, p, fp8):
    return _mm(F.silu(_mm(x, p["w1"], fp8)) * _mm(x, p["w3"], fp8),
               p["w2"], fp8)


def _moe(x, p, bias, cfg, fp8, load_out, route_out):
    B, T, D = x.shape
    flat = x.reshape(B * T, D)
    k, Fe = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    s = torch.sigmoid(flat @ p["router"])
    idx = torch.topk(s.detach() + bias, k, dim=-1).indices
    w = s.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)
    w = w * cfg["routed_scaling_factor"]
    if load_out is not None:
        load_out.copy_(torch.bincount(idx.reshape(-1),
                                      minlength=routed_experts(cfg)))
    if route_out is not None:
        route_out.copy_(idx)
    y = torch.zeros_like(flat)
    for g, e in enumerate(held_experts(cfg)):
        t, j = (idx == e).nonzero(as_tuple=True)
        xe = flat[t]
        w13 = p["w13"][g]
        h = F.silu(_mm(xe, w13[:, :Fe], fp8)) * _mm(xe, w13[:, Fe:], fp8)
        y = y.index_add(0, t, _mm(h, p["w2"][g], fp8) * w[t, j, None])
    return y.reshape(B, T, D)


def _layer(h, mix, ff, bias, *, cfg, kind, dense, fp8, load_out, route_out):
    eps = cfg["norm_eps"]
    x = _rms(h, mix["norm"], eps)
    h = h + (_short_conv(x, mix, cfg, fp8) if kind == "conv"
             else _attention(x, mix, cfg, fp8))
    x = _rms(h, ff["norm"], eps)
    return h + (_dense(x, ff, fp8) if dense
                else _moe(x, ff, bias, cfg, fp8, load_out, route_out))


def forward(params: Dict, tokens: torch.Tensor, cfg: Dict,
            bias: torch.Tensor, *, fp8: bool = False,
            loads: Optional[torch.Tensor] = None,
            routes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits [B, T, vocab_size] in float32 for ``tokens`` [B, T].
    ``params`` is the weight tree (any float dtype; computed in float32),
    ``bias`` the expert bias [moe layers, routed experts]. ``loads``
    [moe layers, routed experts] and ``routes`` [moe layers, B * T, k],
    where given, receive each MoE layer's counts and picks by copy."""
    f = lambda t: t.float()
    emb = f(params["tok_embed"])
    h = emb[tokens]
    n = {"conv": 0, "attn": 0, "dense": 0, "moe": 0}
    for i, kind in enumerate(cfg["layer_types"]):
        op = "conv" if kind == "conv" else "attn"
        dense = i < cfg["num_dense_layers"]
        fk = "dense" if dense else "moe"
        mix = {a: f(v[n[op]]) for a, v in params[op].items()}
        ff = {a: f(v[n[fk]]) for a, v in params[fk].items()}
        j = n["moe"]
        layer = functools.partial(_layer, cfg=cfg, kind=kind, dense=dense,
                                  fp8=fp8)
        kw = {"load_out": None if dense or loads is None else loads[j],
              "route_out": None if dense or routes is None else routes[j]}
        b = None if dense else bias[j]
        if torch.is_grad_enabled():
            h = checkpoint(layer, h, mix, ff, b, use_reentrant=False, **kw)
        else:
            h = layer(h, mix, ff, b, **kw)
        n[op] += 1
        n[fk] += 1
    h = _rms(h, f(params["final_norm"]), cfg["norm_eps"])
    return _mm(h, emb.T, fp8)


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def leaf_names(tree) -> List[str]:
    return [n for n, _ in _leaf_items(tree)]


def _tree(flat):
    out = {}
    for n, t in flat.items():
        node = out
        *path, leaf = n.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def _nll_sum(params, rows, cfg, bias, fp8, loads, routes):
    """Summed next-token negative log-likelihood of ``rows`` [b, T]."""
    logits = forward(params, rows, cfg, bias, fp8=fp8, loads=loads,
                     routes=routes)[:, :-1]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, rows[:, 1:, None])[..., 0]
    return (logz - gold).sum()


def train(params0: Dict, batches: Sequence[torch.Tensor], cfg: Dict,
          opt: Dict, *, fp8: bool = False, rows_per_pass: int = 1,
          route_rows: int = 0) -> Dict:
    """AdamW (optax's update: bias-corrected moments, eps outside the root,
    decoupled decay ``lr * wd * p`` on every leaf) from ``params0`` over
    ``batches``, one step each, the loss the mean next-token NLL of a batch,
    the expert bias (from zero) moved after each step. Gradients are
    summed over passes of ``rows_per_pass`` rows.

    Returns ``{"losses", "grad_norms": {leaf: norm of step 1's gradient},
    "change_norms": {leaf: norm of p_final - p0}, "bias": the final expert
    bias, "routes": step 1's picks [moe layers, route_rows * T, k] for its
    first ``route_rows`` rows (with ``route_rows``, a multiple of
    ``rows_per_pass``)}``. ``params0`` is not modified."""
    names = leaf_names(params0)
    dev = batches[0].device
    p = {n: t.detach().float().clone().requires_grad_(True)
         for n, t in _leaf_items(params0)}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    lr, wd = opt["lr"], opt["weight_decay"]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    L, E = moe_layers(cfg), routed_experts(cfg)
    k = cfg["num_experts_per_tok"]
    bias = torch.zeros(L, E, device=dev)
    losses, grad_norms, routes = [], {}, None

    with no_tf32():
        for step, tokens in enumerate(batches, start=1):
            B, T = tokens.shape
            count = B * (T - 1)
            total = 0.0
            loads = torch.zeros(L, E, dtype=torch.int64, device=dev)
            if step == 1 and route_rows:
                routes = torch.zeros(L, route_rows * T, k, dtype=torch.int64,
                                     device=dev)
            for r in range(0, B, rows_per_pass):
                got = torch.zeros_like(loads)
                rr = (routes[:, r * T:(r + rows_per_pass) * T]
                      if step == 1 and r < route_rows else None)
                nll = _nll_sum(_tree(p), tokens[r:r + rows_per_pass], cfg,
                               bias, fp8, got, rr)
                (nll / count).backward()
                total += float(nll.detach())
                loads += got
            losses.append(total / count)
            with torch.no_grad():
                for n in names:
                    g = p[n].grad
                    if step == 1:
                        grad_norms[n] = float(g.norm())
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mh = m[n] / (1 - b1 ** step)
                    vh = v[n] / (1 - b2 ** step)
                    p[n].sub_(lr * (mh / (vh.sqrt() + eps) + wd * p[n]))
                    p[n].grad = None
                lf = loads.float()
                bias += cfg["expert_bias_rate"] * torch.sign(
                    lf.mean(dim=-1, keepdim=True) - lf)
        with torch.no_grad():
            change = {n: float((p[n] - t.float()).norm())
                      for n, t in _leaf_items(params0)}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "bias": bias, "routes": routes}

"""Plain GPT-2 in PyTorch: the forward pass, the next-token loss, its
gradients and the AdamW update, in float32 with TF32 off.

This is the yardstick the port is judged by. It imports nothing of the port
and takes nothing the port made: the benchmark makes the weights and the
inputs from the seed (``portbench/weights.py``, ``portbench/traffic/``) and
hands the same to both sides.

The model follows Radford et al. 2019 (GPT-2): learned token and position
embeddings, pre-norm blocks of causal multi-head attention and a tanh-GELU
MLP, a final layer norm and an output head tied to the token embedding.
One departure, to judge the port on its own terms: the vocabulary is padded
to ``padded_vocab`` rows (the port pads it to a multiple of 128), and the
training softmax runs over every padded row, as the port's loss does.
Serving compares logits over the real vocabulary only.

``fp8=True`` is the lower-precision control: every product with a weight
(q, k, v, the output projection, the MLP and the head) takes both operands
rounded to float8 e4m3 with one scale a tensor, and in the backward the
incoming gradient rounded to float8 e5m2, as fp8 training recipes do.
Everything else stays in float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch

F8_FWD = torch.float8_e4m3fn
F8_BWD = torch.float8_e5m2


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


def _layer_norm(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def forward(params: Dict, tokens: torch.Tensor, cfg: Dict, *,
            fp8: bool = False, start: int = 0) -> torch.Tensor:
    """Logits [B, T, padded_vocab] in float32 for ``tokens`` [B, T] at
    positions ``start .. start + T - 1``, over the whole causal context
    given. ``params`` is the benchmark's weight tree (any float dtype;
    computed in float32)."""
    d, H = cfg["n_embd"], cfg["n_head"]
    Dh = d // H
    eps = cfg["layer_norm_epsilon"]
    f = lambda t: t.float()
    blocks = params["blocks"]
    B, T = tokens.shape
    emb = f(params["tok_embed"])
    h = emb[tokens] + f(params["pos_embed"])[start:start + T]
    mask = torch.ones(T, T, dtype=torch.bool, device=tokens.device).tril()
    for i in range(cfg["n_layer"]):
        p = {k: f(v[i]) for k, v in blocks.items()}
        a = _layer_norm(h, p["ln1_g"], p["ln1_b"], eps)
        q = (_mm(a, p["wq"].reshape(d, d), fp8) + p["bq"].reshape(d)) \
            .reshape(B, T, H, Dh).transpose(1, 2)
        k = (_mm(a, p["wk"].reshape(d, d), fp8) + p["bk"].reshape(d)) \
            .reshape(B, T, H, Dh).transpose(1, 2)
        v = (_mm(a, p["wv"].reshape(d, d), fp8) + p["bv"].reshape(d)) \
            .reshape(B, T, H, Dh).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(Dh)
        s = s.masked_fill(~mask, float("-inf"))
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, T, d)
        h = h + _mm(o, p["wo"].reshape(d, d), fp8) + p["bo"]
        m = _layer_norm(h, p["ln2_g"], p["ln2_b"], eps)
        u = _gelu(_mm(m, p["w_up"], fp8) + p["b_up"])
        h = h + _mm(u, p["w_down"], fp8) + p["b_down"]
    h = _layer_norm(h, f(params["lnf_g"]), f(params["lnf_b"]), eps)
    return _mm(h, emb.T, fp8)


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def leaf_names(tree) -> List[str]:
    return [n for n, _ in _leaf_items(tree)]


def _nll_sum(params, rows, cfg, fp8):
    """Summed next-token negative log-likelihood of ``rows`` [b, T] over
    the padded vocabulary."""
    logits = forward(params, rows, cfg, fp8=fp8)[:, :-1]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, rows[:, 1:, None])[..., 0]
    return (logz - gold).sum()


def train(params0: Dict, batches: Sequence[torch.Tensor], cfg: Dict, opt: Dict,
          *, fp8: bool = False, rows_per_pass: int = 1) -> Dict:
    """AdamW (optax's update: bias-corrected moments, eps outside the root,
    decoupled decay ``lr * wd * p``) from ``params0`` over ``batches``, one
    step each, the loss the mean next-token NLL of a batch. Gradients are
    summed over passes of ``rows_per_pass`` rows, so a full batch never
    sits in memory at once.

    Returns ``{"losses": [...], "grad_norms": {leaf: norm of step 1's
    gradient}, "change_norms": {leaf: norm of p_final - p0}}``. ``params0``
    is not modified."""
    names = leaf_names(params0)
    p = {n: t.detach().float().clone().requires_grad_(True)
         for n, t in _leaf_items(params0)}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    lr, wd = opt["lr"], opt["weight_decay"]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, grad_norms = [], {}

    def tree(flat):
        out = {}
        for n, t in flat.items():
            node = out
            *path, leaf = n.split(".")
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = t
        return out

    with no_tf32():
        for step, tokens in enumerate(batches, start=1):
            B, T = tokens.shape
            count = B * (T - 1)
            total = 0.0
            for r in range(0, B, rows_per_pass):
                nll = _nll_sum(tree(p), tokens[r:r + rows_per_pass], cfg, fp8)
                (nll / count).backward()
                total += float(nll.detach())
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
        with torch.no_grad():
            change = {n: float((p[n] - t.float()).norm())
                      for n, t in _leaf_items(params0)}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


@torch.no_grad()
def next_token_logits(params: Dict, seq: Sequence[int], prompt_len: int,
                      cfg: Dict, *, fp8: bool = False,
                      device=None) -> torch.Tensor:
    """Logits over the real vocabulary [n, vocab_size], float32, that
    predict ``seq[prompt_len:]`` (n tokens) from everything before each:
    one full forward over ``seq`` (no cache)."""
    t = torch.as_tensor(list(seq), dtype=torch.long, device=device)[None]
    with no_tf32():
        logits = forward(params, t, cfg, fp8=fp8)
    return logits[0, prompt_len - 1:len(seq) - 1, :cfg["vocab_size"]]

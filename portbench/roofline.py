"""The yardstick: the card's published peaks and the operations and bytes
that a step's inputs need.

Every share computed from these counts what the inputs need, never what a
kernel happens to launch or recompute, so a later kernel that does the same
work another way is judged against the same count. Peaks are NVIDIA's data
sheet for the H100 SXM part (dense rates, no sparsity), at its 700 W limit;
results print the card's own power limit beside them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BF16 = 2


def causal_pairs(lq: int, offset: int = 0) -> int:
    """Attended (query, key) pairs of ``lq`` queries at positions
    ``offset .. offset + lq - 1`` over a causal context: query t sees the
    ``offset + t + 1`` keys up to and including its own position."""
    return lq * offset + lq * (lq + 1) // 2


def matmul_params(cfg: Dict) -> int:
    """Weights that take part in a matrix product for one token: q, k, v and
    the output projection (4 d^2), the MLP (2 d d_ff) in every layer, and
    the tied output head over the real vocabulary (d V). Biases, norms and
    the embedding lookup are not products."""
    d, f, n = cfg["n_embd"], cfg["n_inner"], cfg["n_layer"]
    return n * (4 * d * d + 2 * d * f) + d * cfg["vocab_size"]


def attention_flops(cfg: Dict, pairs: int) -> int:
    """Forward attention over ``pairs`` attended pairs in one layer: the
    score product and the product with V, 2 flops a multiply-add each, over
    every head: 4 d pairs."""
    return 4 * cfg["n_embd"] * pairs


def train_step_flops(cfg: Dict, batch: int, seq: int) -> int:
    """Model operations of one training step on ``batch`` rows of ``seq``
    tokens: 6 flops a matmul weight a token (forward 2, backward 4), and
    causal attention forward plus backward (3x the forward: the four
    backward products cost twice the two forward ones) in every layer.
    Recomputation is not counted: it is work the step chose, not work the
    inputs need."""
    tokens = batch * seq
    attn = 3 * attention_flops(cfg, causal_pairs(seq)) * batch
    return 6 * matmul_params(cfg) * tokens + cfg["n_layer"] * attn


def flash_bound_s(kernel: str, B: int, L: int, H: int, D: int,
                  dtype: str = "bfloat16") -> Tuple[float, int, int]:
    """``(seconds, bytes, flops)``: the least time one causal flash call of
    ``kernel`` (``forward``, ``dq`` or ``dkv``) over [B, L, H, D] can take,
    each input read once and each output written once (q, k, v; for the
    backward also dO, lse and delta; o and lse, dq, or dk and dv), and 4, 6
    or 8 D flops a pair a head: the score product and one product an
    output, the backward recomputing P and forming dP."""
    el = BF16 if dtype == "bfloat16" else 4
    pairs = causal_pairs(L) * B * H
    x, rows = B * L * H * D, B * H * L
    if kernel == "forward":
        nbytes, per_pair = 4 * x * el + 4 * rows, 4
    elif kernel == "dq":
        nbytes, per_pair = 5 * x * el + 8 * rows, 6
    elif kernel == "dkv":
        nbytes, per_pair = 6 * x * el + 8 * rows, 8
    else:
        raise ValueError(f"unknown flash kernel {kernel!r}")
    flops = per_pair * D * pairs
    return (max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]),
            nbytes, flops)


def paged_decode_need(cfg: Dict, contexts: Iterable[int]) -> Tuple[int, int]:
    """``(bytes, flops)`` that K4 needs in one layer for decode tokens whose
    attended contexts (keys, the token's own included) are ``contexts``:
    each reads its context's K and V once and its query once, writes its
    output once, and spends 4 D flops a key a head."""
    hd = cfg["n_embd"]
    keys = n = 0
    for c in contexts:
        keys += c
        n += 1
    nbytes = (2 * keys * hd + 2 * n * hd) * BF16
    return nbytes, 4 * hd * keys


def paged_prefill_need(cfg: Dict, cached: int, suffix: int) -> Tuple[int, int]:
    """``(bytes, flops)`` that K4 needs in one layer to prefill ``suffix``
    tokens after ``cached`` tokens already in the pool: K and V of every
    position read once, the suffix's queries read and outputs written once,
    4 D flops a causal pair."""
    hd = cfg["n_embd"]
    nbytes = (2 * (cached + suffix) * hd + 2 * suffix * hd) * BF16
    return nbytes, attention_flops(cfg, causal_pairs(suffix, offset=cached))


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The roofline's least time for ``nbytes`` and ``flops``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])

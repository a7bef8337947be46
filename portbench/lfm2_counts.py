"""The operations and bytes an LFM2-MoE training step's inputs need, for
the ``.lfm2-train`` metrics; peaks and the flash kernels' bounds are
``portbench/roofline.py``'s.

Counts follow the configuration and the step's shapes, never what a kernel
happens to launch: 6 flops a matmul weight a token (forward 2, backward 4)
for every product the token passes through (conv in/out, attention q, k,
v, o, the dense FFN, the router, the tied head over the whole vocabulary),
6 x 3 D F_e for each assignment to an expert held here (the expert's gate,
up and down products), and causal attention forward plus backward. The
experts' assignments are data: they come from the program's counter
(``models.lfm2.moe_stats``). Recomputation under remat is not counted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench import roofline

BF16 = roofline.BF16


def _dims(cfg: Dict) -> Dict[str, int]:
    D = cfg["hidden_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    types = cfg["layer_types"]
    lo, hi = cfg["experts_held"]
    return {"D": D, "H": H, "KV": KV, "Dh": D // H,
            "conv": sum(t == "conv" for t in types),
            "attn": sum(t != "conv" for t in types),
            "dense": cfg["num_dense_layers"],
            "moe": cfg["num_hidden_layers"] - cfg["num_dense_layers"],
            "E": cfg.get("published", {}).get("num_experts",
                                              cfg["num_experts"]),
            "held": hi - lo, "Fe": cfg["moe_intermediate_size"],
            "Fd": cfg["intermediate_size"], "V": cfg["vocab_size"]}


def matmul_params(cfg: Dict) -> int:
    """Weights of the products every token passes through, experts aside:
    conv in_proj (3 D^2) and out_proj (D^2), attention q and o (D H Dh
    each) and k and v (D KV Dh each), the dense SwiGLU (3 D F), the router
    (D E) and the tied head (D V)."""
    d = _dims(cfg)
    D, Dh = d["D"], d["Dh"]
    return (d["conv"] * 4 * D * D
            + d["attn"] * (2 * D * d["H"] * Dh + 2 * D * d["KV"] * Dh)
            + d["dense"] * 3 * D * d["Fd"] + d["moe"] * D * d["E"]
            + D * d["V"])


def expert_flops(cfg: Dict, assignments: int) -> int:
    """Forward plus backward of the held experts' SwiGLUs over
    ``assignments`` (token, layer) assignments to them."""
    d = _dims(cfg)
    return 6 * 3 * d["D"] * d["Fe"] * assignments


def attention_flops(cfg: Dict, batch: int, seq: int) -> int:
    """Causal attention forward plus backward (3x the forward) over every
    query head of every attention layer: 4 H Dh flops an attended pair."""
    d = _dims(cfg)
    pairs = roofline.causal_pairs(seq) * batch
    return 3 * d["attn"] * 4 * d["H"] * d["Dh"] * pairs


def train_step_flops(cfg: Dict, batch: int, seq: int,
                     assignments: float) -> float:
    """Model operations of one step on ``batch`` rows of ``seq`` tokens
    whose MoE layers sent ``assignments`` to the experts held."""
    return (6 * matmul_params(cfg) * batch * seq
            + expert_flops(cfg, assignments)
            + attention_flops(cfg, batch, seq))


def grouped_launches(cfg: Dict, rows: float) -> List[Tuple[float, float]]:
    """``(bytes, flops)`` of each grouped product of one MoE layer's
    forward over ``rows`` assignments held: gate-and-up ([rows, D] by the
    held experts' [D, 2 F]) and down ([rows, F] by [F, D]), in bf16, each
    operand read once and each output written once. Each of the backward's
    two products a forward product (the input's and the weights' gradient)
    touches the same three tensors and does the same flops."""
    d = _dims(cfg)
    D, Fe, n = d["D"], d["Fe"], d["held"]
    return [((rows * D + n * D * 2 * Fe + rows * 2 * Fe) * BF16,
             2 * rows * D * 2 * Fe),
            ((rows * Fe + n * Fe * D + rows * D) * BF16, 2 * rows * Fe * D)]


def grouped_bound_s(cfg: Dict, rows: float, forwards: float) -> float:
    """The least time of one step's grouped products over ``rows``
    assignments a layer, the layers' forward run ``forwards`` times (2
    under remat: the forward and its recomputation) and the backward once:
    each launch bounded on its own (``roofline.bound_s``)."""
    one = sum(roofline.bound_s(b, f) for b, f in grouped_launches(cfg, rows))
    return _dims(cfg)["moe"] * (forwards + 2) * one

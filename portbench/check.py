"""The comparisons that decide ``correct``.

Training: each checked step's loss; the norm of the first gradient, leaf by
leaf; the norm of each leaf's change after the checked steps. Each is a gap
between the program's norm and the reference's, taken at the worst leaf and
measured against the reference's norm of that leaf or of the median leaf,
whichever is larger (some gradients are all but zero). Leaves whose
reference gradient is under a thousandth of the median leaf's (a key bias
under softmax: nought but rounding) move under Adam by round-off alone and
are left out of the change.

Serving: for every served greedy token, how far its logit lies below the
reference's best logit at that position; the widest such gap.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Tuple

STILL = 1e-3     # a leaf's reference gradient under this share of the median


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           leaves: Iterable[str]) -> Tuple[float, str]:
    leaves = list(leaves)
    med = statistics.median(ref[n] for n in leaves)
    worst, at = 0.0, ""
    for n in leaves:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med)
        if not math.isfinite(gap) or gap > worst:
            worst, at = gap, n
            if not math.isfinite(gap):
                break
    return worst, at


def train_numbers(prog: Dict, ref: Dict) -> Tuple[Dict[str, float], Dict]:
    """``(numbers, detail)`` for two ``{"losses", "grad_norms",
    "change_norms"}`` records (``reference.gpt2.train``'s shape)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    gr = ref["grad_norms"]
    grad_gap, grad_at = _worst(prog["grad_norms"], gr, gr)
    med = statistics.median(gr.values())
    moving = [n for n in gr if gr[n] >= STILL * med]
    upd_gap, upd_at = _worst(prog["change_norms"], ref["change_norms"], moving)
    loss_at = max(range(len(ref["losses"])), key=lambda i: abs(
        prog["losses"][i] - ref["losses"][i]) if i < len(prog["losses"])
        else math.inf)
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap,
               "update_gap": upd_gap}
    detail = {"grad_gap_leaf": grad_at, "update_gap_leaf": upd_at,
              "loss_gap_step": loss_at + 1,
              "update_gap_norms": [prog["change_norms"].get(upd_at),
                                   ref["change_norms"].get(upd_at)],
              "grad_gap_norms": [prog["grad_norms"].get(grad_at),
                                 gr.get(grad_at)],
              "still_leaves": sorted(set(gr) - set(moving)),
              "losses": list(prog["losses"]),
              "ref_losses": list(ref["losses"])}
    return numbers, detail


def widest_gap(ref_logits, tokens) -> Tuple[float, int]:
    """``(gap, position)``: the largest ``max(ref) - ref[token]`` over the
    positions, ``ref_logits`` [n, V] predicting ``tokens`` [n]."""
    import torch

    t = torch.as_tensor(list(tokens), dtype=torch.long,
                        device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    gaps = best - ref_logits.gather(1, t[:, None])[:, 0]
    i = int(gaps.argmax())
    return float(gaps[i]), i


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Every number against its limit: correct when each is finite and at
    most its limit. A limit this run has no number for fails it."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks

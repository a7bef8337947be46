"""What a serving window's requests needed, counted from the client's own
records: the tokens served inside the window and the work behind them.

Served token ``i`` of a request with a ``P``-token prompt is ``i`` tokens
past the prompt. Token 0 comes out of the prefill, which needs the prompt's
uncached suffix (past ``known``, the prefix an earlier request already had
whole); token ``i >= 1`` needs one decode forward at position ``P + i - 1``
over a context of ``P + i`` keys. A prefill counts in the window when its
first token came out inside it.
"""

from __future__ import annotations

from typing import Dict

from portbench import roofline


def served(run) -> Dict[str, float]:
    """Tokens served in the window and the work they needed:
    ``tokens``, ``decode_tokens``, ``prefills``, ``prefill_tokens``,
    ``matmul_flops``, ``attn_flops``, and K4's ``k4_bound_s`` (over every
    layer)."""
    cfg = run.cfg
    t0, t1 = run.extra["t0"], run.extra["t1"]
    n_layer = cfg["n_layer"]
    head = cfg["n_embd"] * cfg["vocab_size"]
    blocks = roofline.matmul_params(cfg) - head
    tokens = decode = prefills = pre_tok = 0
    contexts = []
    pre_bound = attn = 0.0
    for q in run.extra["requests"]:
        P = len(q.prompt)
        for i, t in enumerate(q.times):
            if not t0 <= t < t1:
                continue
            tokens += 1
            if i == 0:
                s = P - min(q.known, P - 1)
                prefills += 1
                pre_tok += s
                nb, fl = roofline.paged_prefill_need(cfg, P - s, s)
                pre_bound += roofline.bound_s(nb, fl)
                attn += fl
            else:
                decode += 1
                contexts.append(P + i)
    nb, fl = roofline.paged_decode_need(cfg, contexts)
    attn += fl
    return {"tokens": tokens, "decode_tokens": decode, "prefills": prefills,
            "prefill_tokens": pre_tok,
            "matmul_flops": 2 * (blocks * (pre_tok + decode)
                                 + head * (prefills + decode)),
            "attn_flops": n_layer * attn,
            "k4_bound_s": n_layer * (pre_bound + roofline.bound_s(nb, fl))}

"""Training traffic: a fresh batch of packed documents every step, drawn on
the device from the seed.

Documents have lognormal lengths and are packed end to end with the EOS
token between them (GPT-2's padding-free packing); a row starts at a random
point inside its first document. Every step's rows differ, and every seed
gives batches of the same shape, so the seed changes the tokens and not the
work.

Mix parameters: ``batch``, ``seq``, ``doc_median``, ``doc_sigma``,
``doc_min``, ``doc_max``, ``eos``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.weights import mix as mix_seed


def batch(mix: Dict, seed: int, step: int, device) -> torch.Tensor:
    """Tokens [batch, seq] (int64, on ``device``) of step ``step``."""
    B, L, eos = mix["batch"], mix["seq"], mix["eos"]
    g = torch.Generator(device=device).manual_seed(mix_seed(seed, 2, step))
    tokens = torch.randint(0, eos, (B, L + 1), generator=g, device=device)
    k = L // mix["doc_min"] + 2       # enough documents to cover a row
    lens = torch.exp(math.log(mix["doc_median"]) + mix["doc_sigma"]
                     * torch.randn((B, k), generator=g, device=device))
    lens = lens.clamp(mix["doc_min"], mix["doc_max"]).long()
    offset = (torch.rand((B, 1), generator=g, device=device)
              * lens[:, :1]).long()
    ends = torch.cumsum(lens, dim=1) - offset          # EOS positions
    # EOS past the row lands in the spare last column, dropped below.
    ends = torch.where((ends >= 0) & (ends < L), ends, L)
    tokens.scatter_(1, ends, eos)
    return tokens[:, :L].contiguous()

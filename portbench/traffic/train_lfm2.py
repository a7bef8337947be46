"""Training traffic for the LFM2 cells: a fresh batch of packed documents
every step, drawn on the device from the seed.

As ``portbench/traffic/train.py`` packs them (lognormal document lengths,
documents end to end with the EOS token between them, a row starting at a
random point inside its first document), with the ids drawn uniformly from
the whole vocabulary but the EOS id: LFM2's EOS (7) lies at the bottom of
its vocabulary, where drawing below it would leave seven tokens.

Mix parameters: ``batch``, ``seq``, ``doc_median``, ``doc_sigma``,
``doc_min``, ``doc_max``, ``eos``; the vocabulary is the configuration's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.weights import mix as mix_seed


def batch(mix: Dict, vocab: int, seed: int, step: int,
          device) -> torch.Tensor:
    """Tokens [batch, seq] (int64, on ``device``) of step ``step``."""
    B, L, eos = mix["batch"], mix["seq"], mix["eos"]
    g = torch.Generator(device=device).manual_seed(mix_seed(seed, 2, step))
    tokens = torch.randint(0, vocab - 1, (B, L + 1), generator=g,
                           device=device)
    tokens += (tokens >= eos).long()                   # every id but EOS
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

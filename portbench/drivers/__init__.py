"""Drivers, one a kind of traffic (``train``, ``serve``): each runs a cell's
set-up, its measured window and its check, found by the ``kind`` of the
cell's traffic mix."""

from __future__ import annotations

from typing import Dict


def port_config(cfg: Dict, torch, remat: str = "none"):
    """The port's ``TransformerConfig`` for configuration file ``cfg``;
    ``remat`` is ``none`` or a policy of the port (``full``, ``dots``)."""
    from ray_tpu_torch.models import transformer

    tcfg = transformer.TransformerConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["n_embd"],
        n_layers=cfg["n_layer"], n_heads=cfg["n_head"], d_ff=cfg["n_inner"],
        max_seq_len=cfg["n_positions"], dtype=getattr(torch, cfg["dtype"]),
        param_dtype=getattr(torch, cfg["param_dtype"]),
        remat=remat != "none",
        remat_policy=remat if remat != "none" else "full")
    if tcfg.padded_vocab != cfg["padded_vocab"]:
        raise ValueError(f"the port pads the vocabulary to "
                         f"{tcfg.padded_vocab}, the configuration says "
                         f"{cfg['padded_vocab']}")
    return tcfg

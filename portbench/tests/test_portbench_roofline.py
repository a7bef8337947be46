"""The counting functions against hand-worked shapes, and never more work
than a plain run of the same inputs does, so no share they feed can pass
100 % for a run that does the counted work."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import roofline
from portbench.reference import gpt2
from portbench.tests.conftest import TINY

SMALL = {"n_embd": 768, "n_layer": 12, "n_head": 12, "n_inner": 3072,
         "vocab_size": 50257}


def test_causal_pairs():
    assert roofline.causal_pairs(4) == 10
    assert roofline.causal_pairs(3, offset=2) == 12
    assert roofline.causal_pairs(1, offset=99) == 100


def test_matmul_params_gpt2_small():
    # 12 x (4 x 768^2 + 2 x 768 x 3072) + 768 x 50257
    assert roofline.matmul_params(SMALL) == 84_934_656 + 38_597_376


@pytest.mark.parametrize("kernel,nbytes,flops", [
    ("forward", 4 * 8 * 2 + 4 * 4, 4 * 2 * 10),
    ("dq", 5 * 8 * 2 + 8 * 4, 6 * 2 * 10),
    ("dkv", 6 * 8 * 2 + 8 * 4, 8 * 2 * 10),
])
def test_flash_bound_by_hand(kernel, nbytes, flops):
    s, b, f = roofline.flash_bound_s(kernel, 1, 4, 1, 2)
    assert (b, f) == (nbytes, flops)
    assert s == max(b / roofline.HBM_BYTES_PER_S,
                    f / roofline.PEAK_FLOPS["bfloat16"])


def test_paged_needs_by_hand():
    cfg = {"n_embd": 4}
    assert roofline.paged_decode_need(cfg, [3, 5]) == (
        (2 * 8 * 4 + 2 * 2 * 4) * 2, 4 * 4 * 8)
    assert roofline.paged_prefill_need(cfg, 2, 3) == (
        (2 * 5 * 4 + 2 * 3 * 4) * 2, 4 * 4 * 12)


def test_train_step_flops_by_hand():
    cfg = dict(SMALL)
    pairs = 1024 * 1025 // 2
    want = (6 * roofline.matmul_params(cfg) * 16 * 1024
            + 12 * 3 * 4 * 768 * pairs * 16)
    assert roofline.train_step_flops(cfg, 16, 1024) == want


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_counts_never_exceed_a_plain_run():
    """The plain reference computes the full square of scores and the head
    over the padded vocabulary: more than the counts, never less."""
    cfg = dict(TINY)
    params = {k: v for k, v in __import__("portbench.weights").weights.make(
        cfg, 3, "cpu", torch.float32).items()}
    for leaf in gpt2._leaf_items(params):
        leaf[1].requires_grad_(True)
    B, T = 2, 32
    tokens = torch.randint(0, 256, (B, T))

    def step():
        gpt2.forward(params, tokens, cfg).sum().backward()

    assert roofline.train_step_flops(cfg, B, T) <= _counted(step)
    # one decode token at context c: the products with weights (2 a
    # weight) and 4 d c of attention a layer
    c = T
    need = (2 * roofline.matmul_params(cfg)
            + cfg["n_layer"] * roofline.paged_decode_need(cfg, [c])[1])
    with torch.no_grad():
        full = _counted(lambda: gpt2.forward(params, tokens[:1], cfg))
    assert need * T <= full

"""The whole serving step's share of the card's bf16 peak: the products
with weights and the attention that the window's served tokens needed
(``work.served``) over the window's time."""

from portbench import roofline, work


def read(run):
    s = work.served(run)
    return 100.0 * (s["matmul_flops"] + s["attn_flops"]) / (
        run.window_s * roofline.PEAK_FLOPS["bfloat16"])

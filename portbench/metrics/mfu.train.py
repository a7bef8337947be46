"""The whole training step's share of the card's bf16 peak: the model
operations the window's batches need (``roofline.train_step_flops``, no
recomputation counted) over the traced window's time."""

from portbench import roofline


def read(run):
    x = run.extra
    flops = x["steps"] * roofline.train_step_flops(run.cfg, x["batch"],
                                                  x["seq"])
    return 100.0 * flops / (run.window_s * roofline.PEAK_FLOPS["bfloat16"])

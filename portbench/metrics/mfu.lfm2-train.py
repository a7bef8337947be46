"""The whole LFM2 training step's share of the card's bf16 peak: the model
operations the window's batches need (``lfm2_counts.train_step_flops``:
the products every token passes through, the held experts' products for
the assignments the program counted, causal attention; no recomputation)
over the window's time."""

from portbench import lfm2_counts, roofline


def read(run):
    x = run.extra
    if "lfm2" not in x:
        return None
    flops = (x["steps"] * lfm2_counts.train_step_flops(
        run.cfg, x["batch"], x["seq"], 0)
        + lfm2_counts.expert_flops(run.cfg, x["lfm2"]["held_assignments"]))
    return 100.0 * flops / (run.window_s * roofline.PEAK_FLOPS["bfloat16"])

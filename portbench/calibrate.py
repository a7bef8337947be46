"""The readings that a cell's limits are set from, on the chip at the cell's
own size (``PERF.md`` gives the readings and the limits chosen):

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 [--seconds s]

Training cells: on each seed, the plain reference's first steps (the weights
and batches the cell's run makes) against three stand-ins put in the
program's place: the reference in float8 (the control: the precision below
the configuration's bf16), the reference with half of every batch left out
and the loss the mean over the rest, and the reference with a step that
leaves the state unchanged (a learning rate of 0). Each prints the cell's
numbers as a run would compare them.

Serving cells: a whole run of the cell on each seed (its window included),
which prints the program's widest gap, the float8 control's (the gap of the
token the float8 reference puts first, at each position of the same
prompts and served tokens) and the gap of one served token altered.

The benchmark's own runs never run this. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path


def _train_readings(run, seed: int) -> dict:
    import torch

    from portbench import check, weights
    from portbench.drivers import train as driver
    from portbench.reference import gpt2
    from portbench.traffic import train as traffic

    cfg, mix, dev = run.cfg, run.mix, run.device
    opt = driver.optimizer(mix)
    n = mix["check_steps"]
    batches = [traffic.batch(mix, seed, i, dev) for i in range(n)]
    p0 = weights.make(cfg, seed, dev, getattr(torch, cfg["param_dtype"]))
    rows = mix["reference_rows"]
    ref = gpt2.train(p0, batches, cfg, opt, rows_per_pass=rows)
    out = {}
    low = gpt2.train(p0, batches, cfg, opt, fp8=True, rows_per_pass=rows)
    out["control_fp8"] = check.train_numbers(low, ref)[0]
    half = gpt2.train(p0, [b[:b.shape[0] // 2] for b in batches], cfg, opt,
                      rows_per_pass=rows)
    out["fault_half_batch"] = check.train_numbers(half, ref)[0]
    still = gpt2.train(p0, batches, cfg, dict(opt, lr=0.0),
                       rows_per_pass=rows)
    out["fault_state_unchanged"] = check.train_numbers(still, ref)[0]
    out["ref_losses"] = ref["losses"]
    del p0, batches
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    from portbench import run as bench_run

    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench_run._cache_dirs(root)
    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    seconds = args.seconds or bench["run_seconds"]
    for seed in args.seeds:
        cell = bench_run._cell(bench, args.workload)
        run = bench_run.Run(root, cell, seed, seconds, False, "cuda")
        if run.mix["kind"] == "train":
            out = _train_readings(run, seed)
        else:
            r, line = bench_run.run_cell(root, bench, args.workload, seed,
                                         seconds, False, "cuda",
                                         driver_kw={"control": True})
            out = {"program": line["check"], **r.extra["calibration"],
                   "sample": r.extra["check_sample"],
                   "metrics": line["metrics"]}
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once and print one result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is found by name in ``BENCHMARK.json``;
everything else is found by the names it gives:

- ``portbench/configs/<config>.json``: the model's sizes;
- ``portbench/traffic/<traffic>.json``: the mix, whose ``kind`` names the
  driver ``portbench/drivers/<kind>.py`` and the generator
  ``portbench/traffic/<kind>.py``;
- ``portbench/workloads/<cell>.json``: the limits that decide ``correct``;
- ``portbench/metrics/<metric>.py``: one reader a metric, ``read(run)``
  returning a number or None (nothing to read: the metric is left out).

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a ``torch.profiler`` window over
the whole measured window. Every run checks what the timed path produced
against the plain reference (``portbench/reference/``) and prints each
number compared beside its limit: as the last lines of standard error and
under ``check``, the last key of the result line.

The run needs a CUDA card: without one (or with fewer than the cell asks
for) it exits with code 2 and prints no result. It exits with code 3, and
no result, if JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

# Whole top-level module names that no run may load: JAX, its libraries and
# the JAX package the port was made from (``ray_tpu_torch`` is the port).
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def _boot_seconds() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (the interpreter's own start-up included); the module's import
    time where that record is not readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


class Run:
    """What one run knows: the cell's files, the run's arguments, and what
    the driver measured. Metric readers take it whole."""

    def __init__(self, root: Path, cell: Dict, seed: int, seconds: float,
                 trace: bool, device: str):
        self.root = root
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        pb = root / "portbench"
        self.cfg = json.loads((pb / "configs" / f"{cell['config']}.json")
                              .read_text())
        self.mix = json.loads((pb / "traffic" / f"{cell['traffic']}.json")
                              .read_text())
        self.limits = json.loads((pb / "workloads" / f"{cell['name']}.json")
                                 .read_text())["limits"]
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.trace_window = None        # portbench.trace.Window, traced runs
        self.memory_peak_bytes = 0
        self.attempted = 0
        self.failed = 0
        self.checks: Dict[str, Dict[str, float]] = {}
        self.correct = False
        self.extra: Dict = {}           # driver-specific readings

    def setup_done(self) -> None:
        """The window opens now: set-up ends."""
        self.setup_s = _boot_seconds()


def _cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: Dict, cell: Dict, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones (those listing the cell, or listing no
    cells and moving an end-to-end metric the cell reports)."""
    def has(m):
        return cell["name"] in m.get("workloads", [cell["name"]])

    e2e = [m for m in bench["end_to_end"] if has(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def _reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _card() -> Dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": out[0]} if out else {}


def run_cell(root: Path, bench: Dict, name: str, seed: int, seconds: float,
             trace: bool, device: str, driver_kw: Optional[Dict] = None):
    """Run cell ``name`` and return ``(run, result line dict)``.
    ``driver_kw`` reaches the driver (the calibration script's controls and
    the tests' planted faults; never set by the command)."""
    cell = _cell(bench, name)
    run = Run(root, cell, seed, seconds, trace, device)
    driver = importlib.import_module(f"portbench.drivers.{run.mix['kind']}")
    driver.run(run, **(driver_kw or {}))
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        value = _reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (run.extra["device_name"] if device == "cuda"
                    else device),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": bool(run.correct), "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace and run.trace_window is not None:
        w = run.trace_window
        dev["busy_s"] = w.busy_s
        dev["window_s"] = w.window_s
        line["breakdown"] = w.breakdown()
    line["card"] = _card() if device == "cuda" else {}
    # Strict JSON: a number that could not be read (NaN, inf) prints null.
    line["check"] = {k: {n: (v if math.isfinite(v) else None)
                         for n, v in c.items()}
                     for k, c in run.checks.items()}
    return run, line


def loaded_forbidden() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (a ``None`` entry is a name blocked from import, not a module)."""
    return sorted(m for m, mod in list(sys.modules.items())
                  if mod is not None and m.split(".")[0] in FORBIDDEN)


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    only a checkout's first run builds (the port's own kernels build into
    ``build/kernels/`` of the checkout)."""
    base = root / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = _cell(bench, args.workload)
    _cache_dirs(root)

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"portbench: cell {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); torch sees {cards}", file=sys.stderr)
        return 2
    run, line = run_cell(root, bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda")
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for k in ("check_detail", "check_sample"):
        if k in run.extra:
            print(f"{k} {json.dumps(run.extra[k])}", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr)
    for k, c in line["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

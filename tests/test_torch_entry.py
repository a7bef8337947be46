"""The port's entry points (``ray_tpu_torch/entry.py``), the twins of
``__graft_entry__.py``: ``dryrun_multichip(8)`` runs its three phases on
8 gloo CPU ranks (composed data/fsdp/tensor/seq meshes, pipelined training
held to the non-pipelined oracle within 5e-3 as JAX's dry run holds it, a
Switch-MoE step); ``entry()`` needs the card and refuses without one."""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch_mesh_cases

from ray_tpu_torch import entry

ROOT = str(Path(__file__).resolve().parents[1])


def test_dryrun_multichip_8_runs_three_phases():
    # As a user runs it from a shell, at a lower priority: its 8 ranks
    # yield the host to the rest of the suite.
    code = ("import os; os.nice(10); from ray_tpu_torch.entry import "
            "dryrun_multichip; dryrun_multichip(8)")
    with torch_mesh_cases.one_world_at_a_time():
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=700,
                             cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    main = [l for l in lines if l.startswith("dryrun_multichip(8)")]
    pp = [l for l in lines if l.startswith("dryrun pp-train")]
    moe = [l for l in lines if l.startswith("dryrun moe-train")]
    assert len(main) == 2 and len(pp) == 2 and len(moe) == 1, lines
    assert "'data': 2, 'fsdp': 2" in main[0] and "'seq': 2" in main[1]
    for line in main:
        assert math.isfinite(float(line.rsplit("loss=", 1)[1]))
    for line in pp:
        loss, oracle = map(float, re.findall(r"(?:loss|oracle)=([-\d.]+)",
                                             line))
        assert abs(loss - oracle) < 5e-3 * max(1.0, abs(oracle)), line
    l0, l1 = map(float, re.search(r"loss ([-\d.]+)->([-\d.]+)",
                                  moe[0]).groups())
    assert l1 < l0


def test_entry_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() runs there (chip_smoke)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()

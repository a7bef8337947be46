"""Experiment persistence — snapshot/resume for crashed or killed runs.

Analog of the reference's ``python/ray/tune/execution/experiment_state.py``
(``_ExperimentCheckpointManager``): the controller periodically writes the
full experiment state — every trial's config/status/results/checkpoint
pointer, plus the pickled trainable and search space — under
``<storage_path>/<name>/experiment_state.pkl``. ``Tuner.restore(path)``
rebuilds the Tuner from it: finished trials keep their results, trials that
were RUNNING at the crash resume from their latest checkpoint, and PENDING
trials run normally. No completed work is repeated.

The port's copy of ``ray_tpu/tune/experiment_state.py``.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune.experiment import Trial, TrialStatus

STATE_FILE = "experiment_state.pkl"
META_FILE = "experiment_meta.pkl"


def _trial_to_dict(t: Trial) -> Dict[str, Any]:
    return {
        "trial_id": t.trial_id,
        "config": t.config,
        "status": t.status,
        "last_result": t.last_result,
        "metrics_history": t.metrics_history,
        "error": t.error,
        "latest_checkpoint": t.latest_checkpoint.path if t.latest_checkpoint else None,
        # PENDING trials can carry a restore pointer too (PBT exploit;
        # an already-restored-but-not-yet-launched trial) — losing it
        # on a second crash would restart them from scratch.
        "restore_checkpoint": t.restore_checkpoint.path if t.restore_checkpoint else None,
        "restarts": t.restarts,
        "resources": t.resources,
    }


def _trial_from_dict(d: Dict[str, Any]) -> Trial:
    t = Trial(config=d["config"], trial_id=d["trial_id"])
    t.status = d["status"]
    t.last_result = d["last_result"]
    t.metrics_history = d["metrics_history"]
    t.error = d["error"]
    if d["latest_checkpoint"]:
        t.latest_checkpoint = Checkpoint(d["latest_checkpoint"])
    if d.get("restore_checkpoint"):
        t.restore_checkpoint = Checkpoint(d["restore_checkpoint"])
    t.restarts = d["restarts"]
    t.resources = d.get("resources", {})
    # A trial RUNNING at snapshot time was interrupted by the crash: it
    # resumes from its latest checkpoint (the reference resets RUNNING →
    # PENDING with restore on resume too).
    if t.status == TrialStatus.RUNNING:
        t.status = TrialStatus.PENDING
        t.restore_checkpoint = t.latest_checkpoint
    return t


class ExperimentState:
    """Writes/reads the experiment snapshot with atomic replace.

    Static metadata (pickled trainable, search space, tune config) is
    written ONCE to a sibling ``META_FILE``; the periodic snapshot carries
    only the trial table — the hot loop never re-serializes the trainable.
    """

    def __init__(self, experiment_path: str, snapshot_period_s: float = 2.0):
        self.path = experiment_path
        self.file = os.path.join(experiment_path, STATE_FILE)
        self.meta_file = os.path.join(experiment_path, META_FILE)
        self.period = snapshot_period_s
        self._last = 0.0
        self._meta_written = False
        os.makedirs(experiment_path, exist_ok=True)

    def _write(self, path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def maybe_snapshot(self, trials: List[Trial], meta: Dict[str, Any],
                       force: bool = False) -> None:
        now = time.time()
        if not force and now - self._last < self.period:
            return
        self._last = now
        import cloudpickle

        if not self._meta_written:
            self._write(self.meta_file, cloudpickle.dumps(meta))
            self._meta_written = True
        # cloudpickle here too: trial CONFIGS may hold lambdas/local
        # callables (sample_from, grid over functions) that plain pickle
        # rejects — the snapshot must never crash the experiment.
        self._write(self.file, cloudpickle.dumps({
            "trials": [_trial_to_dict(t) for t in trials],
            "timestamp": now,
        }))

    @staticmethod
    def load(experiment_path: str) -> Dict[str, Any]:
        file = os.path.join(experiment_path, STATE_FILE)
        if not os.path.exists(file):
            raise FileNotFoundError(
                f"no experiment state at {file}; was the experiment started "
                f"with RunConfig(storage_path=...)?")
        with open(file, "rb") as f:
            data = pickle.loads(f.read())
        meta_file = os.path.join(experiment_path, META_FILE)
        if os.path.exists(meta_file):
            with open(meta_file, "rb") as f:
                data["meta"] = pickle.loads(f.read())
        else:
            data["meta"] = {}
        data["trials"] = [_trial_from_dict(d) for d in data["trials"]]
        return data

    @staticmethod
    def exists(experiment_path: str) -> bool:
        return os.path.exists(os.path.join(experiment_path, STATE_FILE))

"""Tuner / tune.run / ResultGrid.

Analog of the reference's ``python/ray/tune/tuner.py`` + ``tune/tune.py`` +
``tune/result_grid.py``. Trainables are functions (``fn(config)`` reporting
via ``ray_tpu_torch.tune.report``) or trainers via ``Trainer.as_trainable()``
(mirroring ``base_trainer.py:819``).

The port's copy of ``ray_tpu/tune/tuner.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.trainer import Result
from ray_tpu_torch.tune.experiment import Trial, TrialStatus
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.tune_controller import TuneController


@dataclass
class TuneConfig:
    """Reference: ``tune/tune_config.py``."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional[Searcher] = None


class ResultGrid:
    """Reference: ``tune/result_grid.py``."""

    def __init__(self, trials: List[Trial], metric: Optional[str], mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode
        self.results = [
            Result(
                metrics=t.last_result,
                checkpoint=t.latest_checkpoint,
                error=RuntimeError(t.error) if t.error else None,
                metrics_history=t.metrics_history,
            )
            for t in trials
        ]

    def __len__(self):
        return len(self.results)

    def __getitem__(self, i):
        return self.results[i]

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self.results if r.error]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set TuneConfig.metric or pass one)")
        scored = [r for r in self.results if metric in r.metrics]
        if not scored:
            raise RuntimeError("no trial reported the metric " + metric)
        key = lambda r: r.metrics[metric]
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics for r in self.results])


class Tuner:
    """Reference: ``tune/tuner.py``."""

    def __init__(
        self,
        trainable: Callable | Any,
        *,
        param_space: Optional[Dict] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
    ):
        # Trainer objects (DataParallelTrainer etc.) wrap themselves
        # (reference: Tuner(trainer) uses trainer.as_trainable()).
        if hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self.resources_per_trial = resources_per_trial
        self._restored_trials: Optional[List[Trial]] = None

    def _experiment_path(self) -> Optional[str]:
        if not self.run_config.storage_path:
            return None
        import os

        name = self.run_config.name or "tune_experiment"
        return os.path.join(self.run_config.storage_path, name)

    # -- persistence / resume (tune/execution/experiment_state.py) -----------

    @classmethod
    def can_restore(cls, path: str) -> bool:
        from ray_tpu_torch.tune.experiment_state import ExperimentState

        return ExperimentState.exists(path)

    @classmethod
    def restore(cls, path: str, trainable: Callable | Any = None) -> "Tuner":
        """Rebuild a Tuner from ``<storage_path>/<name>`` after a crash.

        Finished trials keep their results; interrupted (RUNNING) trials
        resume from their latest checkpoint; pending ones run fresh. Pass
        ``trainable`` to override the pickled one (the reference requires
        re-passing it too when it wasn't serializable).
        """
        import os

        from ray_tpu_torch.tune.experiment_state import ExperimentState

        path = os.path.normpath(path)  # trailing slash would split wrong
        data = ExperimentState.load(path)
        meta = data["meta"]
        if trainable is None:
            trainable = meta.get("trainable")
        if trainable is None:
            raise ValueError(
                "the original trainable was not serializable into the "
                "experiment snapshot — pass it explicitly: "
                "Tuner.restore(path, trainable=...)")
        if trainable is not None and hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        tuner = cls(
            trainable,
            param_space=meta.get("param_space"),
            tune_config=meta.get("tune_config") or TuneConfig(),
            run_config=RunConfig(
                name=os.path.basename(path),
                storage_path=os.path.dirname(path),
            ),
            resources_per_trial=meta.get("resources_per_trial"),
        )
        tuner._restored_trials = data["trials"]
        return tuner

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        searcher = tc.search_alg
        lazy = False
        if self._restored_trials is not None:
            trials = self._restored_trials
        else:
            if searcher is None:
                searcher = BasicVariantGenerator(self.param_space, num_samples=tc.num_samples)
                n_trials = searcher.total_variants
            else:
                n_trials = tc.num_samples
            if searcher.metric is None:
                searcher.metric = tc.metric
                searcher.mode = tc.mode

            # Sequential (model-based) searchers suggest lazily inside the
            # controller loop — each suggestion sees prior results.
            lazy = getattr(searcher, "sequential", False)
            trials = []
            if not lazy:
                for _ in range(n_trials):
                    t = Trial(config={})
                    cfg = searcher.suggest(t.trial_id)
                    if cfg is None:
                        break
                    t.config = cfg
                    trials.append(t)

        exp_state = None
        exp_meta = {}
        exp_path = self._experiment_path()
        if exp_path is not None:
            from ray_tpu_torch.tune.experiment_state import ExperimentState

            exp_state = ExperimentState(exp_path)
            try:
                import cloudpickle

                cloudpickle.dumps(self.trainable)
                trainable_meta = self.trainable
            except Exception:  # noqa: BLE001 — restore() must re-pass it
                trainable_meta = None
            exp_meta = {
                "trainable": trainable_meta,
                "param_space": self.param_space,
                "tune_config": tc,
                "resources_per_trial": self.resources_per_trial,
            }
            exp_state.maybe_snapshot(trials, exp_meta, force=True)

        controller = TuneController(
            self.trainable,
            trials,
            scheduler=tc.scheduler,
            metric=tc.metric,
            mode=tc.mode,
            max_concurrent=tc.max_concurrent_trials,
            resources_per_trial=self.resources_per_trial,
            searcher=searcher if not isinstance(searcher, BasicVariantGenerator) else None,
            num_samples=tc.num_samples,
            experiment_state=exp_state,
            experiment_meta=exp_meta,
        )
        controller.run()
        return ResultGrid(controller.trials, tc.metric, tc.mode)


def run(
    trainable: Callable,
    *,
    config: Optional[Dict] = None,
    num_samples: int = 1,
    metric: Optional[str] = None,
    mode: str = "max",
    scheduler: Optional[TrialScheduler] = None,
    search_alg: Optional[Searcher] = None,
    max_concurrent_trials: Optional[int] = None,
    resources_per_trial: Optional[Dict[str, float]] = None,
) -> ResultGrid:
    """``tune.run`` convenience wrapper (reference: ``tune/tune.py``)."""
    return Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric,
            mode=mode,
            num_samples=num_samples,
            scheduler=scheduler,
            search_alg=search_alg,
            max_concurrent_trials=max_concurrent_trials,
        ),
        resources_per_trial=resources_per_trial,
    ).fit()

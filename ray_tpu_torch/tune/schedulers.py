"""Trial schedulers — FIFO, ASHA, median-stopping, PBT.

Analog of the reference's ``python/ray/tune/schedulers/``:
``async_hyperband.py`` (ASHA), ``median_stopping_rule.py``, ``pbt.py``. The
controller feeds every trial result through ``on_trial_result``; the scheduler
answers CONTINUE/STOP (and for PBT, a clone-and-perturb restart decision
carried out by the controller).

The port's copy of ``ray_tpu/tune/schedulers.py``.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.tune.experiment import Trial


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"
    RESTART = "RESTART"  # PBT exploit: restart with mutated config+checkpoint

    metric: Optional[str] = None
    mode: str = "max"

    def set_metric(self, metric: str, mode: str) -> None:
        self.metric = metric
        self.mode = mode

    def _score(self, result: Dict) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, trial: "Trial", result: Dict) -> str:
        return self.CONTINUE

    def on_trial_complete(self, trial: "Trial", result: Optional[Dict]) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (reference default)."""


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (reference:
    ``tune/schedulers/async_hyperband.py``).

    Rung r handles iteration ``grace_period * reduction_factor**r``; a trial
    reaching a rung is stopped unless it is in the top ``1/reduction_factor``
    of scores recorded at that rung so far.
    """

    def __init__(
        self,
        *,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: float = 4,
    ):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestones ascending
        self.milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self.milestones.append(int(t))
            t *= reduction_factor
        self._rung_scores: Dict[int, List[float]] = defaultdict(list)
        self._trial_rung: Dict[str, int] = defaultdict(int)  # next rung index

    def on_trial_result(self, trial: "Trial", result: Dict) -> str:
        t = int(result.get(self.time_attr, 0))
        if t >= self.max_t:
            return self.STOP
        decision = self.CONTINUE
        score = self._score(result)
        # Enter every rung this trial has newly crossed (t >= milestone; a
        # trial reporting a custom time_attr need not hit milestones exactly).
        i = self._trial_rung[trial.trial_id]
        while i < len(self.milestones) and t >= self.milestones[i]:
            milestone = self.milestones[i]
            scores = self._rung_scores[milestone]
            scores.append(score)
            k = max(1, int(len(scores) / self.rf))
            cutoff = sorted(scores, reverse=True)[k - 1]
            if score < cutoff:
                decision = self.STOP
            i += 1
        self._trial_rung[trial.trial_id] = i
        return decision


class HyperBandScheduler(TrialScheduler):
    """HyperBand (reference: ``tune/schedulers/hyperband.py``): trials are
    assigned round-robin to ``s_max + 1`` brackets; bracket ``s`` gives its
    trials an initial budget of ``max_t * eta**-s`` iterations, then runs
    successive halving — at each rung only the top ``1/eta`` of the
    bracket's scores continue. Brackets with small initial budgets explore
    many configs cheaply; the ``s=0`` bracket runs few configs to
    ``max_t``. Halving decisions are asynchronous (a trial is judged
    against the scores recorded at its rung so far — the ASHA relaxation),
    which avoids the pause/resume machinery of the strictly synchronous
    variant while keeping the bracketed exploration/exploitation spread
    that distinguishes HyperBand from plain ASHA's single bracket."""

    def __init__(
        self,
        *,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        max_t: int = 81,
        reduction_factor: float = 3,
    ):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.eta = reduction_factor
        # Integer repeated division, not int(log/log): float error truncates
        # exact powers (log(243)/log(3) = 4.999... -> 4, losing a bracket).
        s_max, t = 0, max_t
        while t >= reduction_factor:
            t /= reduction_factor
            s_max += 1
        self.s_max = s_max
        # bracket s → ascending rung milestones starting at max_t * eta^-s
        self._bracket_milestones: List[List[int]] = []
        for s in range(self.s_max + 1):
            r0 = max_t * reduction_factor ** (-s)
            rungs = [int(round(r0 * reduction_factor ** i))
                     for i in range(s + 1)
                     if r0 * reduction_factor ** i < max_t]
            self._bracket_milestones.append(sorted(set(rungs)) or [max_t])
        self._next_bracket = 0
        self._trial_bracket: Dict[str, int] = {}
        self._trial_rung: Dict[str, int] = defaultdict(int)
        # (bracket, milestone) → scores recorded there
        self._rung_scores: Dict[tuple, List[float]] = defaultdict(list)

    def _bracket_of(self, trial_id: str) -> int:
        b = self._trial_bracket.get(trial_id)
        if b is None:
            # Round-robin assignment, large-s (cheap, exploratory) first.
            b = self.s_max - (self._next_bracket % (self.s_max + 1))
            self._next_bracket += 1
            self._trial_bracket[trial_id] = b
        return b

    def on_trial_result(self, trial: "Trial", result: Dict) -> str:
        t = int(result.get(self.time_attr, 0))
        if t >= self.max_t:
            return self.STOP
        bracket = self._bracket_of(trial.trial_id)
        milestones = self._bracket_milestones[bracket]
        score = self._score(result)
        decision = self.CONTINUE
        i = self._trial_rung[trial.trial_id]
        while i < len(milestones) and t >= milestones[i]:
            rung = (bracket, milestones[i])
            scores = self._rung_scores[rung]
            scores.append(score)
            k = max(1, int(len(scores) / self.eta))
            cutoff = sorted(scores, reverse=True)[k - 1]
            if score < cutoff:
                decision = self.STOP
            i += 1
        self._trial_rung[trial.trial_id] = i
        return decision


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best score is below the median of running averages
    (reference: ``tune/schedulers/median_stopping_rule.py``)."""

    def __init__(
        self,
        *,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._history: Dict[str, List[float]] = defaultdict(list)

    def on_trial_result(self, trial: "Trial", result: Dict) -> str:
        t = int(result.get(self.time_attr, 0))
        score = self._score(result)
        self._history[trial.trial_id].append(score)
        if t < self.grace_period or len(self._history) < self.min_samples:
            return self.CONTINUE
        means = [sum(v) / len(v) for k, v in self._history.items() if v]
        median = sorted(means)[len(means) // 2]
        my_best = max(self._history[trial.trial_id])
        return self.STOP if my_best < median else self.CONTINUE


@dataclass
class _PbtState:
    last_perturb_t: int = 0
    score: Optional[float] = None


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: ``tune/schedulers/pbt.py``): at each
    ``perturbation_interval``, bottom-quantile trials exploit (copy config +
    checkpoint from a top-quantile trial) and explore (mutate hyperparams).

    The controller executes the RESTART decision: it stops the trial actor and
    respawns it with ``trial.config`` (already mutated here) and
    ``trial.restore_checkpoint`` (the donor's latest reported checkpoint).
    """

    def __init__(
        self,
        *,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: str = "max",
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        if not 0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.rng = random.Random(seed)
        self._state: Dict[str, _PbtState] = defaultdict(_PbtState)
        self._trials: Dict[str, "Trial"] = {}

    def _quantiles(self):
        scored = [(tid, st.score) for tid, st in self._state.items() if st.score is not None]
        if len(scored) < 2:
            return [], []
        scored.sort(key=lambda kv: kv[1])
        n = max(1, int(len(scored) * self.quantile))
        bottom = [tid for tid, _ in scored[:n]]
        top = [tid for tid, _ in scored[-n:]]
        return bottom, top

    def _mutate(self, config: Dict) -> Dict:
        from ray_tpu_torch.tune.search import Domain

        out = dict(config)
        for key, spec in self.mutations.items():
            if self.rng.random() < self.resample_p or key not in out:
                if isinstance(spec, Domain):
                    out[key] = spec.sample(self.rng)
                elif isinstance(spec, list):
                    out[key] = self.rng.choice(spec)
                elif callable(spec):
                    out[key] = spec()
            else:
                factor = self.rng.choice([0.8, 1.2])
                if isinstance(out[key], (int, float)) and not isinstance(out[key], bool):
                    out[key] = type(out[key])(out[key] * factor)
        return out

    def on_trial_result(self, trial: "Trial", result: Dict) -> str:
        self._trials[trial.trial_id] = trial
        st = self._state[trial.trial_id]
        st.score = self._score(result)
        t = int(result.get(self.time_attr, 0))
        if t - st.last_perturb_t < self.interval:
            return self.CONTINUE
        st.last_perturb_t = t
        bottom, top = self._quantiles()
        if trial.trial_id in bottom and top:
            donor_id = self.rng.choice(top)
            donor = self._trials.get(donor_id)
            if donor is None or donor.latest_checkpoint is None:
                return self.CONTINUE
            trial.config = self._mutate(dict(donor.config))
            trial.restore_checkpoint = donor.latest_checkpoint
            self._state[trial.trial_id].last_perturb_t = 0
            return self.RESTART
        return self.CONTINUE

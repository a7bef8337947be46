"""TuneController — the experiment event loop.

Analog of the reference's ``python/ray/tune/execution/tune_controller.py``
(step loop :667 driving trial actors through ``RayActorManager``
``air/execution/_internal/actor_manager.py:23``): launch trials up to the
concurrency/resource budget, stream their results through a collector actor,
feed each result to the scheduler, and execute STOP/RESTART decisions.

Early stop is delivered at ``report()`` itself: the trial's report hook
pushes the result and then polls the collector until the controller has run
the scheduler on THAT iteration and acked a decision, raising ``_StopTrial``
on STOP — the deterministic in-runtime analog of the reference killing the
trial actor. (An unacked fire-and-forget push would make every scheduler
decision a race between the trial's next report and the controller's drain
loop: a fast trainable outruns the controller and HyperBand/ASHA culling
silently never happens.)

The port's copy of ``ray_tpu/tune/tune_controller.py``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.utils.logging import get_logger
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, TrainingResult, set_context
from ray_tpu_torch.train.worker_group import resource_options
from ray_tpu_torch.tune.experiment import Trial, TrialStatus
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler

logger = get_logger("tune")


class _StopTrial(BaseException):
    """Raised inside a trial fn at report() when the scheduler said stop.
    BaseException so user ``except Exception`` blocks don't swallow it."""


class _TuneCollectorImpl:
    """Mailbox between trial runners and the controller."""

    def __init__(self):
        self.results: List[dict] = []  # [{trial_id, iter, metrics, ckpt}]
        # trial_id -> (highest acked iteration, decision at that iteration):
        # written by the controller after the scheduler saw the result, read
        # by the trial's report hook poll (see await_decision).
        self.acked: Dict[str, tuple] = {}
        self.done: Dict[str, Optional[str]] = {}

    def push(self, trial_id: str, iteration: int, metrics: dict, ckpt_path: Optional[str]) -> str:
        self.results.append(
            {"trial_id": trial_id, "iter": iteration, "metrics": metrics, "ckpt": ckpt_path}
        )
        return "QUEUED"

    def ack_batch(self, acks: List[tuple]):
        """Controller acks processed results: [(trial_id, iter, decision)]."""
        for trial_id, iteration, decision in acks:
            prev = self.acked.get(trial_id)
            if prev is None or iteration >= prev[0]:
                self.acked[trial_id] = (iteration, decision)
        return True

    def await_decision(self, trial_id: str, iteration: int) -> Optional[str]:
        """The decision for ``iteration``, or None if the controller hasn't
        processed it yet (the trial's report hook polls)."""
        ent = self.acked.get(trial_id)
        if ent is not None and ent[0] >= iteration:
            return ent[1]
        return None

    def finish(self, trial_id: str, error: Optional[str], stopped: bool = False):
        self.done[trial_id] = {"error": error, "stopped": stopped}
        return True

    def clear(self, trial_id: str):
        """Reset decision/done state before a trial relaunch (PBT). Safe
        against the old incarnation's results: they are drained in the same
        atomic drain() as (or before) its finish event, which precedes the
        relaunch — so no stale high-iteration ack can land after this."""
        self.acked.pop(trial_id, None)
        self.done.pop(trial_id, None)
        return True

    def drain(self):
        """Return and consume queued results + finished map."""
        out, self.results = self.results, []
        done, self.done = self.done, {}
        return out, done


def _trial_main(fn: Callable, config: Dict, trial_id: str, collector, ckpt_path: Optional[str]):
    """Runs inside a trial actor: wire the session context so both
    ``ray_tpu_torch.tune.report`` and ``ray_tpu_torch.train.report`` stream here."""
    state = {"i": 0}

    def on_report(result):
        state["i"] += 1
        metrics = dict(result.metrics)
        metrics.setdefault("training_iteration", state["i"])
        cp = result.checkpoint.path if result.checkpoint else None
        ray_tpu_torch.get(collector.push.remote(trial_id, state["i"], metrics, cp))
        # Lock-step with the controller: wait until the scheduler has seen
        # THIS iteration and acked a decision. Bounded so a dead controller
        # can't park the trial forever (the experiment is lost either way).
        try:
            from ray_tpu_torch.core.config import config

            bound = config().internal_wait_timeout_s
        except Exception:  # noqa: BLE001 — mirror the flag's default
            bound = 60.0
        deadline = time.time() + bound
        decision = "CONTINUE"
        poll = 0.002  # backs off to 50ms: the controller acks within one
        while time.time() < deadline:  # drain pass, usually the first poll
            got = ray_tpu_torch.get(
                collector.await_decision.remote(trial_id, state["i"]))
            if got is not None:
                decision = got
                break
            time.sleep(poll)
            poll = min(poll * 2, 0.05)
        if decision == "STOP":
            raise _StopTrial()

    ctx = TrainContext(
        world_rank=0, world_size=1, local_rank=0, local_world_size=1, node_rank=0,
        trial_name=trial_id,
        checkpoint=Checkpoint(ckpt_path) if ckpt_path else None,
        report_fn=on_report,
    )
    set_context(ctx)
    error: Optional[str] = None
    stopped = False
    try:
        result = fn(config)
        if isinstance(result, dict):
            # function returned final metrics (reference supports both styles)
            on_report(TrainingResult(metrics=result))
    except _StopTrial:
        stopped = True
    except BaseException as e:  # noqa: BLE001
        error = f"{type(e).__name__}: {e}"
    finally:
        set_context(None)
        ray_tpu_torch.get(collector.finish.remote(trial_id, error, stopped))
    return {"stopped": stopped, "error": error}


class TuneController:
    def __init__(
        self,
        trainable: Callable,
        trials: List[Trial],
        *,
        scheduler: Optional[TrialScheduler] = None,
        metric: Optional[str] = None,
        mode: str = "max",
        max_concurrent: Optional[int] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        searcher=None,
        num_samples: int = 0,  # lazy-suggestion budget (sequential searchers)
        experiment_state=None,  # ExperimentState for periodic snapshots
        experiment_meta: Optional[Dict[str, Any]] = None,
    ):
        self.trainable = trainable
        self.trials = trials
        self.scheduler = scheduler or FIFOScheduler()
        # A scheduler constructed with its own metric/mode wins; otherwise it
        # inherits the experiment's (reference: Tune errors on double-spec —
        # here scheduler-local settings take precedence).
        if getattr(self.scheduler, "metric", None) is None and metric:
            self.scheduler.set_metric(metric, mode)
        self.metric = metric
        self.mode = mode
        self.max_concurrent = max_concurrent or 8
        self.resources_per_trial = resources_per_trial or {"CPU": 1}
        self.searcher = searcher
        # Sequential (model-based) searchers are consulted LAZILY: trials
        # are created as slots free up, so each suggestion sees every prior
        # completion (reference: TuneController asks the SearchGenerator for
        # the next trial inside the step loop, not up front).
        self.lazy_suggest = bool(searcher is not None
                                 and getattr(searcher, "sequential", False))
        self.num_samples = num_samples
        if self.lazy_suggest and num_samples <= len(trials):
            # A sequential searcher is only consulted for trials BEYOND the
            # pre-generated ones, budgeted by num_samples (which defaults to
            # 0): without this guard a direct TuneController user gets zero
            # suggestions and — with no trials — an immediate clean exit
            # that looks like success.
            if not trials:
                raise ValueError(
                    "TuneController got a sequential searcher but "
                    f"num_samples={num_samples} and no pre-generated trials: "
                    "the searcher would never be consulted and the run would "
                    "complete with zero trials. Pass num_samples > 0.")
            logger.warning(
                "TuneController: sequential searcher will never be consulted "
                "(num_samples=%d <= %d pre-generated trials)",
                num_samples, len(trials))
        self._suggested = len(trials)
        self._search_exhausted = False
        self._runners: Dict[str, Any] = {}
        self._run_refs: Dict[str, Any] = {}
        self._collector = None
        self._exp_state = experiment_state
        self._exp_meta = experiment_meta or {}

    # -- helpers -------------------------------------------------------------
    def _launch(self, trial: Trial) -> None:
        # ``GPU`` is the card (``TPU`` its alias), as for a train worker.
        opts = resource_options(self.resources_per_trial)
        runner_cls = ray_tpu_torch.remote(_TrialRunnerActor)
        runner = runner_cls.options(**opts).remote()
        ray_tpu_torch.get(self._collector.clear.remote(trial.trial_id))
        trial._stop_issued = False
        ckpt = trial.restore_checkpoint
        ref = runner.run.remote(
            self.trainable,
            dict(trial.config),
            trial.trial_id,
            self._collector,
            ckpt.path if ckpt else None,
        )
        trial.status = TrialStatus.RUNNING
        trial.restore_checkpoint = None
        self._runners[trial.trial_id] = runner
        self._run_refs[trial.trial_id] = ref

    def _cleanup_runner(self, trial_id: str) -> None:
        runner = self._runners.pop(trial_id, None)
        self._run_refs.pop(trial_id, None)
        if runner is not None:
            try:
                ray_tpu_torch.kill(runner)
            except Exception:
                pass

    # -- the loop ------------------------------------------------------------
    def run(self) -> List[Trial]:
        collector_cls = ray_tpu_torch.remote(_TuneCollectorImpl)
        self._collector = collector_cls.options(num_cpus=0).remote()
        by_id = {t.trial_id: t for t in self.trials}
        # Resume support: already-finished trials (from a restored
        # experiment) never relaunch; interrupted ones carry their
        # restore_checkpoint (experiment_state.py).
        pending = [t for t in self.trials if not t.is_finished()]
        restarting: List[Trial] = []

        while True:
            # launch up to budget
            while (pending or restarting) and len(self._runners) < self.max_concurrent:
                trial = restarting.pop(0) if restarting else pending.pop(0)
                self._launch(trial)

            # Lazy model-based suggestion: fill remaining slots one trial at
            # a time so each suggest() call sees all completions so far.
            while (self.lazy_suggest and not self._search_exhausted
                   and self._suggested < self.num_samples
                   and len(self._runners) < self.max_concurrent):
                from ray_tpu_torch.tune.search import Searcher

                trial = Trial(config={})
                cfg = self.searcher.suggest(trial.trial_id)
                if cfg is None:
                    self._search_exhausted = True
                    break
                if cfg is Searcher.DEFER:
                    if not self._runners and not pending and not restarting:
                        # Nothing running that could unblock the searcher —
                        # treat as exhausted instead of spinning forever.
                        self._search_exhausted = True
                    break
                trial.config = cfg
                self._suggested += 1
                self.trials.append(trial)
                by_id[trial.trial_id] = trial
                self._launch(trial)

            lazy_more = (self.lazy_suggest and not self._search_exhausted
                         and self._suggested < self.num_samples)
            if not self._runners and not pending and not restarting and not lazy_more:
                break

            results, done = ray_tpu_torch.get(self._collector.drain.remote())
            acks: List[tuple] = []  # every result gets one — trials block on it
            for r in results:
                trial = by_id[r["trial_id"]]
                if trial.is_finished():
                    acks.append((trial.trial_id, r["iter"], "STOP"))
                    continue
                metrics = r["metrics"]
                trial.last_result = metrics
                trial.metrics_history.append(metrics)
                if r["ckpt"]:
                    trial.latest_checkpoint = Checkpoint(r["ckpt"])
                if self.searcher is not None:
                    self.searcher.on_trial_result(trial.trial_id, metrics)
                if self.scheduler.metric is not None and self.scheduler.metric in metrics:
                    decision = self.scheduler.on_trial_result(trial, metrics)
                else:
                    decision = TrialScheduler.CONTINUE
                if decision == TrialScheduler.STOP:
                    acks.append((trial.trial_id, r["iter"], "STOP"))
                    trial._stop_issued = True
                elif decision == TrialScheduler.RESTART:
                    # PBT exploit: stop now, respawn with mutated config +
                    # donor checkpoint (scheduler already rewrote trial.config
                    # and trial.restore_checkpoint).
                    acks.append((trial.trial_id, r["iter"], "STOP"))
                    trial.restarts += 1
                    trial._pbt_restart_pending = True
                else:
                    acks.append((trial.trial_id, r["iter"], "CONTINUE"))
            if acks:
                ray_tpu_torch.get(self._collector.ack_batch.remote(acks))

            for trial_id, fin in done.items():
                trial = by_id[trial_id]
                if trial_id not in self._runners:
                    continue  # already handled
                error = fin["error"]
                self._cleanup_runner(trial_id)
                if getattr(trial, "_pbt_restart_pending", False):
                    trial._pbt_restart_pending = False
                    trial.status = TrialStatus.PENDING
                    restarting.append(trial)
                elif error:
                    trial.status = TrialStatus.ERROR
                    trial.error = error
                    if self.searcher is not None:
                        self.searcher.on_trial_complete(trial_id, error=True)
                else:
                    trial.status = (
                        TrialStatus.STOPPED if fin["stopped"] else TrialStatus.TERMINATED
                    )
                    if self.searcher is not None:
                        self.searcher.on_trial_complete(trial_id, result=trial.last_result)
                    self.scheduler.on_trial_complete(trial, trial.last_result)

            if self._exp_state is not None:
                # Completion events always persist immediately (a throttled
                # snapshot losing a TERMINATED status would rerun the trial
                # on restore); mid-trial progress is throttled.
                self._exp_state.maybe_snapshot(self.trials, self._exp_meta,
                                               force=bool(done))

            if not results and not done:
                time.sleep(0.02)

        if self._exp_state is not None:
            self._exp_state.maybe_snapshot(self.trials, self._exp_meta,
                                           force=True)
        try:
            ray_tpu_torch.kill(self._collector)
        except Exception:
            pass
        self._collector = None
        return self.trials


class _TrialRunnerActor:
    """Actor wrapper so each trial gets its own mailbox + resources."""

    def run(self, fn, config, trial_id, collector, ckpt_path):
        return _trial_main(fn, config, trial_id, collector, ckpt_path)

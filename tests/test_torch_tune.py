"""The JAX package's ``tests/test_tune.py`` on the port's Tune package,
modeled on the reference's ``python/ray/tune/tests/``: variant generation
(grid × random), controller end-to-end, ASHA early stopping, PBT
exploit/explore, trainer-through-tune integration (``TorchTrainer``),
experiment persistence across a crashed driver, model-based search.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.tune import (
    ASHAScheduler,
    BasicVariantGenerator,
    PopulationBasedTraining,
    TuneConfig,
    Tuner,
    TrialStatus,
)


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


class TestSearchSpaces:
    def test_grid_cross_product_and_samples(self):
        space = {
            "a": tune.grid_search([1, 2, 3]),
            "b": tune.grid_search(["x", "y"]),
            "c": tune.uniform(0.0, 1.0),
        }
        gen = BasicVariantGenerator(space, num_samples=2, seed=0)
        assert gen.total_variants == 12  # 3*2 grid × 2 samples
        cfgs = [gen.suggest(str(i)) for i in range(12)]
        assert all(c is not None for c in cfgs)
        assert gen.suggest("13") is None
        assert {c["a"] for c in cfgs} == {1, 2, 3}
        assert all(0.0 <= c["c"] <= 1.0 for c in cfgs)

    def test_random_only_space(self):
        gen = BasicVariantGenerator(
            {"lr": tune.loguniform(1e-5, 1e-1), "n": tune.randint(1, 5)},
            num_samples=8,
            seed=1,
        )
        assert gen.total_variants == 8
        for i in range(8):
            c = gen.suggest(str(i))
            assert 1e-5 <= c["lr"] <= 1e-1
            assert 1 <= c["n"] < 5

    def test_nested_space(self):
        gen = BasicVariantGenerator(
            {"opt": {"lr": tune.choice([1, 2]), "wd": 0.1}}, num_samples=3, seed=0
        )
        c = gen.suggest("0")
        assert c["opt"]["lr"] in (1, 2) and c["opt"]["wd"] == 0.1


class TestTunerE2E:
    def test_fifo_runs_all_trials(self, ray_start_regular):
        def trainable(config):
            tune.report({"score": config["x"] * 2})

        grid = Tuner(
            trainable,
            param_space={"x": tune.grid_search([1, 2, 3, 4])},
            tune_config=TuneConfig(metric="score", mode="max"),
        ).fit()
        assert len(grid) == 4
        assert grid.num_errors == 0
        assert grid.get_best_result().metrics["score"] == 8

    def test_final_return_dict_counts_as_report(self, ray_start_regular):
        def trainable(config):
            return {"score": config["x"]}

        grid = tune.run(trainable, config={"x": tune.grid_search([5, 7])},
                        metric="score", mode="max")
        assert grid.get_best_result().metrics["score"] == 7

    def test_trial_error_isolated(self, ray_start_regular):
        def trainable(config):
            if config["x"] == 2:
                raise RuntimeError("bad trial")
            tune.report({"score": config["x"]})

        grid = tune.run(trainable, config={"x": tune.grid_search([1, 2, 3])},
                        metric="score", mode="max")
        assert grid.num_errors == 1
        assert grid.get_best_result().metrics["score"] == 3

    def test_asha_stops_bad_trials_early(self, ray_start_regular):
        iters_run = {}

        def trainable(config):
            n = 0
            for i in range(1, 17):
                n = i
                tune.report({"loss": config["quality"] + i * 0.001})
            # record via metric (can't touch driver state from actor)
            tune.report({"loss": config["quality"], "final_iters": n})

        grid = tune.run(
            trainable,
            config={"quality": tune.grid_search([0.1, 0.2, 5.0, 6.0])},
            metric="loss",
            mode="min",
            scheduler=ASHAScheduler(max_t=32, grace_period=2, reduction_factor=2, mode="min"),
        )
        statuses = [t.status for t in grid._trials]
        assert TrialStatus.STOPPED in statuses  # bad trials cut early
        # the best (lowest quality value) trial survived to completion
        best = grid.get_best_result()
        assert best.metrics["loss"] <= 0.2

    def test_pbt_exploits_and_restores(self, ray_start_regular, tmp_path):
        """Bad PBT trials must pick up the good trial's checkpointed step &
        mutated lr."""
        from ray_tpu_torch.train import save_pytree, load_pytree

        def trainable(config):
            ctx = tune.get_context()
            start, inherited_lr = 0, None
            ck = tune.get_checkpoint()
            if ck is not None:
                state = load_pytree(ck.path)
                start = state["step"]
                inherited_lr = state["lr"]
            score = config["lr"]  # higher lr == better, to make exploit deterministic
            import tempfile as tf

            for i in range(start, start + 12):
                d = tf.mkdtemp()
                save_pytree({"step": i + 1, "lr": config["lr"]}, d)
                tune.report(
                    {"score": score, "step": i + 1, "inherited": inherited_lr or 0.0},
                    checkpoint=tune.Checkpoint(d),
                )

        grid = tune.run(
            trainable,
            config={"lr": tune.grid_search([0.01, 1.0])},
            metric="score",
            mode="max",
            scheduler=PopulationBasedTraining(
                metric="score",
                mode="max",
                perturbation_interval=3,
                quantile_fraction=0.5,
                hyperparam_mutations={"lr": tune.uniform(0.5, 2.0)},
                seed=0,
            ),
        )
        restarted = [t for t in grid._trials if t.restarts > 0]
        assert restarted, "PBT should have restarted the weak trial"
        # after exploit, the restarted trial inherits the strong lr lineage
        assert any(
            t.last_result.get("inherited", 0) >= 0.5 for t in restarted
        ), [t.last_result for t in grid._trials]

    def test_trainer_through_tuner(self, ray_start_regular, tmp_path):
        """Reference layering: Train's fit runs through Tune
        (``base_trainer.py:580``) — here via as_trainable()."""
        from ray_tpu_torch.train import TorchTrainer, RunConfig, ScalingConfig
        import ray_tpu_torch.train as rtt

        def loop(config):
            rtt.report({"loss": 1.0 / config.get("lr", 1.0)})

        trainer = TorchTrainer(
            loop,
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(storage_path=str(tmp_path), name="tt"),
        )
        grid = Tuner(
            trainer,
            param_space={"lr": tune.grid_search([1.0, 2.0, 4.0])},
            tune_config=TuneConfig(metric="loss", mode="min"),
        ).fit()
        assert len(grid) == 3
        assert grid.get_best_result().metrics["loss"] == 0.25


class TestReviewRegressions:
    def test_scheduler_own_metric_respected(self):
        from ray_tpu_torch.tune.tune_controller import TuneController

        sched = ASHAScheduler(metric="loss", mode="min", max_t=8)
        c = TuneController(lambda cfg: None, [], scheduler=sched)
        assert sched.metric == "loss" and sched.mode == "min"

    def test_asha_uneven_time_attr(self):
        from ray_tpu_torch.tune.experiment import Trial

        sched = ASHAScheduler(metric="s", mode="max", time_attr="step",
                              max_t=100, grace_period=2, reduction_factor=2)
        good, bad = Trial({}), Trial({})
        # reports at step 5 (crosses milestones 2 and 4 at once)
        assert sched.on_trial_result(good, {"step": 5, "s": 10.0}) == "CONTINUE"
        assert sched.on_trial_result(bad, {"step": 5, "s": 0.1}) == "STOP"

    def test_sample_from_sees_siblings(self):
        gen = BasicVariantGenerator(
            {"a": tune.choice([3]), "b": tune.sample_from(lambda c: c["a"] * 2)},
            num_samples=2, seed=0,
        )
        cfg = gen.suggest("0")
        assert cfg == {"a": 3, "b": 6}

    def test_sample_from_sees_grid_values(self):
        gen = BasicVariantGenerator(
            {"a": tune.grid_search([1, 5]), "b": tune.sample_from(lambda c: c["a"] + 1)},
            num_samples=1,
        )
        cfgs = [gen.suggest(str(i)) for i in range(2)]
        assert sorted((c["a"], c["b"]) for c in cfgs) == [(1, 2), (5, 6)]

    def test_pbt_rejects_bad_quantile(self):
        with pytest.raises(ValueError):
            PopulationBasedTraining(metric="s", quantile_fraction=0.7)


class TestExperimentPersistence:
    """Tuner.restore after a hard crash (tune/execution/experiment_state.py
    analog): completed trials keep results, the interrupted trial resumes
    from its checkpoint, pending trials run — nothing completed reruns."""

    def test_crash_and_restore(self, tmp_path):
        import os
        import subprocess
        import sys

        storage = tmp_path / "exp_store"
        marks = tmp_path / "marks"
        marks.mkdir()
        script = tmp_path / "crash_run.py"
        script.write_text(f"""
import os, sys
sys.path.insert(0, {str(os.getcwd())!r})
import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.checkpoint import Checkpoint

MARKS = {str(marks)!r}

def trainable(config):
    trial = config["idx"]
    ckpt = tune.get_checkpoint()
    start = 0
    if ckpt is not None:
        with open(os.path.join(ckpt.path, "it.txt")) as f:
            start = int(f.read())
    import uuid
    open(os.path.join(MARKS, f"start-{{trial}}-{{start}}-{{uuid.uuid4().hex[:6]}}"), "w").close()
    # The third trial crashes the whole controller process mid-flight
    # after writing one checkpoint.
    for i in range(start, 3):
        cdir = os.path.join(MARKS, f"ckpt-{{trial}}-{{i}}")
        os.makedirs(cdir, exist_ok=True)
        with open(os.path.join(cdir, "it.txt"), "w") as f:
            f.write(str(i + 1))
        tune.report({{"score": trial * 10 + i, "training_iteration": i + 1}},
                    checkpoint=Checkpoint(cdir))
        crash_marker = os.path.join(MARKS, "crashed-once")
        if trial == 2 and i == 1 and not os.path.exists(crash_marker):
            open(crash_marker, "w").close()
            os.kill(os.getpid(), 9)  # one-shot: resumes must survive

ray_tpu_torch.init(resources={{"CPU": 2}})
tuner = tune.Tuner(
    trainable,
    param_space={{"idx": tune.grid_search([0, 1, 2, 3])}},
    tune_config=tune.TuneConfig(metric="score", mode="max",
                                max_concurrent_trials=1),
    run_config=RunConfig(name="crashy", storage_path={str(storage)!r}),
)
tuner.fit()
""")
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, timeout=300)
        assert proc.returncode != 0, "expected the run to crash"
        exp_path = str(storage / "crashy")

        import ray_tpu_torch
        from ray_tpu_torch import tune as rtune

        assert rtune.Tuner.can_restore(exp_path)
        ray_tpu_torch.init(resources={"CPU": 2})
        try:
            tuner = rtune.Tuner.restore(exp_path)
            grid = tuner.fit()
        finally:
            ray_tpu_torch.shutdown()
        assert len(grid) == 4
        scores = sorted(r.metrics["score"] for r in grid.results)
        assert scores == [2, 12, 22, 32]  # every trial reached iteration 3

        starts = sorted(p.name for p in marks.iterdir()
                        if p.name.startswith("start-"))
        # Trials 0,1 ran once (before crash; never rerun). Trial 2 ran
        # fresh then resumed from its iteration-2 checkpoint. Trial 3 ran
        # only after restore.
        def count(prefix):
            return len([s for s in starts if s.startswith(prefix)])

        # Trials 0,1 completed before the crash and never rerun.
        assert count("start-0-") == 1 and count("start-1-") == 1
        # Trial 2 ran in both processes (resumed from whichever point the
        # snapshot caught — possibly from scratch; only COMPLETION
        # persistence is guaranteed).
        assert count("start-2-") == 2
        # Trial 3 only ran after restore.
        assert count("start-3-") == 1


class TestModelBasedSearch:
    """TPE + ConcurrencyLimiter + HyperBand (VERDICT r4 missing #5)."""

    @staticmethod
    def _surface(x, y):
        # Deterministic 2-D objective, minimum 0 at (0.2, -0.6); multi-scale
        # enough that random search wastes samples far from the bowl.
        return (x - 0.2) ** 2 + (y + 0.6) ** 2

    def _best_offline(self, searcher_factory, budget: int, seed: int) -> float:
        """Drive a searcher through the suggest/complete protocol without a
        cluster; returns the best (lowest) objective found."""
        s = searcher_factory(seed)
        s.metric, s.mode = "obj", "min"
        best = float("inf")
        for i in range(budget):
            cfg = s.suggest(f"t{i}")
            assert cfg is not None
            v = self._surface(cfg["x"], cfg["y"])
            best = min(best, v)
            s.on_trial_complete(f"t{i}", result={"obj": v})
        return best

    def test_tpe_beats_random_on_2d_surface(self):
        from ray_tpu_torch.tune.search import TPESearcher

        space = {"x": tune.uniform(-2.0, 2.0), "y": tune.uniform(-2.0, 2.0)}
        budget = 40
        seeds = range(6)
        tpe = [self._best_offline(
            lambda s: TPESearcher(space, n_initial=8, seed=s), budget, s)
            for s in seeds]
        rnd = [self._best_offline(
            lambda s: BasicVariantGenerator(space, num_samples=budget, seed=s),
            budget, s) for s in seeds]
        # Same budget, averaged over seeds: the model must focus samples
        # into the bowl and land measurably closer to the optimum.
        assert np.mean(tpe) < np.mean(rnd), (tpe, rnd)
        assert np.median(tpe) < 0.05, tpe

    def test_tpe_nested_and_categorical(self):
        from ray_tpu_torch.tune.search import TPESearcher

        space = {"opt": {"lr": tune.loguniform(1e-4, 1e0),
                         "kind": tune.choice(["sgd", "adam"])},
                 "n": tune.randint(1, 8)}
        s = TPESearcher(space, n_initial=4, seed=0)
        s.metric, s.mode = "obj", "min"
        for i in range(12):
            cfg = s.suggest(f"t{i}")
            assert 1e-4 <= cfg["opt"]["lr"] <= 1.0
            assert cfg["opt"]["kind"] in ("sgd", "adam")
            assert 1 <= cfg["n"] < 8
            # "adam" with small lr is better: TPE should learn this.
            v = (0.0 if cfg["opt"]["kind"] == "adam" else 1.0) + cfg["opt"]["lr"]
            s.on_trial_complete(f"t{i}", result={"obj": v})
        late = [s.suggest(f"late{i}") for i in range(6)]
        assert sum(1 for c in late if c["opt"]["kind"] == "adam") >= 4

    def test_concurrency_limiter_defers(self):
        from ray_tpu_torch.tune.search import ConcurrencyLimiter, Searcher, TPESearcher

        space = {"x": tune.uniform(0.0, 1.0)}
        lim = ConcurrencyLimiter(TPESearcher(space, seed=0), max_concurrent=2)
        lim.metric, lim.mode = "obj", "min"
        a, b = lim.suggest("a"), lim.suggest("b")
        assert a is not None and b is not None
        assert lim.suggest("c") is Searcher.DEFER
        lim.on_trial_complete("a", result={"obj": 0.5})
        assert lim.suggest("c") is not Searcher.DEFER

    def test_tpe_through_tuner_lazy(self, ray_start_regular):
        """End-to-end: a sequential searcher under a ConcurrencyLimiter
        through the real controller — trials are created lazily and the
        searcher sees completions between suggestions."""
        from ray_tpu_torch.tune.search import ConcurrencyLimiter, TPESearcher

        def trainable(config):
            tune.report({"obj": (config["x"] - 0.3) ** 2})

        space = {"x": tune.uniform(-1.0, 1.0)}
        result = Tuner(
            trainable,
            param_space=space,
            tune_config=TuneConfig(
                metric="obj", mode="min", num_samples=10,
                search_alg=ConcurrencyLimiter(
                    TPESearcher(space, n_initial=4, seed=0), max_concurrent=2),
            ),
        ).fit()
        assert len(result) == 10
        best = result.get_best_result()
        assert best.metrics["obj"] < 0.2

    def test_hyperband_brackets_and_stops(self):
        from ray_tpu_torch.tune.experiment import Trial
        from ray_tpu_torch.tune.schedulers import HyperBandScheduler, TrialScheduler

        hb = HyperBandScheduler(metric="score", mode="max", max_t=9,
                                reduction_factor=3)
        # Brackets exist with distinct initial budgets.
        assert len(hb._bracket_milestones) == 3
        trials = [Trial(config={"i": i}) for i in range(9)]
        # Feed results: trial quality equals its index (higher = better).
        stopped = set()
        for t_iter in range(1, 10):
            for i, tr in enumerate(trials):
                if tr.trial_id in stopped:
                    continue
                d = hb.on_trial_result(tr, {"training_iteration": t_iter,
                                            "score": float(i)})
                if d == TrialScheduler.STOP:
                    stopped.add(tr.trial_id)
        # Some early stopping happened, and the best trial was never culled
        # before max_t (it can only stop by exhausting the budget).
        assert stopped
        best = trials[-1]
        # best trial stops only via t >= max_t, which counts as budget end
        d = hb.on_trial_result(best, {"training_iteration": 9, "score": 8.0})
        assert d == TrialScheduler.STOP  # budget exhausted, not culled early


class TestBOHBStyleComposition:
    def test_tpe_searcher_with_hyperband_scheduler(self, ray_start_regular):
        """BOHB's shape: a model-based searcher PROPOSES configs while
        HyperBand's bracketed successive halving CULLS them early — the
        two compose through the standard TuneConfig surface (reference:
        tune/schedulers/hb_bohb.py + search/bohb)."""
        from ray_tpu_torch.tune.schedulers import HyperBandScheduler
        from ray_tpu_torch.tune.search import ConcurrencyLimiter, TPESearcher

        def trainable(cfg):
            # Converges toward a config-dependent plateau; bad x plateaus
            # low and should be culled at early rungs.
            for i in range(1, 10):
                score = (1.0 - (cfg["x"] - 0.6) ** 2) * (i / 9.0)
                tune.report({"score": score})

        space = {"x": tune.uniform(0.0, 1.0)}
        res = Tuner(
            trainable,
            param_space=space,
            tune_config=TuneConfig(
                metric="score", mode="max", num_samples=12,
                search_alg=ConcurrencyLimiter(
                    TPESearcher(space, n_initial=4, seed=3),
                    max_concurrent=3),
                scheduler=HyperBandScheduler(
                    metric="score", mode="max", max_t=9,
                    reduction_factor=3),
            ),
        ).fit()
        assert len(res) == 12
        best = res.get_best_result()
        assert best.metrics["score"] > 0.8, best.metrics
        # HyperBand actually culled: some trials stopped before max_t.
        iters = [r.metrics.get("training_iteration", 0) for r in res.results]
        assert min(iters) < 9, iters


class TestTPECategoricalExploration:
    """_categorical_axis must SAMPLE candidates ∝ the smoothed good-set
    frequencies and argmax the density ratio over that candidate set — the
    old deterministic argmax over all categories emitted the identical
    value on every back-to-back suggest (ADVICE r5), killing exploration
    under ConcurrencyLimiter(max_concurrent>1)."""

    def _searcher(self, seed=0):
        from ray_tpu_torch.tune.search import Choice, TPESearcher

        space = {"c": Choice(["a", "b", "c"])}
        # Small candidate pool so the draw visibly subsets the categories.
        return TPESearcher(space, n_initial=2, n_candidates=4, seed=seed)

    def test_back_to_back_draws_explore(self):
        s = self._searcher(seed=3)
        # good favors "a" heavily; "c" is rare-but-good (highest l/g ratio);
        # bad concentrates on "a"/"b".
        good = ["a"] * 8 + ["c"]
        bad = ["a"] * 6 + ["b"] * 6
        draws = [s._categorical_axis(["a", "b", "c"], good, bad)
                 for _ in range(100)]
        # No new observations between calls — the old code returned one
        # category 100 times; the fix must explore.
        assert len(set(draws)) > 1, "categorical axis collapsed to argmax"
        # ...while still favoring categories that look good.
        counts = {v: draws.count(v) for v in set(draws)}
        assert counts.get("b", 0) < counts.get("a", 0) + counts.get("c", 0)

    def test_candidates_follow_good_frequencies(self):
        s = self._searcher(seed=11)
        # Everything good is "b": the draw should essentially always pick it.
        draws = [s._categorical_axis(["a", "b", "c"], ["b"] * 12, ["a"] * 6)
                 for _ in range(50)]
        assert draws.count("b") >= 45


class TestTuneControllerLazySuggestGuard:
    """TuneController must not silently complete with zero trials when a
    sequential searcher is given but num_samples was left at 0 (ADVICE r5)."""

    def _sequential_searcher(self):
        from ray_tpu_torch.tune.search import Searcher

        class Seq(Searcher):
            sequential = True

            def suggest(self, trial_id):
                return {"x": 1}

        return Seq()

    def test_zero_samples_no_trials_raises(self):
        from ray_tpu_torch.tune.tune_controller import TuneController

        with pytest.raises(ValueError, match="num_samples"):
            TuneController(lambda cfg: None, [],
                           searcher=self._sequential_searcher())

    def test_samples_below_pregenerated_warns(self, caplog):
        import logging

        from ray_tpu_torch.tune.experiment import Trial
        from ray_tpu_torch.tune.tune_controller import TuneController

        trials = [Trial(config={"x": 0}), Trial(config={"x": 1})]
        # The ray_tpu_torch root logger is propagate=False; caplog captures at the
        # python root, so re-enable propagation for the assertion.
        logging.getLogger("ray_tpu_torch").propagate = True
        try:
            with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.tune"):
                TuneController(lambda cfg: None, trials,
                               searcher=self._sequential_searcher(),
                               num_samples=2)
        finally:
            logging.getLogger("ray_tpu_torch").propagate = False
        assert any("never be consulted" in r.message for r in caplog.records)

    def test_adequate_budget_is_silent(self, caplog):
        import logging

        from ray_tpu_torch.tune.tune_controller import TuneController

        logging.getLogger("ray_tpu_torch").propagate = True
        try:
            with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.tune"):
                TuneController(lambda cfg: None, [],
                               searcher=self._sequential_searcher(),
                               num_samples=4)
        finally:
            logging.getLogger("ray_tpu_torch").propagate = False
        assert not any("never be consulted" in r.message
                       for r in caplog.records)

"""The JAX package's ``tests/test_train.py`` on the port's Train library:
rank mapping, report rounds as barriers, checkpoint persistence + top-k,
failure→restart-from-checkpoint, and the MLP and GPT-2 end-to-end gates
(SURVEY §7 P4 gates #1 and #2), through ``TorchTrainer`` on the in-process
runtime. Then the port's own rules: ``TorchConfig``'s process group (none
among workers of one process unless asked, and then one per process only;
a ``GPU`` grant without a card raises rather than dropping to gloo; a
stale group destroyed within its bound), ``ScalingConfig``'s ``GPU`` and
its aliases, and checkpoint leaves JAX has no counterpart for (bf16
tensors, in-place updates after an async snapshot).
"""

import os
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train as rt_train
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchConfig,
    TorchTrainer,
)


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(resources={"CPU": 4})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture
def storage(tmp_path):
    return str(tmp_path / "results")


class TestSessionAndExecutor:
    def test_rank_mapping_and_rounds(self, ray_start_regular, storage):
        def loop(config):
            ctx = rt_train.get_context()
            for i in range(3):
                rt_train.report(
                    {
                        "round": i,
                        "rank": ctx.get_world_rank(),
                        "world": ctx.get_world_size(),
                        "local_rank": ctx.get_local_rank(),
                    }
                )

        trainer = TorchTrainer(
            loop,
            scaling_config=ScalingConfig(num_workers=4),
            run_config=RunConfig(storage_path=storage, name="ranks"),
        )
        result = trainer.fit()
        assert result.error is None
        assert len(result.metrics_history) == 3
        assert result.metrics["round"] == 2
        assert result.metrics["world"] == 4

    def test_all_ranks_report_each_round(self, ray_start_regular, storage):
        from ray_tpu_torch.train.backend_executor import BackendExecutor

        def loop(config):
            ctx = rt_train.get_context()
            rt_train.report({"rank": ctx.get_world_rank()})
            rt_train.report({"rank2": ctx.get_world_rank()})

        ex = BackendExecutor(scaling_config=ScalingConfig(num_workers=3))
        ex.start()
        ex.start_training(loop, {})
        r0 = ex.get_next_results(timeout=60)
        assert sorted(r.metrics["rank"] for r in r0) == [0, 1, 2]
        r1 = ex.get_next_results(timeout=60)
        assert sorted(r.metrics["rank2"] for r in r1) == [0, 1, 2]
        assert ex.get_next_results(timeout=60) is None
        ex.shutdown()

    def test_worker_exception_surfaces(self, ray_start_regular, storage):
        def loop(config):
            ctx = rt_train.get_context()
            if ctx.get_world_rank() == 1:
                raise ValueError("boom on rank 1")
            rt_train.report({"ok": 1})

        trainer = TorchTrainer(
            loop,
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(storage_path=storage, name="fail"),
        )
        result = trainer.fit()
        assert result.error is not None
        assert "boom" in str(result.error)


class TestCheckpointing:
    def test_checkpoint_pytree_roundtrip(self, tmp_path):
        tree = {"w": torch.arange(6.0).reshape(2, 3),
                "meta": {"step": 7, "name": "x"}}
        d = str(tmp_path / "ck")
        rt_train.save_pytree(tree, d)
        back = rt_train.load_pytree(d)
        np.testing.assert_array_equal(back["w"], np.arange(6.0).reshape(2, 3))
        assert back["meta"] == {"step": 7, "name": "x"}

    def test_restore_preserves_container_types(self, tmp_path):
        from ray_tpu_torch.models import training

        params = {"w": torch.ones((3,), requires_grad=True)}
        opt = training.adamw(1e-3).init(params)
        state = training.adamw_state_tree(opt, params)
        d = str(tmp_path / "opt")
        rt_train.save_pytree(state, d)
        zeros = rt_train.load_pytree(d)   # plain tuples, numpy leaves
        restored = rt_train.restore_pytree(state, d)
        assert type(restored[0]).__name__ == type(state[0]).__name__
        assert type(zeros[0]) is tuple
        np.testing.assert_array_equal(restored[0].mu["w"], state[0].mu["w"])

    def test_report_checkpoint_and_topk(self, ray_start_regular, storage):
        def loop(config):
            import tempfile as tf

            ctx = rt_train.get_context()
            for i in range(5):
                ckpt = None
                if ctx.get_world_rank() == 0:
                    d = tf.mkdtemp()
                    rt_train.save_pytree({"step": i}, d)
                    ckpt = Checkpoint(d)
                rt_train.report({"score": float(i)}, checkpoint=ckpt)

        trainer = TorchTrainer(
            loop,
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(
                storage_path=storage,
                name="topk",
                checkpoint_config=CheckpointConfig(
                    num_to_keep=2, checkpoint_score_attribute="score"
                ),
            ),
        )
        result = trainer.fit()
        assert result.error is None
        kept = result.best_checkpoints
        assert len(kept) == 2
        assert rt_train.load_pytree(result.checkpoint.path)["step"] == 4

    def test_failure_restarts_from_checkpoint(self, ray_start_regular, storage):
        marker = os.path.join(storage, "crashed_once")
        os.makedirs(storage, exist_ok=True)

        def loop(config):
            import tempfile as tf

            ctx = rt_train.get_context()
            start = 0
            ck = rt_train.get_checkpoint()
            if ck is not None:
                start = rt_train.load_pytree(ck.path)["step"] + 1
            for i in range(start, 4):
                if i == 2 and not os.path.exists(config["marker"]):
                    open(config["marker"], "w").close()
                    raise RuntimeError("injected failure at step 2")
                ckpt = None
                if ctx.get_world_rank() == 0:
                    d = tf.mkdtemp()
                    rt_train.save_pytree({"step": i}, d)
                    ckpt = Checkpoint(d)
                rt_train.report({"step": i, "resumed_from": start}, checkpoint=ckpt)

        trainer = TorchTrainer(
            loop,
            train_loop_config={"marker": marker},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(
                storage_path=storage,
                name="restart",
                failure_config=FailureConfig(max_failures=1),
            ),
        )
        result = trainer.fit()
        assert result.error is None
        assert result.metrics["step"] == 3
        assert result.metrics["resumed_from"] == 2  # resumed, not from scratch


class TestMLPGate:
    def test_mlp_e2e_converges(self, ray_start_regular, storage):
        """SURVEY §7 P4 e2e gate #1: MLP classification through the trainer."""

        def loop(config):
            import numpy as np
            import torch

            from ray_tpu_torch.models import mlp, training

            cfg = mlp.MLPConfig(in_dim=8, hidden=(32,), n_classes=2)
            bundle = training.make_train_step(
                loss_fn=lambda p, b: mlp.classifier_loss(p, b, cfg),
                init_params_fn=lambda seed: mlp.init_params(cfg, seed,
                                                            device="cpu"),
                optimizer=training.adamw(1e-2), device="cpu")
            params, state = bundle.init(0)
            rng = np.random.default_rng(0)
            x = rng.normal(size=(256, 8)).astype(np.float32)
            y = (x[:, 0] > 0).astype(np.int64)
            batch = {"x": torch.tensor(x), "y": torch.tensor(y)}
            for epoch in range(30):
                params, state, m = bundle.step(params, state, batch)
                if epoch % 10 == 9:
                    rt_train.report({"loss": m["loss"].item()})

        trainer = TorchTrainer(
            loop,
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(storage_path=storage, name="mlp"),
        )
        result = trainer.fit()
        assert result.error is None
        assert result.metrics["loss"] < 0.2


class TestCheckpointRegressions:
    def test_none_leaf_roundtrip(self, tmp_path):
        d = str(tmp_path / "nck")
        rt_train.save_pytree({"a": None, "b": 1.0, "c": np.arange(3)}, d)
        back = rt_train.load_pytree(d)
        assert back["a"] is None and back["b"] == 1.0
        np.testing.assert_array_equal(back["c"], np.arange(3))

    def test_non_string_dict_keys_rejected(self, tmp_path):
        with pytest.raises(TypeError, match="keys must be str"):
            rt_train.save_pytree({0: np.zeros(2)}, str(tmp_path / "bad"))

    def test_async_checkpointer_surfaces_errors(self, tmp_path):
        ck = rt_train.AsyncCheckpointer()
        ck.save({"x": object()}, str(tmp_path / "a"))  # unsupported leaf
        with pytest.raises(TypeError):
            ck.wait()


class TestGpt2Gate:
    def test_gpt2_through_torch_trainer(self, ray_start_regular, storage):
        """SURVEY §7 P4 gate #2 (scaled down): tiny GPT-2, the sharded train
        step on a mesh over the process group ``TorchConfig`` formed (world
        1, gloo), checkpointed via report. The JAX gate streams its token
        rows through the Data library; the port's Data library is not
        ported yet (ROADMAP Queue 1, item 12), so the same rows go in as
        numpy batches."""

        def loop(config):
            import tempfile as tf

            import numpy as np
            import torch
            import torch.distributed as dist

            from ray_tpu_torch.models import training, transformer
            from ray_tpu_torch.parallel.mesh import MeshSpec, cpu_mesh
            from ray_tpu_torch.parallel.sharding import ShardingRules

            cfg = transformer.tiny(max_seq_len=32, n_layers=2)
            mesh = cpu_mesh(MeshSpec(data=-1))
            rules = ShardingRules()
            bundle = training.make_train_step(
                loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg, mesh=mesh,
                                                         rules=rules),
                init_params_fn=lambda seed: transformer.init_params(
                    cfg, seed, device="cpu"),
                logical_params=transformer.logical_axes(cfg),
                mesh=mesh,
                rules=rules,
                optimizer=training.adamw(1e-3),
                batch_logical=None,
            )
            params, opt = bundle.init(0)

            rng = np.random.default_rng(0)
            docs = [rng.integers(0, cfg.vocab_size, 32).tolist()
                    for _ in range(64)]

            losses = []
            for epoch in range(4):
                for i in range(0, len(docs), 8):
                    batch = {"tokens": torch.tensor(np.stack(
                        [np.asarray(t, np.int64) for t in docs[i:i + 8]]))}
                    params, opt, metrics = bundle.step(params, opt, batch)
                    losses.append(metrics["loss"].item())
                d = tf.mkdtemp()
                rt_train.save_pytree({"epoch": epoch}, d)
                rt_train.report(
                    {"loss": losses[-1], "first_loss": losses[0],
                     "epoch": epoch, "backend": dist.get_backend(),
                     "world": dist.get_world_size()},
                    checkpoint=Checkpoint(d),
                )

        trainer = TorchTrainer(
            loop,
            backend_config=TorchConfig(init_distributed=True),
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(storage_path=storage, name="gpt2gate"),
        )
        result = trainer.fit()
        assert result.error is None
        assert result.metrics["loss"] < result.metrics["first_loss"]
        assert (result.metrics["backend"], result.metrics["world"]) == ("gloo", 1)
        assert rt_train.load_pytree(result.checkpoint.path)["epoch"] == 3
        # The group formed in this process went with the trainer.
        assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------


def test_no_process_group_among_workers_of_one_process(ray_start_regular, storage):
    def loop(config):
        import torch.distributed as dist

        rt_train.report({"group": dist.is_initialized()})

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=storage, name="nogroup")).fit()
    assert result.error is None and result.metrics == {"group": False}
    with pytest.raises(ValueError, match="one rank per process"):
        TorchTrainer(
            loop, backend_config=TorchConfig(init_distributed=True),
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(storage_path=storage, name="two")).fit()


def test_gpu_grant_without_a_card_raises(storage):
    """``init(num_gpus=1)`` fakes the card for the scheduler: the worker
    gets its ``GPU`` grant, sees no CUDA device and raises; the group never
    falls back to gloo."""
    ray_tpu_torch.init(resources={"CPU": 2}, num_gpus=1)
    try:
        def loop(config):
            rt_train.report({"ran": True})

        with pytest.raises(Exception, match="sees no CUDA device"):
            TorchTrainer(
                loop, backend_config=TorchConfig(init_distributed=True),
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                run_config=RunConfig(storage_path=storage, name="nocard")).fit()
        assert not torch.distributed.is_initialized()
    finally:
        ray_tpu_torch.shutdown()


def test_scaling_config_gpu_and_aliases():
    assert ScalingConfig().worker_resources() == {"CPU": 1.0}
    assert ScalingConfig(use_gpu=True).worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(gpus_per_worker=0.5).worker_resources() == {"CPU": 1.0, "GPU": 0.5}
    assert ScalingConfig(use_tpu=True).worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(tpus_per_worker=2).worker_resources() == {"CPU": 1.0, "GPU": 2}
    with pytest.raises(ValueError, match="slice"):
        ScalingConfig(topology="v5e-16")
    from ray_tpu_torch.train.worker_group import resource_options

    assert resource_options({"CPU": 2, "GPU": 0.5, "disk": 1}) == {
        "num_cpus": 2, "num_gpus": 0.5, "resources": {"disk": 1}}
    assert resource_options({"TPU": 1}) == {"num_gpus": 1}
    with pytest.raises(ValueError, match="alias"):
        resource_options({"GPU": 1, "TPU": 1})


def test_stale_group_destroyed_within_its_bound(monkeypatch):
    """A stale group whose destroy never returns (a gloo peer gone) fails
    the setup after the bound instead of hanging it."""
    from ray_tpu_torch.train import backend

    release = threading.Event()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        lambda: release.wait(30))
    try:
        with pytest.raises(RuntimeError, match="did not return in 0.2 s"):
            backend._destroy_process_group(0.2)
    finally:
        release.set()


def test_bf16_leaf_kept_and_tagged(tmp_path):
    import json

    t = torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)
    d = str(tmp_path / "bf16")
    rt_train.save_pytree({"w": t, "f": torch.ones(2)}, d)
    meta = json.load(open(os.path.join(d, "state.tree.json")))["leaves"]
    assert meta == [{"kind": "array"}, {"kind": "array", "dtype": "bfloat16"}]
    back = rt_train.load_pytree(d)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t)
    assert isinstance(back["f"], np.ndarray)
    restored = rt_train.restore_pytree(
        {"w": torch.zeros(3, dtype=torch.float32), "f": torch.zeros(2)}, d)
    assert restored["w"].dtype == torch.float32
    assert torch.equal(restored["w"], t.float())


def test_async_snapshot_survives_in_place_updates(tmp_path):
    """Torch steps update tensors in place: the snapshot ``save`` takes must
    not see a later update."""
    w = torch.zeros(1000)
    ck = rt_train.AsyncCheckpointer()
    ck.save({"w": w}, str(tmp_path / "a"))
    w.add_(1.0)
    ck.wait()
    assert not rt_train.load_pytree(str(tmp_path / "a"))["w"].any()


def test_adamw_state_resumes_the_same_steps():
    """``adamw_state_tree`` through a checkpoint into a fresh optimizer: the
    next steps equal an uninterrupted run's, bit for bit (the count and
    both moments come back; dropping either would change the update)."""
    from ray_tpu_torch.models import training

    def make():
        g = torch.Generator().manual_seed(0)
        return {"a": torch.randn(4, 3, generator=g).requires_grad_(True),
                "b": [{"w": torch.randn(5, generator=g).requires_grad_(True)}]}

    def step(params, opt, seed):
        g = torch.Generator().manual_seed(seed)
        loss = sum(((p - torch.randn(p.shape, generator=g)) ** 2).sum()
                   for p in training._leaves(params))
        for p in training._leaves(params):
            p.grad = None
        loss.backward()
        opt.step()
        return loss.item()

    ad = training.adamw(1e-2, weight_decay=0.1)
    params = make()
    opt = ad.init(params)
    for s in range(3):
        step(params, opt, s)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        rt_train.save_pytree({"params": params,
                              "opt": training.adamw_state_tree(opt, params)}, d)
        fresh = make()
        fresh_opt = ad.init(fresh)
        target = {"params": fresh, "opt": training.adamw_state_tree(fresh_opt, fresh)}
        back = rt_train.restore_pytree(target, d)
    params2 = back["params"]
    opt2 = training.load_adamw_state_tree(ad.init(params2), params2, back["opt"])
    assert int(training.adamw_state_tree(opt2, params2)[0].count) == 3
    for s in range(3, 5):
        assert step(params, opt, s) == step(params2, opt2, s)
    for a, b in zip(training._leaves(params), training._leaves(params2)):
        assert torch.equal(a, b)

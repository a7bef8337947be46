"""The JAX package's ``tests/test_multihost_train.py`` on the port: Train
across real worker PROCESSES of a port ``Cluster``.

Torch runs one rank per process, so the global mesh is a gloo process group
of two worker processes (one CPU device each) — the address flowing through
the GCS KV, as JAX's coordinator does — running the sharded GPT-2-tiny
train step with data parallelism across the process boundary. Its losses
over two steps are held to JAX's single-process 8-device oracle
(``_oracle_two_steps`` of the JAX test) on the same parameters and tokens,
at JAX's tolerance (2e-4): step 2's loss depends on step 1's cross-process
gradient reduction. Each rank is handed the whole global batch and keeps
its half (``training.place_batch``); JAX's ranks are handed their halves.

Then elastic fault tolerance through ``TorchTrainer``: a worker process
that dies mid-round is detected, the group restarts from the last
checkpoint, and with ``TorchConfig(init_distributed=True)`` the restarted
group re-forms its gloo world (all-reduce over both ranks).
"""

import os
import sys

import cloudpickle
import jax
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.core.cluster import Cluster, connect

# Worker processes cannot import the tests package — ship this module's
# classes by value (what cloudpickle does automatically for __main__).
cloudpickle.register_pickle_by_value(sys.modules[__name__])

VOCAB, SEQ, GLOBAL_BATCH = 256, 64, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_per_process():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _port_tiny():
    import torch

    from ray_tpu_torch.models import transformer

    return transformer.tiny(
        vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64,
        max_seq_len=SEQ, vocab_multiple=128, attn_impl="dense",
        dtype=torch.float32, param_dtype=torch.float32,
    )


class TrainWorker:
    """One training process (one CPU device, rank in a world of 2)."""

    def __init__(self, rank: int, world: int):
        self.rank = rank
        self.world = world

    def reserve_coordinator(self) -> str:
        """Rank 0: pick a free port; the driver publishes it via GCS KV."""
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return f"127.0.0.1:{port}"

    def init_distributed(self, coordinator: str) -> int:
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=self.world, rank=self.rank)
        return dist.get_world_size()  # global device count

    def train_two_steps(self, tokens_global: np.ndarray, params_np):
        """Run two sharded train steps; returns both global losses."""
        import torch

        from ray_tpu_torch.models import training, transformer
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.parallel.mesh import MeshSpec, cpu_mesh
        from ray_tpu_torch.parallel.sharding import ShardingRules

        mesh = cpu_mesh(MeshSpec(data=-1))
        rules = ShardingRules()
        cfg = _port_tiny()
        bundle = training.make_train_step(
            loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg, mesh=mesh,
                                                     rules=rules),
            init_params_fn=lambda seed: params_from_numpy(params_np, "cpu"),
            logical_params=transformer.logical_axes(cfg),
            mesh=mesh, rules=rules,
            optimizer=training.adamw(1e-2),
            batch_logical=("batch", None),
        )
        params, opt_state = bundle.init(0)
        batch = {"tokens": torch.tensor(tokens_global)}
        losses = []
        for _ in range(2):
            params, opt_state, metrics = bundle.step(params, opt_state, batch)
            # loss is whole on every rank
            losses.append(metrics["loss"].item())
        return losses


def test_two_process_global_mesh_matches_oracle():
    from test_multihost_train import _oracle_two_steps

    from ray_tpu.models import transformer as jtf

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, VOCAB, (GLOBAL_BATCH, SEQ)).astype(np.int32)

    oracle = _oracle_two_steps(tokens)
    # The oracle's own initial parameters (its config, key 0), carried over.
    jcfg = jtf.tiny(
        vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64,
        max_seq_len=SEQ, vocab_multiple=128, attn_impl="dense",
        dtype=jax.numpy.float32, param_dtype=jax.numpy.float32,
    )
    params_np = jax.tree.map(np.asarray,
                             jtf.init_params(jcfg, jax.random.key(0)))

    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 4})
    try:
        core = connect(cluster.gcs_address)
        try:
            worker_cls = ray_tpu_torch.remote(TrainWorker)
            workers = [worker_cls.options(num_cpus=2).remote(r, 2)
                       for r in range(2)]
            # Coordinator address flows through the control plane: rank 0
            # reserves it, the driver publishes to the GCS KV, rank 1 reads
            # it back (the reference broadcasts rank 0's addr the same way).
            coordinator = ray_tpu_torch.get(
                workers[0].reserve_coordinator.remote(), timeout=120)
            core.gcs.kv_put("train/coordinator", coordinator.encode())
            addr = core.gcs.kv_get("train/coordinator").decode()
            # Both inits must be in flight together (the store blocks
            # until every process connects).
            counts = ray_tpu_torch.get(
                [w.init_distributed.remote(addr) for w in workers],
                timeout=300)
            assert counts == [2, 2], f"global world wrong: {counts}"

            refs = [w.train_two_steps.remote(tokens, params_np)
                    for w in workers]
            losses = ray_tpu_torch.get(refs, timeout=300)
            # Every process observed the same (whole) global loss...
            np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
            # ...and it matches the single-process oracle across BOTH steps
            # (step 2 proves the cross-process gradient reduction applied).
            np.testing.assert_allclose(losses[0], oracle, rtol=2e-4, atol=2e-4)
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------------------
# Elastic fault tolerance (SURVEY hard-part #4; reference answer: whole-group
# restart from the last checkpoint, backend_executor.py:121 + FailureConfig)
# ---------------------------------------------------------------------------


def _elastic_loop(config):
    """Deterministic 'training': loss halves each step. Rank 1 kills its own
    PROCESS (kill -9 semantics: no cleanup, no finish() report) at step 3 of
    the FIRST incarnation; the restarted group must resume from the last
    checkpoint, not step 0."""
    import os

    from ray_tpu_torch import train as rt_train

    ctx = rt_train.get_context()
    start_step, loss = 0, 64.0
    ckpt = rt_train.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_dict()
        start_step, loss = int(state["step"]) + 1, float(state["loss"])

    marker = config["marker"]
    for step in range(start_step, config["steps"]):
        loss = loss / 2.0
        if (ctx.get_world_rank() == 1 and step == 3
                and not os.path.exists(marker)):
            open(marker, "w").close()
            os._exit(1)  # hard death — simulates a host/process loss
        rt_train.report(
            {"step": step, "loss": loss, "rank": ctx.get_world_rank()},
            checkpoint=(rt_train.Checkpoint.from_dict(
                {"step": step, "loss": loss})
                if ctx.get_world_rank() == 0 else None),
        )


def test_elastic_worker_death_restores_and_resumes(tmp_path):
    """Kill one worker process mid-training: the BackendExecutor detects the
    death (no hang on the round barrier), fit() tears the group down,
    restarts it, restores the last checkpoint, and the loss trajectory
    CONTINUES (values prove resume-from-checkpoint, not restart-from-0)."""
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)

    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            marker = str(tmp_path / "killed-once")
            trainer = TorchTrainer(
                _elastic_loop,
                train_loop_config={"steps": 6, "marker": marker},
                scaling_config=ScalingConfig(num_workers=2,
                                             cpus_per_worker=1),
                run_config=RunConfig(
                    name="elastic",
                    storage_path=str(tmp_path / "results"),
                    failure_config=FailureConfig(max_failures=2),
                ),
            )
            result = trainer.fit()
            assert result.error is None, result.error
            losses = [m["loss"] for m in result.metrics_history]
            # Deterministic halving from 64.0: a restart-from-scratch would
            # repeat the early values; resume continues the series. The
            # kill at step 3 may or may not lose step 2/3's report, so
            # check: monotone halving, last value correct, and the series
            # NEVER rewinds upward (which restart-from-0 would do).
            assert losses[-1] == 64.0 / 2 ** 6, losses
            assert all(b < a for a, b in zip(losses, losses[1:])), losses
            assert os.path.exists(marker), "kill never happened"
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()


def test_elastic_torch_process_group_world_reforms(tmp_path):
    """After a worker-process death, the restarted group re-forms the torch
    process group (a fresh rendezvous, the full world) and an all-reduce
    across the processes still produces the right value — a fixed world
    handled by whole-group restart (JAX's test: the jax.distributed world
    re-formed)."""
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchConfig, TorchTrainer)

    def loop(config):
        import os

        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train as rt_train

        ctx = rt_train.get_context()
        if (ctx.get_world_rank() == 1
                and not os.path.exists(config["marker"])):
            open(config["marker"], "w").close()
            os._exit(1)
        # all-reduce across the whole re-formed world
        local = torch.full((2,), float(ctx.get_world_rank() + 1))
        dist.all_reduce(local)
        rt_train.report({"world": dist.get_world_size(),
                         "backend": dist.get_backend(),
                         "total": float(local.sum()), "pid": os.getpid()})

    cluster = Cluster(num_nodes=2, resources_per_node={"CPU": 2})
    try:
        core = connect(cluster.gcs_address)
        try:
            marker = str(tmp_path / "pg-killed-once")
            trainer = TorchTrainer(
                loop,
                train_loop_config={"marker": marker},
                backend_config=TorchConfig(init_distributed=True),
                scaling_config=ScalingConfig(num_workers=2,
                                             cpus_per_worker=1),
                run_config=RunConfig(
                    name="elastic-torch",
                    storage_path=str(tmp_path / "results"),
                    failure_config=FailureConfig(max_failures=2),
                ),
            )
            result = trainer.fit()
            assert result.error is None, result.error
            m = result.metrics
            # world re-formed: 2 processes; the sum over per-rank
            # contributions (1+1) + (2+2) = 6
            assert (m["world"], m["backend"]) == (2, "gloo"), m
            assert m["total"] == 6.0, m
            assert os.path.exists(marker)
        finally:
            core.shutdown()
            runtime_mod._global_runtime = None
    finally:
        cluster.shutdown()

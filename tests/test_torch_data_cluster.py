"""The port's Data pipeline on a multi-process ``Cluster``: read and map
tasks pinned to a node of their own by ``ray_remote_args`` (a hard
``NodeAffinitySchedulingStrategy``), the shuffle between them, the split
iterated by the test process, every row once. Run with the daemons' idle-lease
sweep at 0 s, so every capacity block's free units go back to the GCS
before the submitter can carve them: a spent block is not a worker
failure, and the submitter asks the GCS again instead of aborting the task
("cannot obtain a worker after 4 block grants")."""

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rt_data
from ray_tpu_torch.core.cluster import Cluster
from torch_time_limit import per_test_time_limit, time_limit  # noqa: F401

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

TIME_LIMIT_S = 120


@pytest.fixture(scope="module")
def sweeping_cluster():
    with pytest.MonkeyPatch.context() as mp, \
            time_limit(60, "the cluster's start"):
        mp.setenv("OMP_NUM_THREADS", "1")     # one torch thread a process
        cluster = Cluster(num_nodes=0, system_config={"idle_lease_ttl_s": 0.0})
        cluster.add_node({"CPU": 8})
        node_b = cluster.add_node({"CPU": 4})
        rt.init(address=cluster.gcs_address)
    yield node_b
    rt.shutdown()
    cluster.shutdown()


def test_pinned_pipeline_survives_instant_lease_sweeps(sweeping_cluster,
                                                       tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    def _double(batch):      # a closure: shipped to the workers by value
        return {"x": batch["x"] * 2}

    for i in range(16):
        pq.write_table(pa.table({"x": np.arange(i * 64, i * 64 + 64)}),
                       str(tmp_path / f"f{i:02d}.parquet"))
    on_b = {"scheduling_strategy": rt.NodeAffinitySchedulingStrategy(
        node_id=sweeping_cluster.node_id, soft=False)}
    ds = (rt_data.read_parquet(str(tmp_path), ray_remote_args=on_b)
          .map_batches(_double, ray_remote_args=on_b)
          .random_shuffle(seed=0))
    (split,) = ds.streaming_split(1, equal=True)
    got = []
    for b in split.iter_torch_batches(batch_size=16, device="cpu"):
        got.extend(b["x"].tolist())
    split.finish()
    assert sorted(got) == [2 * i for i in range(16 * 64)]

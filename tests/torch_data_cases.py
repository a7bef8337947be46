"""Per-rank body of ``test_torch_data.py``'s sharded-ingest test, run on a
world of gloo CPU ranks (``ray_tpu_torch.parallel.launch.run_world``). No
JAX here: the ranks import torch and the port only."""

import numpy as np


def iter_sharded(rank, world):
    """Every rank iterates the same dataset and lays each batch out on a
    1-D mesh, as the JAX package's single process does under a
    ``NamedSharding``; returns what rank ``rank`` sees of the first batch."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    import ray_tpu_torch
    from ray_tpu_torch import data as rt_data

    ray_tpu_torch.init(resources={"CPU": 1})
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        it = rt_data.range(64).iterator()
        batches = list(it.iter_torch_batches(
            batch_size=16, device="cpu", sharding=(mesh, [Shard(0)]),
            drop_last=True, dtypes={"id": torch.int64}))
        first = batches[0]["id"]
        return {
            "n": len(batches),
            "dtensor": all(isinstance(b["id"], DTensor) for b in batches),
            "placements": [p.is_shard(0) for p in first.placements],
            "mesh_dims": first.device_mesh.mesh_dim_names,
            "local": first.to_local().numpy().copy(),
            "full": [b["id"].full_tensor().numpy().copy() for b in batches],
            "dtype": str(first.dtype),
        }
    finally:
        ray_tpu_torch.shutdown()

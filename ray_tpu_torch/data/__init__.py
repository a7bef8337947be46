"""ray_tpu_torch.data — lazy streaming datasets over the distributed runtime.

Public surface mirrors ``ray.data``: read_* constructors, Dataset transforms,
streaming execution, per-rank iterators for Train ingest.

Counterpart of ``ray_tpu/data``, on pyarrow blocks in the port's object
store: the same modules, with ``iter_torch_batches`` (onto the card by
default) in place of ``iter_jax_batches``, torch tensors accepted where the
JAX package accepts JAX arrays, and ``ray_remote_args`` on ``read_parquet``
and ``map_batches``.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.dataset import (
    Dataset,
    GroupedData,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_csv,
    read_json,
    read_numpy,
    read_parquet,
)
from ray_tpu_torch.data.connectors import (
    read_mongo,
    read_parquet_partitioned,
    read_sql,
    read_webdataset,
    write_parquet_partitioned,
    write_webdataset,
)
from ray_tpu_torch.data.datasources import (
    read_binary_files,
    read_images,
    read_text,
    read_tfrecords,
    write_tfrecords,
)
from ray_tpu_torch.data.iterator import DataIterator

__all__ = [
    "Dataset",
    "GroupedData",
    "DataIterator",
    "Block",
    "BlockAccessor",
    "range",
    "from_items",
    "from_pandas",
    "from_numpy",
    "from_arrow",
    "read_parquet",
    "read_csv",
    "read_json",
    "read_numpy",
    "read_text",
    "read_binary_files",
    "read_images",
    "read_tfrecords",
    "write_tfrecords",
    "read_webdataset",
    "write_webdataset",
    "read_sql",
    "read_parquet_partitioned",
    "write_parquet_partitioned",
    "read_mongo",
]

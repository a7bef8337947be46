"""The port's Data library against the JAX package's, on the same seeded
inputs: every transform and exchange gives equal blocks under each
package's in-process runtime, and files written by one package read back
equal in the other (parquet with partitions, csv, json, TFRecord,
WebDataset). The CRC32C vectors agree.

Each package runs every case in one runtime (the ``outputs`` fixture): JAX's first,
then the port's, then JAX's again to read the port's files; each test
compares one case.
"""

import builtins

import numpy as np
import pytest

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

N_ROWS = 240


def _items(seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": i, "key": int(rng.integers(0, 5)),
             "x": float(rng.standard_normal()),
             "name": f"r{int(rng.integers(0, 1000))}"}
            for i in builtins.range(N_ROWS)]


def _blocks(ds):
    """The dataset's blocks as python rows, block by block."""
    return [b.to_pylist() for b in ds.iter_blocks()]


def _cases(data):
    items = _items()

    def base():
        return data.from_items(items, override_num_blocks=6)

    def push_shuffle():
        from importlib import import_module

        sh = import_module(data.__name__ + ".shuffle")
        ex = import_module(data.__name__ + ".executor")
        rt = import_module(data.__name__.rsplit(".", 1)[0])
        refs = list(ex.execute_streaming(
            data.range(600, override_num_blocks=12)._plan))
        out = sh.push_based_shuffle(
            refs, num_partitions=3, map_fn=sh.shuffle_map_split,
            final_fn=sh._merge_and_permute, maps_per_round=4, seed=1)
        return [rt.get(r).to_pylist() for r in out]

    return {
        "map": lambda: _blocks(base().map(
            lambda r: {"id": r["id"], "y": r["x"] * 2 + r["key"]})),
        "map_batches": lambda: _blocks(base().map_batches(
            lambda b: {"id": b["id"], "z": np.cumsum(b["x"])},
            batch_size=32)),
        "filter": lambda: _blocks(base().filter(lambda r: r["key"] % 2 == 0)),
        "flat_map": lambda: _blocks(base().flat_map(
            lambda r: [{"id": r["id"], "k": k}
                       for k in builtins.range(r["key"])])),
        "limit": lambda: _blocks(base().limit(37)),
        "union": lambda: _blocks(base().union(data.range(20))),
        "zip": lambda: _blocks(base().select_columns(["id"]).zip(
            base().select_columns(["x"]))),
        "aggregates": lambda: [base().sum("x"), base().min("x"),
                               base().max("x"), base().mean("x"),
                               base().std("x"), base().count()],
        "random_shuffle": lambda: _blocks(base().random_shuffle(seed=0)),
        "random_sample": lambda: _blocks(base().random_sample(0.3, seed=2)),
        "sort": lambda: _blocks(base().sort("x", descending=True)),
        "groupby": lambda: [
            _blocks(base().groupby("key").count()),
            _blocks(base().groupby("key").sum("x")),
            _blocks(base().groupby("key").mean("x"))],
        "split": lambda: [[_blocks(s) for s in base().split(4)],
                          [_blocks(s) for s in base().split(7, equal=True)]],
        "repartition": lambda: _blocks(base().repartition(4)),
        "push_shuffle": push_shuffle,
    }


def _write_files(data, root):
    import os

    ds = data.from_items(_items(), override_num_blocks=3)
    ds.write_parquet(os.path.join(root, "parquet"))
    ds.write_csv(os.path.join(root, "csv"))
    ds.write_json(os.path.join(root, "json"))
    data.write_parquet_partitioned(ds, os.path.join(root, "part"),
                                   partition_cols=["key"])
    recs = data.from_items([{"data": f"rec-{i}".encode() * (i % 7 + 1)}
                            for i in builtins.range(40)])
    data.write_tfrecords(recs, os.path.join(root, "tfr"))
    wds = data.from_items([{"__key__": f"{i:04d}", "cls": i % 3,
                            "txt": f"sample {i}"}
                           for i in builtins.range(24)])
    data.write_webdataset(wds, os.path.join(root, "wds"),
                          rows_per_shard=10)


def _read_files(data, root):
    import os

    def rows(ds, key):
        return sorted(ds.take_all(), key=lambda r: r[key])

    return {
        "parquet": rows(data.read_parquet(os.path.join(root, "parquet")),
                        "id"),
        "csv": rows(data.read_csv(os.path.join(root, "csv")), "id"),
        "json": rows(data.read_json(os.path.join(root, "json")), "id"),
        "partitioned": rows(data.read_parquet_partitioned(
            os.path.join(root, "part")), "id"),
        "partition_pruned": rows(data.read_parquet_partitioned(
            os.path.join(root, "part"),
            partition_filter=lambda p: p["key"] in ("1", "3")), "id"),
        "tfrecord": rows(data.read_tfrecords(os.path.join(root, "tfr")),
                         "data"),
        "webdataset": rows(data.read_webdataset(os.path.join(root, "wds")),
                           "__key__"),
    }


def _run(pkg, fn):
    pkg.init(resources={"CPU": 4})
    try:
        return fn()
    finally:
        pkg.shutdown()


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    import ray_tpu
    import ray_tpu.data as jdata

    import ray_tpu_torch
    import ray_tpu_torch.data as tdata

    jroot = str(tmp_path_factory.mktemp("jax_files"))
    troot = str(tmp_path_factory.mktemp("port_files"))

    def jax_side():
        _write_files(jdata, jroot)
        return ({k: f() for k, f in _cases(jdata).items()},
                _read_files(jdata, jroot))

    def port_side():
        _write_files(tdata, troot)
        return ({k: f() for k, f in _cases(tdata).items()},
                _read_files(tdata, troot), _read_files(tdata, jroot))

    jax_cases, jax_own = _run(ray_tpu, jax_side)
    port_cases, port_own, port_reads_jax = _run(ray_tpu_torch, port_side)
    jax_reads_port = _run(ray_tpu, lambda: _read_files(jdata, troot))
    return {"jax": jax_cases, "port": port_cases, "jax_own": jax_own,
            "port_own": port_own, "port_reads_jax": port_reads_jax,
            "jax_reads_port": jax_reads_port}


def _equal(a, b):
    """Exact equality; floats compared bit for bit (NaN equal to NaN)."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (a, b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_array_equal(np.float64(a), np.float64(b))
    else:
        assert a == b, (a, b)


CASES = ["map", "map_batches", "filter", "flat_map", "limit", "union", "zip",
         "aggregates", "random_shuffle", "random_sample", "sort", "groupby",
         "split", "repartition", "push_shuffle"]


@pytest.mark.parametrize("case", CASES)
def test_transform_matches_jax(outputs, case):
    assert outputs["jax"][case]
    _equal(outputs["port"][case], outputs["jax"][case])


FORMATS = ["parquet", "csv", "json", "partitioned", "partition_pruned",
           "tfrecord", "webdataset"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_reads_jax_files(outputs, fmt):
    assert outputs["jax_own"][fmt]
    _equal(outputs["port_reads_jax"][fmt], outputs["jax_own"][fmt])


@pytest.mark.parametrize("fmt", FORMATS)
def test_jax_reads_port_files(outputs, fmt):
    _equal(outputs["jax_reads_port"][fmt], outputs["port_own"][fmt])
    _equal(outputs["port_own"][fmt], outputs["jax_own"][fmt])


def test_crc32c_vectors_agree():
    from ray_tpu.data import datasources as jds

    from ray_tpu_torch.data import datasources as tds

    rng = np.random.default_rng(0)
    payloads = [b"", b"a", b"123456789", bytes(32), bytes(range(256)) * 3,
                rng.bytes(1000)]
    assert tds.crc32c(b"123456789") == 0xE3069283
    for p in payloads:
        assert tds.crc32c(p) == jds.crc32c(p)
        assert tds._masked_crc(p) == jds._masked_crc(p)

"""High-value data connectors: WebDataset, SQL, partitioned Parquet, Mongo.

Broadens source coverage toward the reference's
``python/ray/data/datasource/`` family with the connectors training
workloads actually hit. Counterpart of ``ray_tpu/data/connectors.py``:

- **WebDataset** (``webdataset_datasource.py``): tar shards where each
  sample is the group of members sharing a basename stem (``0001.jpg`` +
  ``0001.cls`` + ``0001.json`` → one row) — the de-facto large-scale image/
  multimodal training layout. One read task per shard, streaming through
  the executor.
- **SQL** (``sql_datasource.py``): any DB-API 2.0 connection via a
  ``connection_factory`` (sqlite3 in tests); optional ``shard_keys``
  parallelism by hashing a column into N disjoint WHERE-clauses.
- **Partitioned Parquet** with hive-style partition PRUNING
  (``parquet_datasource.py`` + ``partitioning.py``): ``key=value`` path
  segments become columns, and a row-filter over partition values prunes
  whole files before a byte is read.
- **MongoDB** (``mongo_datasource.py``): pymongo collection → arrow blocks,
  split by ``_id`` range; the client is injectable so the connector is
  testable without a server (pymongo is not in the image).
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import pyarrow as pa

from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.dataset import Dataset, _expand_paths
from ray_tpu_torch.data.plan import LogicalPlan, Read

# ---------------------------------------------------------------------------
# WebDataset
# ---------------------------------------------------------------------------

_WDS_AUTO_DECODE = {
    ".txt": lambda b: b.decode("utf-8"),
    ".cls": lambda b: int(b.decode("utf-8").strip()),
    ".json": lambda b: json.loads(b.decode("utf-8")),
}


def _decode_member(suffix: str, payload: bytes, decode_images: bool):
    if suffix == ".npy":
        return np.load(io.BytesIO(payload), allow_pickle=False)
    if suffix in _WDS_AUTO_DECODE:
        return _WDS_AUTO_DECODE[suffix](payload)
    if decode_images and suffix in (".jpg", ".jpeg", ".png", ".bmp"):
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(payload)))
    return payload  # raw bytes (bin/unknown — caller maps further)


_WDS_TYPED_SUFFIXES = (".txt", ".cls", ".json", ".npy")


def _split_member(base: str):
    """WebDataset naming: the sample key is the name up to the FIRST dot;
    everything after is the (possibly dotted) extension. A trailing typed
    suffix (``caption.txt``, ``meta.json``, ``emb.npy``) carries the
    value's TYPE while the rest names the column — how the writer
    round-trips str/int/dict/ndarray columns with arbitrary names."""
    stem, _, ext = base.partition(".")
    parts = ext.split(".")
    type_suffix = "." + parts[-1].lower() if parts else ""
    if len(parts) > 1 and type_suffix in _WDS_TYPED_SUFFIXES:
        return stem, ".".join(parts[:-1]), type_suffix
    return stem, ext, type_suffix


def read_webdataset(paths: Union[str, List[str]], *,
                    decode_images: bool = False,
                    suffixes: Optional[List[str]] = None) -> Dataset:
    """Rows of ``{"__key__": stem, "<ext>": value, ...}`` per tar sample.

    ``decode_images=True`` decodes jpg/png members to HxWxC uint8 via PIL;
    ``suffixes`` restricts which member extensions are loaded (dotted,
    e.g. ``[".jpg", ".cls"]``).
    """
    files = _expand_paths(paths, ".tar")

    def make_task(f: str):
        def read():
            samples: Dict[str, Dict[str, Any]] = {}
            order: List[str] = []
            with tarfile.open(f, "r") as tar:
                for member in tar:
                    if not member.isfile():
                        continue
                    base = os.path.basename(member.name)
                    stem, column, type_suffix = _split_member(base)
                    if (suffixes is not None
                            and "." + column not in suffixes
                            and type_suffix not in suffixes):
                        continue
                    payload = tar.extractfile(member).read()
                    if stem not in samples:
                        samples[stem] = {"__key__": stem}
                        order.append(stem)
                    samples[stem][column] = _decode_member(
                        type_suffix, payload, decode_images)
            return BlockAccessor.from_items([samples[k] for k in order])

        return read

    return Dataset(LogicalPlan(Read([make_task(f) for f in files])))


def write_webdataset(ds: Dataset, path: str, *,
                     rows_per_shard: int = 1000) -> None:
    """Round-trip writer: each row becomes one sample; bytes columns are
    stored raw, str as .txt, int as .cls, dict/list as .json, ndarray as
    .npy. ``__key__`` names the sample (default: running index)."""
    os.makedirs(path, exist_ok=True)
    shard_idx, n_in_shard, tar = 0, 0, None

    def open_shard(i):
        return tarfile.open(
            os.path.join(path, f"shard-{i:05d}.tar"), "w")

    def add(tar, name, payload: bytes):
        info = tarfile.TarInfo(name)
        info.size = len(payload)
        tar.addfile(info, io.BytesIO(payload))

    idx = 0
    for block in ds.iter_blocks():
        for row in BlockAccessor(block).iter_rows():
            if tar is None:
                tar = open_shard(shard_idx)
            key = str(row.get("__key__", f"{idx:08d}"))
            for col, val in row.items():
                if col == "__key__":
                    continue
                # Typed double extensions (``caption.txt``, ``meta.json``)
                # make ANY column name round-trip with its Python type;
                # a column already named after its type stays single-ext.
                def name(type_ext: str) -> str:
                    if "." + col == type_ext:
                        return f"{key}{type_ext}"
                    return f"{key}.{col}{type_ext}"

                if isinstance(val, (bytes, bytearray)):
                    add(tar, f"{key}.{col}", bytes(val))
                elif isinstance(val, str):
                    add(tar, name(".txt"), val.encode("utf-8"))
                elif isinstance(val, (bool, np.bool_)):
                    add(tar, name(".json"), json.dumps(bool(val)).encode())
                elif isinstance(val, (int, np.integer)):
                    add(tar, name(".cls"), str(int(val)).encode())
                elif isinstance(val, np.ndarray):
                    buf = io.BytesIO()
                    np.save(buf, val)
                    add(tar, name(".npy"), buf.getvalue())
                else:
                    add(tar, name(".json"),
                        json.dumps(val).encode("utf-8"))
            idx += 1
            n_in_shard += 1
            if n_in_shard >= rows_per_shard:
                tar.close()
                tar, n_in_shard = None, 0
                shard_idx += 1
    if tar is not None:
        tar.close()


# ---------------------------------------------------------------------------
# SQL (DB-API 2.0)
# ---------------------------------------------------------------------------

def read_sql(sql: str, connection_factory: Callable[[], Any], *,
             shard_key: Optional[str] = None,
             parallelism: int = 1) -> Dataset:
    """Run ``sql`` through a DB-API connection and emit arrow blocks
    (reference: ``read_sql(sql, connection_factory)``).

    With ``shard_key`` + ``parallelism`` > 1 the query is fanned out as
    ``parallelism`` read tasks, each appending
    ``WHERE/AND (<shard_key> % N) = i`` — disjoint row partitions pulled
    concurrently (each task opens its own connection; the factory must be
    picklable and safe to call in worker processes)."""
    if parallelism > 1 and shard_key is None:
        raise ValueError("parallelism > 1 requires shard_key")

    def make_task(clause: Optional[str]):
        def read():
            conn = connection_factory()
            try:
                cur = conn.cursor()
                q = sql
                if clause:
                    # Subquery wrap: appending WHERE/AND to the raw text
                    # breaks on ORDER BY / GROUP BY / LIMIT tails (and on
                    # subqueries that merely contain "where").
                    q = f"SELECT * FROM ({sql}) AS _rt_shard WHERE {clause}"
                cur.execute(q)
                cols = [d[0] for d in cur.description]
                rows = cur.fetchall()
            finally:
                conn.close()
            arrays = {c: [r[i] for r in rows] for i, c in enumerate(cols)}
            return pa.table({c: pa.array(v) for c, v in arrays.items()})

        return read

    if parallelism <= 1:
        tasks = [make_task(None)]
    else:
        # Sign-normalized modulo (SQL % keeps the dividend's sign, so a
        # negative key would match no shard) + NULL keys routed to shard 0
        # (NULL % N is NULL — silently dropped otherwise).
        def clause(i: int) -> str:
            c = (f"((({shard_key}) % {parallelism}) + {parallelism}) "
                 f"% {parallelism} = {i}")
            if i == 0:
                c = f"({c} OR ({shard_key}) IS NULL)"
            return c

        tasks = [make_task(clause(i)) for i in range(parallelism)]
    return Dataset(LogicalPlan(Read(tasks)))


# ---------------------------------------------------------------------------
# Partitioned parquet with pruning
# ---------------------------------------------------------------------------

def _parse_partitions(root: str, file_path: str) -> Dict[str, str]:
    parts: Dict[str, str] = {}
    rel = os.path.relpath(os.path.dirname(file_path), root)
    for seg in rel.split(os.sep):
        if "=" in seg:
            k, v = seg.split("=", 1)
            parts[k] = v
    return parts


def read_parquet_partitioned(
    root: str, *,
    partition_filter: Optional[Callable[[Dict[str, str]], bool]] = None,
) -> Dataset:
    """Hive-layout parquet tree (``.../key=value/.../*.parquet``):
    ``key=value`` path segments become string columns on every row, and
    ``partition_filter(partitions) -> bool`` PRUNES files before any data
    is read — predicate pushdown on the directory structure (reference:
    ``parquet_datasource.py`` + ``partitioning.py``)."""
    files: List[str] = []
    for dirpath, _dirs, names in os.walk(root):
        for n in sorted(names):
            if n.endswith(".parquet"):
                files.append(os.path.join(dirpath, n))
    if not files:
        raise FileNotFoundError(f"no parquet files under {root}")
    kept = []
    for f in files:
        parts = _parse_partitions(root, f)
        if partition_filter is None or partition_filter(parts):
            kept.append((f, parts))
    if not kept:
        raise FileNotFoundError(
            f"partition_filter pruned every file under {root}")

    def make_task(f: str, parts: Dict[str, str]):
        def read():
            import pyarrow.parquet as pq

            table = pq.read_table(f)
            for k, v in parts.items():
                if k not in table.column_names:
                    table = table.append_column(
                        k, pa.array([v] * len(table), pa.string()))
            return table

        return read

    return Dataset(LogicalPlan(Read([make_task(f, p) for f, p in kept])))


def write_parquet_partitioned(ds: Dataset, root: str, *,
                              partition_cols: List[str]) -> None:
    """Writer side of the hive layout: rows land under
    ``root/key=value/...``. STREAMING: blocks are processed one at a time
    and each partition keeps one open ``ParquetWriter`` (appending row
    groups), so datasets larger than driver RAM write fine — the whole
    corpus is never materialized."""
    import pyarrow.parquet as pq

    writers: Dict[tuple, pq.ParquetWriter] = {}
    part_idx: Dict[tuple, int] = {}

    def open_writer(key: tuple, schema) -> pq.ParquetWriter:
        d = os.path.join(root, *(f"{c}={v}" for c, v in
                                 zip(partition_cols, key)))
        os.makedirs(d, exist_ok=True)
        i = part_idx.get(key, 0)
        part_idx[key] = i + 1
        return pq.ParquetWriter(
            os.path.join(d, f"part-{i:05d}.parquet"), schema)

    try:
        for block in ds.iter_blocks():
            # Per-block grouping only (bounded memory): rows of this block
            # split by partition value, then append to the open writers.
            groups: Dict[tuple, List[dict]] = {}
            for row in BlockAccessor(block).iter_rows():
                key = tuple(str(row[c]) for c in partition_cols)
                groups.setdefault(key, []).append(
                    {k: v for k, v in row.items()
                     if k not in partition_cols})
            for key, rows in groups.items():
                table = BlockAccessor.from_items(rows)
                w = writers.get(key)
                if w is None:
                    w = writers[key] = open_writer(key, table.schema)
                if not table.schema.equals(w.schema):
                    # Per-block type inference can disagree (int64 block
                    # then double block): cast when possible, else roll a
                    # NEW part file with the new schema — readers merge
                    # all parts, so no rows are lost either way.
                    try:
                        table = table.cast(w.schema)
                    except (pa.ArrowInvalid, pa.ArrowTypeError,
                            pa.ArrowNotImplementedError, ValueError):
                        # cast raises ValueError (not ArrowInvalid) on
                        # field-name/count mismatches — the common case.
                        w.close()
                        w = writers[key] = open_writer(key, table.schema)
                w.write_table(table)
    finally:
        for w in writers.values():
            w.close()


# ---------------------------------------------------------------------------
# MongoDB
# ---------------------------------------------------------------------------

def read_mongo(uri: str, database: str, collection: str, *,
               pipeline: Optional[List[Dict]] = None,
               shard_filters: Optional[List[Dict]] = None,
               _client_factory: Optional[Callable[[], Any]] = None) -> Dataset:
    """MongoDB collection → Dataset (reference: ``read_mongo``).

    ``pipeline`` is an aggregation prefix applied server-side. Parallel
    reads are EXPLICIT: pass ``shard_filters`` — a list of disjoint
    ``$match`` documents (e.g. ``_id`` range predicates), one read task per
    filter, each pushed down server-side (a client-side modulo split would
    scan the whole collection once per task). Documents' ``_id`` is
    stringified (ObjectId isn't arrow-able). ``_client_factory`` injects a
    client for tests; by default ``pymongo.MongoClient(uri)`` is
    constructed inside each read task (pymongo must be installed — it is
    not baked into this image, matching the reference's optional extra).
    """
    if _client_factory is None:
        def _client_factory():  # noqa: ANN202 — deferred optional dep
            try:
                import pymongo
            except ImportError as e:  # pragma: no cover
                raise ImportError(
                    "read_mongo requires pymongo (pip install pymongo)"
                ) from e
            return pymongo.MongoClient(uri)

    def make_task(shard_match: Optional[Dict]):
        def read():
            client = _client_factory()
            try:
                coll = client[database][collection]
                stages = list(pipeline or [])
                if shard_match is not None:
                    stages = [{"$match": shard_match}] + stages
                docs = list(coll.aggregate(stages)) if stages else list(
                    coll.find())
            finally:
                try:
                    client.close()
                except Exception:  # noqa: BLE001 — fake clients in tests
                    pass
            for d in docs:
                if "_id" in d:
                    d["_id"] = str(d["_id"])
            return BlockAccessor.from_items(docs)

        return read

    shards = shard_filters if shard_filters else [None]
    return Dataset(LogicalPlan(Read([make_task(s) for s in shards])))

"""File datasources beyond the columnar formats.

Broadens the source coverage toward the reference's ``python/ray/data/
datasource/`` family: text, raw binary files, images (PIL), and TFRecords —
the formats LLM/vision ingest actually touches. Each reader produces one
read task per file (parallel, streaming through the executor); writers
round-trip for tests.

TFRecord framing (``tensorflow/core/lib/io/record_writer.cc``): each record
is ``len:uint64le | masked_crc32c(len):uint32le | data | masked_crc32c(data)
:uint32le``; the CRC is Castagnoli with TensorFlow's rotate-right masking —
implemented here table-driven so files interoperate with real TF readers.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Union

import numpy as np
import pyarrow as pa

from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.dataset import Dataset, _expand_paths
from ray_tpu_torch.data.plan import LogicalPlan, Read

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven — tiny and dependency-free
# ---------------------------------------------------------------------------

_CRC_TABLE: Optional[List[int]] = None


def _crc32c_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


try:  # accelerated CRC when a native wheel is present
    import google_crc32c as _gcrc
except ImportError:
    _gcrc = None


def crc32c(data: bytes) -> int:
    if _gcrc is not None:
        return _gcrc.value(bytes(data))
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecords
# ---------------------------------------------------------------------------

def _read_tfrecord_file(path: str) -> List[bytes]:
    records = []
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                break
            if len(header) < 12:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if len_crc != _masked_crc(header[:8]):
                raise ValueError(f"corrupt TFRecord length crc in {path}")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"truncated TFRecord payload in {path}")
            crc_bytes = f.read(4)
            if len(crc_bytes) < 4:
                raise ValueError(f"truncated TFRecord data crc in {path}")
            (data_crc,) = struct.unpack("<I", crc_bytes)
            if data_crc != _masked_crc(data):
                raise ValueError(f"corrupt TFRecord data crc in {path}")
            records.append(data)
    return records


def read_tfrecords(paths: Union[str, List[str]]) -> Dataset:
    """Rows of ``{"data": bytes}`` — decode (e.g. tf.Example protos) with a
    downstream ``map``/``map_batches``."""
    files = _expand_paths(paths, ".tfrecord")

    def make_task(f: str):
        def read():
            recs = _read_tfrecord_file(f)
            return pa.table({"data": pa.array(recs, pa.binary())})

        return read

    return Dataset(LogicalPlan(Read([make_task(f) for f in files])))


def write_tfrecords(ds: Dataset, path: str, *, column: str = "data") -> None:
    os.makedirs(path, exist_ok=True)
    for i, block in enumerate(ds.iter_blocks()):
        with open(os.path.join(path, f"part-{i:05d}.tfrecord"), "wb") as f:
            for row in BlockAccessor(block).iter_rows():
                data = row[column]
                if not isinstance(data, (bytes, bytearray)):
                    data = bytes(data)
                header = struct.pack("<Q", len(data))
                f.write(header)
                f.write(struct.pack("<I", _masked_crc(header)))
                f.write(data)
                f.write(struct.pack("<I", _masked_crc(data)))


# ---------------------------------------------------------------------------
# text / binary / images
# ---------------------------------------------------------------------------

def read_text(paths: Union[str, List[str]], *, encoding: str = "utf-8") -> Dataset:
    """One row per line: ``{"text": str}`` (reference: ``read_text``)."""
    files = _expand_paths(paths, ".txt")

    def make_task(f: str):
        def read():
            with open(f, encoding=encoding) as fh:
                lines = [line.rstrip("\r\n") for line in fh]
            return pa.table({"text": pa.array(lines, pa.string())})

        return read

    return Dataset(LogicalPlan(Read([make_task(f) for f in files])))


def read_binary_files(paths: Union[str, List[str]],
                      *, include_paths: bool = False) -> Dataset:
    """One row per file: ``{"bytes": ..., ["path"]}``."""
    files = _expand_paths(paths, "")

    def make_task(f: str):
        def read():
            with open(f, "rb") as fh:
                payload = fh.read()
            cols = {"bytes": pa.array([payload], pa.binary())}
            if include_paths:
                cols["path"] = pa.array([f], pa.string())
            return pa.table(cols)

        return read

    return Dataset(LogicalPlan(Read([make_task(f) for f in files])))


_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".gif")


def read_images(paths: Union[str, List[str]], *, size=None,
                mode: Optional[str] = None,
                include_paths: bool = False) -> Dataset:
    """One row per image: ``{"image": HxWxC uint8, ["path"]}`` via PIL
    (reference: ``datasource/image_datasource.py``)."""
    if isinstance(paths, str) and os.path.isdir(paths):
        files = sorted(
            os.path.join(paths, f) for f in os.listdir(paths)
            if f.lower().endswith(_IMAGE_SUFFIXES))
        if not files:
            raise FileNotFoundError(f"no images under {paths}")
    else:
        files = _expand_paths(paths, "")

    def make_task(f: str):
        def read():
            from PIL import Image

            img = Image.open(f)
            if mode is not None:
                img = img.convert(mode)
            if size is not None:
                img = img.resize(size)
            arr = np.asarray(img)
            cols = {"image": arr[None, ...]}
            block = BlockAccessor.from_numpy(cols)
            if include_paths:
                table = block
                return table.append_column("path", pa.array([f], pa.string()))
            return block

        return read

    return Dataset(LogicalPlan(Read([make_task(f) for f in files])))

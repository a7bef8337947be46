"""The port's transport copies: the shm ring ``Channel``, the KV handoff
lane, ``serialization`` and the flight recorder.

The ring and flight-recorder tests are the JAX package's
(``test_dag.py::TestChannel``, ``test_flightrec.py::TestRing``) run against
the port's copies; the lane's payloads must come back bit for bit, in f32
and in bfloat16 (which numpy has no dtype for).
"""

import os
import struct

import numpy as np
import pytest
import torch

from ray_tpu.util import flightrec as jax_flightrec
from ray_tpu_torch.core import serialization
from ray_tpu_torch.dag import channel as chmod
from ray_tpu_torch.dag.channel import Channel, ChannelClosed, ChannelTimeout
from ray_tpu_torch.serve.dag_pipeline import KVHandoffLane
from ray_tpu_torch.util import flightrec

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


# -- the ring (tests/test_dag.py::TestChannel) --------------------------------
def test_write_read_roundtrip():
    ch = Channel(capacity=1 << 16)
    try:
        ch.write({"x": 1, "y": [1, 2, 3]})
        assert ch.read(timeout=5) == {"x": 1, "y": [1, 2, 3]}
    finally:
        ch.destroy()


def test_backpressure_blocks_second_write():
    ch = Channel(capacity=1 << 16, slots=1)
    try:
        ch.write(1)
        with pytest.raises(ChannelTimeout):
            ch.write(2, timeout=0.2)
        assert ch.read(timeout=5) == 1
        ch.write(2)  # now the slot is free
        assert ch.read(timeout=5) == 2
    finally:
        ch.destroy()


def test_ring_pipelines_n_writes_then_backpressures():
    ch = Channel(capacity=1 << 16, slots=4)
    try:
        for i in range(4):  # the whole ring fills without a reader
            ch.write(i, timeout=5)
        with pytest.raises(ChannelTimeout):
            ch.write(99, timeout=0.2)  # slot 0 still unacked
        assert ch.read(timeout=5) == 0  # one ack frees one slot
        ch.write(4, timeout=5)
        assert [ch.read(timeout=5) for _ in range(4)] == [1, 2, 3, 4]
    finally:
        ch.destroy()


def test_ring_fifo_across_wraparound():
    ch = Channel(capacity=1 << 16, slots=3)
    try:
        out = []
        for i in range(11):  # > 3 full ring revolutions
            ch.write(i, timeout=5)
            out.append(ch.read(timeout=5))
        assert out == list(range(11))
    finally:
        ch.destroy()


def test_cross_attach_by_name():
    ch = Channel(capacity=1 << 16)
    try:
        reader = Channel(ch.name, capacity=1 << 16, create=False)
        ch.write("hello")
        assert reader.read(timeout=5) == "hello"
        reader.detach()
    finally:
        ch.destroy()


def test_ring_larger_than_free_shm_refused(monkeypatch):
    """A sparse ring past /dev/shm's free space would fault on its first
    deep write: creation raises ENOSPC with the sizes instead, and leaves
    no file."""
    class TinyShm:  # a 1 MiB filesystem with 64 KiB free
        f_frsize, f_blocks, f_bavail = 4096, 256, 16

    monkeypatch.setattr(chmod.os, "statvfs", lambda path: TinyShm)
    with pytest.raises(OSError, match="needs .* bytes of /dev/shm, which "
                                      "has 65536 free of 1048576"):
        Channel(name="rtpu-chan-roomtest", capacity=1 << 16, slots=2)
    assert not os.path.exists(f"{chmod.SHM_DIR}/rtpu-chan-roomtest")


# -- the lane -----------------------------------------------------------------
def _blocks(dtype, seed=0, shape=(2, 3, 8, 4, 16)):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g).to(dtype),
            torch.randn(shape, generator=g).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_round_trip_bit_exact(dtype):
    lane = KVHandoffLane(capacity=1 << 20, slots=2)
    try:
        k, v = _blocks(dtype)
        last = np.linspace(-1, 1, 50, dtype=np.float32)
        lane.send({"prompt": np.arange(5, dtype=np.int32), "last_row": last,
                   "seed": 7}, k, v, timeout=5)
        meta, k2, v2, token = lane.recv(timeout=5)
        assert k2.dtype == v2.dtype == dtype
        assert k2.shape == v2.shape == k.shape
        # The views sit on 64-byte boundaries of the mapping.
        assert k2.data_ptr() % 64 == 0 and v2.data_ptr() % 64 == 0
        assert torch.equal(k2.view(torch.uint8), k.view(torch.uint8))
        assert torch.equal(v2.view(torch.uint8), v.view(torch.uint8))
        np.testing.assert_array_equal(meta["last_row"], last)
        assert meta["seed"] == 7 and meta["dtype"] == str(dtype)[6:]
        del k2, v2
        lane.ack(token)
    finally:
        lane.destroy()


def test_lane_slot_not_reused_before_ack():
    """Deferred ack: the views of a received slot stay intact while the
    writer fills the rest of the ring, and the writer blocks on that slot
    until it is acked."""
    lane = KVHandoffLane(capacity=1 << 20, slots=2)
    try:
        k0, v0 = _blocks(torch.float32, seed=0)
        k1, v1 = _blocks(torch.float32, seed=1)
        lane.send({"i": 0}, k0, v0, timeout=5)
        meta, rk, rv, token = lane.recv(timeout=5)
        lane.send({"i": 1}, k1, v1, timeout=5)   # the other slot
        with pytest.raises(ChannelTimeout):
            lane.send({"i": 2}, k1, v1, timeout=0.2)  # slot 0 unacked
        assert torch.equal(rk, k0) and torch.equal(rv, v0)
        del rk, rv
        lane.ack(token)
        lane.send({"i": 2}, k0, v0, timeout=5)
        assert [lane.recv(timeout=5)[0]["i"] for _ in range(2)] == [1, 2]
    finally:
        lane.destroy()


def test_lane_close_pill_raises_closed():
    lane = KVHandoffLane(capacity=1 << 16, slots=2)
    try:
        lane.close()
        with pytest.raises(ChannelClosed):
            lane.recv(timeout=5)
    finally:
        lane.destroy()


def test_lane_oversized_payload_raises_and_keeps_the_ring():
    lane = KVHandoffLane(capacity=1 << 12, slots=2)
    try:
        k, v = _blocks(torch.float32)   # 6 KiB each
        with pytest.raises(ValueError, match="exceeds lane capacity"):
            lane.send({}, k, v, timeout=5)
        small = torch.ones(4)
        lane.send({"ok": True}, small, small, timeout=5)
        meta, k2, _, token = lane.recv(timeout=5)
        assert meta["ok"] and torch.equal(k2, small)
        del k2
        lane.ack(token)
    finally:
        lane.destroy()


# -- serialization --------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.bool])
def test_serialization_round_trips_tensors(dtype):
    t = (torch.arange(24).reshape(2, 3, 4) % 3).to(dtype)
    if dtype.is_floating_point:
        t = t + torch.linspace(-1, 1, 24).reshape(2, 3, 4).to(dtype)
    back = serialization.loads(serialization.dumps(t))
    assert back.dtype == dtype and back.shape == t.shape
    assert torch.equal(back.view(-1), t.view(-1))
    # A writable copy, not a read-only view of the blob.
    assert back.reshape(-1).view(torch.uint8).numpy().flags.writeable


def test_serialization_round_trips_meta_and_closures():
    meta = {"prompt": np.arange(7, dtype=np.int32), "s": "x", "n": 3,
            "row": np.ones(33, np.float32)}
    back = serialization.loads(serialization.dumps(meta))
    np.testing.assert_array_equal(back["prompt"], meta["prompt"])
    np.testing.assert_array_equal(back["row"], meta["row"])
    assert back["s"] == "x" and back["n"] == 3
    k = 5
    assert serialization.loads(serialization.dumps(lambda x: x + k))(1) == 6


# -- the flight recorder (tests/test_flightrec.py::TestRing) --------------------
def test_flightrec_roundtrip(tmp_path):
    path = str(tmp_path / "driver-1.ring")
    rec = flightrec.FlightRecorder(path, "driver", ring_kb=8)
    rec.record("task", "t-1", "start f trace=aabb")
    rec.record("lease", "blk-0", "carve free=2")
    rec.close()
    ring = flightrec.read_ring(path)
    assert ring["component"] == "driver"
    assert ring["pid"] == os.getpid()
    assert ring["written"] == 2
    assert [e["category"] for e in ring["events"]] == ["task", "lease"]
    assert ring["events"][0]["subject"] == "t-1"
    assert "trace=aabb" in ring["events"][0]["detail"]
    # The same format: the JAX package's reader decodes the port's ring.
    assert jax_flightrec.read_ring(path)["events"] == ring["events"]


def test_flightrec_wraparound_keeps_newest(tmp_path):
    path = str(tmp_path / "w-1.ring")
    rec = flightrec.FlightRecorder(path, "w", ring_kb=8)  # 64 slots
    for i in range(100):
        rec.record("task", f"t{i}", "x")
    rec.close()
    ring = flightrec.read_ring(path)
    assert ring["nslots"] == 64
    assert ring["written"] == 100
    assert len(ring["events"]) == 64
    assert ring["events"][0]["seq"] == 37
    assert ring["events"][0]["subject"] == "t36"
    assert ring["events"][-1]["seq"] == 100


def test_flightrec_oversize_fields_truncate_not_fail(tmp_path):
    path = str(tmp_path / "big-1.ring")
    rec = flightrec.FlightRecorder(path, "big", ring_kb=8)
    rec.record("task", "s" * 100, "d" * 300)
    rec.close()
    ring = flightrec.read_ring(path)
    assert ring["events"][0]["subject"] == "s" * flightrec.SUBJECT_MAX
    assert ring["events"][0]["detail"] == "d" * flightrec.DETAIL_MAX


def test_flightrec_torn_slot_skipped(tmp_path):
    path = str(tmp_path / "torn-1.ring")
    rec = flightrec.FlightRecorder(path, "torn", ring_kb=8)
    for i in range(5):
        rec.record("task", f"t{i}", "x")
    rec.close()
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        struct.pack_into("<Q", data, 64 + 2 * flightrec.SLOT_SIZE, 10 ** 15)
        f.seek(0)
        f.write(data)
    ring = flightrec.read_ring(path)
    assert [e["seq"] for e in ring["events"]] == [1, 2, 4, 5]


def test_flightrec_rejects_foreign_and_truncated_files(tmp_path):
    junk = tmp_path / "junk.ring"
    junk.write_bytes(b"not a ring at all" + b"\0" * 64)
    with pytest.raises(ValueError):
        flightrec.read_ring(str(junk))
    short = tmp_path / "short.ring"
    short.write_bytes(b"\0" * 8)
    with pytest.raises(ValueError):
        flightrec.read_ring(str(short))

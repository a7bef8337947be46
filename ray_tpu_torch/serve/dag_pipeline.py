"""Serve pipelines and the prefill→decode KV handoff lane.

Counterpart of ``ray_tpu/serve/dag_pipeline.py``. For a LINEAR chain of
deployments (preprocess → model → postprocess),
``serve.run_pipeline(..., compiled=True)`` precompiles the call chain into
resident compiled-DAG lanes (:func:`build_compiled_pipeline`,
:class:`PipelineHandle`). Each lane parks one replica of every stage in a
``dag_call`` loop over mutable channels (``ray_tpu_torch.dag``), so a
steady-state request costs one channel write and one read per edge
instead of a routed actor call per stage.

A replica parked in a lane is DEDICATED: the resident loop occupies one of
its execution threads, so autoscaling and redeploys must not touch lane
members mid-flight. Lanes are built from the replica fleet at build time;
tear the pipeline down (``PipelineHandle.shutdown``) before redeploying
its stages. ``compiled=False`` walks the same chain over per-call handles
(:class:`SequentialPipelineHandle`).

:class:`KVHandoffLane` carries KV blocks from a prefill engine to a decode
engine over one shm ring.
"""

from __future__ import annotations

import itertools
import struct
import threading
import time
from typing import Any, List, Optional, Tuple

import torch

import ray_tpu_torch
from ray_tpu_torch.core import serialization
from ray_tpu_torch.dag.channel import (_CLOSE, FILE_HEADER_SIZE,
                                       SLOT_HEADER_SIZE, Channel,
                                       ChannelClosed)
from ray_tpu_torch.dag.dag_node import InputNode
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("serve_pipeline")


class PipelineResponse:
    """Future-like response (same surface as DeploymentResponse.result)."""

    def __init__(self, ref):
        self._ref = ref

    def result(self, timeout_s: Optional[float] = 30.0):
        return self._ref.get(timeout=timeout_s)


class PipelineHandle:
    """Ingress handle of a COMPILED pipeline: requests round-robin over the
    precompiled lanes; each lane pipelines several in-flight requests
    through its multi-slot ring edges."""

    def __init__(self, stage_names: List[str], lanes: List[Any]):
        self.stage_names = list(stage_names)
        self._lanes = list(lanes)
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self._shut = False
        # serve.run_pipeline registers the handle here so serve.shutdown()
        # can tear down forgotten pipelines; a direct shutdown() call
        # deregisters so repeatedly-rebuilt pipelines don't accrete.
        self._registry: Optional[list] = None

    @property
    def num_lanes(self) -> int:
        return len(self._lanes)

    def remote(self, value: Any) -> PipelineResponse:
        if self._shut:
            raise RuntimeError("pipeline was shut down")
        lane = self._lanes[next(self._rr) % len(self._lanes)]
        return PipelineResponse(lane.execute(value))

    def shutdown(self) -> None:
        """Tear down every lane (close pills propagate, loops exit, the
        driver unlinks the channels). The stage replicas come back to life
        as ordinary routed replicas afterwards. Idempotent."""
        with self._lock:
            if self._shut:
                return
            self._shut = True
            for lane in self._lanes:
                try:
                    lane.teardown()
                except Exception:  # noqa: BLE001 — teardown is best-effort
                    log_swallowed(logger, "pipeline lane teardown")
        if self._registry is not None:
            try:
                self._registry.remove(self)
            except ValueError:
                pass  # serve.shutdown already popped us


class SequentialPipelineHandle:
    """Per-call pipeline: the chain walked with one routed actor call per
    stage per request."""

    def __init__(self, stage_names: List[str], handles: List[Any]):
        self.stage_names = list(stage_names)
        self._handles = list(handles)

    def remote(self, value: Any) -> "_SequentialResponse":
        return _SequentialResponse(self._handles, value)

    def shutdown(self) -> None:
        pass  # nothing resident to tear down


class _SequentialResponse:
    def __init__(self, handles, value):
        self._handles = handles
        self._value = value
        self._done = False

    def result(self, timeout_s: Optional[float] = 30.0):
        if not self._done:
            v = self._value
            for h in self._handles:
                v = h.remote(v).result(timeout_s=timeout_s)
            self._value = v
            self._done = True
        return self._value


def build_compiled_pipeline(controller, stage_names: List[str], *,
                            channel_type: str = "auto",
                            channel_capacity: int = 4 * 1024 * 1024,
                            channel_slots: Optional[int] = None,
                            lanes: Optional[int] = None) -> PipelineHandle:
    """Compile ``lanes`` parallel resident DAG lanes over the current
    replica fleet of ``stage_names`` (in chain order). Each lane uses a
    DISTINCT replica per stage (a resident loop occupies the replica), so
    the lane count is capped by the smallest stage's replica count."""
    _version, table = ray_tpu_torch.get(
        controller.get_snapshot.remote(-1, 0.0))
    replica_sets = []
    for name in stage_names:
        entry = table.get(name)
        if not entry or not entry["replicas"]:
            raise RuntimeError(
                f"deployment {name!r} has no live replicas to compile")
        replica_sets.append(list(entry["replicas"]))
    max_lanes = min(len(rs) for rs in replica_sets)
    n_lanes = min(lanes, max_lanes) if lanes else max_lanes
    compiled_lanes = []
    try:
        for lane in range(n_lanes):
            node = InputNode()
            for rs in replica_sets:
                node = rs[lane].dag_call.bind(node)
            compiled_lanes.append(node.experimental_compile(
                channel_type=channel_type,
                channel_capacity=channel_capacity,
                channel_slots=channel_slots))
    except BaseException:
        for built in compiled_lanes:
            try:
                built.teardown()
            except Exception:  # noqa: BLE001 — unwind is best-effort
                log_swallowed(logger, "pipeline build unwind")
        raise
    return PipelineHandle(stage_names, compiled_lanes)


def _round64(n: int) -> int:
    return -(-n // 64) * 64


class KVHandoffLane:
    """Prefill→decode KV-block transport over one multi-slot shm
    :class:`~ray_tpu_torch.dag.channel.Channel` — the disaggregated-serving
    lane.

    A finished prefill's pool blocks travel as one framed payload::

        [meta_len, k_len, v_len : <QQQ>] [pickled meta, padded]
        [raw K, padded] [raw V]

    where meta carries the request (prompt, sampling params, last-token
    logits row) and the K/V torch dtype name and shape needed to
    reinterpret the raw bytes. The padding puts K and V on 64-byte
    boundaries of the mapping. The raw bytes are the tensors' own, whatever
    the dtype: bfloat16, which numpy has no dtype for, travels bit for bit.
    (The wire format is not the JAX lane's, whose meta names a numpy
    dtype; no process of one package reads the other's lane.)

    ``send`` lands K and V DIRECTLY in the ring slot through a uint8 torch
    view of it, between the channel's ``_wait_writable``/``_publish``: a
    CUDA tensor is copied device to host straight into the slot, with no
    host copy between. ``recv`` returns zero-copy CPU tensor views of the
    slot plus an ack token: the DEFERRED-ACK protocol
    (``_consume_view``/``_ack``) — the decode engine uploads the views into
    its own pool, waits until the upload landed, and only then releases the
    slot back to the prefill writer. Up to ``slots`` handoffs ride in
    flight, so prefill keeps producing while decode drains.

    Single-writer (prefill side) / single-reader (decode side), in- or
    cross-process: another process attaches by ``name`` with
    ``create=False`` and the same ``capacity`` and ``slots``.
    """

    _HDR = struct.Struct("<QQQ")
    # Offset of a slot's payload in the mapping, modulo 64 (the slot stride
    # is a multiple of 64).
    _PAYLOAD_MOD64 = (FILE_HEADER_SIZE + SLOT_HEADER_SIZE) % 64

    def __init__(self, name: Optional[str] = None,
                 capacity: int = 8 * 1024 * 1024,
                 slots: Optional[int] = None, create: bool = True):
        self.chan = Channel(name=name, capacity=capacity, create=create,
                            slots=slots)
        self.name = self.chan.name

    @classmethod
    def attach(cls, name: str, timeout: float = 10.0,
               capacity: int = 8 * 1024 * 1024,
               slots: Optional[int] = None) -> Optional["KVHandoffLane"]:
        """Attach to a lane some OTHER endpoint creates, retrying until it
        appears or ``timeout`` lapses (None on timeout). The KV-tier drain
        path races lane creation against attachment — the survivor creates,
        the retiring victim attaches — so the attach side polls instead of
        requiring create-before-attach ordering. ``capacity``/``slots``
        must MATCH the creator's (the shm mapping is sized from them; both
        drain endpoints derive them from the same model config)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return cls(name=name, capacity=capacity, slots=slots,
                           create=False)
            except Exception:  # noqa: BLE001 — shm segment not there yet
                if time.monotonic() > deadline:
                    return None
                time.sleep(0.01)

    # -- writer half (prefill engine) -----------------------------------------
    def send(self, meta: dict, k: torch.Tensor, v: torch.Tensor,
             timeout: Optional[float] = 30.0) -> None:
        """Write one handoff: ``k`` and ``v`` (same dtype and shape, on any
        device) and ``meta``. Raises ``ValueError`` if it exceeds the
        lane's capacity and ``ChannelTimeout`` if no slot frees in
        ``timeout`` seconds."""
        k = torch.as_tensor(k).contiguous()
        v = torch.as_tensor(v).contiguous()
        if k.dtype != v.dtype or k.shape != v.shape:
            raise ValueError(f"k {k.dtype} {tuple(k.shape)} and v {v.dtype} "
                             f"{tuple(v.shape)} must match")
        meta = dict(meta)
        meta["dtype"] = str(k.dtype).removeprefix("torch.")
        meta["shape"] = tuple(int(d) for d in k.shape)
        blob = serialization.dumps(meta)
        k_len = k.numel() * k.element_size()
        v_len = v.numel() * v.element_size()
        # K starts on a 64-byte boundary of the mapping: pad the meta.
        head = self._PAYLOAD_MOD64 + self._HDR.size
        meta_len = _round64(head + len(blob)) - head
        total = self._HDR.size + meta_len + _round64(k_len) + v_len
        if total > self.chan.capacity:
            raise ValueError(
                f"KV handoff of {total} bytes exceeds lane capacity "
                f"{self.chan.capacity}")
        self.chan._wait_writable(timeout)
        try:
            mm = self.chan._mm
            off = self.chan._wpayload_off
            self._HDR.pack_into(mm, off, meta_len, k_len, v_len)
            off += self._HDR.size
            mm[off:off + len(blob)] = blob
            off += meta_len
            _copy_into(mm, off, k, k_len)
            _copy_into(mm, off + _round64(k_len), v, v_len)
        except BaseException:
            self.chan._abort_write()  # never leave the slot's seq odd
            raise
        self.chan._publish(total)

    # -- reader half (decode engine) ------------------------------------------
    def recv(self, timeout: Optional[float] = 30.0
             ) -> Tuple[dict, torch.Tensor, torch.Tensor, Tuple[int, int]]:
        """Return ``(meta, k, v, ack_token)``. ``k``/``v`` are CPU tensors
        viewing the ring slot — they stay valid (the writer cannot reuse
        the slot) until ``ack(ack_token)``; copy or upload them first."""
        view, length, slot, seq = self.chan._consume_view(timeout)
        if length == len(_CLOSE) and bytes(view[:length]) == _CLOSE:
            self.chan._ack(slot, seq)
            raise ChannelClosed(self.name)
        meta_len, k_len, v_len = self._HDR.unpack_from(view, 0)
        off = self._HDR.size
        # A copy: the meta's arrays must outlive the slot.
        meta = serialization.loads(bytes(view[off:off + meta_len]))
        off += meta_len
        dt = getattr(torch, meta["dtype"])
        shape = tuple(meta["shape"])
        k = torch.frombuffer(view, dtype=dt, count=k_len // dt.itemsize,
                             offset=off).reshape(shape)
        v = torch.frombuffer(view, dtype=dt, count=v_len // dt.itemsize,
                             offset=off + _round64(k_len)).reshape(shape)
        return meta, k, v, (slot, seq)

    def ack(self, token: Tuple[int, int]) -> None:
        self.chan._ack(*token)

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        self.chan.close()

    def detach(self) -> None:
        self.chan.detach()

    def destroy(self) -> None:
        self.chan.destroy()


def _copy_into(mm, off: int, t: torch.Tensor, nbytes: int) -> None:
    """Copy ``t``'s bytes into the mapping at ``off``: through a uint8
    torch view of the mapping, so a CUDA tensor lands there in one
    device-to-host copy (which returns once the bytes are on the host)."""
    if nbytes:
        dst = torch.frombuffer(mm, dtype=torch.uint8, count=nbytes,
                               offset=off)
        dst.copy_(t.reshape(-1).view(torch.uint8))

"""The prefill→decode KV handoff lane.

Counterpart of ``ray_tpu/serve/dag_pipeline.py``'s :class:`KVHandoffLane`.
The compiled serve pipelines of that module (``PipelineHandle``,
``build_compiled_pipeline``) park replicas in DAG loops and need the core
runtime, which comes with ROADMAP Queue 1.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import torch

from ray_tpu_torch.core import serialization
from ray_tpu_torch.dag.channel import (_CLOSE, FILE_HEADER_SIZE,
                                       SLOT_HEADER_SIZE, Channel,
                                       ChannelClosed)


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

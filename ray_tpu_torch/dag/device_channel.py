"""Device channels — torch tensors between pipelined actor stages.

The port's counterpart of ``ray_tpu/dag/device_channel.py``, the device
tier of the compiled-DAG transport. Separate processes hold separate CUDA
contexts, so a tensor crossing an actor boundary traverses host memory;
this channel makes that one device→host copy into the shm ring slot and
one host→device copy out of it, with the two directions overlapped:

- a slot holds a header (the dtype's name and the shape) and then the
  tensor's raw bytes — no pickle on either side, and bf16 needs no numpy
  dtype;
- the underlying :class:`~ray_tpu_torch.dag.channel.Channel` ring has at
  least 2 slots: the writer fills slot ``k+1`` while the reader's upload
  of slot ``k`` is still in flight;
- the reader stages a slot's bytes through a pinned buffer and copies them
  to its device with ``non_blocking=True`` on a side stream; a CUDA event
  marks the end of that copy, the reader's current stream waits on the
  event (``wait_event``), and ``record_stream`` keeps the allocator from
  handing the tensor's memory to the side stream again while the current
  stream still uses it. Engines keep launching on their current stream:
  only this copy runs on the side stream;
- the slot is acked (and the pinned buffer reused) only once that event
  has completed — a deferred ack, so the writer never overwrites bytes a
  copy still reads.

The reader lands tensors on the channel's ``device``; with none given, on
its current CUDA device, and with no card and no device given it raises
instead of landing on the CPU. Anything that is not a tensor takes the
pickled path of the ring.
"""

from __future__ import annotations

import pickle
import struct
import uuid
from typing import Any, Optional

from ray_tpu_torch.dag.channel import (SLOT_HEADER_SIZE, Channel,
                                       ChannelClosed, ChannelTimeout,
                                       _default_slots)

# Payload kinds inside a slot: raw tensor (header + bytes) or pickled.
_KIND_TENSOR = 0
_KIND_PICKLE = 1
_META = struct.Struct("<BI")  # kind, header_len


def _raw_tensor(value):
    """The tensor behind ``value`` when it travels as raw bytes (a dense
    ``torch.Tensor`` or ``Parameter``), else None. torch is looked up, not
    imported: a process that never imported it has no tensor to send."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or type(value) not in (torch.Tensor,
                                            torch.nn.Parameter):
        return None
    if value.layout != torch.strided:
        return None
    return value.detach()


class DeviceChannel:
    """Single-writer single-reader device-tensor channel (ring-buffered)."""

    def __init__(self, name: Optional[str] = None,
                 capacity: int = 64 * 1024 * 1024, create: bool = True,
                 device: Any = None, slots: Optional[int] = None):
        self.name = name or f"rtpu-devchan-{uuid.uuid4().hex[:12]}"
        self.capacity = capacity
        # At least two slots — one upload in flight + one being filled is
        # the minimum for the overlap this channel exists for — even when
        # dag_channel_slots=1 pins plain channels to lock-step.
        self._ch = Channel(f"{self.name}-ring", capacity=capacity,
                           create=create,
                           slots=max(2, slots if slots else _default_slots()))
        self.device = None if device is None else str(device)
        self._attached_endpoint = not create
        # The previous read's (slot, seq, copy-done event): the slot is
        # acked once the event has completed (deferred ack = the overlap).
        self._pending_ack: Optional[tuple] = None
        self._pinned = None   # reader's staging buffer (uint8, pinned)
        self._stream = None   # reader's side stream for the upload

    # -- write ---------------------------------------------------------------

    def write(self, value: Any, timeout: Optional[float] = 30.0) -> None:
        t = _raw_tensor(value)
        if t is None:
            from ray_tpu_torch.core import serialization

            blob = serialization.dumps(value)
            payload = _META.pack(_KIND_PICKLE, len(blob)) + blob
            self._ch._write_payload(payload, timeout)
            return
        import torch

        header = pickle.dumps((str(t.dtype).rsplit(".", 1)[-1],
                               tuple(t.shape)))
        nbytes = t.numel() * t.element_size()
        total = _META.size + len(header) + nbytes
        if total > self.capacity:
            raise ValueError(
                f"tensor of {nbytes} bytes exceeds device-channel capacity "
                f"{self.capacity}")
        # The tensor's bytes land straight in the ring slot's shm region
        # (a device→host copy for a CUDA tensor), no pickle copy.
        ch = self._ch
        ch._wait_writable(timeout)
        try:
            base = ch._wpayload_off
            mm = ch._mm
            _META.pack_into(mm, base, _KIND_TENSOR, len(header))
            mm[base + _META.size:base + _META.size + len(header)] = header
            if nbytes:
                dst = torch.frombuffer(mm, dtype=torch.uint8, count=nbytes,
                                       offset=base + _META.size + len(header))
                dst.copy_(t.contiguous().reshape(-1).view(torch.uint8))
                del dst
        except BaseException:
            # Roll the seqlock back to even: a failed fill must not leave
            # the slot marked write-in-progress forever.
            ch._abort_write()
            raise
        ch._publish(total)

    # -- read ----------------------------------------------------------------

    def _target(self, torch):
        """The device tensors land on: the channel's, else the current CUDA
        device; no card and no device given raises."""
        if self.device is not None:
            dev = torch.device(self.device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            return dev
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"DeviceChannel {self.name}: no CUDA device and no device "
                f"given; pass device= (channel_device= to "
                f"experimental_compile) to land tensors elsewhere")
        return torch.device("cuda", torch.cuda.current_device())

    def read(self, timeout: Optional[float] = 30.0) -> Any:
        """Next value: a tensor on this channel's device (raw tensors) or
        the pickled object (control payloads)."""
        self._complete_pending_ack()
        ch = self._ch
        view, length, slot, seq = ch._consume_view(timeout)
        kind, hlen = _META.unpack_from(view, 0)
        if kind == _KIND_PICKLE:
            from ray_tpu_torch.core import serialization

            blob = bytes(view[_META.size:_META.size + hlen])
            del view
            if ch._load(slot)[0] != seq:
                # close() force-published over the slot mid-copy; the only
                # force-publisher is teardown.
                ch._ack(slot, ch._load(slot)[0])
                raise ChannelClosed(self.name)
            ch._ack(slot, seq)
            value = serialization.loads(blob)
            if isinstance(value, bytes) and value == _CLOSE_SENTINEL:
                raise ChannelClosed(self.name)
            return value
        import torch

        dtype_name, shape = pickle.loads(
            bytes(view[_META.size:_META.size + hlen]))
        dtype = getattr(torch, dtype_name)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"{self.name}: no torch dtype {dtype_name!r}")
        off = _META.size + hlen
        nbytes = length - off
        # Offset of the tensor's bytes in the mapped file.
        base = ch._slot_off(slot) + SLOT_HEADER_SIZE + off
        del view
        dev = self._target(torch)
        if nbytes == 0:
            ch._ack(slot, seq)
            return torch.empty(shape, dtype=dtype, device=dev)
        src = torch.frombuffer(ch._mm, dtype=torch.uint8, count=nbytes,
                               offset=base)
        if dev.type != "cuda":
            out = src.clone()
            del src
            ch._ack(slot, seq)
            return out.view(dtype).reshape(shape)
        # Host staging: the slot's bytes into a pinned buffer, then an
        # asynchronous upload on the side stream.
        if self._pinned is None or self._pinned.numel() < nbytes:
            self._pinned = None
            self._pinned = torch.empty(nbytes, dtype=torch.uint8,
                                       pin_memory=True)
        staged = self._pinned[:nbytes]
        staged.copy_(src)
        del src
        if self._stream is None or self._stream.device != dev:
            self._stream = torch.cuda.Stream(device=dev)
        current = torch.cuda.current_stream(dev)
        with torch.cuda.stream(self._stream):
            out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            out.copy_(staged, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        current.wait_event(done)
        out.record_stream(current)
        # DEFERRED ack: the upload may still read the pinned bytes; ack the
        # slot (and free the buffer) once it has landed — usually on the
        # NEXT read, by which time the writer is filling the next slot.
        self._pending_ack = (slot, seq, done)
        return out.view(dtype).reshape(shape)

    def _complete_pending_ack(self) -> None:
        if self._pending_ack is None:
            return
        slot, seq, done = self._pending_ack
        self._pending_ack = None
        done.synchronize()
        if self._ch._load(slot)[0] != seq:
            # A teardown force-publish overwrote the slot while the upload
            # was in flight — the consumer's tensor may be torn. Surface it
            # as the close it is rather than silent corruption.
            self._ch._ack(slot, self._ch._load(slot)[0])
            raise ChannelClosed(self.name)
        self._ch._ack(slot, seq)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        from ray_tpu_torch.core import serialization

        blob = serialization.dumps(_CLOSE_SENTINEL)
        payload = _META.pack(_KIND_PICKLE, len(blob)) + blob
        try:
            self._ch._write_payload(payload, timeout=0.5)
        except (ChannelTimeout, ValueError):
            # Force-publish the META-FRAMED pill (the raw underlying pill
            # would be misparsed by this channel's framed read path).
            self._ch._force_publish(payload)

    def _settle(self) -> None:
        try:
            self._complete_pending_ack()
        except ChannelClosed:
            pass  # teardown overwrote the in-flight slot — expected here
        self._pinned = None

    def detach(self) -> None:
        """Worker-side endpoint close (no unlink); see Channel.detach."""
        self._settle()
        self._ch.detach()

    def destroy(self) -> None:
        self._settle()
        self._ch.destroy()

    def __reduce__(self):
        return (DeviceChannel, (self.name, self.capacity, False,
                                self.device, self._ch.slots))


_CLOSE_SENTINEL = b"\x00__ray_tpu_device_channel_closed__"

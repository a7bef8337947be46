"""Mutable shm channels — the zero-allocation transport under the KV
handoff lane.

Counterpart of ``ray_tpu/dag/channel.py``: a fixed shm region written in
place per value instead of a fresh object per call. The channel is an
N-slot ring (``dag_channel_slots`` knob). Each slot is an independent
seqlock cell; writer and reader walk the ring with private cursors, so up
to N values can be in flight on one edge before the writer blocks on the
reader's ack. ``slots=1`` is strict capacity-1 lock-step.

Layout (one mmap'd file under /dev/shm, works in- and cross-process)::

    [0:8)    nslots (stamped by the creator; attach verifies)
    per slot, at 8 + i * stride (stride = 64-byte-aligned header+capacity):
      [0:8)   write_seq  — odd while a write is in progress (seqlock)
      [8:16)  ack_seq    — last write_seq the (single) reader consumed
      [16:24) payload_len
      [24:..) payload

Writer blocks when the ring is full (its next slot's previous value is not
yet acked); reader blocks until a new even write_seq appears in its slot.

The file is sparse, so a ring larger than the free space of /dev/shm would
map and then fault (SIGBUS) on the first write past the limit: the creator
checks the room first (:func:`check_shm_room`) and raises instead.

:class:`SocketChannel` is the cross-host edge of a compiled DAG: the same
surface over a TCP stream, its rendezvous through the runtime's KV, its
acks windowed (``dag_socket_window``).
"""

from __future__ import annotations

import errno
import mmap
import os
import struct
import time
import uuid
from typing import Any, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.util import flightrec

_FILE_HEADER = struct.Struct("<Q")  # nslots


def _stall_after_s() -> float:
    """How long a channel wait may block before the flight recorder calls
    it a stall — a quarter of the internal wait budget, so the ring names
    a wedged stage well before the ChannelTimeout fires."""
    from ray_tpu_torch.core.config import config

    return max(0.05, float(config().internal_wait_timeout_s) / 4.0)


_SLOT_HEADER = struct.Struct("<QQQ")  # write_seq, ack_seq, payload_len
FILE_HEADER_SIZE = _FILE_HEADER.size
SLOT_HEADER_SIZE = _SLOT_HEADER.size
SHM_DIR = "/dev/shm"


def _slot_stride(capacity: int) -> int:
    # 64-byte-align each slot so seqlock headers sit on their own cache
    # lines (writer and reader hammer adjacent slots concurrently).
    return -(-(SLOT_HEADER_SIZE + capacity) // 64) * 64


def shm_footprint(capacity: int, slots: int) -> int:
    """Bytes of the file behind a channel of ``slots`` slots of
    ``capacity`` payload bytes each."""
    return FILE_HEADER_SIZE + slots * _slot_stride(capacity)


def shm_room(path: str = SHM_DIR) -> tuple:
    """``(total, free)`` bytes of the filesystem at ``path``."""
    st = os.statvfs(path)
    return st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize


def check_shm_room(nbytes: int, what: str = "channel") -> None:
    """Raise ``OSError(ENOSPC)`` unless /dev/shm has ``nbytes`` free: a
    sparse ring past the free space maps, then faults on the first write
    that reaches past it."""
    total, free = shm_room()
    if nbytes > free:
        raise OSError(
            errno.ENOSPC,
            f"{what} needs {nbytes} bytes of {SHM_DIR}, which has {free} "
            f"free of {total}")


def _spin_params() -> Tuple[int, float, float]:
    """(tight_spins, spin_s, spin_max_s) from the config knobs.

    Resolved per channel instance (not per wait iteration): the knobs are
    process-lifetime settings, and config() is a lock + dict hit.
    """
    from ray_tpu_torch.core.config import config

    cfg = config()
    spin_s = max(1e-6, float(cfg.dag_channel_spin_us) * 1e-6)
    # Idle-poll ceiling: exponential backoff stops at 40x the granularity
    # (2ms at the 50us default) so parked DAG loops stop burning wakeups.
    return int(cfg.dag_channel_tight_spins), spin_s, spin_s * 40.0


def _default_slots() -> int:
    from ray_tpu_torch.core.config import config

    return max(1, int(config().dag_channel_slots))


class ChannelTimeout(TimeoutError):
    pass


class ChannelClosed(Exception):
    pass


_CLOSE = b"\x00__ray_tpu_channel_closed__"


class Channel:
    """Single-writer single-reader mutable ring channel over shm."""

    def __init__(self, name: Optional[str] = None,
                 capacity: int = 4 * 1024 * 1024, create: bool = True,
                 slots: Optional[int] = None):
        self.name = name or f"rtpu-chan-{uuid.uuid4().hex[:12]}"
        self.capacity = capacity
        self.slots = max(1, int(slots)) if slots else _default_slots()
        self._stride = _slot_stride(capacity)
        path = f"{SHM_DIR}/{self.name}"
        size = shm_footprint(capacity, self.slots)
        created = False
        if create and not os.path.exists(path):
            check_shm_room(size, f"channel {self.name}")
            with open(path, "wb") as f:
                f.truncate(size)
            created = True
        self._f = open(path, "r+b")
        self._mm = mmap.mmap(self._f.fileno(), size)
        if created:
            _FILE_HEADER.pack_into(self._mm, 0, self.slots)
        else:
            stamped = _FILE_HEADER.unpack_from(self._mm, 0)[0]
            if stamped and stamped != self.slots:
                self._mm.close()
                self._f.close()
                raise ValueError(
                    f"channel {self.name} has {stamped} slots; attach "
                    f"requested {self.slots}")
        self._tight_spins, self._spin_s, self._spin_max_s = _spin_params()
        # Reattached (unpickled) endpoints detach themselves at DAG-loop
        # exit; the creating endpoint's lifecycle belongs to the driver.
        self._attached_endpoint = not create
        # Private cursors: count of completed writes / reads. Slot index is
        # cursor % slots; both endpoints start at 0 (fresh or attach-by-name
        # before first use, the same contract the capacity-1 channel had).
        self._wcursor = 0
        self._rcursor = 0
        # Last write_seq consumed per slot (reader-private).
        self._read_seq = [0] * self.slots
        flightrec.record("channel", self.name[:32],
                         "create" if created else "attach")

    # -- header accessors -----------------------------------------------------

    def _slot_off(self, i: int) -> int:
        return FILE_HEADER_SIZE + i * self._stride

    def _load(self, i: int) -> Tuple[int, int, int]:
        return _SLOT_HEADER.unpack_from(self._mm, self._slot_off(i))

    def _store_write_seq(self, i: int, v: int) -> None:
        struct.pack_into("<Q", self._mm, self._slot_off(i), v)

    def _store_ack(self, i: int, v: int) -> None:
        struct.pack_into("<Q", self._mm, self._slot_off(i) + 8, v)

    def _sleep_poll(self, spins: int) -> None:
        # Exponential backoff to the ceiling: hot hand-offs stay at
        # ~spin_s latency, parked DAG loops stop burning ~20k wakeups/s
        # per stage while idle.
        time.sleep(min(self._spin_s * (1 << min(spins // 64, 6)),
                       self._spin_max_s))

    # -- write half -----------------------------------------------------------

    def write(self, value: Any, timeout: Optional[float] = 30.0) -> None:
        # ALWAYS serialize — read() always deserializes; a raw-bytes fast
        # path would misparse user bytes payloads (the close pill goes
        # through _force_publish framing instead).
        self._write_payload(serialization.dumps(value), timeout)

    def _wait_writable(self, timeout: Optional[float]) -> None:
        """Block until this writer's next ring slot is free (its previous
        value acked), then mark a write in progress (odd seq). Split out so
        callers (the KV handoff lane) can land payload bytes DIRECTLY in the shm
        region — ``self._wpayload_off`` — between this and ``_publish``,
        no intermediate buffer."""
        started = time.monotonic()
        deadline = (None if timeout is None
                    else started + timeout)
        stall_at = started + _stall_after_s()
        stalled = False
        slot = self._wcursor % self.slots
        spins = 0
        while True:
            write_seq, ack_seq, _ = self._load(slot)
            if write_seq % 2 == 0 and ack_seq == write_seq:
                break  # slot's previous value consumed (or slot fresh)
            now = time.monotonic()
            if deadline is not None and now > deadline:
                raise ChannelTimeout(
                    f"writer blocked on full ring in {self.name} "
                    f"(slot {slot}/{self.slots})")
            if not stalled and now > stall_at:
                stalled = True
                flightrec.record("channel", self.name[:32],
                                 f"write stall slot={slot}")
            spins += 1
            if spins > self._tight_spins:
                self._sleep_poll(spins)
        if stalled:
            flightrec.record(
                "channel", self.name[:32],
                f"write resume after {time.monotonic() - started:.1f}s")
        self._store_write_seq(slot, write_seq + 1)  # mark in-progress (odd)
        self._pending_write_seq = write_seq
        self._wslot = slot
        self._wpayload_off = self._slot_off(slot) + SLOT_HEADER_SIZE

    def _publish(self, length: int) -> None:
        struct.pack_into("<Q", self._mm, self._slot_off(self._wslot) + 16,
                         length)
        self._store_write_seq(self._wslot, self._pending_write_seq + 2)
        self._wcursor += 1

    def _abort_write(self) -> None:
        """Roll a begun (odd) write back to even without advancing the
        cursor — a failed slot fill must not wedge the seqlock."""
        self._store_write_seq(self._wslot, self._pending_write_seq)

    def _write_payload(self, payload: bytes, timeout: Optional[float]) -> None:
        if len(payload) > self.capacity:
            raise ValueError(
                f"payload of {len(payload)} bytes exceeds channel capacity "
                f"{self.capacity}")
        self._wait_writable(timeout)
        off = self._wpayload_off
        self._mm[off:off + len(payload)] = payload
        self._publish(len(payload))

    # -- read half ------------------------------------------------------------

    def _read_view(self, timeout: Optional[float]):
        """Block for the next value; return ``(view, length)`` WITHOUT
        acking or advancing — the bytes stay stable (the writer can't reuse
        the slot before our ack) until the caller's ``_ack_current``. The
        zero-copy read half of the deferred-ack protocol. Idempotent until
        acked, which is what lets ``read()`` retry a torn copy."""
        started = time.monotonic()
        deadline = (None if timeout is None
                    else started + timeout)
        stall_at = started + _stall_after_s()
        stalled = False
        slot = self._rcursor % self.slots
        spins = 0
        while True:
            write_seq, _ack, length = self._load(slot)
            if write_seq % 2 == 0 and write_seq > self._read_seq[slot]:
                if stalled:
                    flightrec.record(
                        "channel", self.name[:32],
                        f"read resume after "
                        f"{time.monotonic() - started:.1f}s")
                self._pending_read_seq = write_seq
                self._rslot = slot
                off = self._slot_off(slot) + SLOT_HEADER_SIZE
                return memoryview(self._mm)[off:off + length], length
            now = time.monotonic()
            if deadline is not None and now > deadline:
                raise ChannelTimeout(f"no value arrived in {self.name}")
            if not stalled and now > stall_at:
                stalled = True
                flightrec.record("channel", self.name[:32],
                                 f"read stall slot={slot}")
            spins += 1
            if spins > self._tight_spins:
                self._sleep_poll(spins)

    def _ack_current(self) -> None:
        self._ack(self._rslot, self._pending_read_seq)
        self._rcursor += 1

    def _ack(self, slot: int, seq: int) -> None:
        """Release one slot back to the writer (deferred-ack primitive:
        the KV handoff lane acks slot k only once k's upload to the card
        landed, possibly after reading slot k+1)."""
        self._read_seq[slot] = seq
        self._store_ack(slot, seq)

    def _consume_view(self, timeout: Optional[float]):
        """Advancing read for pipelined consumers: returns ``(view, length,
        slot, seq)`` and moves the read cursor on, WITHOUT acking — the
        caller owns the eventual ``_ack(slot, seq)``. Unlike ``_read_view``
        a subsequent call proceeds to the next ring slot immediately."""
        view, length = self._read_view(timeout)
        slot, seq = self._rslot, self._pending_read_seq
        self._read_seq[slot] = seq  # consumed (ack still pending)
        self._rcursor += 1
        return view, length, slot, seq

    def read(self, timeout: Optional[float] = 30.0) -> Any:
        """Block until a value newer than the last read appears; ack it."""
        while True:
            view, length = self._read_view(timeout)
            payload = bytes(view[:length])
            # Stability recheck: a close() FORCE-publish may overwrite the
            # payload mid-copy (the one writer path that skips the ack
            # handshake); a changed seq means the copy is torn — retry and
            # pick up the pill.
            if self._load(self._rslot)[0] == self._pending_read_seq:
                break
        self._ack_current()
        if payload == _CLOSE:
            raise ChannelClosed(self.name)
        return serialization.loads(payload)

    # -- lifecycle ------------------------------------------------------------

    def _force_publish(self, payload: bytes) -> None:
        """Teardown-only: publish ``payload`` into the writer's CURRENT
        ring slot WITHOUT waiting for the reader's ack (used when the ring
        is full because the reader never drained). The pill overwrites one
        undelivered value — readers detect a torn copy via the stability
        recheck, and the bumped seq satisfies their wait when the cursor
        reaches this slot."""
        slot = self._wcursor % self.slots
        write_seq, _, _ = self._load(slot)
        base = write_seq if write_seq % 2 == 0 else write_seq + 1
        self._store_write_seq(slot, base + 1)
        off = self._slot_off(slot) + SLOT_HEADER_SIZE
        self._mm[off:off + len(payload)] = payload
        struct.pack_into("<Q", self._mm, self._slot_off(slot) + 16,
                         len(payload))
        self._store_write_seq(slot, base + 2)

    def close(self) -> None:
        """Wake the reader with a poison pill (teardown path)."""
        try:
            self._write_payload(_CLOSE, timeout=0.5)
        except (ChannelTimeout, ValueError):
            # Ring full (reader never drained); force-publish the pill.
            self._force_publish(_CLOSE)

    def detach(self) -> None:
        """Close THIS endpoint's mmap/fd without unlinking the backing
        file — the worker-side half of teardown (the driver, which created
        the channel, unlinks in ``destroy``). Idempotent."""
        try:
            self._mm.close()
        except (OSError, BufferError):
            # BufferError: a zero-copy view handed out by _read_view is
            # still referenced (e.g. a device array's source buffer whose
            # consumer hasn't been collected yet) — the mmap closes when
            # the last view dies.
            pass
        try:
            self._f.close()  # its own try: the fd must not leak when
        except OSError:      # mm.close() raised above
            pass

    def destroy(self) -> None:
        self.detach()
        try:
            os.unlink(f"{SHM_DIR}/{self.name}")
        except OSError:
            pass

    def __reduce__(self):
        # Cross-process handle: reattach by name (same slot geometry).
        return (Channel, (self.name, self.capacity, False, self.slots))


class SocketChannel:
    """Single-writer single-reader channel ACROSS HOSTS (shm cannot).

    Same surface and semantics as :class:`Channel` — a ring of in-flight
    values with backpressure — over a TCP stream with CREDIT-BASED acks:
    the writer may run ``dag_socket_window`` frames ahead of the reader's
    acks (the reader acks each frame as its read returns), so burst
    submission pipelines over the wire instead of stalling on a per-frame
    ack round-trip. ``window=1`` restores strict lock-step. Roles bind
    lazily: the first ``read()`` makes this end the reader (it listens and
    publishes its address in the control plane's KV under the channel
    name); the first ``write()`` makes it the writer (it polls the KV and
    connects). Frames are length-prefixed.
    """

    _ACK = b"\x06\x00\x00\x00\x00\x00\x00\x01"

    def __init__(self, name: Optional[str] = None,
                 capacity: int = 4 * 1024 * 1024, create: bool = True,
                 window: Optional[int] = None):
        from ray_tpu_torch.core.config import config

        self.name = name or f"rtpu-schan-{uuid.uuid4().hex[:12]}"
        self.capacity = capacity  # parity with Channel; frames are unbounded
        self.window = (max(1, int(window)) if window
                       else max(1, int(config().dag_socket_window)))
        self._sock = None
        self._listener = None
        self._role: Optional[str] = None
        self._unacked = 0
        self._closed = False
        self._attached_endpoint = not create

    # -- rendezvous -----------------------------------------------------------

    def _kv(self):
        from ray_tpu_torch.core.runtime import get_runtime

        return get_runtime().gcs

    def _become_reader(self, timeout: Optional[float]) -> None:
        import socket as _socket

        self._role = "reader"
        lst = _socket.socket()
        lst.bind(("0.0.0.0", 0))
        lst.listen(1)
        port = lst.getsockname()[1]
        self._listener = lst
        # Publish host AND port: the writer may sit on another machine —
        # loopback would only ever work same-host (which auto mode gives
        # to shm anyway). The reader's reachable interface is the one its
        # runtime registered with the control plane.
        self._kv().kv_put(f"dag_channel:{self.name}",
                          f"{self._my_host()}:{port}".encode(),
                          namespace="dag")
        lst.settimeout(timeout if timeout is not None else None)
        try:
            conn, _addr = lst.accept()
        except _socket.timeout as e:
            raise ChannelTimeout(
                f"writer never connected to {self.name}") from e
        conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        conn.settimeout(None)
        self._sock = conn

    @staticmethod
    def _my_host() -> str:
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
        for attr in ("owner_address", "_node_address"):
            addr = getattr(rt, attr, None)
            if addr:
                return addr.rsplit(":", 1)[0]
        return "127.0.0.1"

    def _become_writer(self, timeout: Optional[float]) -> None:
        import socket as _socket

        self._role = "writer"
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            raw = self._kv().kv_get(f"dag_channel:{self.name}",
                                    namespace="dag")
            if raw:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeout(
                    f"reader of {self.name} never published its address")
            time.sleep(0.02)
        host, port = raw.decode().rsplit(":", 1)
        sock = _socket.create_connection((host, int(port)),
                                         timeout=timeout or 60.0)
        sock.settimeout(None)
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._sock = sock

    # -- IO -------------------------------------------------------------------

    def _send_frame(self, payload: bytes) -> None:
        self._sock.sendall(len(payload).to_bytes(8, "big") + payload)

    def _recv_exact(self, n: int, timeout: Optional[float]) -> bytes:
        # Partial data RIDES OVER timeouts in self._rx: a timed-out read
        # must be retryable without desyncing the length-prefixed stream
        # (discarding a half-received payload would make the next read
        # parse payload bytes as a length prefix).
        if not hasattr(self, "_rx"):
            self._rx = bytearray()
        self._sock.settimeout(timeout)
        try:
            while len(self._rx) < n:
                try:
                    chunk = self._sock.recv(65536)
                except TimeoutError as e:
                    raise ChannelTimeout(f"no data in {self.name}") from e
                if not chunk:
                    raise ChannelClosed(self.name)
                self._rx.extend(chunk)
            out = bytes(self._rx[:n])
            del self._rx[:n]
            return out
        finally:
            # Back to blocking mode: a lingering recv timeout would make a
            # later sendall of a large frame fail MID-WRITE and desync the
            # length-prefixed stream.
            self._sock.settimeout(None)

    def _drain_acks(self) -> None:
        """Opportunistically consume every ack already on the wire without
        blocking — the credit-refill half of the windowed protocol. The
        writer's socket only ever carries acks, so buffered bytes parse as
        fixed 8-byte frames."""
        if not hasattr(self, "_rx"):
            self._rx = bytearray()
        try:
            self._sock.settimeout(0.0)
            while True:
                chunk = self._sock.recv(65536)
                if not chunk:
                    raise ChannelClosed(self.name)
                self._rx.extend(chunk)
        except (BlockingIOError, InterruptedError):
            pass
        finally:
            self._sock.settimeout(None)
        while len(self._rx) >= 8 and self._unacked > 0:
            ack = bytes(self._rx[:8])
            del self._rx[:8]
            if ack != self._ACK:
                raise ChannelClosed(self.name)
            self._unacked -= 1

    def write(self, value: Any, timeout: Optional[float] = 30.0) -> None:
        self._write_payload(serialization.dumps(value), timeout)

    def _write_payload(self, payload: bytes, timeout: Optional[float]) -> None:
        if self._sock is None:
            self._become_writer(timeout)
        self._drain_acks()
        if self._unacked >= self.window:
            # Window exhausted: block for exactly one credit before
            # publishing the next frame.
            ack = self._recv_exact(8, timeout)
            if ack != self._ACK:
                raise ChannelClosed(self.name)
            self._unacked -= 1
        self._send_frame(payload)
        self._unacked += 1

    def read(self, timeout: Optional[float] = 30.0) -> Any:
        if self._sock is None:
            self._become_reader(timeout)
        length = int.from_bytes(self._recv_exact(8, timeout), "big")
        payload = self._recv_exact(length, timeout)
        if payload == _CLOSE:
            raise ChannelClosed(self.name)
        value = serialization.loads(payload)
        try:
            self._sock.sendall(self._ACK)
        except OSError:
            pass  # writer gone; the value still counts
        return value

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self._sock is None:
                self._become_writer(timeout=5.0)
            self._send_frame(_CLOSE)
        except (ChannelTimeout, ChannelClosed, OSError):
            pass

    def detach(self) -> None:
        """Close this endpoint's socket/listener fds without touching the
        KV registration — the worker-side half of teardown. Idempotent."""
        for s in (self._sock, self._listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._sock = self._listener = None

    def destroy(self) -> None:
        self.detach()
        try:
            self._kv().kv_del(f"dag_channel:{self.name}", namespace="dag")
        except Exception:  # noqa: BLE001 — runtime already down
            pass

    def __reduce__(self):
        return (SocketChannel, (self.name, self.capacity, False, self.window))

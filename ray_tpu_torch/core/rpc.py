"""Socket RPC — the wire layer between cluster processes.

TPU-era analog of the reference's gRPC plumbing (``src/ray/rpc/`` — typed
client/server wrappers with retrying clients; service methods declared in
``src/ray/protobuf/*.proto``). We use length-prefixed frames over TCP with
cloudpickle payloads instead of protobuf/HTTP2: the control plane carries
small metadata messages (task specs, leases, table updates), while bulk data
rides the shared-memory object plane (``_native/object_store.cc``) or XLA
collectives — so the RPC layer optimizes for simplicity and correct failure
propagation, not throughput.

Wire format, one frame per message::

    8-byte big-endian length | payload = pickle((kind, request_id, method, data))

``kind`` is ``"req"`` / ``"rep"`` / ``"err"`` / ``"note"`` (one-way) /
``"tmpl"`` (a task-spec template registration, processed IN ORDER on the
connection loop — never handed to the pool — so a request referencing the
template by digest can never race ahead of it).
Requests multiplex over one connection: each carries a request id and replies
may arrive out of order (the reference gets this from HTTP/2 streams; we get
it from a reader thread matching ids to futures).

Send path — the control-plane fast path: every connection owns a
:class:`_FrameSender` that writes frames with ONE ``sendmsg`` scatter-gather
syscall per batch (length prefix, header, and out-of-band payload buffers as
separate iovecs — nothing is ever concatenated into an intermediate blob).
Frames queued while a send is in flight coalesce into the next syscall, and
an adaptive micro-window (``rpc_coalesce_window_us``, engaged only when the
connection has recently seen back-to-back frames) lets non-urgent frames —
server replies, one-way notes — wait a few dozen microseconds for company.
Urgent frames (requests) and :meth:`RpcClient.flush` never wait on the
window, so a blocking call is never delayed by the coalescer. The receive
path mirrors it with a buffered reader: one ``recv`` refills up to 256 KiB
and many small frames are parsed out of it without further syscalls.

Bulk payloads ride OUT-OF-BAND (pickle protocol 5): any buffer ≥
``OOB_MIN_BYTES`` inside a message is stripped from the pickle stream and
streamed raw after a wrapper frame::

    8B len | pickle(("oob", request_id, [sizes...], inner_pickle)) | raw...

so a multi-MB numpy array or shm view crosses the socket with ZERO
user-space copies on the sender (``sendall`` straight from the source
buffer) and exactly one on the receiver (kernel → scratch, reconstructed as
views). Replies can go further: a client that registered a destination
buffer for a request id (``call_async(..., _dest=view)``) gets the raw
bytes received DIRECTLY into that buffer — the object plane's chunked
pulls land in the shm arena without ever existing twice in host RAM
(the reference gets the same effect from plasma fd-passing +
``src/ray/object_manager/object_buffer_pool.cc`` chunk reuse).

Security: frames are pickled, so any peer that can connect gets arbitrary
code execution — bind ``--host`` to loopback or a mesh-internal interface
ONLY. For non-loopback bindings set ``RAY_TPU_AUTH_TOKEN`` (propagated to
every spawned cluster process like the other ``RAY_TPU_*`` vars): each
connection must then open with a matching token frame before any request is
read; mismatches close the socket without unpickling anything else.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.util import flightrec
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("rpc")

_LEN = struct.Struct(">Q")
_AUTH_MAGIC = b"RTPU-AUTH1"


def _auth_token() -> bytes:
    import os

    return os.environ.get("RAY_TPU_AUTH_TOKEN", "").encode()
# Hard cap on a single frame (control messages are small; sealed objects can
# be fetched in one frame — match the reference's practical object sizes).
MAX_FRAME = 16 * 1024 * 1024 * 1024

# Buffers at or above this size are stripped out of the pickle stream and
# streamed raw (see module docstring). Below it, the syscall + bookkeeping
# costs more than the copy it saves. RAY_TPU_RPC_OOB=0 disables the raw
# path entirely (A/B benching + emergency fallback): Raw wrappers then
# serialize in-band as plain bytes.
import os as _os

if _os.environ.get("RAY_TPU_RPC_OOB", "1") == "0":
    OOB_MIN_BYTES = 1 << 62
else:
    OOB_MIN_BYTES = 256 * 1024

_RAW_SCOPE = threading.local()


def _raw_identity(buf):
    return buf


class Raw:
    """Zero-copy send wrapper: ``Raw(view)`` anywhere inside an RPC message
    serializes the buffer out-of-band — the sender's socket write reads
    straight from ``view`` (e.g. a shm arena slot), no intermediate bytes.
    The receiver sees a ``memoryview``/``bytes`` in its place.

    ``release`` (optional) fires exactly once after the frame carrying this
    buffer has been fully written to the socket (or the send failed) — the
    hook for shm refcount release on served object chunks."""

    __slots__ = ("view", "_release")

    def __init__(self, buf, release: Optional[Callable[[], None]] = None):
        self.view = memoryview(buf).cast("B")
        self._release = release

    def release_once(self) -> None:
        r, self._release = self._release, None
        if r is not None:
            try:
                r()
            except Exception:  # noqa: BLE001 — refcount bookkeeping only
                logger.exception("Raw release hook failed")

    def __len__(self) -> int:
        return self.view.nbytes

    def __reduce_ex__(self, protocol):
        scope = getattr(_RAW_SCOPE, "raws", None)
        if scope is not None:
            scope.append(self)
        return (_raw_identity, (pickle.PickleBuffer(self.view),))


def _dumps_frame(message: Tuple) -> Tuple[bytes, list, list]:
    """Serialize an RPC message with out-of-band bulk buffers.

    Returns ``(header, bufs, raws)``: if ``bufs`` is empty, ``header`` is a
    legacy whole-message pickle; otherwise ``header`` is the "oob"-wrapped
    frame payload and ``bufs`` are the raw buffers to stream after it.
    ``raws`` are :class:`Raw` wrappers whose ``release_once`` the sender
    must call after the socket write."""
    import io as _io

    import cloudpickle

    from ray_tpu_torch.core.serialization import _FastPickler

    bufs: list = []
    raws: list = []
    prev_scope = getattr(_RAW_SCOPE, "raws", None)
    _RAW_SCOPE.raws = raws

    def _cb(pb: pickle.PickleBuffer):
        mv = pb.raw()
        if mv.nbytes < OOB_MIN_BYTES:
            return True  # keep small buffers in-band
        bufs.append(mv)
        return False

    try:
        try:
            out = _io.BytesIO()
            _FastPickler(out, protocol=5, buffer_callback=_cb).dump(message)
            inner = out.getvalue()
        except Exception:  # noqa: BLE001 — __main__-defined / unpicklable
            bufs.clear()
            del raws[:]
            inner = cloudpickle.dumps(message, protocol=5, buffer_callback=_cb)
    except BaseException:
        for r in raws:  # pickling died: nobody else will fire the releases
            r.release_once()
        raise
    finally:
        _RAW_SCOPE.raws = prev_scope
    if not bufs:
        return inner, [], raws
    req_id = message[1] if len(message) > 2 else 0
    header = pickle.dumps(
        ("oob", req_id, [b.nbytes for b in bufs], inner),
        protocol=pickle.HIGHEST_PROTOCOL)
    return header, bufs, raws


# ---------------------------------------------------------------------------
# Coalescing scatter-gather send path
# ---------------------------------------------------------------------------

# Per-process send-path counters (frames_per_syscall is the headline metric
# tracked by benches/core_perf.py). Plain int stores under the GIL — stats,
# not invariants.
_SEND_STATS = {"frames": 0, "syscalls": 0, "bytes": 0, "batches": 0}

# Keep each sendmsg comfortably under Linux's UIO_MAXIOV (1024).
_IOV_MAX = 512


def send_stats() -> dict:
    """Snapshot of the process-wide frame-send counters."""
    out = dict(_SEND_STATS)
    out["frames_per_syscall"] = (
        out["frames"] / out["syscalls"] if out["syscalls"] else 0.0)
    return out


def reset_send_stats() -> None:
    for k in _SEND_STATS:
        _SEND_STATS[k] = 0


def _sendmsg_all(sock: socket.socket, iovecs: list) -> None:
    """Write every buffer in ``iovecs`` with scatter-gather ``sendmsg``
    syscalls — no intermediate concatenation, partial writes resumed."""
    iovs = [b if isinstance(b, memoryview) else memoryview(b) for b in iovecs]
    i, n = 0, len(iovs)
    while i < n:
        try:
            sent = sock.sendmsg(iovs[i:i + _IOV_MAX])
        except InterruptedError:
            continue
        _SEND_STATS["syscalls"] += 1
        _SEND_STATS["bytes"] += sent
        while sent:
            b = iovs[i]
            nb = b.nbytes
            if sent >= nb:
                sent -= nb
                i += 1
            else:
                iovs[i] = b[sent:]
                sent = 0
        while i < n and iovs[i].nbytes == 0:
            i += 1


def _connect_timeout_default() -> float:
    """The rpc_connect_timeout_s knob, with the config-table default as the
    fallback when the config machinery is unavailable (mid-teardown)."""
    try:
        from ray_tpu_torch.core.config import config

        return config().rpc_connect_timeout_s
    except Exception:  # noqa: BLE001 — mirror the flag's default exactly
        return 10.0


def _rpc_tunables() -> tuple:
    """(window_s, max_batch_frames, max_batch_bytes) from the config table
    (env-overridable as RAY_TPU_RPC_COALESCE_WINDOW_US etc.)."""
    try:
        from ray_tpu_torch.core.config import config

        cfg = config()
        return (cfg.rpc_coalesce_window_us / 1e6,
                cfg.rpc_max_batch_frames, cfg.rpc_max_batch_bytes)
    except Exception:  # noqa: BLE001 — config unavailable mid-teardown;
        # mirror the config DEFAULTS (window disabled) exactly.
        return (0.0, 64, 1 << 20)


class _FrameSender:
    """Per-connection micro-batching sender.

    Every ``send`` enqueues one frame (as a list of iovecs). If no drain is
    in progress the calling thread drains the queue itself — an isolated
    send therefore costs exactly one ``sendmsg`` with zero added latency.
    Frames enqueued while another thread is mid-``sendmsg`` ride the
    drainer's NEXT batch: one syscall for the lot. On top of that, a
    non-urgent lone frame may wait ``window_s`` for company — but only when
    the connection is "hot" (a recent drain actually coalesced), so
    sequential request/reply traffic never pays the window. ``flush``
    releases any window wait immediately.

    ``raws`` release hooks fire exactly once after their frame's bytes are
    written (or the send failed). A send failure poisons the sender: the
    synchronous drainer re-raises, queued frames release their raws, and
    ``on_error`` (if given) reports the failure to the connection owner —
    the client uses it to fail all in-flight futures.
    """

    _HOT_S = 0.002  # how long one observed coalesce keeps the window armed

    def __init__(self, sock: socket.socket, window_s: float | None = None,
                 on_error: Optional[Callable[[BaseException], None]] = None):
        win, max_frames, max_bytes = _rpc_tunables()
        self._sock = sock
        self._window = win if window_s is None else window_s
        self._max_frames = max_frames
        self._max_bytes = max_bytes
        self._on_error = on_error
        self._cv = threading.Condition(threading.Lock())
        self._queue: deque = deque()  # (iovecs, nbytes, raws, urgent)
        self._draining = False
        self._flush = False
        self._hot_until = 0.0
        self._helper: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def send(self, iovecs: list, raws=(), urgent: bool = True,
             handoff: bool = False) -> None:
        """``handoff=True``: enqueue and return immediately — a per-
        connection helper thread drains. The caller races ahead producing
        the next frame while the helper's ``sendmsg`` is in flight, so
        single-threaded pipelined submitters (the actor window's submit
        loop) coalesce instead of paying one syscall per frame."""
        nbytes = sum(
            b.nbytes if isinstance(b, memoryview) else len(b) for b in iovecs)
        with self._cv:
            if self._error is not None:
                for r in raws:
                    r.release_once()
                raise self._error
            self._queue.append((iovecs, nbytes, list(raws), urgent))
            if self._draining:
                # A drainer is mid-send: our frame rides its next batch.
                self._cv.notify()
                return
            if handoff:
                if self._helper is None or not self._helper.is_alive():
                    self._helper = threading.Thread(
                        target=self._helper_loop, name="rpc-sendq",
                        daemon=True)
                    self._helper.start()
                self._cv.notify()
                return
            self._draining = True
        self._drain()

    def flush(self) -> None:
        """Release any window wait and push queued frames out now."""
        with self._cv:
            if self._queue:
                self._flush = True
                self._cv.notify_all()

    def close(self, error: Optional[BaseException] = None) -> None:
        with self._cv:
            if self._error is None:
                self._error = error or OSError("sender closed")
            leftovers = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()  # release the helper + window waiters
        for _iv, _nb, raws, _u in leftovers:
            for r in raws:
                r.release_once()

    def _helper_loop(self) -> None:
        """Background drainer for handed-off frames; parks on the cv."""
        while True:
            with self._cv:
                while self._error is None and (not self._queue
                                               or self._draining):
                    self._cv.wait(1.0)
                if self._error is not None:
                    return
                self._draining = True
            try:
                self._drain()
            except BaseException:  # noqa: BLE001 — poisoned via on_error
                return

    def _drain(self) -> None:
        while True:
            with self._cv:
                if not self._queue:
                    self._draining = False
                    return
                if (self._window > 0.0 and not self._flush
                        and len(self._queue) == 1
                        and not self._queue[0][3]  # non-urgent lone frame
                        and time.monotonic() < self._hot_until):
                    self._cv.wait(self._window)
                self._flush = False
                iovecs: list = []
                raws: list = []
                nframes = nbytes = 0
                while (self._queue and nframes < self._max_frames
                       and (nframes == 0
                            or nbytes + self._queue[0][1] <= self._max_bytes)):
                    iv, nb, rw, _u = self._queue.popleft()
                    iovecs += iv
                    raws += rw
                    nframes += 1
                    nbytes += nb
                if nframes > 1:
                    self._hot_until = time.monotonic() + self._HOT_S
            try:
                _sendmsg_all(self._sock, iovecs)
            except BaseException as e:  # noqa: BLE001 — poison + propagate
                err = e if isinstance(e, OSError) else OSError(repr(e))
                with self._cv:
                    self._error = err
                    leftovers = list(self._queue)
                    self._queue.clear()
                    self._draining = False
                for r in raws:
                    r.release_once()
                for _iv, _nb, rw, _u in leftovers:
                    for r in rw:
                        r.release_once()
                if self._on_error is not None:
                    try:
                        self._on_error(e)
                    except Exception:  # noqa: BLE001
                        logger.exception("sender on_error hook failed")
                raise
            for r in raws:
                r.release_once()
            _SEND_STATS["frames"] += nframes
            _SEND_STATS["batches"] += 1


def _send_frame_oob(sender: "_FrameSender", header: bytes, bufs: list,
                    raws=(), urgent: bool = True,
                    handoff: bool = False) -> None:
    """One frame + its raw continuation as a single scatter-gather send."""
    sender.send([_LEN.pack(len(header)), header, *bufs], raws, urgent=urgent,
                handoff=handoff)


class BoundedSet:
    """Insertion-ordered membership set with an eviction cap — for
    liveness bookkeeping (dead client ids) that must not grow without
    bound on a long-lived control plane."""

    def __init__(self, cap: int = 4096):
        self._cap = cap
        self._items: Dict[Any, None] = {}

    def add(self, item) -> None:
        self._items[item] = None
        while len(self._items) > self._cap:
            self._items.pop(next(iter(self._items)))

    def discard(self, item) -> None:
        self._items.pop(item, None)

    def __contains__(self, item) -> bool:
        return item in self._items


class RpcError(Exception):
    """Base for transport-level failures."""


class RpcConnectionError(RpcError, ConnectionError):
    """Peer unreachable / connection dropped with requests in flight."""


class RpcRemoteError(RpcError):
    """Handler raised; carries the remote traceback string."""

    def __init__(self, exc: BaseException, remote_traceback: str):
        super().__init__(f"{type(exc).__name__}: {exc}\n{remote_traceback}")
        self.cause = exc
        self.remote_traceback = remote_traceback


def _send_frame(sender: "_FrameSender", payload: bytes,
                urgent: bool = True) -> None:
    sender.send([_LEN.pack(len(payload)), payload], urgent=urgent)


class _SockReader:
    """Buffered frame reader: one ``recv`` refills up to ``BUF`` bytes and
    back-to-back small frames (the coalesced sends of the peer's
    :class:`_FrameSender`) are parsed out of the buffer with no further
    syscalls. Large reads — and zero-copy landings into a registered
    destination — bypass the buffer and ``recv_into`` the target
    directly, so bulk transfers keep their single-copy path."""

    __slots__ = ("_sock", "_buf", "_pos")

    # Below glibc's mmap threshold so the refill allocation recycles from
    # the malloc arena instead of paying mmap/munmap per recv.
    BUF = 64 * 1024

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""
        self._pos = 0

    def readexact(self, n: int):
        avail = len(self._buf) - self._pos
        if avail >= n:
            out = memoryview(self._buf)[self._pos:self._pos + n]
            self._pos += n
            return out
        out = bytearray(n)
        view = memoryview(out)
        got = 0
        if avail:
            view[:avail] = memoryview(self._buf)[self._pos:]
            got = avail
        self._buf, self._pos = b"", 0
        while got < n:
            want = n - got
            if want >= self.BUF:
                r = self._sock.recv_into(view[got:], want)
                if r == 0:
                    raise RpcConnectionError("connection closed by peer")
                got += r
                continue
            chunk = self._sock.recv(self.BUF)
            if not chunk:
                raise RpcConnectionError("connection closed by peer")
            take = min(len(chunk), want)
            view[got:got + take] = memoryview(chunk)[:take]
            got += take
            if take < len(chunk):
                self._buf, self._pos = chunk, take
        return out

    def readinto(self, dest: memoryview) -> None:
        n = dest.nbytes
        got = 0
        avail = len(self._buf) - self._pos
        if avail:
            take = min(avail, n)
            # numpy copy, not memoryview slice assignment: dest may be an
            # exotic buffer (shm arena slot) where slice assignment
            # degrades to ~75 MB/s (see serialization.fast_copy_into).
            from ray_tpu_torch.core.serialization import fast_copy_into

            fast_copy_into(dest, 0,
                           memoryview(self._buf)[self._pos:self._pos + take])
            self._pos += take
            got = take
            if self._pos >= len(self._buf):
                self._buf, self._pos = b"", 0
        while got < n:
            r = self._sock.recv_into(dest[got:], n - got)
            if r == 0:
                raise RpcConnectionError("connection closed by peer")
            got += r


def _recv_frame(reader: _SockReader, dest_resolver=None) -> Any:
    """Read one message; transparently consumes "oob" raw continuations.

    ``dest_resolver(req_id, sizes)`` (client read loops only) may return a
    writable memoryview to receive a single-buffer continuation directly —
    the zero-copy landing path for chunked object pulls. Returns the
    message, with out-of-band buffers reconstructed as views."""
    (length,) = _LEN.unpack(reader.readexact(_LEN.size))
    if length > MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    msg = pickle.loads(reader.readexact(length))
    if not (isinstance(msg, tuple) and msg and msg[0] == "oob"):
        return msg
    _, req_id, sizes, inner = msg
    total = sum(sizes)
    if total > MAX_FRAME:
        raise RpcError(f"oob continuation too large: {total}")
    dest = None
    if dest_resolver is not None and len(sizes) == 1:
        dest = dest_resolver(req_id, sizes[0])
    if dest is not None:
        reader.readinto(dest)
        views = [dest]
    else:
        scratch = memoryview(bytearray(total))
        reader.readinto(scratch)
        views, off = [], 0
        for s in sizes:
            views.append(scratch[off:off + s])
            off += s
    return pickle.loads(inner, buffers=views)


def _dumps(message: Tuple) -> bytes:
    import cloudpickle

    from ray_tpu_torch.core.serialization import _FastPickler

    try:
        import io as _io

        out = _io.BytesIO()
        _FastPickler(out, protocol=pickle.HIGHEST_PROTOCOL).dump(message)
        return out.getvalue()
    except Exception:  # noqa: BLE001 — __main__-defined / unpicklable parts
        return cloudpickle.dumps(message, protocol=pickle.HIGHEST_PROTOCOL)


class RpcServer:
    """Threaded RPC server dispatching to a handler object's public methods.

    The reference declares services in .proto and generates servers per
    service (``src/ray/rpc/gcs_server/``, ``node_manager/``, ``worker/``);
    here any object is a service — its public methods are the RPC surface.
    Handlers run on a shared pool so slow calls (task execution, long-poll
    subscriptions) don't block the accept or read loops.
    """

    # Grace period after a client's LAST connection drops before its death
    # cleanup fires — a transient drop + lazy reconnect must not read as a
    # client death (the reference's gRPC channels reconnect the same way).
    CLIENT_DEATH_GRACE_S = 5.0

    def __init__(self, handler: Any, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 64, name: str = "rpc",
                 auth_token: Optional[bytes] = None):
        self._handler = handler
        self._name = name
        self._token = _auth_token() if auth_token is None else auth_token
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.address = f"{host}:{self._sock.getsockname()[1]}"
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix=f"{name}-h")
        self._max_workers = max_workers
        self._depth_lock = threading.Lock()
        self._in_flight = 0           # pooled calls submitted, not returned
        self._last_full_warning = 0.0
        self._stopped = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        # Client identity: live-connection counts per client id (the hello
        # frame), so cleanup keys on CLIENT death, not connection churn.
        self._client_conns: Dict[str, int] = {}
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{name}-accept", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._conn_loop, args=(conn,),
                name=f"{self._name}-conn", daemon=True,
            ).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        sender = _FrameSender(conn)
        reader = _SockReader(conn)
        client_id = ""
        try:
            token = self._token
            if token:
                # First frame must be the raw (unpickled!) auth blob;
                # anything else — wrong token, or a peer without one —
                # closes the socket before pickle ever sees peer bytes.
                import hmac

                (length,) = _LEN.unpack(reader.readexact(_LEN.size))
                if length > 4096:
                    raise RpcConnectionError("oversized auth frame")
                blob = bytes(reader.readexact(length))
                if not hmac.compare_digest(blob, _AUTH_MAGIC + token):
                    logger.warning("%s: rejected connection with bad auth "
                                   "token", self._name)
                    raise RpcConnectionError("bad auth token")
            while not self._stopped.is_set():
                kind, req_id, method, data = _recv_frame(reader)
                if kind == "tmpl":
                    # Task-spec template registration: handled HERE, on the
                    # connection loop, so it is ordered BEFORE any pooled
                    # request that references it by digest.
                    hook = getattr(self._handler, "register_spec_template",
                                   None)
                    if hook is not None:
                        try:
                            hook(*data)
                        except Exception:  # noqa: BLE001
                            logger.exception("%s: register_spec_template "
                                             "failed", self._name)
                elif kind == "hello":
                    # Client identity frame (sent once right after connect):
                    # a stable id across this client's reconnects.
                    if not client_id and isinstance(data, str):
                        client_id = data
                        # Increment + ban-lift atomically under _conns_lock,
                        # ordered against the death-grace timer's re-check
                        # (see _on_client_conn_closed).
                        with self._conns_lock:
                            self._client_conns[client_id] = (
                                self._client_conns.get(client_id, 0) + 1)
                            hook = getattr(self._handler, "on_client_opened",
                                           None)
                            if hook is not None:
                                try:
                                    hook(client_id)
                                except Exception:  # noqa: BLE001
                                    logger.exception(
                                        "%s: on_client_opened failed",
                                        self._name)
                elif kind == "note":
                    self._submit(self._run_note, method, data)
                elif kind == "req":
                    fn = getattr(self._handler, method, None)
                    if getattr(fn, "_rpc_inline", False):
                        # Short, never-blocking handlers (liveness) run
                        # here, ahead of whatever fills the pool.
                        self._run_request(sender, req_id, method, data,
                                          client_id)
                    else:
                        self._submit(self._run_request, sender, req_id,
                                     method, data, client_id)
        except (RpcConnectionError, OSError):
            pass
        finally:
            sender.close()
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass
            if client_id:
                self._on_client_conn_closed(client_id)

    def _on_client_conn_closed(self, client_id: str) -> None:
        """Client-death detection: when a client's LAST connection closes,
        wait a grace period (transient drops reconnect lazily), then fire
        the handler's cleanup — the analog of raylet DisconnectClient on
        gRPC channel breakage, minus the churn sensitivity."""
        with self._conns_lock:
            n = self._client_conns.get(client_id, 1) - 1
            if n > 0:
                self._client_conns[client_id] = n
                return
            self._client_conns.pop(client_id, None)
        hook = getattr(self._handler, "on_client_closed", None)
        if hook is None:
            return

        def check():
            # Liveness re-check and the death hook run under ONE hold of
            # _conns_lock, atomically ordered against the hello path (which
            # increments + lifts bans under the same lock) — otherwise a
            # reconnect landing between the check and the hook would be
            # banned forever.
            with self._conns_lock:
                if self._client_conns.get(client_id, 0) > 0:
                    return  # client reconnected within the grace period
                try:
                    hook(client_id)
                except Exception:  # noqa: BLE001
                    logger.exception("%s: on_client_closed failed", self._name)

        timer = threading.Timer(self.CLIENT_DEATH_GRACE_S, check)
        timer.daemon = True
        timer.start()

    def _submit(self, fn, *args) -> None:
        """Run ``fn`` on the handler pool, counting the calls in flight; a
        pool with every thread taken logs a warning (at most one every 10
        s): what arrives then waits for a blocking call to return."""
        with self._depth_lock:
            self._in_flight += 1
            full = self._in_flight > self._max_workers
            now = time.monotonic()
            warn = full and now - self._last_full_warning > 10.0
            if warn:
                self._last_full_warning = now
        if warn:
            logger.warning("%s: handler pool full: %d calls in flight on %d "
                           "threads", self._name, self._in_flight,
                           self._max_workers)

        def run():
            try:
                fn(*args)
            finally:
                with self._depth_lock:
                    self._in_flight -= 1

        self._pool.submit(run)

    def _run_note(self, method: str, data: Tuple) -> None:
        try:
            args, kwargs = data
            getattr(self._handler, method)(*args, **kwargs)
        except Exception:
            logger.exception("%s: notification %s failed", self._name, method)

    def _run_request(self, sender, req_id, method, data,
                     client_id: str = "") -> None:
        bufs: list = []
        raws: list = []
        try:
            args, kwargs = data
            fn = getattr(self._handler, method, None)
            if fn is None or method.startswith("_"):
                raise AttributeError(f"no RPC method '{method}'")
            if getattr(fn, "_rpc_wants_conn", False):
                kwargs = dict(kwargs, _client_id=client_id)
            result = fn(*args, **kwargs)
            frame, bufs, raws = _dumps_frame(("rep", req_id, method, result))
        except BaseException as exc:  # noqa: BLE001 — propagate to caller
            tb = traceback.format_exc()
            try:
                frame = _dumps(("err", req_id, method, (exc, tb)))
            except Exception:
                # Unpicklable exception: degrade to a plain RuntimeError.
                frame = _dumps(
                    ("err", req_id, method,
                     (RuntimeError(f"{type(exc).__name__}: {exc}"), tb))
                )
        try:
            # Replies are coalescable (urgent=False): consecutive small
            # task-finish reports ride ONE scatter-gather syscall to the
            # owner when produced faster than the socket drains.
            _send_frame_oob(sender, frame, bufs, raws, urgent=False)
        except OSError:
            pass  # caller is gone; sender released the raws

    def stop(self) -> None:
        self._stopped.set()
        # shutdown() BEFORE close(): close() alone frees the fd but does
        # NOT wake a thread already parked in accept()/recv() on it — the
        # accept thread would survive every server stop (and could even
        # accept on a recycled fd number). shutdown() forces those calls
        # to return with an error first.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            for conn in list(self._conns):
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._accept_thread.join(timeout=2.0)


# Sentinel: a registered reply destination that the read loop has filled.
_DEST_WRITTEN = memoryview(b"")


class RpcClient:
    """Thread-safe client with multiplexed in-flight requests.

    Mirrors the reference's retryable gRPC client (``src/ray/rpc/
    retryable_grpc_client.h``) minimally: one TCP connection, a reader thread
    resolving futures by request id; connection loss fails every in-flight
    call with :class:`RpcConnectionError` (callers own retry policy, exactly
    as core-worker transports do in the reference).
    """

    def __init__(self, address: str, connect_timeout: Optional[float] = None,
                 auth_token: Optional[bytes] = None):
        import uuid

        self.address = address
        # None -> the rpc_connect_timeout_s config knob (10s default).
        self._timeout = (_connect_timeout_default() if connect_timeout is None
                         else connect_timeout)
        self._token = _auth_token() if auth_token is None else auth_token
        # Stable across reconnects: servers key liveness-scoped state
        # (leases, leased workers) on this, not on TCP connections.
        self.client_id = uuid.uuid4().hex
        self._sock: Optional[socket.socket] = None
        self._sender: Optional[_FrameSender] = None
        # Task-spec template digests this CONNECTION's server has been sent
        # (reset with the socket: a fresh server process knows nothing).
        self._sent_templates: set = set()
        self._state_lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        # req_id → writable memoryview: replies for these ids land their
        # raw continuation directly in the buffer (zero-copy pulls).
        self._pending_dest: Dict[int, memoryview] = {}
        self._next_id = 0
        self._closed = False

    # -- connection management ------------------------------------------------

    def _ensure_connected(self) -> socket.socket:
        with self._state_lock:
            if self._closed:
                raise RpcConnectionError("client closed")
            if self._sock is not None:
                return self._sock
        # Dial + handshake OUTSIDE the state lock: a slow connect (dead
        # peer, SYN backlog) must not block unrelated senders/flushes on
        # this client for the whole connect timeout.
        host, port = self.address.rsplit(":", 1)
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=self._timeout)
        except OSError as e:
            flightrec.record("rpc", self.address, f"connect fail: {e}")
            raise RpcConnectionError(
                f"cannot connect to {self.address}: {e}"
            ) from e
        try:
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            token = self._token
            if token:
                blob = _AUTH_MAGIC + token
                try:
                    sock.sendall(_LEN.pack(len(blob)) + blob)
                except OSError as e:
                    raise RpcConnectionError(
                        f"auth handshake to {self.address} failed: {e}"
                    ) from e
            hello = _dumps(("hello", 0, "", self.client_id))
            try:
                sock.sendall(_LEN.pack(len(hello)) + hello)
            except OSError as e:
                raise RpcConnectionError(
                    f"hello to {self.address} failed: {e}") from e
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        with self._state_lock:
            if self._closed or self._sock is not None:
                # Lost the connect race (or the client closed meanwhile):
                # discard ours — the server saw hello open+close, which the
                # death-grace counting tolerates.
                try:
                    sock.close()
                except OSError:
                    pass
                if self._closed:
                    raise RpcConnectionError("client closed")
                return self._sock
            self._sock = sock
            self._sender = _FrameSender(sock, on_error=self._on_send_error)
            self._sent_templates = set()
            threading.Thread(
                target=self._read_loop, args=(sock,),
                name=f"rpc-read-{self.address}", daemon=True,
            ).start()
            flightrec.record("rpc", self.address, "connected")
            return sock

    def _resolve_dest(self, req_id: int, size: int):
        """Hand the read loop a registered landing buffer for this reply's
        raw continuation — only when the size matches exactly (a partial
        chunk or an unexpected reply shape falls back to the scratch path)."""
        with self._state_lock:
            dest = self._pending_dest.get(req_id)
            if dest is None or dest.nbytes != size:
                return None
            # Consumed: mark so the caller knows the bytes are in place.
            self._pending_dest[req_id] = _DEST_WRITTEN
            return dest

    def _read_loop(self, sock: socket.socket) -> None:
        reader = _SockReader(sock)
        try:
            while True:
                kind, req_id, _method, data = _recv_frame(
                    reader, dest_resolver=self._resolve_dest)
                with self._state_lock:
                    fut = self._pending.pop(req_id, None)
                    dest_state = self._pending_dest.pop(req_id, None)
                if fut is None:
                    continue
                if dest_state is _DEST_WRITTEN:
                    fut.dest_written = True  # read by PullManager.pull_into
                if kind == "rep":
                    fut.set_result(data)
                else:
                    exc, tb = data
                    fut.set_exception(RpcRemoteError(exc, tb))
        except BaseException as e:  # noqa: BLE001 — any reader death must
            # fail in-flight calls, else callers hang forever (e.g. an
            # AttributeError unpickling a class the peer defined in __main__).
            self._fail_all(RpcConnectionError(f"connection to {self.address} lost: {e}"))

    def _on_send_error(self, exc: BaseException) -> None:
        """Drain-thread send failure: the enqueuing caller may already have
        returned, so surface it by failing every in-flight future."""
        self._fail_all(RpcConnectionError(
            f"send to {self.address} failed: {exc}"))

    def _fail_all(self, error: Exception) -> None:
        with self._state_lock:
            if self._pending and not self._closed:
                # Only meaningful losses (in-flight calls failed), not
                # plain close() teardown — the ring is for postmortems.
                flightrec.record("rpc", self.address,
                                 f"lost {len(self._pending)} in-flight")
            pending, self._pending = self._pending, {}
            self._pending_dest.clear()
            self._sent_templates = set()
            sender, self._sender = self._sender, None
            if self._sock is not None:
                # shutdown() first: close() does not wake the reader
                # thread parked in recv() on this socket — it would leak
                # (with its fd) on every client close.
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
        if sender is not None:
            sender.close(error)
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(error)

    # -- calls ------------------------------------------------------------------

    def call_async(self, method: str, *args,
                   _dest: Optional[memoryview] = None,
                   _handoff: bool = False, **kwargs) -> Future:
        """``_dest``: optional writable buffer; if the reply carries exactly
        one out-of-band payload of ``_dest.nbytes``, it is received straight
        into it and ``fut.dest_written`` is True. ``_handoff``: queue the
        frame for the connection's helper drainer instead of sending inline
        — pipelined submitters coalesce their requests this way."""
        self._ensure_connected()
        with self._state_lock:
            sender = self._sender
            if sender is None:
                raise RpcConnectionError(
                    f"connection to {self.address} lost")
            req_id = self._next_id
            self._next_id += 1
            fut: Future = Future()
            fut.req_id = req_id  # for release_dests on abandoned calls
            self._pending[req_id] = fut
            if _dest is not None:
                self._pending_dest[req_id] = memoryview(_dest).cast("B")
        frame, bufs, raws = _dumps_frame(("req", req_id, method, (args, kwargs)))
        try:
            _send_frame_oob(sender, frame, bufs, raws, handoff=_handoff)
        except OSError as e:
            self._fail_all(RpcConnectionError(f"send to {self.address} failed: {e}"))
        return fut

    def flush(self) -> None:
        """Push any coalescer-held frames out now (called before blocking
        waits so a pending request never sits behind the window)."""
        sender = self._sender
        if sender is not None:
            sender.flush()

    # -- task-spec template cache (see task_spec.SpecEncoder) ----------------

    def template_cached(self, digest: bytes) -> bool:
        return digest in self._sent_templates

    def forget_template(self, digest: bytes) -> None:
        self._sent_templates.discard(digest)

    def send_template(self, digest: bytes, blob: bytes) -> None:
        """Ship a spec template to the peer; ordered BEFORE any subsequent
        request on this connection (FIFO send queue + in-order conn loop)."""
        self._ensure_connected()
        with self._state_lock:
            sender = self._sender
        if sender is None:
            raise RpcConnectionError(f"connection to {self.address} lost")
        frame = _dumps(("tmpl", 0, "", (digest, blob)))
        try:
            _send_frame(sender, frame)
        except OSError as e:
            self._fail_all(RpcConnectionError(
                f"send to {self.address} failed: {e}"))
            raise RpcConnectionError(str(e)) from e
        self._sent_templates.add(digest)

    def call(self, method: str, *args, timeout: Optional[float] = None, **kwargs):
        trace_start = self._trace_call_start()
        fut = self.call_async(method, *args, **kwargs)
        self.flush()
        try:
            return fut.result(timeout=timeout)
        except RpcRemoteError as e:
            # Re-raise the original exception type when it round-tripped, so
            # callers catch domain errors (ValueError, TaskError...) natively.
            raise e.cause from e
        finally:
            if trace_start is not None:
                self._trace_call_end(method, trace_start)

    def _trace_call_start(self):
        """Opt-in (``trace_rpc_enabled``) client-side rpc spans, only for
        calls reachable from a SAMPLED trace context — which inherently
        keeps the span-export path itself (flusher threads carry no
        context) out of the trace. Off: one flag check."""
        from ray_tpu_torch.util import tracing

        if not tracing.is_sampled():
            return None
        try:
            from ray_tpu_torch.core.config import config

            if not config().trace_rpc_enabled:
                return None
        except Exception:  # noqa: BLE001 — config unavailable mid-teardown
            return None
        return (tracing.current_context(), time.monotonic())

    def _trace_call_end(self, method: str, trace_start) -> None:
        from ray_tpu_torch.util import tracing

        ctx, t0 = trace_start
        tracing.emit(f"rpc.{method}", ctx,
                     duration=time.monotonic() - t0,
                     attrs={"addr": self.address})

    def release_dests(self, futs, wait_timeout: float = 30.0) -> None:
        """Revoke the registered reply destinations of abandoned calls.

        A caller that gives up on ``_dest`` calls (timeout, partial-chunk
        failure) MUST revoke before freeing the destination memory — a
        late-arriving reply would otherwise be received straight into a
        buffer that now belongs to someone else. Unconsumed registrations
        are removed under the state lock (the read loop then falls back to
        scratch); a registration the read loop has already claimed is
        mid-``recv_into``, so we block on that future, and if it doesn't
        resolve in ``wait_timeout`` the connection is torn down — killing
        the socket is the only way to stop an in-flight landing."""
        consumed = []
        with self._state_lock:
            for fut in futs:
                req_id = getattr(fut, "req_id", None)
                if req_id is None:
                    continue
                dest = self._pending_dest.get(req_id)
                if dest is None:
                    continue
                if dest is _DEST_WRITTEN:
                    consumed.append(fut)
                else:
                    del self._pending_dest[req_id]
        for fut in consumed:
            try:
                fut.result(timeout=wait_timeout)
            except Exception:  # noqa: BLE001 — includes our own timeout
                if not fut.done():
                    self._fail_all(RpcConnectionError(
                        "connection torn down: abandoned zero-copy landing "
                        "did not complete"))

    def notify(self, method: str, *args, **kwargs) -> None:
        self._ensure_connected()
        with self._state_lock:
            sender = self._sender
        if sender is None:
            raise RpcConnectionError(f"connection to {self.address} lost")
        frame, bufs, raws = _dumps_frame(("note", 0, method, (args, kwargs)))
        try:
            # One-way notes are coalescable: nobody blocks on them, so they
            # may ride the adaptive window with other frames.
            _send_frame_oob(sender, frame, bufs, raws, urgent=False)
        except OSError as e:
            self._fail_all(RpcConnectionError(f"send to {self.address} failed: {e}"))
            raise RpcConnectionError(str(e)) from e

    def close(self) -> None:
        with self._state_lock:
            self._closed = True
        self._fail_all(RpcConnectionError("client closed"))

    def __repr__(self):
        return f"RpcClient({self.address})"


class RpcClientPool:
    """Cached clients keyed by address (reference: client pools in
    ``src/ray/rpc/*_client_pool.h``)."""

    def __init__(self, connect_timeout: Optional[float] = None):
        self._timeout = connect_timeout
        self._clients: Dict[str, RpcClient] = {}
        self._lock = threading.Lock()

    def get(self, address: str) -> RpcClient:
        with self._lock:
            client = self._clients.get(address)
            if client is None:
                client = RpcClient(address, connect_timeout=self._timeout)
                self._clients[address] = client
            return client

    def invalidate(self, address: str) -> None:
        with self._lock:
            client = self._clients.pop(address, None)
        if client is not None:
            client.close()

    def close_all(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()

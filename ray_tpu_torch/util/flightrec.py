"""Per-process black-box flight recorder — a crash-surviving event ring.

Counterpart of ``ray_tpu/util/flightrec.py``, the same ring format
(``RTFR1``), so the JAX package's reader decodes the port's rings and the
other way round.

The third observability pillar next to the metrics plane and request
tracing: both of those only observe live, orderly processes, so a killed
process takes its last state with it. Every process that calls
:func:`init` appends compact binary events to a bounded mmap'd ring file
under the session dir at each state transition that matters for a
postmortem, at the same sites as the JAX package: task and actor lifecycle
edges in the core runtime, the GCS, the node daemons and the workers, RPC
connect/fail, lease grant/carve/revoke, DAG channel stall/resume, serve
admission and sheds, collective enter/exit. The kernel owns the dirty
pages, so the file is readable by ``ray-tpu-torch debug``
(``devtools/postmortem.py``) after the process is gone, no flush required.

Ring format (version ``RTFR1``): a 64-byte header followed by fixed
128-byte slots. Fixed slots make wraparound trivial and keep a torn
write (SIGKILL mid-record) confined to one decodable-or-skippable slot:

==========  ============================================================
header      ``<8sIIQQd24s`` — magic ``RTFR1\\0\\0\\0``, slot size, slot
            count, total records written, pid, start wall ts, component
slot        ``<QdBBH2x32s74s`` — seq (1-based, 0 = never written), wall
            ts, category code, subject length, detail length, subject
            (≤32 bytes), detail (≤74 bytes)
==========  ============================================================

Writers are lock-free: sequence numbers come from ``itertools.count``
(atomic under the GIL) and each record is a single ``pack_into`` at
``seq % nslots`` — no lock, no syscall, ~1 µs. Readers scan every slot,
keep non-zero seqs, and sort; a torn slot decodes as garbage text at
worst and is skipped, never corrupts its neighbors.

Knobs: ``flightrec_enabled`` (off = one ``None`` check per record site),
``flightrec_ring_kb`` (ring size per process). The session dir comes
from ``RAY_TPU_SESSION_DIR`` (exported by :func:`init` so spawned
processes land their rings next to this one's).
"""

from __future__ import annotations

import itertools
import mmap
import os
import struct
import tempfile
import time
from typing import Any, Dict, List, Optional

MAGIC = b"RTFR1\0\0\0"
_HEADER = struct.Struct("<8sIIQQd24s")
_SLOT = struct.Struct("<QdBBH2x32s74s")
SLOT_SIZE = 128
SUBJECT_MAX = 32
DETAIL_MAX = 74

assert _HEADER.size == 64 and _SLOT.size == SLOT_SIZE

# Category codes are part of the on-disk format: append-only, never renumber.
CATEGORIES = {
    "other": 0, "task": 1, "actor": 2, "rpc": 3, "lease": 4, "channel": 5,
    "serve": 6, "collective": 7, "health": 8, "process": 9,
}
_CATEGORY_NAMES = {v: k for k, v in CATEGORIES.items()}

ENV_SESSION_DIR = "RAY_TPU_SESSION_DIR"


def session_dir() -> str:
    """The directory ring files live in (shared by a whole cluster run):
    ``RAY_TPU_SESSION_DIR``, else ``ray_tpu_flightrec`` under the temporary
    directory (TMPDIR; the JAX package's default is /tmp/ray_tpu_flightrec)."""
    return (os.environ.get(ENV_SESSION_DIR)
            or os.path.join(tempfile.gettempdir(), "ray_tpu_flightrec"))


class FlightRecorder:
    """One process's mmap'd event ring. Use the module-level :func:`record`
    in instrumentation sites — it is a no-op until :func:`init` ran."""

    def __init__(self, path: str, component: str, ring_kb: int = 256):
        self.path = path
        self.component = component
        nslots = max(64, (max(1, int(ring_kb)) * 1024) // SLOT_SIZE)
        self.nslots = nslots
        size = _HEADER.size + nslots * SLOT_SIZE
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)  # the mmap keeps its own reference
        self._seq = itertools.count(1)
        self.last_write_ts = 0.0
        self._closed = False
        _HEADER.pack_into(self._mm, 0, MAGIC, SLOT_SIZE, nslots, 0,
                          os.getpid(), time.time(),
                          component.encode()[:24])

    def record(self, category: str, subject: str, detail: str = "") -> None:
        """Append one event. Never raises and never blocks — a black box
        that can take down the plane is worse than none."""
        try:
            mm = self._mm
            if self._closed:
                return
            seq = next(self._seq)  # GIL-atomic: no lock on the hot path
            ts = time.time()
            _SLOT.pack_into(
                mm, _HEADER.size + ((seq - 1) % self.nslots) * SLOT_SIZE,
                seq, ts, CATEGORIES.get(category, 0),
                0, 0,  # lengths are implied by NUL padding; kept for v2 use
                subject.encode("utf-8", "replace")[:SUBJECT_MAX],
                detail.encode("utf-8", "replace")[:DETAIL_MAX])
            # Total-written counter for readers; last-writer-wins is fine.
            struct.pack_into("<Q", mm, 16, seq)
            self.last_write_ts = ts
        except Exception:  # noqa: BLE001 — crash-recording must not crash
            from ray_tpu_torch.utils.logging import get_logger, log_swallowed

            log_swallowed(get_logger("flightrec"), "ring record")

    def close(self) -> None:
        """Detach the mmap (leaves the file for postmortems). Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            self._mm.close()
        except (OSError, BufferError):
            pass


# -- reader half (postmortem: works on rings of dead processes) --------------


def read_ring(path: str) -> Dict[str, Any]:
    """Decode one ring file into ``{component, pid, start_ts, written,
    nslots, events}`` with events ordered by sequence number. Torn or
    garbage slots are skipped, not fatal — the file may have been written
    right up to a SIGKILL."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HEADER.size:
        raise ValueError(f"{path}: truncated flight-recorder ring")
    magic, slot_size, nslots, written, pid, start_ts, comp = \
        _HEADER.unpack_from(raw, 0)
    if magic != MAGIC or slot_size != SLOT_SIZE:
        raise ValueError(f"{path}: not a flight-recorder ring")
    events: List[Dict[str, Any]] = []
    usable = min(nslots, (len(raw) - _HEADER.size) // SLOT_SIZE)
    for i in range(usable):
        seq, ts, cat, _sl, _dl, subj, detail = _SLOT.unpack_from(
            raw, _HEADER.size + i * SLOT_SIZE)
        if seq == 0 or seq > written + nslots:  # empty or torn-garbage
            continue
        events.append({
            "seq": seq, "ts": ts,
            "category": _CATEGORY_NAMES.get(cat, "other"),
            "subject": subj.rstrip(b"\0").decode("utf-8", "replace"),
            "detail": detail.rstrip(b"\0").decode("utf-8", "replace"),
        })
    events.sort(key=lambda e: e["seq"])
    return {"path": path, "component": comp.rstrip(b"\0").decode(),
            "pid": pid, "start_ts": start_ts, "written": written,
            "nslots": nslots, "events": events}


def discover_rings(directory: Optional[str] = None) -> List[str]:
    """All ring files under the session dir, oldest-mtime first."""
    directory = directory or session_dir()
    try:
        names = [n for n in os.listdir(directory) if n.endswith(".ring")]
    except OSError:
        return []
    paths = [os.path.join(directory, n) for n in names]
    return sorted(paths, key=lambda p: (os.path.getmtime(p)
                                        if os.path.exists(p) else 0.0))


# -- module-level singleton (what instrumentation sites call) ----------------

_REC: Optional[FlightRecorder] = None
_beacon_installed = False


def init(component: str) -> Optional[FlightRecorder]:
    """Open this process's ring (``<session_dir>/<component>-<pid>.ring``)
    if ``flightrec_enabled``. Idempotent; never raises. Exports the
    session dir into the environment so spawned children (cluster
    daemons, workers) record into the same directory, and registers the
    progress-beacon collector so ``ray_tpu_flightrec_last_write_ts``
    rides this process's metrics report."""
    global _REC, _beacon_installed
    if _REC is not None:
        return _REC
    try:
        from ray_tpu_torch.core.config import config

        if not config().flightrec_enabled:
            return None
        directory = session_dir()
        os.environ.setdefault(ENV_SESSION_DIR, directory)
        os.makedirs(directory, exist_ok=True)
        _REC = FlightRecorder(
            os.path.join(directory, f"{component}-{os.getpid()}.ring"),
            component, ring_kb=config().flightrec_ring_kb)
        if not _beacon_installed:
            _beacon_installed = True
            from ray_tpu_torch.util import metrics as um

            um.register_collector(_beacon_collector)
        _REC.record("process", component, "start")
        return _REC
    except Exception:  # noqa: BLE001 — a read-only fs must not block boot
        _REC = None
        return None


def recorder() -> Optional[FlightRecorder]:
    return _REC


def record(category: str, subject: str, detail: str = "") -> None:
    """Hot-path append; one global load + None check when disabled."""
    rec = _REC
    if rec is not None:
        rec.record(category, subject, detail)


def last_write_ts() -> float:
    rec = _REC
    return rec.last_write_ts if rec is not None else 0.0


def close() -> None:
    """Detach this process's ring (clean shutdown; the file stays for
    postmortems). The module singleton resets so tests can re-init."""
    global _REC
    rec, _REC = _REC, None
    if rec is not None:
        rec.record("process", rec.component, "shutdown")
        rec.close()


def _beacon_collector() -> None:
    """Progress beacon: ship the last ring-write wall ts on the normal
    metrics report — the watchdog reads it out of the GCS aggregator to
    tell a stalled process (beacon frozen) from an idle one (beacon
    absent or fresh heartbeats). Registered once; no-op once closed."""
    rec = _REC
    if rec is None or rec.last_write_ts == 0.0:
        return
    from ray_tpu_torch.core.metrics_export import gauge

    gauge("ray_tpu_flightrec_last_write_ts",
          "Wall timestamp of this process's last flight-recorder write "
          "(the health watchdog's progress beacon)").set(rec.last_write_ts)

"""Daemon-local lease table — carve per-task worker leases from capacity blocks.

Analog of the reference's raylet-side ``cluster_task_manager`` /
``local_task_manager`` split (PAPER.md L1/L2): the GCS stops being the
per-task scheduler and instead grants a node a revocable *capacity block* —
N units of one resource shape — keyed ``cap-<n>``. The node daemon owns this
table and carves per-task leases (``cap-<n>#<seq>``) out of a block locally,
so a deep scheduling-key queue costs one GCS round trip instead of one per
task. Unused capacity flows back on idle TTL (``sweep_idle``) or on explicit
GCS revocation (client death reclaim, ``revoke``).

A block id that the sweep or a revocation dropped is remembered in a
bounded tombstone set: its units already belong to the GCS again, so a late
adopt (the GCS push) or a late carve carrying the adopt hint must not
re-create it. The carve gets None and the submitter asks the GCS anew. The
JAX package's table has no tombstone and re-adopts such a block.

Single-lock design: every block mutation is a dict/int update under one
plain ``Lock``; nothing blocks under it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.util import flightrec

# Capacity-block lease ids are namespaced so every release path can route a
# lease to the right authority: "lease-N" → GCS release_lease, "cap-N#k" →
# daemon-local LocalLeaseTable.release.
BLOCK_PREFIX = "cap-"
# Block ids remembered as dropped (an id carries its GCS incarnation's
# epoch, so it never comes back); the oldest are forgotten first.
TOMBSTONE_CAP = 4096


def is_block_lease(lease_id: Optional[str]) -> bool:
    """True for leases carved from a daemon-local capacity block."""
    return bool(lease_id) and str(lease_id).startswith(BLOCK_PREFIX)


def block_of(lease_id: str) -> str:
    """The owning block id of a carved lease (``cap-3#7`` → ``cap-3``)."""
    return str(lease_id).split("#", 1)[0]


class _BlockState:
    __slots__ = ("block_id", "shape", "free", "in_use", "next_seq",
                 "revoked", "pinned", "last_activity")

    def __init__(self, block_id: str, shape: Dict[str, float], total: int,
                 pinned: bool = False):
        self.block_id = block_id
        self.shape = dict(shape)
        self.free = int(total)
        self.in_use: set = set()
        self.next_seq = 0
        self.revoked = False
        # Pinned blocks back a gang placement-group reservation: the idle
        # sweep must never ship their units back to the GCS (the bundle
        # accounting there still owns them). They leave only via revoke.
        self.pinned = bool(pinned)
        self.last_activity = time.monotonic()


class LocalLeaseTable:
    """Per-daemon table of GCS-granted capacity blocks and carved leases."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blocks: Dict[str, _BlockState] = {}
        # Swept or revoked block ids, insertion-ordered (see the module
        # docstring). Mutated under _lock.
        self._dead: "collections.OrderedDict[str, None]" = (
            collections.OrderedDict())

    def _bury_locked(self, block_id: str) -> None:
        """Drop ``block_id`` and remember it as dead. Caller holds _lock."""
        self._blocks.pop(block_id, None)
        self._dead[block_id] = None
        while len(self._dead) > TOMBSTONE_CAP:
            self._dead.popitem(last=False)

    def adopt(self, block_id: str, shape: Dict[str, float], total: int,
              pinned: bool = False) -> None:
        """Record a GCS-granted block. Idempotent — the grant may arrive both
        as a GCS push and as the first client carve's inline hint. Gang
        bundle blocks arrive ``pinned`` (exempt from the idle sweep). A
        block already swept or revoked stays dead."""
        with self._lock:
            if block_id in self._blocks or block_id in self._dead:
                return
            self._blocks[block_id] = _BlockState(block_id, shape, total, pinned)
        flightrec.record("lease", block_id,
                         f"adopt x{int(total)}" + (" pinned" if pinned else ""))

    def carve(self, block_id: str, shape: Optional[Dict[str, float]] = None,
              total: Optional[int] = None) -> Optional[str]:
        """Carve one per-task lease out of ``block_id``; None when the block
        is unknown/revoked/exhausted. ``shape``/``total`` let the first
        client touch adopt the block when the GCS push lost the race, unless
        the block was already swept or revoked."""
        with self._lock:
            st = self._blocks.get(block_id)
            if (st is None and shape is not None and total is not None
                    and block_id not in self._dead):
                st = _BlockState(block_id, shape, total)
                self._blocks[block_id] = st
            if st is None or st.revoked or st.free <= 0:
                return None
            st.free -= 1
            lease_id = f"{block_id}#{st.next_seq}"
            st.next_seq += 1
            st.in_use.add(lease_id)
            st.last_activity = time.monotonic()
        flightrec.record("lease", lease_id, f"carve free={st.free}")
        return lease_id

    def release(self, lease_id: str) -> bool:
        """Return a carved lease's unit to its block's free pool. Revoked
        blocks don't get the unit back (the GCS already reclaimed it); empty
        revoked blocks are dropped."""
        with self._lock:
            st = self._blocks.get(block_of(lease_id))
            if st is None or lease_id not in st.in_use:
                return False
            st.in_use.discard(lease_id)
            if not st.revoked:
                st.free += 1
                st.last_activity = time.monotonic()
            elif not st.in_use:
                self._bury_locked(st.block_id)
        flightrec.record("lease", lease_id, "release")
        return True

    def revoke(self, block_id: str) -> None:
        """GCS reclaim: stop carving and drop the free pool NOW; in-use
        leases finish their tasks but their units never return here."""
        with self._lock:
            st = self._blocks.get(block_id)
            if st is None:
                # Revoked before any adopt landed: a late one stays dead.
                self._bury_locked(block_id)
                return
            st.revoked = True
            st.free = 0
            if not st.in_use:
                self._bury_locked(block_id)
        flightrec.record("lease", block_id, "revoke")

    def sweep_idle(self, ttl_s: float) -> List[Tuple[str, int]]:
        """Remove and return ``(block_id, n_free)`` for blocks whose free
        pool sat untouched for > ttl_s — the caller ships those units back
        to the GCS (``return_block_capacity``)."""
        now = time.monotonic()
        out: List[Tuple[str, int]] = []
        with self._lock:
            for st in list(self._blocks.values()):
                if st.revoked or st.pinned or st.free <= 0:
                    continue
                if now - st.last_activity > ttl_s:
                    out.append((st.block_id, st.free))
                    st.free = 0
                    if not st.in_use:
                        self._bury_locked(st.block_id)
        return out

    def unsweep(self, block_id: str, n: int) -> None:
        """Roll a failed capacity return back into the local free pool (the
        GCS was unreachable; retry next sweep)."""
        with self._lock:
            st = self._blocks.get(block_id)
            if st is None:
                return
            st.free += int(n)
            st.last_activity = time.monotonic()

    # -- introspection (tests, daemon stats) ----------------------------------

    def stats(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                bid: {"shape": dict(st.shape), "free": st.free,
                      "in_use": len(st.in_use), "revoked": st.revoked,
                      "pinned": st.pinned}
                for bid, st in self._blocks.items()
            }

    def free_units(self, block_id: str) -> int:
        with self._lock:
            st = self._blocks.get(block_id)
            return st.free if st is not None else 0

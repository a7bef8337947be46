"""Cluster-wide KV tier: spilled prefix chains as shared cluster objects.

The paged engine's prefix cache (``models/generate.KVBlockManager``) is
engine-private: two replicas never share a block, and a downscaled replica
takes every warm session with it. This module promotes retired chains to
the object plane:

- **Spill** — the engine's retire path extracts a chain's FULL blocks off
  device, wraps them in an immutable content-addressed payload (keyed by
  the chain's ``prefix_head_hash``) and publishes it here: payload into the
  object store, locator into the cluster **prefix directory**
  (``core/gcs_shards.ShardedPrefixDirectory`` on the GCS — digest →
  (object id, token count, replica hint), refcounted per publisher).
- **Fetch** — a prefill whose LOCAL lookup missed probes the directory
  with the prompt's chained digests; a hit pulls the payload back (the
  runtime ``get`` path — striped multi-source pulls on a multiprocess
  cluster) and the engine inserts the blocks into its own pool instead of
  recomputing prefill. A fetch that finds the payload gone (publisher
  died, GCS restarted over a stale snapshot) **drops** the directory entry
  — the self-heal path that keeps the index free of dangling object ids.

Two backends behind one client API, resolved once at first use:

- **runtime** — a live ray_tpu_torch runtime: directory calls go through
  ``get_runtime().gcs.prefix_*`` (works on the in-process AND multiprocess
  runtimes — same facade), payloads ride ``runtime.put`` / ``runtime.get``
  with the publishing client holding the pinning ObjectRef until release.
- **local** — no runtime (bare-engine unit tests, benches): a process-local
  singleton directory + payload dict with the same semantics, so
  same-process engines still share a tier.

Never resolves a backend by *initializing* anything: an engine constructed
before ``ray_tpu_torch.init()`` stays on the local backend for its lifetime.

The port's copy of ``ray_tpu/serve/kv_tier.py``. A payload is
``{"k", "v": CPU tensors [L, nb, bt, H, Dh] of the pool's dtype, "tokens"}``
— JAX's layout, in torch because numpy has no bf16. It never holds a CUDA
tensor: it outlives the publisher's card memory and must be readable in a
process that holds no grant.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("kv_tier")

__all__ = ["KVTier", "kv_tier_enabled", "reset_local_backend"]


def kv_tier_enabled() -> bool:
    """Master switch (``kv_tier_enabled`` flag): off = engine-private KV
    and sweep-only downscale, byte-identical to pre-tier behavior."""
    try:
        return bool(config().kv_tier_enabled)
    except Exception:  # noqa: BLE001 — config unavailable mid-teardown
        return False


# -- local (runtime-less) backend ---------------------------------------------


class _LocalBackend:
    """Process-local tier: the ShardedPrefixDirectory plus a payload dict,
    shared by every runtime-less engine in this process."""

    def __init__(self):
        from ray_tpu_torch.core.gcs_shards import ShardedPrefixDirectory

        self._lock = threading.Lock()
        self._payloads: Dict[bytes, Any] = {}
        self.directory = ShardedPrefixDirectory(
            1, max_entries=int(config().kv_tier_dir_max_entries),
            ttl_s=float(config().kv_tier_dir_ttl_s), on_free=self._on_free)

    def _on_free(self, digest: bytes, _entry: Dict[str, Any]) -> None:
        with self._lock:
            self._payloads.pop(bytes(digest), None)

    def _apply_bounds(self) -> None:
        self.directory.max_entries = int(config().kv_tier_dir_max_entries)
        self.directory.ttl_s = float(config().kv_tier_dir_ttl_s)

    def prepare(self, payload: Any) -> Any:
        """One payload handle shared by every prefix entry of a chain —
        the local backend stores the object itself."""
        return payload

    def publish(self, digest: bytes, handle: Any, token_count: int,
                n_blocks: int, hint: str) -> bool:
        self._apply_bounds()
        with self._lock:
            self._payloads[bytes(digest)] = handle
        return self.directory.publish(digest, b"local", token_count,
                                      n_blocks, hint=hint)

    def match(self, digests: List[bytes]):
        return self.directory.match(digests)

    def fetch(self, digest: bytes, _entry: Dict[str, Any]):
        with self._lock:
            return self._payloads.get(bytes(digest))

    def release(self, digest: bytes) -> bool:
        return self.directory.release(digest)

    def drop(self, digest: bytes) -> bool:
        return self.directory.drop(digest)

    def stats(self) -> Dict[str, int]:
        st = self.directory.stats()
        with self._lock:
            st["prefix_dir_payloads"] = len(self._payloads)
        return st


_local_lock = threading.Lock()
_local: Optional[_LocalBackend] = None


def _local_backend() -> _LocalBackend:
    global _local
    with _local_lock:
        if _local is None:
            _local = _LocalBackend()
        return _local


def reset_local_backend() -> None:
    """Drop the process-local tier (test isolation between engine runs)."""
    global _local
    with _local_lock:
        _local = None


# -- runtime backend ----------------------------------------------------------


class _RuntimeBackend:
    """Directory on the GCS (``prefix_*`` RPCs), payloads in the object
    store. The PUBLISHER pins its payload with a live ObjectRef; the
    directory entry carries only the 28-byte object id, so a reader
    reconstructs a borrowing ref, pulls, and lets it go."""

    def __init__(self, runtime):
        self._rt = runtime
        self._lock = threading.Lock()
        self._pins: Dict[bytes, Any] = {}  # digest -> pinning ObjectRef

    def prepare(self, payload: Any) -> Any:
        """Put the payload ONCE; every prefix entry of the chain aliases
        the same object (content addressing: the payload's leading blocks
        are the shorter chains)."""
        return self._rt.put(payload)

    def publish(self, digest: bytes, handle: Any, token_count: int,
                n_blocks: int, hint: str) -> bool:
        # The entry's hint is what a reader's ObjectRef takes as its owner
        # hint, so it names the payload's owner (this process's address on
        # a multiprocess cluster): the deployment name there would send
        # every fetch to an address that does not exist, and a payload
        # small enough to stay inline in its owner is nowhere else.
        hint = getattr(handle, "_owner_hint", None) or hint
        created = self._rt.gcs.prefix_publish(
            bytes(digest), handle.id.binary(), token_count, n_blocks, hint)
        if created:
            with self._lock:
                self._pins[bytes(digest)] = handle
        # not created: an identical chain is already indexed — our pin on
        # the shared ref is dropped at release and refcounting frees it.
        return created

    def match(self, digests: List[bytes]):
        return self._rt.gcs.prefix_match([bytes(d) for d in digests])

    def fetch(self, digest: bytes, entry: Dict[str, Any]):
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.core.object_ref import ObjectRef

        owner = entry.get("hint") or None
        if owner is not None and not self._publisher_alive(owner):
            return None  # the payload went with its publisher
        ref = ObjectRef(ObjectID(bytes(entry["meta"])), owner_hint=owner)
        return self._rt.get(ref, timeout=5.0)

    def _publisher_alive(self, owner: str) -> bool:
        """Whether the process that owns a payload still answers. A spilled
        payload shares its publisher's fate: a node's arena can keep the
        bytes after the owner died (nothing frees them), but the directory
        must not lead readers there — the fetch misses and self-heals. The
        in-process runtime has no owner processes (its hint is the
        deployment's name), so there everything counts as alive."""
        clients = getattr(self._rt, "_owner_clients", None)
        if clients is None or owner == getattr(self._rt, "owner_address",
                                               None):
            return True
        try:
            clients.get(owner).call("ping", timeout=2.0)
            return True
        except Exception:  # noqa: BLE001 — refused, reset or timed out
            return False

    def release(self, digest: bytes) -> bool:
        removed = False
        try:
            removed = bool(self._rt.gcs.prefix_release(bytes(digest)))
        except Exception:  # noqa: BLE001 — GCS mid-restart: drop pin anyway
            log_swallowed(logger, "prefix_release")
        with self._lock:
            self._pins.pop(bytes(digest), None)  # ref dies -> object freed
        return removed

    def drop(self, digest: bytes) -> bool:
        try:
            return bool(self._rt.gcs.prefix_drop(bytes(digest)))
        except Exception:  # noqa: BLE001 — self-heal is best-effort
            log_swallowed(logger, "prefix_drop")
            return False

    def stats(self) -> Dict[str, int]:
        try:
            return dict(self._rt.gcs.prefix_stats())
        except Exception:  # noqa: BLE001 — GCS mid-restart
            return {}


# -- client -------------------------------------------------------------------


class KVTier:
    """One engine's handle on the cluster KV tier.

    Tracks what THIS client published so refcounts drain deterministically:
    each head digest is published at most once per client, and
    :meth:`close` releases every outstanding publish (directory refs and
    object pins both reach zero when every client closes — the
    ``RAY_TPU_LEAK_CHECK_ENABLED`` invariant).
    """

    def __init__(self, deployment: str = ""):
        self.deployment = deployment
        self._lock = threading.Lock()
        # head digest -> n_blocks published (for the spilled-blocks gauge)
        self._published: Dict[bytes, int] = {}
        self._backend = None

    def _resolve(self):
        if self._backend is not None:
            return self._backend
        try:
            from ray_tpu_torch.core.runtime import get_runtime

            rt = get_runtime()  # raises when not initialized — never inits
            if hasattr(rt.gcs, "prefix_publish"):
                self._backend = _RuntimeBackend(rt)
        except Exception:  # noqa: BLE001 — no runtime: local tier
            log_swallowed(logger, "kv tier backend resolve")
        if self._backend is None:
            self._backend = _local_backend()
        return self._backend

    def is_published(self, digest: bytes) -> bool:
        with self._lock:
            return bytes(digest) in self._published

    def publish_chain(self, digests: List[bytes], payload: Any,
                      token_count: int, n_blocks: int) -> bool:
        """Spill one chain: the payload goes to the object plane ONCE, and
        every prefix digest of the chain gets a directory entry aliasing it
        — content addressing means the payload's first ``i + 1`` blocks ARE
        the chain ``digests[i]`` keys, so a prompt that only covers part of
        the spilled chain still matches. Idempotent per client; True when
        this call indexed new content."""
        digests = [bytes(d) for d in digests][:int(n_blocks)]
        if not digests:
            return False
        n_blocks = len(digests)
        head = digests[-1]
        with self._lock:
            if all(d in self._published for d in digests):
                return False
        backend = self._resolve()
        handle = backend.prepare(payload)
        bt = int(token_count) // n_blocks
        created = False
        for i, d in enumerate(digests):
            with self._lock:
                if d in self._published:
                    continue
            if backend.publish(d, handle, (i + 1) * bt, i + 1,
                               self.deployment):
                created = True
            with self._lock:
                # The gauge counts each payload's blocks once — on its
                # head entry; prefix aliases carry no extra device bytes.
                self._published[d] = n_blocks if i == n_blocks - 1 else 0
        flightrec.record("serve", self.deployment or "kv_tier",
                         f"kv spill {n_blocks}b {head.hex()[:12]}")
        return created

    def match(self, digests: List[bytes]) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Longest directory match over the probe chain's digests —
        ``(block_index, entry)`` where ``block_index`` indexes ``digests``
        (entry covers blocks ``0..block_index`` inclusive)."""
        if not digests:
            return None
        return self._resolve().match(digests)

    def fetch(self, digest: bytes, entry: Dict[str, Any]):
        """Pull a matched payload back; a miss DROPS the directory entry
        (self-heal) and returns None."""
        digest = bytes(digest)
        backend = self._resolve()
        try:
            payload = backend.fetch(digest, entry)
        except Exception:  # noqa: BLE001 — object gone / pull timed out
            payload = None
        if payload is None:
            backend.drop(digest)
            flightrec.record("serve", self.deployment or "kv_tier",
                             f"kv fetch MISS drop {digest.hex()[:12]}")
            return None
        flightrec.record("serve", self.deployment or "kv_tier",
                         f"kv fetch {digest.hex()[:12]}")
        return payload

    def release(self, digest: bytes) -> None:
        """Withdraw one of this client's publishes (chain evicted for good,
        or client closing)."""
        digest = bytes(digest)
        with self._lock:
            if self._published.pop(digest, None) is None:
                return
        self._resolve().release(digest)

    def spilled_blocks(self) -> int:
        with self._lock:
            return sum(self._published.values())

    def stats(self) -> Dict[str, int]:
        st = self._resolve().stats()
        st["kv_tier_published_here"] = len(self._published)
        return st

    def close(self) -> None:
        """Release every outstanding publish — directory refs (and the
        runtime backend's object pins) drain to zero."""
        with self._lock:
            digests = list(self._published)
            self._published.clear()
        backend = self._resolve()
        for d in digests:
            try:
                backend.release(d)
            except Exception:  # noqa: BLE001 — teardown best-effort
                log_swallowed(logger, "kv tier release")

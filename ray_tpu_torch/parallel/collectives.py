"""Eager actor-level collectives.

The port's copy of ``ray_tpu/parallel/collectives.py``: host-side tensors
exchanged between actors in a named group, rendezvoused through the
runtime's control plane (``init_collective_group``, ``allreduce``,
``barrier``, ``broadcast``, ``allgather``, ``reducescatter``,
``alltoall``, ``send``/``recv``). Tensors inside one program (the mesh,
``ray_tpu_torch/parallel/mesh.py``) use torch.distributed instead.

Backends:

- ``local`` — ranks in one process synchronise on a condition variable and
  reduce with numpy (the test substrate);
- ``gloo`` / ``ring`` — ranks in separate processes, TOPOLOGY-AWARE: ranks
  that share a node store reduce intra-node through shm first, node
  LEADERS run the inter-node ring moving size/num_nodes bytes per node
  instead of per rank, and results fan back out intra-node by shm key
  (``collective_hierarchy_enabled=0`` restores the flat ring);
- ``device`` — ranks in one process whose torch tensors share a device:
  the allreduce stacks and reduces them with torch on that device and
  each rank gets its result there. Ranks on distinct CUDA devices raise
  ``NotImplementedError``: the port runs on one card.

Host backends take a torch tensor through ``.detach().cpu()`` and return
numpy, as the JAX package does. numpy has no bfloat16 without
``ml_dtypes``, so a bf16 tensor crosses the host backends as its raw
16-bit words in the structured dtype :data:`BF16` (one field, ``bf16``;
no ufunc accepts it, so no path adds the words as integers by mistake).
Reductions of bf16 widen every contribution to f32 and accumulate in f32
— partial sums ride the rings as f32 — and the result rounds ONCE, to
nearest even (torch's own bf16 rounding), from the f32 accumulator; it
comes back as a bf16 torch tensor on the CPU. The JAX package rounds
after every add instead, so the two agree within world × 2^-8 relative.
"""

from __future__ import annotations

import functools
import sys
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.core.config import config as _get_config
from ray_tpu_torch.core.runtime import get_runtime
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("collectives")

# In-place accumulation kernels: every reduce site accumulates with ufunc
# ``out=`` into a private buffer (mean = sum + one final in-place divide)
# instead of stacking contributions and reducing the stack — no O(world)
# temporary per step.
_UFUNCS = {
    "sum": np.add,
    "prod": np.multiply,
    "min": np.minimum,
    "max": np.maximum,
}


# bf16 on the host: its 16-bit words, tagged (see the module docstring).
BF16 = np.dtype([("bf16", "<u2")])


def _is_bf16(dtype) -> bool:
    return np.dtype(dtype) == BF16


def _bf16_to_f32(a) -> np.ndarray:
    """The f32 values of a :data:`BF16` array (exact: bf16 is f32's top
    half)."""
    words = np.asarray(a).view(np.uint16).astype(np.uint32)
    return (words << 16).view(np.float32)


def _f32_to_bf16(x) -> np.ndarray:
    """Round f32 values to :data:`BF16` words, to nearest even; a NaN
    becomes the canonical quiet NaN 0x7FC0 (torch's conversion)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    u = x.view(np.uint32)
    words = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))
             >> 16).astype(np.uint16)
    words[np.isnan(x)] = 0x7FC0
    return words.view(BF16)


def _dtype_token(dtype) -> str:
    """A dtype's name on the wire (``dtype.str`` would drop BF16's tag)."""
    return "bf16" if _is_bf16(dtype) else np.dtype(dtype).str


def _dtype_of(token: str) -> np.dtype:
    return BF16 if token == "bf16" else np.dtype(token)


def _operand(a):
    """``a`` as a ufunc operand: BF16 words widen to f32."""
    return _bf16_to_f32(a) if _is_bf16(np.asarray(a).dtype) else a


def _widen(a, acc_dt) -> np.ndarray:
    """A private C-ordered copy of ``a`` in the accumulator dtype."""
    a = np.asarray(a)
    if _is_bf16(a.dtype):
        return np.ascontiguousarray(_bf16_to_f32(a), dtype=acc_dt)
    return a.astype(acc_dt, order="C", copy=True)


def _out_dtype(dtype, op: str) -> np.dtype:
    """The dtype a reduction of ``dtype`` returns: BF16 stays BF16, the
    rest per :func:`_acc_dtype`."""
    return BF16 if _is_bf16(dtype) else _acc_dtype(dtype, op)


def _narrow(acc: np.ndarray, out_dt) -> np.ndarray:
    """The accumulator in the result dtype (BF16: one rounding)."""
    if _is_bf16(out_dt):
        return _f32_to_bf16(acc)
    return acc if acc.dtype == out_dt else acc.astype(out_dt)


def _acc_dtype(dtype, op: str) -> np.dtype:
    """Accumulator dtype matching numpy's stack-then-reduce promotion rules
    (``np.sum``/``np.prod`` widen sub-word ints to the platform int;
    ``np.mean`` of integral input is float64) so the in-place kernels return
    the same dtypes a ``np.sum(arrs, axis=0)`` would; BF16 accumulates in
    f32 for every op."""
    dtype = np.dtype(dtype)
    if _is_bf16(dtype):
        return np.dtype(np.float32)
    if op == "mean":
        return dtype if np.issubdtype(dtype, np.inexact) else np.dtype(np.float64)
    if op in ("sum", "prod"):
        if dtype.kind in "bi":
            return np.result_type(dtype, np.int_)
        if dtype.kind == "u":
            return np.result_type(dtype, np.uint)
    return dtype


def _reduce_inplace(op: str, arrs):
    """Reduce a list of arrays with in-place ufunc accumulation. The inputs
    are never mutated: the first contribution is copied into a private
    accumulator (promoting per :func:`_acc_dtype`), the rest accumulate with
    ``out=``. float16 mean keeps ``np.mean``'s float32 intermediate (cast
    back at the end) so half-precision results don't round per
    contribution; BF16 accumulates in f32 and rounds once at the end."""
    acc_op = "sum" if op == "mean" else op
    first = np.asarray(arrs[0])
    out_dt = _out_dtype(first.dtype, op)
    acc_dt = (np.dtype(np.float32)
              if op == "mean" and out_dt == np.float16
              else _acc_dtype(first.dtype, op))
    acc = _widen(first, acc_dt)
    uf = _UFUNCS[acc_op]
    for a in arrs[1:]:
        uf(acc, _operand(a), out=acc)
    if op == "mean":
        np.divide(acc, len(arrs), out=acc)
    return _narrow(acc, out_dt)


# Public op table (kept for the op-validation contract): each entry reduces
# a LIST of per-rank arrays, now via the in-place kernels above.
_REDUCE_OPS = {op: functools.partial(_reduce_inplace, op)
               for op in ("sum", "prod", "min", "max", "mean")}


def _tensor_device(t):
    """The device a rank's tensor lives on."""
    return t.device


def _device_allreduce(slots: Dict[int, "object"], op: str, world: int):
    """Allreduce over the DEVICE the ranks' torch tensors already share:
    the tensors are stacked and reduced with torch there, and every rank
    gets the result on that device (the counterpart of the JAX package's
    co-located compiled reduction). Ranks whose tensors sit on distinct
    devices raise: the port runs on one card (ROADMAP, "one card"), so
    there is no cross-card reduction here."""
    import torch

    ranks = sorted(slots)
    ts = [slots[r] if isinstance(slots[r], torch.Tensor)
          else torch.as_tensor(np.asarray(slots[r])) for r in ranks]
    devices = [_tensor_device(t) for t in ts]
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"backend='device' allreduce over tensors on distinct devices "
            f"{sorted({str(d) for d in devices})}: the port runs on one "
            f"card (ROADMAP, the one-card record) and has no cross-card "
            f"eager collective; put the ranks' tensors on one device, or "
            f"use backend='gloo' for host tensors")
    stacked = torch.stack(ts)
    if op == "sum":
        red = stacked.sum(0)
    elif op == "prod":
        red = stacked.prod(0)
    elif op == "min":
        red = stacked.amin(0)
    elif op == "max":
        red = stacked.amax(0)
    else:
        if not (stacked.is_floating_point() or stacked.is_complex()):
            stacked = stacked.to(torch.float64)
        red = stacked.mean(0)
    return {r: red for r in ranks}


class _Failed:
    """A round's compute raised: every rank of the round re-raises it."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _GroupState:
    """Shared rendezvous state for one collective group (local backend)."""

    backend = "local"

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.epoch = 0
        self.slots: Dict[int, np.ndarray] = {}
        self.result = None
        self.arrived = 0
        self.departed = 0
        self._timeout = float(_get_config().collective_timeout_s)
        # Point-to-point mailboxes: (src, dst) -> list of arrays.
        self.p2p: Dict[tuple, List[np.ndarray]] = {}

    def exchange(self, rank: int, value, compute):
        """All ranks deposit, one computes, all withdraw. Returns result."""
        with self.cv:
            # Phase 0: a fast rank can re-enter for the NEXT collective while
            # stragglers are still withdrawing from the previous one; without
            # this drain guard its deposit lands in (and is wiped with) the
            # old round — mixed-epoch corruption.
            while self.arrived == self.world_size or rank in self.slots:
                if not self.cv.wait(timeout=self._timeout):
                    raise TimeoutError(
                        f"collective drain timed out at rank {rank} "
                        f"(prev round: {self.departed}/{self.world_size} departed)"
                    )
            epoch = self.epoch
            self.slots[rank] = value
            self.arrived += 1
            if self.arrived == self.world_size:
                try:
                    self.result = compute(self.slots)
                except Exception as e:  # noqa: BLE001 — every rank raises
                    self.result = _Failed(e)
                self.cv.notify_all()
            else:
                while self.epoch == epoch and self.arrived < self.world_size:
                    if not self.cv.wait(timeout=self._timeout):
                        raise TimeoutError(
                            f"collective timed out at rank {rank} "
                            f"({self.arrived}/{self.world_size} arrived)"
                        )
            result = self.result
            self.departed += 1
            if self.departed == self.world_size:
                # Reset for the next collective on this group.
                self.slots = {}
                self.arrived = 0
                self.departed = 0
                self.result = None
                self.epoch += 1
                self.cv.notify_all()
        if isinstance(result, _Failed):
            raise result.exc
        return result

    # Descriptor-driven surface shared with the distributed backend.
    def exchange_desc(self, rank: int, descriptor: tuple, value):
        return self.exchange(rank, value,
                             _compute_for(descriptor, self.world_size))

    def p2p_send(self, src: int, dst: int, value) -> None:
        with self.cv:
            self.p2p.setdefault((src, dst), []).append(value)
            self.cv.notify_all()

    def p2p_recv(self, src: int, dst: int, timeout: Optional[float] = None):
        if timeout is None:
            timeout = self._timeout
        key = (src, dst)
        with self.cv:
            while not self.p2p.get(key):
                if not self.cv.wait(timeout=timeout):
                    raise TimeoutError(f"recv from rank {src} timed out")
            return self.p2p[key].pop(0)


class _DeviceGroupState(_GroupState):
    """In-process group whose allreduce runs with torch on the device the
    ranks' tensors share (``backend="device"``). Broadcast/allgather hand
    tensors through untouched; reducescatter/alltoall fall back to the
    host compute (their payloads coerce via numpy)."""

    backend = "device"

    def exchange_desc(self, rank: int, descriptor: tuple, value):
        if descriptor[0] == "allreduce":
            op = descriptor[1]
            per = self.exchange(
                rank, value,
                lambda slots: _device_allreduce(slots, op, self.world_size))
            return per[rank]
        return self.exchange(rank, value,
                             _compute_for(descriptor, self.world_size))


def _compute_for(descriptor: tuple, world: int):
    """Server-side compute for a descriptor-driven collective round.

    Both backends funnel through this: the local backend calls it in
    process, the "gloo" backend's rank-0 hub calls it after all ranks'
    payloads arrive over RPC — one implementation of the math either way.
    """
    kind = descriptor[0]
    if kind == "allreduce":
        op = descriptor[1]
        return lambda slots: _REDUCE_OPS[op]([slots[r] for r in sorted(slots)])
    if kind == "barrier":
        return lambda slots: None
    if kind == "broadcast":
        src = descriptor[1]
        return lambda slots: slots[src]
    if kind == "allgather":
        return lambda slots: [slots[r] for r in sorted(slots)]
    if kind == "reducescatter":
        op = descriptor[1]

        def compute(slots):
            reduced = _REDUCE_OPS[op]([slots[r] for r in sorted(slots)])
            return np.array_split(reduced, world, axis=0)

        return compute
    if kind == "alltoall":
        def compute(slots):
            split = {r: np.array_split(slots[r], world, axis=0) for r in slots}
            return {r: np.concatenate(
                [split[s][r] for s in sorted(split)], axis=0)
                for r in range(world)}

        return compute
    raise ValueError(f"unknown collective descriptor {descriptor}")


class _Topology:
    """rank → node grouping for one cross-process group, derived from the
    store names every rank rendezvoused through the GCS group KV: ranks
    publishing the same (non-empty) node-store name share a node; distinct stores
    are separated by the cross-node fabric. A rank with no
    reachable store is its own singleton node (no zero-copy plane to share).
    """

    def __init__(self, stores: List[Optional[str]]):
        key_to_idx: Dict[object, int] = {}
        self.node_of: List[int] = []
        for r, s in enumerate(stores):
            key = s if s else ("#solo", r)
            idx = key_to_idx.setdefault(key, len(key_to_idx))
            self.node_of.append(idx)
        self.nodes: List[List[int]] = [[] for _ in key_to_idx]
        for r, idx in enumerate(self.node_of):
            self.nodes[idx].append(r)
        # Node leader = lowest rank sharing the store; leaders alone run the
        # inter-node ring.
        self.leaders = [g[0] for g in self.nodes]

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def multi_rank_nodes(self) -> bool:
        """True when at least one node hosts >1 rank — the only shape where
        the two-level schedule differs from (and beats) the flat ring."""
        return any(len(g) > 1 for g in self.nodes)


class _ShmIncoming:
    """A chunk delivered by shm reference: the array is a zero-copy view
    into the node's object store; ``close()`` releases the view and acks
    the origin so it can delete the backing object."""

    __slots__ = ("arr", "key", "origin", "_shm", "_closed")

    def __init__(self, arr, key, origin, shm):
        self.arr = arr
        self.key = key
        self.origin = origin
        self._shm = shm
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._shm.release(self.key)
        except Exception:  # noqa: BLE001 — store gone at shutdown
            log_swallowed(logger, "shm release at close")


_TAKE_DEFAULT = object()  # sentinel: "use the service's configured timeout"


class _MemberService:
    """Every rank's RPC surface in the cross-process backend: a tagged
    mailbox. Peers deliver (tag -> payload) messages; the local rank waits
    on its mailbox. Tags are (op_seq, step, src) so concurrent steps of
    pipelined rounds can't mix.

    Same-node peers can deliver big tensors BY SHM REFERENCE
    (``deliver_shm``): the payload crosses as a 16-byte object key; the
    receiver maps a zero-copy view out of the shared arena — the
    "large host tensors ride the shm object plane" tier."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.box: Dict[tuple, object] = {}
        self.shm = None  # set by the group when a node store is reachable
        # Default blocking-take timeout; the owning group overrides it with
        # its collective_timeout_s.
        self.default_timeout: Optional[float] = 120.0
        # Origin-side: shm chunks awaiting consumer acks -> pending count.
        self._outstanding: Dict[bytes, int] = {}

    def deliver(self, tag: tuple, value) -> None:
        with self.cv:
            self.box[tuple(tag)] = value
            self.cv.notify_all()

    def deliver_shm(self, tag: tuple, key: bytes, shape, dtype: str,
                    origin: int) -> None:
        view = self.shm.get(key) if self.shm is not None else None
        if view is None:
            raise RuntimeError(
                f"shm chunk {key.hex()[:12]} not found in local store")
        arr = np.frombuffer(view, dtype=_dtype_of(dtype)).reshape(shape)
        with self.cv:
            self.box[tuple(tag)] = _ShmIncoming(arr, key, origin, self.shm)
            self.cv.notify_all()

    def note_outstanding(self, key: bytes, consumers: int) -> None:
        with self.lock:
            self._outstanding[key] = consumers

    def shm_done(self, key: bytes) -> None:
        """Consumer ack: delete the backing object once all consumers of
        this chunk have released their views."""
        with self.lock:
            n = self._outstanding.get(key, 1) - 1
            if n > 0:
                self._outstanding[key] = n
                return
            self._outstanding.pop(key, None)
        if self.shm is not None:
            try:
                self.shm.delete(key)
            except Exception:  # noqa: BLE001 — store gone at shutdown
                log_swallowed(logger, "shm delete after acks")

    def take(self, tag: tuple, timeout=_TAKE_DEFAULT):
        import time as _time

        if timeout is _TAKE_DEFAULT:
            timeout = self.default_timeout
        end = None if timeout is None else _time.time() + timeout
        tag = tuple(tag)
        with self.cv:
            while tag not in self.box:
                if end is None:  # block indefinitely (p2p recv contract)
                    self.cv.wait(timeout=1.0)
                    continue
                remaining = end - _time.time()
                if remaining <= 0:
                    raise TimeoutError(f"collective step {tag} never arrived")
                self.cv.wait(timeout=min(remaining, 1.0))
            return self.box.pop(tag)

    def ping(self) -> str:
        return "pong"


class _DistributedGroup:
    """One rank's view of a cross-process group.

    Two schedules, chosen from the rendezvoused topology:

    - **Two-level (default when some node hosts >1 rank):** intra-node
      reduce through shm into the node leader's private buffer (ufunc
      ``out=`` over peers' zero-copy views), a SEGMENTED PIPELINED ring
      between node leaders moving size/num_nodes bytes per node over the
      cross-node fabric, then an intra-node fan-out by shm key. This is the
      two-tier (node, cross-node) hierarchy.
    - **Flat ring** (``collective_hierarchy_enabled=0``, or no shared
      stores): ring reduce-scatter/allgather over all ranks — each rank
      moves O(size) bytes per allreduce regardless of world size. The
      reduce phase is segmented the same way, so segment k's in-place
      reduction overlaps segment k+1's transfer.
    """

    # Payloads at or above this ride the shm object plane between
    # same-node ranks (below it, the socket path's latency wins).
    SHM_MIN_BYTES = 1 << 20

    # Class-level defaults so partially-constructed instances (unit tests
    # build the group via ``object.__new__``) still run the flat paths.
    _timeout = 120.0
    _segment_bytes = 1 << 20
    _hier = False
    _topo: Optional[_Topology] = None
    stats: Optional[Dict[str, int]] = None

    def __init__(self, world_size: int, rank: int, addrs: List[str],
                 service: _MemberService, server,
                 stores: Optional[List[Optional[str]]] = None,
                 hierarchy: Optional[bool] = None):
        from ray_tpu_torch.core.rpc import RpcClientPool

        cfg = _get_config()
        self.world_size = world_size
        self.rank = rank
        self._addrs = addrs
        self._service = service
        self._server = server  # keeps the member server alive
        self._peers = RpcClientPool()
        self._op_seq = 0
        self._op_lock = threading.Lock()
        self._timeout = float(cfg.collective_timeout_s)
        self._segment_bytes = max(4096, int(cfg.collective_segment_size))
        service.default_timeout = self._timeout
        # Same-node shm fast path: ranks publishing the same store name
        # share one arena; big chunks cross as object keys. The stores list
        # is the KV-RENDEZVOUSED view — identical on every rank — and it
        # alone decides the topology/schedule; a rank whose own store failed
        # to open published "" (so everyone, itself included, sees it as a
        # solo node) and gates only its local shm TRANSPORT off via
        # ``self._shm`` — zeroing the whole list here would make this rank
        # pick the flat schedule while its peers run the hierarchy, and
        # their tags would never pair.
        self._stores = stores or [None] * world_size
        # The store handle is opened by _init_distributed_group BEFORE the
        # rank's address is published (a peer may deliver_shm the moment it
        # can see us); here we just adopt it off the service.
        self._shm = service.shm
        self._topo = _Topology(self._stores)
        self._hier = (bool(cfg.collective_hierarchy_enabled)
                      if hierarchy is None else bool(hierarchy))
        # Instrumentation: logical payload bytes sent, split by whether
        # the destination shares this rank's store (the cross-node
        # "cross-store" traffic is what the hierarchy minimizes), plus
        # which schedule each reduction round took.
        self.stats = {"bytes_cross_store": 0, "bytes_same_store": 0,
                      "hier_rounds": 0, "flat_rounds": 0}
        # Homogeneous single-node group: broadcast can write once and
        # circulate one key through the whole tree.
        self._all_same_store = bool(
            self._stores[0]
            and all(s == self._stores[0] for s in self._stores))

    # -- plumbing -----------------------------------------------------------

    def _next_seq(self) -> int:
        with self._op_lock:
            self._op_seq += 1
            return self._op_seq

    def _use_hier(self) -> bool:
        return (self._hier and self._topo is not None
                and self._topo.multi_rank_nodes and self.world_size > 1)

    def _acct(self, dst: int, nbytes: int) -> None:
        st = self.stats
        if st is None or not nbytes:
            return
        same = (self._stores[dst] is not None
                and self._stores[dst] == self._stores[self.rank])
        st["bytes_same_store" if same else "bytes_cross_store"] += int(nbytes)

    def _send(self, dst: int, tag: tuple, value) -> None:
        if dst == self.rank:
            self._service.deliver(tag, value)
            return
        self._acct(dst, getattr(value, "nbytes", 0))
        self._peers.get(self._addrs[dst]).call(
            "deliver", tag, value, timeout=self._timeout)

    @staticmethod
    def _bc_subtree_consumers(rel: int, n: int) -> int:
        """How many DESCENDANTS of relative rank ``rel`` in the binomial
        broadcast tree will receive (and ack) a key published by ``rel``.
        Node ``rel`` owns children ``rel + 2^k`` for ``2^k > rel`` while
        ``rel + 2^k < n``; descendants ack recursively. Publishing with
        ``n - 1`` on a non-root republisher (root's publish failed, chunk
        arrived by socket) would leave ``shm_done`` forever short — only
        the republisher's own subtree ever acks."""
        count = 0
        k = 1
        while k < n:
            if rel < k and rel + k < n:
                child = rel + k
                count += 1 + _DistributedGroup._bc_subtree_consumers(child, n)
            k *= 2
        return count

    def _ring_shm_consumers(self, ring: List[int], start_pos: int,
                            hops: int) -> int:
        """How many CONSECUTIVE downstream ring receivers (starting at ring
        position ``start_pos``, following the ring for ``hops`` hops) share
        this rank's store. Only those receive the chunk BY KEY and ack; once
        the ring crosses to a different store the chunk continues as socket
        copies — counting those would leave the backing object undeletable."""
        m = len(ring)
        count = 0
        for i in range(hops):
            r = ring[(start_pos + i) % m]
            if self._stores[r] != self._stores[self.rank]:
                break
            count += 1
        return count

    def _send_async(self, dst: int, tag: tuple, value, *,
                    consumers: int = 1, holder=None):
        """Fire-and-overlap send: returns a future (or None for self-
        delivery). Ring steps overlap their outgoing transfer with the
        blocking wait for the incoming one — full-duplex links move both
        directions at once instead of serializing on the deliver ack.

        Big numpy payloads to SAME-NODE peers go by shm reference: one
        copy into the shared arena, a 16-byte key over the socket, a
        zero-copy view on the other side. A chunk already BACKED by shm
        (``holder``) is forwarded by key — zero copies on any hop;
        ``consumers`` (total ranks that will ack) is fixed by the
        creator."""
        if dst == self.rank:
            self._service.deliver(tag, value)
            return None
        same_store = (self._shm is not None
                      and self._stores[dst] == self._stores[self.rank])
        if holder is not None and same_store:
            return self._peers.get(self._addrs[dst]).call_async(
                "deliver_shm", tag, holder.key, value.shape,
                _dtype_token(value.dtype), holder.origin)
        if (same_store
                and isinstance(value, np.ndarray)
                and value.nbytes >= self.SHM_MIN_BYTES
                and consumers > 0):
            key = self._publish_shm(value, consumers)
            if key is not None:
                return self._peers.get(self._addrs[dst]).call_async(
                    "deliver_shm", tag, key, value.shape, _dtype_token(value.dtype),
                    self.rank)
            # Arena full: fall through to the socket path.
        self._acct(dst, getattr(value, "nbytes", 0))
        return self._peers.get(self._addrs[dst]).call_async(
            "deliver", tag, value)

    def _publish_shm(self, arr: np.ndarray, consumers: int) -> Optional[bytes]:
        """Seal one shm object holding ``arr``; returns its key (None when
        the arena is full). The creator expects ``consumers`` acks before
        deleting."""
        import os as _os

        key = _os.urandom(16)
        view = self._shm.create(key, arr.nbytes)
        if view is None:
            return None
        flat = np.frombuffer(view, dtype=arr.dtype)
        flat[:] = np.ascontiguousarray(arr).reshape(-1)
        self._shm.seal(key)
        self._service.note_outstanding(key, consumers)
        if self.stats is not None:
            self.stats["bytes_same_store"] += int(arr.nbytes)
        return key

    def _materialize(self, incoming):
        """(ndarray, holder) for a received chunk. shm-delivered chunks
        come back as zero-copy views with a non-None holder: the caller
        uses the array, then MUST call ``_finish_consume(holder)`` (a
        caller that keeps the array beyond the step copies it first)."""
        if isinstance(incoming, _ShmIncoming):
            return incoming.arr, incoming
        return np.asarray(incoming), None

    def _ack_shm(self, incoming: "_ShmIncoming") -> None:
        try:
            self._peers.get(self._addrs[incoming.origin]).notify(
                "shm_done", incoming.key)
        except Exception:  # noqa: BLE001 — origin gone; its store reaps
            log_swallowed(logger, "shm consumer ack")

    def _finish_consume(self, holder) -> None:
        if holder is not None:
            holder.close()
            self._ack_shm(holder)

    def _recv(self, tag: tuple, timeout: Optional[float] = None):
        return self._service.take(
            tag, self._timeout if timeout is None else timeout)

    def _segment_slices(self, n_elems: int, itemsize: int) -> List[slice]:
        """Split a 1-D chunk into ``collective_segment_size``-byte segments.
        Both ring ends compute the same split from the (globally agreed)
        chunk length, so segment tags pair up without negotiation."""
        if n_elems == 0:
            return []
        seg = max(1, self._segment_bytes // max(1, itemsize))
        return [slice(i, min(i + seg, n_elems))
                for i in range(0, n_elems, seg)]

    def _chunk_segments(self, peer: int, n_elems: int,
                        itemsize: int) -> List[slice]:
        """Segmentation policy for one ring hop: chunks CROSSING stores
        (the inter-node / cross-node hop) are segmented so reduction
        overlaps transfer; same-store chunks ride shm whole — one key, one
        arena copy, zero-copy reduce (per-segment objects would only add
        RPC overhead on the fast tier). Sender and receiver derive the same
        split from the shared topology, so tags pair up."""
        if n_elems == 0:
            return []
        if (self._shm is not None
                and self._stores[peer] == self._stores[self.rank]):
            return [slice(0, n_elems)]
        return self._segment_slices(n_elems, itemsize)

    # -- collectives --------------------------------------------------------

    def exchange_desc(self, rank: int, descriptor: tuple, value):
        assert rank == self.rank
        kind = descriptor[0]
        seq = self._next_seq()
        hier = self._use_hier()
        if kind == "allreduce":
            return self._allreduce(seq, value, descriptor[1])
        if kind == "reducescatter":
            if hier:
                reduced = self._hier_reduce_scatter(seq, value, descriptor[1])
            else:
                reduced = self._reduce_scatter(seq, value, descriptor[1])
            # API contract: caller indexes [rank]; return full split list
            # shape-compatible with the local backend.
            out = [None] * self.world_size
            out[self.rank] = reduced
            return out
        if kind == "allgather":
            if hier:
                return self._hier_allgather(seq, value)
            return self._allgather(seq, value)
        if kind == "broadcast":
            if hier:
                return self._hier_broadcast(seq, value, descriptor[1])
            return self._broadcast(seq, value, descriptor[1])
        if kind == "barrier":
            # 1-byte payloads: the flat ring's latency is the floor either
            # way; the two-level schedule only adds hops here.
            self._allgather(seq, np.zeros(1, dtype=np.uint8))
            return None
        if kind == "alltoall":
            return {self.rank: self._alltoall(seq, value)}
        raise ValueError(f"unknown collective descriptor {descriptor}")

    # -- ring engine --------------------------------------------------------

    def _ring_allreduce_inplace(self, seq: int, buf: np.ndarray, acc_op: str,
                                ring: List[int], phase: str = "r",
                                src: Optional[np.ndarray] = None) -> None:
        """Segmented pipelined ring allreduce over the ranks in ``ring``
        (all of which must be calling this with the same ring),
        accumulating IN PLACE into the 1-D ``buf`` — the caller owns the
        buffer and applies any mean division afterwards.

        ``src`` (optional, same length) carries this rank's ORIGINAL
        contribution with ``buf`` left uninitialized: each chunk's first
        accumulation then reads straight from the input into ``buf``
        (``uf(src, incoming, out=buf)``) and step-0 sends ship input views
        — the full-size private entry copy disappears.

        Phase 1 (reduce-scatter) moves each store-crossing chunk as
        ``collective_segment_size`` segments: the peer posts every segment
        up front (persistent per-peer connection, sends overlap), so
        segment k's in-place reduction here overlaps segment k+1's
        transfer; same-store chunks ride shm whole. Phase 2 (allgather)
        circulates each owner's fully-reduced chunk whole — published to
        shm once and forwarded BY KEY between same-store ranks — and lands
        it straight into ``buf`` (no final concatenate)."""
        m = len(ring)
        if m == 1:
            if src is not None:
                np.copyto(buf, src)
            return
        pos = ring.index(self.rank)
        nxt = ring[(pos + 1) % m]
        prv = ring[(pos - 1) % m]
        uf = _UFUNCS[acc_op]
        chunks = np.array_split(buf, m)  # views into buf
        src_chunks = np.array_split(src, m) if src is not None else chunks
        touched = [src is None] * m
        rs_tag, ag_tag = phase + "rs", phase + "ag"
        # Phase 1 — after step s, this rank holds the running reduction of
        # chunk (pos - s) % m over s+1 contributors.
        for step in range(m - 1):
            send_idx = (pos - step) % m
            recv_idx = (pos - step - 1) % m
            out_chunk = (chunks if touched[send_idx]
                         else src_chunks)[send_idx]
            futs = [self._send_async(nxt, (seq, rs_tag, step, g),
                                     out_chunk[sl])
                    for g, sl in enumerate(self._chunk_segments(
                        nxt, len(out_chunk), out_chunk.itemsize))]
            dst = chunks[recv_idx]
            first = not touched[recv_idx]
            for g, sl in enumerate(self._chunk_segments(prv, len(dst),
                                                        dst.itemsize)):
                arr, holder = self._materialize(
                    self._recv((seq, rs_tag, step, g)))
                seg = dst[sl]
                uf(src_chunks[recv_idx][sl] if first else seg, arr, out=seg)
                self._finish_consume(holder)
            touched[recv_idx] = True
            for fut in futs:
                if fut is not None:
                    fut.result(timeout=self._timeout)
        # Phase 2 — allgather the reduced chunks around the ring. Each
        # reduced chunk is written to shm ONCE by its owner and then
        # FORWARDED BY KEY: every same-store rank reads the same backing
        # object, copies its range into ``buf``, forwards, and acks.
        holders: List[Optional[_ShmIncoming]] = [None] * m
        for step in range(m - 1):
            send_idx = (pos + 1 - step) % m
            recv_idx = (pos - step) % m
            # consumers = the consecutive same-store receivers downstream
            # of THIS send (the chunk has m-1-step hops left; once the
            # ring crosses stores it continues as socket copies that never
            # ack — counting them would leak the backing object).
            fut = self._send_async(
                nxt, (seq, ag_tag, step), chunks[send_idx],
                consumers=self._ring_shm_consumers(ring, (pos + 1) % m,
                                                   m - 1 - step),
                holder=holders[send_idx])
            arr, holder = self._materialize(self._recv((seq, ag_tag, step)))
            np.copyto(chunks[recv_idx], arr)
            holders[recv_idx] = holder  # kept for the key-forward next step
            if fut is not None:
                fut.result(timeout=self._timeout)
        for h in holders:
            self._finish_consume(h)

    def _allreduce(self, seq: int, value, op: str):
        n = self.world_size
        arr = np.asarray(value)
        if n == 1:
            return _REDUCE_OPS[op]([arr])
        orig_shape = arr.shape
        arr = np.atleast_1d(arr)
        acc_op = "sum" if op == "mean" else op
        if self._use_hier():
            return self._hier_allreduce(seq, arr, acc_op,
                                        op).reshape(orig_shape)
        if self.stats is not None:
            self.stats["flat_rounds"] += 1
        # Private working buffer; the caller's input is never mutated. When
        # no dtype promotion is needed, the buffer starts EMPTY and each
        # chunk's first accumulation reads the input directly (``src``) —
        # no full-size entry copy. Promoting ops (int sum/prod, int mean)
        # pre-copy so every accumulation runs in the promoted dtype.
        acc_dt = _acc_dtype(arr.dtype, op)
        flat_in = np.ascontiguousarray(arr).reshape(-1)
        if flat_in.dtype == acc_dt:
            buf = np.empty(flat_in.size, dtype=acc_dt)
            self._ring_allreduce_inplace(seq, buf, acc_op, list(range(n)),
                                         src=flat_in)
        else:
            buf = _widen(flat_in, acc_dt)
            self._ring_allreduce_inplace(seq, buf, acc_op, list(range(n)))
        if op == "mean":
            np.divide(buf, n, out=buf)
        return _narrow(buf, _out_dtype(arr.dtype, op)).reshape(orig_shape)

    # -- two-level schedule -------------------------------------------------

    def _reduce_to_leader(self, seq: int, arr: np.ndarray, acc_op: str,
                          op: str) -> Optional[np.ndarray]:
        """Intra-node reduce (the fast tier): non-leaders ship their
        ORIGINAL array to the node leader — by shm reference when big
        enough, with no intermediate promote-copy — and the leader
        accumulates IN PLACE into a private promoted buffer over the
        incoming zero-copy views. Returns that buffer on the leader;
        non-leaders return None and await the fan-out."""
        topo = self._topo
        group = topo.nodes[topo.node_of[self.rank]]
        leader = group[0]
        if self.rank != leader:
            fut = self._send_async(leader, (seq, "hup", self.rank),
                                   np.ascontiguousarray(arr))
            if fut is not None:
                fut.result(timeout=self._timeout)
            return None
        acc_dt = _acc_dtype(arr.dtype, op)
        uf = _UFUNCS[acc_op]
        buf = None
        for peer in group[1:]:
            inc, holder = self._materialize(self._recv((seq, "hup", peer)))
            if buf is not None:
                uf(buf, _operand(inc).reshape(buf.shape), out=buf)
            elif arr.dtype == acc_dt:
                # First accumulation ALLOCATES the private buffer (one
                # fused read-read-write pass instead of copy-then-add).
                buf = uf(arr, inc.reshape(arr.shape), dtype=acc_dt)
            else:
                buf = _widen(arr, acc_dt)
                uf(buf, _operand(inc).reshape(buf.shape), out=buf)
            self._finish_consume(holder)
        if buf is None:  # leader with no node peers
            buf = _widen(arr, acc_dt)
        # The inter-node ring and fan-out flatten this buffer with
        # reshape(-1), which must be a VIEW: a non-C-contiguous buffer
        # (astype order='K' preserves an F-ordered input's layout) would
        # silently detach the flat copy from buf.
        if not buf.flags.c_contiguous:
            buf = np.ascontiguousarray(buf)
        return buf

    def _take_down(self, seq: int, tag: str):
        """Receive a fan-out result: a socket-delivered payload is already
        private and returns WITHOUT a copy; only shm views (whose backing
        object dies with the ack) detach."""
        inc, holder = self._materialize(self._recv((seq, tag, self.rank)))
        if holder is not None:
            inc = np.array(inc)
            self._finish_consume(holder)
        return inc

    def _fan_out(self, seq: int, tag: str, arr: np.ndarray,
                 peers: List[int]) -> None:
        """Intra-node distribution: publish ``arr`` to shm ONCE and hand
        every peer the key (each acks; the object dies after the last),
        falling back to per-peer socket sends when small or arena-full."""
        if not peers:
            return
        futs = []
        key = None
        if (self._shm is not None and isinstance(arr, np.ndarray)
                and arr.nbytes >= self.SHM_MIN_BYTES):
            key = self._publish_shm(arr, len(peers))
        for p in peers:
            if key is not None:
                futs.append(self._peers.get(self._addrs[p]).call_async(
                    "deliver_shm", (seq, tag, p), key, arr.shape,
                    _dtype_token(arr.dtype), self.rank))
            else:
                futs.append(self._send_async(p, (seq, tag, p), arr))
        for fut in futs:
            if fut is not None:
                fut.result(timeout=self._timeout)

    def _hier_allreduce(self, seq: int, arr: np.ndarray, acc_op: str,
                        op: str) -> np.ndarray:
        """Two-level allreduce of ``arr`` (atleast-1d, never mutated):
        intra-node reduce at the leader, segmented ring between node
        leaders moving size/num_nodes bytes per node across the slow
        fabric, one final in-place mean divide, then fan-out by shm key."""
        if self.stats is not None:
            self.stats["hier_rounds"] += 1
        topo = self._topo
        group = topo.nodes[topo.node_of[self.rank]]
        buf = self._reduce_to_leader(seq, arr, acc_op, op)
        if buf is None:
            return self._take_down(seq, "hdn").reshape(arr.shape)
        flat = buf.reshape(-1)
        if topo.num_nodes > 1:
            self._ring_allreduce_inplace(seq, flat, acc_op, topo.leaders,
                                         phase="h")
        if op == "mean":
            np.divide(flat, self.world_size, out=flat)
        # BF16 rounds here, once, so the fan-out carries 16-bit words.
        buf = _narrow(buf, _out_dtype(arr.dtype, op))
        self._fan_out(seq, "hdn", buf.reshape(-1), group[1:])
        return buf

    def _hier_reduce_scatter(self, seq: int, value, op: str):
        """Two-level reduce-scatter: intra-node reduce to the leader,
        leaders allreduce over the ring, leader hands each node peer ONLY
        its own ``slots[rank]`` slice (zero-copy by shm key when big)."""
        n = self.world_size
        arr = np.asarray(value)
        acc_op = "sum" if op == "mean" else op
        topo = self._topo
        group = topo.nodes[topo.node_of[self.rank]]
        buf = self._reduce_to_leader(seq, arr, acc_op, op)
        if buf is None:
            return self._take_down(seq, "hdn")
        if topo.num_nodes > 1:
            self._ring_allreduce_inplace(seq, buf.reshape(-1), acc_op,
                                         topo.leaders, phase="h")
        if op == "mean":
            np.divide(buf, n, out=buf)
        split = np.array_split(_narrow(buf, _out_dtype(arr.dtype, op)), n,
                               axis=0)
        futs = [self._send_async(p, (seq, "hdn", p), split[p])
                for p in group[1:]]
        for fut in futs:
            if fut is not None:
                fut.result(timeout=self._timeout)
        return split[self.rank]

    def _hier_allgather(self, seq: int, value) -> List[np.ndarray]:
        """Two-level allgather: each node's leader collects its ranks'
        arrays, leaders circulate ONE block per node around their ring
        (each node's data crosses the slow fabric once per hop instead of
        once per rank), and leaders hand the assembled result back down."""
        topo = self._topo
        n = self.world_size
        group = topo.nodes[topo.node_of[self.rank]]
        leader = group[0]
        arr = np.asarray(value)
        if self.rank != leader:
            fut = self._send_async(leader, (seq, "gup", self.rank), arr)
            if fut is not None:
                fut.result(timeout=self._timeout)
            # Equal-shape results arrive STACKED as one ndarray (published
            # to shm once per node by the leader); ragged results arrive as
            # a pickled list over the socket.
            got = self._recv((seq, "gdn", self.rank))
            if isinstance(got, list):
                return got
            stacked, holder = self._materialize(got)
            if holder is not None:
                stacked = np.array(stacked)  # detach from shm before ack
                self._finish_consume(holder)
            return [stacked[i] for i in range(len(stacked))]
        block = {self.rank: arr}
        for peer in group[1:]:
            a, holder = self._materialize(self._recv((seq, "gup", peer)))
            if holder is not None:
                a = np.array(a)  # kept past the step: detach from shm
                self._finish_consume(holder)
            block[peer] = a
        blocks = {topo.node_of[self.rank]: block}
        ring = topo.leaders
        m = len(ring)
        if m > 1:
            pos = ring.index(self.rank)
            nxt = ring[(pos + 1) % m]
            carry = (topo.node_of[self.rank], block)
            for step in range(m - 1):
                fut = self._send_async(nxt, (seq, "hga", step), carry)
                carry = self._recv((seq, "hga", step))
                blocks[carry[0]] = carry[1]
                if fut is not None:
                    fut.result(timeout=self._timeout)
        out: List[Optional[np.ndarray]] = [None] * n
        for blk in blocks.values():
            for r, a in blk.items():
                out[r] = a
        if group[1:]:
            same = all(isinstance(a, np.ndarray) and a.shape == out[0].shape
                       and a.dtype == out[0].dtype for a in out)
            if same:
                # One stacked array fans down by shm key (one arena write
                # per node) instead of pickling the full result list once
                # per peer through the socket.
                self._fan_out(seq, "gdn", np.stack(out), group[1:])
            else:
                futs = [self._send_async(p, (seq, "gdn", p), out)
                        for p in group[1:]]
                for fut in futs:
                    if fut is not None:
                        fut.result(timeout=self._timeout)
        return out  # type: ignore[return-value]

    def _hier_broadcast(self, seq: int, value, src: int):
        """Two-level broadcast: the root sends ONE copy per remote node (to
        its leader, crossing the slow fabric once per node), and every
        node's distributor fans out intra-node by shm key."""
        topo = self._topo
        my_node = topo.node_of[self.rank]
        src_node = topo.node_of[src]
        if self.rank == src:
            arr = np.asarray(value)
            futs = []
            for nidx, grp in enumerate(topo.nodes):
                if nidx == src_node:
                    continue
                futs.append(self._send_async(grp[0], (seq, "hbc", grp[0]),
                                             arr))
            # The root distributes within its own node (even when it is not
            # the node leader — one fewer intra-node hop).
            self._fan_out(seq, "hbc", arr,
                          [r for r in topo.nodes[src_node] if r != src])
            for fut in futs:
                if fut is not None:
                    fut.result(timeout=self._timeout)
            return arr
        arr, holder = self._materialize(self._recv((seq, "hbc", self.rank)))
        if my_node != src_node and self.rank == topo.nodes[my_node][0]:
            self._fan_out(seq, "hbc", arr,
                          [r for r in topo.nodes[my_node] if r != self.rank])
        if holder is not None:
            arr = np.array(arr)  # result is returned to the caller
            self._finish_consume(holder)
        return arr

    # -- flat schedule ------------------------------------------------------

    def _reduce_scatter(self, seq: int, value, op: str):
        n = self.world_size
        arr = np.asarray(value)
        if n == 1:
            return _REDUCE_OPS[op]([arr])
        acc_op = "sum" if op == "mean" else op
        # Private promoted copy: ring steps accumulate in place into its
        # chunk views (axis-0 split — the slots[rank] contract).
        buf = _widen(arr, _acc_dtype(arr.dtype, op))
        chunks = np.array_split(buf, n, axis=0)
        uf = _UFUNCS[acc_op]
        nxt = (self.rank + 1) % n
        for step in range(n - 1):
            send_idx = (self.rank - step) % n
            recv_idx = (self.rank - step - 1) % n
            fut = self._send_async(nxt, (seq, "rs", step), chunks[send_idx])
            arr_in, holder = self._materialize(self._recv((seq, "rs", step)))
            uf(chunks[recv_idx], arr_in, out=chunks[recv_idx])
            self._finish_consume(holder)
            if fut is not None:
                fut.result(timeout=self._timeout)
        owned = (self.rank + 1) % n
        res = chunks[owned]
        if op == "mean":
            np.divide(res, n, out=res)
        # Rotate so the API's slots[rank] convention holds: ring ownership
        # is chunk (rank+1)%n; the contract gives rank its OWN index. The
        # rotation rides the async path (big chunks cross by shm key); the
        # received chunk is copied ONLY when an shm holder is attached — a
        # socket-delivered chunk is already private.
        fut = self._send_async((self.rank + 1) % n, (seq, "rsrot", 0), res)
        out, holder = self._materialize(self._recv((seq, "rsrot", 0)))
        if holder is not None:
            out = np.array(out)  # returned to the caller: detach from shm
            self._finish_consume(holder)
        if fut is not None:
            fut.result(timeout=self._timeout)
        return _narrow(out, _out_dtype(arr.dtype, op))

    def _allgather(self, seq: int, value) -> List[np.ndarray]:
        n = self.world_size
        out: List[Optional[np.ndarray]] = [None] * n
        out[self.rank] = np.asarray(value)
        if n == 1:
            return out  # type: ignore[return-value]
        nxt = (self.rank + 1) % n
        carry_idx = self.rank
        for step in range(n - 1):
            fut = self._send_async(nxt, (seq, "ag", step), out[carry_idx])
            carry_idx = (self.rank - step - 1) % n
            arr, holder = self._materialize(self._recv((seq, "ag", step)))
            if holder is not None:
                arr = np.array(arr)
                self._finish_consume(holder)
            out[carry_idx] = arr
            if fut is not None:
                fut.result(timeout=self._timeout)
        return out  # type: ignore[return-value]

    def _broadcast(self, seq: int, value, src: int):
        """Binomial tree: log2(N) rounds, no rank sends more than
        ceil(log2 N) copies (vs the hub serializing N sends)."""
        n = self.world_size
        rel = (self.rank - src) % n
        holder = None
        if rel != 0:
            arr, holder = self._materialize(self._recv((seq, "bc", rel)))
        else:
            arr = np.asarray(value)
        # Forward to children in the binomial tree over RELATIVE ranks:
        # node `rel` owns children rel + 2^k for 2^k > rel. Sends overlap
        # (async); on a homogeneous same-store group the payload is
        # written to shm ONCE (by the root) and the whole tree circulates
        # its key — every forward hop is a 16-byte message.
        children = []
        k = 1
        while k < n:
            if rel < k and rel + k < n:
                children.append(rel + k)
            k *= 2
        futs = []
        key_holder = holder
        if (children and key_holder is None and self._all_same_store
                and self._shm is not None and isinstance(arr, np.ndarray)
                and arr.nbytes >= self.SHM_MIN_BYTES):
            key = self._publish_shm(
                arr, self._bc_subtree_consumers(rel, n))
            if key is not None:
                # Root-side pseudo-holder: carries the key for forwarding;
                # the root itself never acks/closes it.
                key_holder = _ShmIncoming(arr, key, self.rank, self._shm)
        for child_rel in children:
            if key_holder is not None and self._all_same_store:
                futs.append(self._peers.get(
                    self._addrs[(src + child_rel) % n]).call_async(
                    "deliver_shm", (seq, "bc", child_rel), key_holder.key,
                    arr.shape, _dtype_token(arr.dtype), key_holder.origin))
            else:
                futs.append(self._send_async(
                    (src + child_rel) % n, (seq, "bc", child_rel), arr))
        for fut in futs:
            if fut is not None:
                fut.result(timeout=self._timeout)
        if holder is not None:
            arr = np.array(arr)  # result is returned to the caller
            self._finish_consume(holder)
        return arr

    def _alltoall(self, seq: int, value):
        n = self.world_size
        shards = np.array_split(np.asarray(value), n, axis=0)
        futs = []
        for dst in range(n):
            if dst != self.rank:
                futs.append(self._send_async(
                    dst, (seq, "a2a", self.rank), shards[dst]))
        pieces = []
        holders = []
        for s in range(n):
            if s == self.rank:
                pieces.append(shards[self.rank])
            else:
                arr, holder = self._materialize(self._recv((seq, "a2a", s)))
                pieces.append(arr)
                if holder is not None:
                    holders.append(holder)
        result = np.concatenate(pieces, axis=0)  # copies: views die after
        for h in holders:
            self._finish_consume(h)
        for fut in futs:
            if fut is not None:
                fut.result(timeout=self._timeout)
        return result

    # -- p2p ----------------------------------------------------------------

    def p2p_send(self, src: int, dst: int, value) -> None:
        self._send(dst, ("p2p", src, dst,
                         self._p2p_counter(src, dst, "send")), value)

    def p2p_recv(self, src: int, dst: int,
                 timeout: Optional[float] = None):
        # Matching monotone counters on both ends keep repeated send/recv
        # pairs FIFO-ordered. The cursor is RESERVED under the lock before
        # blocking — two concurrent recvs for the same (src, dst) get
        # distinct tags instead of racing for one message and stranding the
        # loser on a tag the sender has moved past. A timed-out recv rolls
        # its reservation back (only if it is still the newest — with a
        # later recv outstanding the gap is unrecoverable either way) so a
        # single-threaded retry consumes the late-arriving message.
        if timeout is None:
            timeout = self._timeout
        key = ("p2p_ctr", src, dst, "recv")
        with self._op_lock:
            d = getattr(self, "_p2p_counts", None)
            if d is None:
                d = self._p2p_counts = {}
            nxt = d.get(key, 0) + 1
            d[key] = nxt
        try:
            return self._recv(("p2p", src, dst, nxt), timeout)
        except BaseException:
            with self._op_lock:
                if self._p2p_counts.get(key) == nxt:
                    self._p2p_counts[key] = nxt - 1
            raise

    def _p2p_counter(self, src: int, dst: int, direction: str) -> int:
        key = ("p2p_ctr", src, dst, direction)
        with self._op_lock:
            d = getattr(self, "_p2p_counts", None)
            if d is None:
                d = self._p2p_counts = {}
            d[key] = d.get(key, 0) + 1
            return d[key]


@dataclass
class GroupInfo:
    name: str
    world_size: int
    backend: str


_groups: Dict[str, _GroupState] = {}
_groups_lock = threading.Lock()
# rank registry keyed by execution context: an actor's rank is visible from
# every thread that executes its methods (actor init and method calls run on
# different threads in the runtime).
_ranks: Dict[tuple, Dict[str, int]] = {}


def _ctx_key() -> tuple:
    try:
        rt = get_runtime()
        aid = rt.current_actor_id
        if aid is not None:
            return ("actor", aid)
    except Exception:  # noqa: BLE001 — no runtime: plain thread context
        log_swallowed(logger, "runtime lookup in _ctx_key")
    return ("thread", threading.get_ident())


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "local",
    group_name: str = "default",
) -> None:
    """Join a named collective group.

    Every member actor/task calls this with its rank; the group state
    rendezvouses through the process-wide registry (``local``, ``device``)
    or the control plane's KV (``gloo``, ``ring``).
    """
    if backend not in ("local", "gloo", "ring", "device", "xla"):
        raise ValueError(f"unknown backend {backend}")
    if backend == "xla":
        # No silent fallback: tensors inside one program use the mesh's
        # collectives (torch.distributed); the EAGER device tier is
        # backend="device".
        raise RuntimeError(
            "backend='xla' is the compiled path of the JAX package; in the "
            "port, tensors inside one program use the mesh's collectives "
            "(ray_tpu_torch/parallel/mesh.py: make_mesh and "
            "torch.distributed). For eager collectives between actors use "
            "backend='device' (torch tensors on one device), 'gloo' (host "
            "tensors, ring over sockets) or 'local' (in-process).")
    if backend in ("gloo", "ring"):
        _init_distributed_group(world_size, rank, group_name)
    else:
        cls = _DeviceGroupState if backend == "device" else _GroupState
        with _groups_lock:
            state = _groups.get(group_name)
            if state is None:
                state = cls(world_size)
                _groups[group_name] = state
            elif state.world_size != world_size:
                raise ValueError(
                    f"group {group_name} exists with world_size={state.world_size}"
                )
            elif type(state) is not cls:
                raise ValueError(
                    f"group {group_name} exists with backend="
                    f"{state.backend!r}")
    with _groups_lock:
        _ranks.setdefault(_ctx_key(), {})[group_name] = rank
    # Record membership in the control plane for observability.
    try:
        get_runtime().gcs.kv_put(
            f"collective:{group_name}:{rank}", b"1", namespace="collective"
        )
    except Exception:  # noqa: BLE001 — observability only
        log_swallowed(logger, "membership kv_put")


def _init_distributed_group(world_size: int, rank: int, group_name: str) -> None:
    """Cross-process backend: every rank hosts a member mailbox server and
    publishes its address — AND its node-store name + hierarchy vote, the
    topology rendezvous — through the control plane's KV; collectives then
    run rank-to-rank over the two-level or flat schedule with no hub."""
    import time as _time

    from ray_tpu_torch.core.rpc import RpcServer

    with _groups_lock:
        existing = _groups.get(group_name)
        if existing is not None and existing.world_size != world_size:
            raise ValueError(
                f"group {group_name} exists with world_size="
                f"{existing.world_size}")

    import os as _os

    cfg = _get_config()
    gcs = get_runtime().gcs
    service = _MemberService()
    # Open the node store (and arm the service's shm surface) BEFORE the
    # address is published: a fast peer may deliver_shm the instant it can
    # see this rank. RAY_TPU_COLLECTIVE_SHM=0 disables the shm transport
    # (A/B benching + emergency fallback to pure sockets).
    my_store = _os.environ.get("RAY_TPU_STORE_NAME", "")
    if _os.environ.get("RAY_TPU_COLLECTIVE_SHM", "1") == "0":
        my_store = ""
    if my_store:
        try:
            from ray_tpu_torch.core.native_store import NativeObjectStore

            service.shm = NativeObjectStore.open(my_store)
        except Exception:  # noqa: BLE001 — no local store: socket path
            service.shm = None
            my_store = ""
    server = RpcServer(service, name=f"collective-{group_name}-r{rank}",
                       max_workers=max(8, world_size + 2))
    my_hier = "1" if cfg.collective_hierarchy_enabled else "0"
    gcs.kv_put(f"collective:{group_name}:addr:{rank}",
               f"{server.address}|{my_store}|{my_hier}".encode(),
               namespace="collective")
    addrs: List[Optional[str]] = [None] * world_size
    stores: List[Optional[str]] = [None] * world_size
    hier_votes: List[bool] = [True] * world_size
    addrs[rank] = server.address
    stores[rank] = my_store or None
    hier_votes[rank] = my_hier == "1"
    deadline = _time.time() + 60.0
    while any(a is None for a in addrs):
        for r in range(world_size):
            if addrs[r] is None:
                raw = gcs.kv_get(f"collective:{group_name}:addr:{r}",
                                 namespace="collective")
                if raw:
                    parts = raw.decode().split("|")
                    addrs[r] = parts[0]
                    stores[r] = (parts[1] or None) if len(parts) > 1 else None
                    hier_votes[r] = parts[2] != "0" if len(parts) > 2 else True
        if any(a is None for a in addrs):
            if _time.time() > deadline:
                server.stop()
                missing = [r for r in range(world_size) if addrs[r] is None]
                raise TimeoutError(
                    f"collective group {group_name}: ranks {missing} never "
                    f"published their member address")
            _time.sleep(0.05)
    # The schedule must be identical on every rank (tags would never pair
    # up otherwise): the hierarchy runs only when EVERY member voted for it.
    group = _DistributedGroup(world_size, rank, addrs, service, server,
                              stores=stores, hierarchy=all(hier_votes))
    group._kv_key = f"collective:{group_name}:addr:{rank}"
    with _groups_lock:
        _groups[group_name] = group  # type: ignore[assignment]


def destroy_collective_group(group_name: str = "default") -> None:
    with _groups_lock:
        state = _groups.pop(group_name, None)
    server = getattr(state, "_server", None)
    if server is not None:  # cross-process member mailbox server
        server.stop()
        peers = getattr(state, "_peers", None)
        if peers is not None:  # close per-peer clients (one per rank)
            peers.close_all()
        # Drop the rendezvous key so a re-created group can't race a
        # later joiner onto a dead member's address.
        try:
            get_runtime().gcs.kv_del(getattr(state, "_kv_key", ""),
                                     namespace="collective")
        except Exception:  # noqa: BLE001 — GCS gone at teardown
            log_swallowed(logger, "rendezvous kv_del")


def get_rank(group_name: str = "default") -> int:
    with _groups_lock:
        ranks = _ranks.get(_ctx_key(), {})
        if group_name in ranks:
            return ranks[group_name]
    raise RuntimeError(
        f"init_collective_group must be called in this actor/task first "
        f"(group={group_name})"
    )


def get_collective_group_size(group_name: str = "default") -> int:
    state = _group(group_name)
    return state.world_size


def get_group_stats(group_name: str = "default") -> Dict[str, int]:
    """Instrumentation snapshot for a cross-process group: logical payload
    bytes sent split by same-store vs cross-store destination (the
    cross-node traffic the hierarchy minimizes) and how many reduction
    rounds took each schedule. Empty for in-process backends."""
    state = _group(group_name)
    st = getattr(state, "stats", None)
    return dict(st) if st else {}


def all_group_stats() -> Dict[str, Dict[str, int]]:
    """:func:`get_group_stats` over every live group in this process — the
    metrics exporter's collector mirrors these into per-group gauges."""
    with _groups_lock:
        items = list(_groups.items())
    out: Dict[str, Dict[str, int]] = {}
    for name, state in items:
        st = getattr(state, "stats", None)
        if st:
            out[name] = dict(st)
    return out


def _group(group_name: str) -> _GroupState:
    with _groups_lock:
        state = _groups.get(group_name)
    if state is None:
        raise RuntimeError(f"collective group '{group_name}' not initialized")
    return state


def _is_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _to_numpy(tensor) -> np.ndarray:
    """Host numpy for the host backends: a torch tensor through
    ``.detach().cpu()``, a bf16 one as its :data:`BF16` words."""
    if not _is_tensor(tensor):
        return np.asarray(tensor)
    import torch

    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _from_host(value):
    """A host backend's result for the caller: :data:`BF16` words back as
    a bf16 CPU tensor (lists and dicts of results element-wise); the rest
    as it is."""
    if isinstance(value, np.ndarray) and _is_bf16(value.dtype):
        import torch

        return torch.from_numpy(
            np.ascontiguousarray(value).view(np.int16)).view(torch.bfloat16)
    if isinstance(value, list):
        return [_from_host(v) for v in value]
    if isinstance(value, dict):
        return {k: _from_host(v) for k, v in value.items()}
    return value


def _prep(state, tensor):
    """Device-backend groups keep tensors ON DEVICE; host backends get
    numpy."""
    if getattr(state, "backend", "local") == "device":
        return tensor
    return _to_numpy(tensor)


def _traced_op(op: str, group: str, rank: int, call):
    """Flight-record the enter/exit edges of one collective op — a rank
    that dies inside the rendezvous leaves an unmatched ``enter`` in its
    ring, which is exactly what the postmortem needs to name the straggler
    that hung the group."""
    flightrec.record("collective", group[:32], f"enter {op} rank={rank}")
    try:
        result = call()
    except BaseException as e:
        flightrec.record("collective", group[:32],
                         f"FAIL {op} rank={rank}: {type(e).__name__}")
        raise
    flightrec.record("collective", group[:32], f"exit {op} rank={rank}")
    return result


def allreduce(tensor, op: str = "sum", group_name: str = "default"):
    """Reduce ``tensor`` over the group; every rank gets the result."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op}")
    state = _group(group_name)
    rank = get_rank(group_name)
    return _from_host(_traced_op(
        "allreduce", group_name, rank, lambda: state.exchange_desc(
            rank, ("allreduce", op), _prep(state, tensor))))


def barrier(group_name: str = "default") -> None:
    """Block until every rank of the group has arrived."""
    state = _group(group_name)
    rank = get_rank(group_name)
    _traced_op("barrier", group_name, rank,
               lambda: state.exchange_desc(rank, ("barrier",), None))


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """Every rank gets ``src_rank``'s tensor."""
    state = _group(group_name)
    rank = get_rank(group_name)
    value = _prep(state, tensor) if rank == src_rank else None
    return _from_host(_traced_op(
        "broadcast", group_name, rank, lambda: state.exchange_desc(
            rank, ("broadcast", src_rank), value)))


def allgather(tensor, group_name: str = "default") -> List[np.ndarray]:
    """Every rank gets the list of per-rank tensors."""
    state = _group(group_name)
    rank = get_rank(group_name)
    return _from_host(_traced_op(
        "allgather", group_name, rank, lambda: state.exchange_desc(
            rank, ("allgather",), _prep(state, tensor))))


def reducescatter(tensor, op: str = "sum", group_name: str = "default"):
    """Input split along dim 0 across ranks; each rank receives its
    reduced shard."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op}")
    state = _group(group_name)
    rank = get_rank(group_name)
    shards = _traced_op("reducescatter", group_name, rank, lambda: state.
                        exchange_desc(rank, ("reducescatter", op),
                                      _to_numpy(tensor)))
    return _from_host(shards[rank])


def alltoall(tensor, group_name: str = "default"):
    """Each rank's input is split along dim 0; shard i goes to rank i.

    The host-side analog of XLA ``all_to_all`` (expert-parallel routing).
    """
    state = _group(group_name)
    rank = get_rank(group_name)
    return _from_host(_traced_op(
        "alltoall", group_name, rank, lambda: state.exchange_desc(
            rank, ("alltoall",), _to_numpy(tensor)))[rank])


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send to ``dst_rank``."""
    state = _group(group_name)
    rank = get_rank(group_name)
    _traced_op("send", group_name, rank,
               lambda: state.p2p_send(rank, dst_rank, _to_numpy(tensor)))


def recv(src_rank: int, group_name: str = "default",
         timeout: Optional[float] = None):
    """Point-to-point receive from ``src_rank``. ``timeout=None`` uses the
    group's ``collective_timeout_s``."""
    state = _group(group_name)
    rank = get_rank(group_name)
    return _from_host(_traced_op(
        "recv", group_name, rank,
        lambda: state.p2p_recv(src_rank, rank, timeout)))

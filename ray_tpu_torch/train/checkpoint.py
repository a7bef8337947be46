"""Checkpoints — directory-backed, pytree-aware.

Analog of the reference's ``ray.train.Checkpoint`` + ``CheckpointManager``
(``python/ray/train/_internal/checkpoint_manager.py``, ``storage.py``): a
checkpoint IS a directory; ``report(..., checkpoint=)`` persists it under the
run's storage path; the manager tracks top-k by a score attribute.

Counterpart of ``ray_tpu/train/checkpoint.py``, on the same disk format: a
tree of tensors, numpy arrays and JSON scalars is one ``{name}.npz`` (the
arrays, keyed by their index in the flatten order: dict keys sorted, lists
and tuples in order, ``None`` a leaf) plus ``{name}.tree.json`` (the
skeleton and each leaf's kind). A NamedTuple is stored as a tuple, as the
JAX package stores optax's states. A tensor is stored as its host copy (a
DTensor as its whole tensor). numpy has no bfloat16, so a bf16 leaf is
stored as its 16-bit words with ``"dtype": "bfloat16"`` in its meta; every
other dtype is stored as numpy stores it, so f32, f16 and integer leaves
read the same in both packages (the JAX package's loader reads only
``kind``).

``load_pytree`` returns numpy arrays (a bf16 leaf as a bf16 CPU tensor);
``restore_pytree`` places each leaf as the target's leaf is placed.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor


class Checkpoint:
    """A checkpoint is a directory (reference: ``ray.train.Checkpoint``)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="rtpu-ckpt-")
        save_pytree(data, d)
        return cls(d)

    # -- accessors ----------------------------------------------------------
    def to_directory(self) -> str:
        return self.path

    def to_dict(self) -> Dict[str, Any]:
        return load_pytree(self.path)

    def __repr__(self):
        return f"Checkpoint({self.path!r})"


_BF16 = "bfloat16"


def _host_leaf(x, copy: bool = False):
    """A leaf as the host holds it: a tensor on the CPU (a CUDA tensor by one
    device-to-host copy; a DTensor's whole tensor first; with ``copy`` a CPU
    tensor cloned too, so that later in-place updates cannot reach it);
    anything else as it is."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=copy)
    return x


def _flatten(tree) -> List[Any]:
    """The leaves in the JAX package's flatten order: dict keys sorted,
    lists and tuples (NamedTuples too) in order, ``None`` a leaf."""
    out: List[Any] = []

    def rec(node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v)
        else:
            out.append(node)

    rec(tree)
    return out


def _same_dict(node: dict, items) -> dict:
    """A dict of ``node``'s own type (an OrderedDict, a defaultdict with its
    factory) holding ``items``."""
    out = node.copy()
    out.clear()
    out.update(items)
    return out


def _map_leaves(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, containers kept
    (a NamedTuple rebuilt as its own type)."""
    if isinstance(tree, dict):
        return _same_dict(tree, ((k, _map_leaves(fn, v))
                                 for k, v in tree.items()))
    if isinstance(tree, list):
        return [_map_leaves(fn, v) for v in tree]
    if isinstance(tree, tuple):
        vals = [_map_leaves(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree)


def _array_of(leaf) -> Tuple[np.ndarray, Dict[str, str]]:
    """(the array written to the npz, the leaf's meta)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return (leaf.contiguous().view(torch.int16).numpy().view(np.uint16),
                    {"kind": "array", "dtype": _BF16})
        return leaf.numpy(), {"kind": "array"}
    a = np.asarray(leaf)
    if a.dtype.name == _BF16:      # a JAX bf16 array (ml_dtypes) handed over
        return a.view(np.uint16), {"kind": "array", "dtype": _BF16}
    return a, {"kind": "array"}


def save_pytree(tree: Any, directory: str, *, name: str = "state") -> str:
    """Write a pytree of tensors/arrays/scalars to ``directory``.

    Arrays → ``{name}.npz`` keyed by flattened index; structure + non-array
    leaves → ``{name}.tree.json``.
    """
    os.makedirs(directory, exist_ok=True)
    skeleton = _treedef_to_json(tree)       # rejects non-str keys first
    leaves = [_host_leaf(x) for x in _flatten(tree)]
    arrays: Dict[str, np.ndarray] = {}
    meta: List[Dict] = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
            arrays[str(i)], m = _array_of(leaf)
            meta.append(m)
        elif isinstance(leaf, (int, float, bool, str, type(None))):
            meta.append({"kind": "json", "value": leaf})
        else:
            raise TypeError(f"unsupported checkpoint leaf type {type(leaf)}")
    np.savez(os.path.join(directory, f"{name}.npz"), **arrays)
    with open(os.path.join(directory, f"{name}.tree.json"), "w") as f:
        json.dump({"structure": skeleton, "leaves": meta}, f)
    return directory


def _treedef_to_json(tree) -> Any:
    """JSON skeleton with leaf positions as {"__leaf__": i}."""
    counter = [0]

    def rec(node):
        if isinstance(node, dict):
            if any(not isinstance(k, str) for k in node):
                raise TypeError(
                    f"checkpoint dict keys must be str, got {list(node)[:4]}"
                )
            return {"__dict__": {k: rec(node[k]) for k in sorted(node)}}
        if isinstance(node, (list, tuple)):
            tag = "__list__" if isinstance(node, list) else "__tuple__"
            return {tag: [rec(v) for v in node]}
        i = counter[0]
        counter[0] += 1
        return {"__leaf__": i}

    return rec(tree)


def _json_to_tree(skel, leaves: List[Any]) -> Any:
    def rec(node):
        if "__leaf__" in node:
            return leaves[node["__leaf__"]]
        if "__dict__" in node:
            return {k: rec(v) for k, v in node["__dict__"].items()}
        if "__list__" in node:
            return [rec(v) for v in node["__list__"]]
        if "__tuple__" in node:
            return tuple(rec(v) for v in node["__tuple__"])
        raise ValueError(f"bad checkpoint skeleton node: {node}")

    return rec(skel)


def _read(directory: str, name: str):
    """(the skeleton, the leaves: numpy arrays, bf16 CPU tensors, JSON
    values)."""
    with open(os.path.join(directory, f"{name}.tree.json")) as f:
        spec = json.load(f)
    leaves: List[Any] = []
    with np.load(os.path.join(directory, f"{name}.npz")) as npz:
        for i, m in enumerate(spec["leaves"]):
            if m["kind"] != "array":
                leaves.append(m["value"])
            elif m.get("dtype") == _BF16:
                leaves.append(torch.from_numpy(
                    npz[str(i)].view(np.int16)).view(torch.bfloat16))
            else:
                leaves.append(npz[str(i)])
    return spec["structure"], leaves


def load_pytree(directory: str, *, name: str = "state") -> Any:
    skeleton, leaves = _read(directory, name)
    return _json_to_tree(skeleton, leaves)


def _place(loaded, target):
    """A loaded leaf placed as ``target`` is: a DTensor on its mesh with its
    placements, a tensor with its dtype, device and ``requires_grad``;
    anything else comes back as loaded."""
    if not isinstance(target, torch.Tensor):
        return loaded
    t = torch.as_tensor(loaded).to(device=target.device, dtype=target.dtype)
    if isinstance(target, DTensor):
        t = distribute_tensor(t, target.device_mesh, target.placements)
    return t.requires_grad_(target.requires_grad)


def restore_pytree(target: Any, directory: str, *, name: str = "state") -> Any:
    """Load leaves into the STRUCTURE of ``target`` (exact container types —
    NamedTuple optimizer states etc. — are preserved, unlike ``load_pytree``
    which returns plain dicts/lists/tuples); a leaf whose target is a tensor
    takes that tensor's dtype and device (a DTensor's mesh and
    placements)."""
    n_target = len(_flatten(target))
    _, loaded = _read(directory, name)
    if len(loaded) != n_target:
        raise ValueError(
            f"checkpoint has {len(loaded)} leaves but target expects {n_target}"
        )
    it = iter(loaded)

    def rec(node):
        # Leaves pair up in the flatten order (dict keys sorted); the result
        # keeps the target's own key order.
        if isinstance(node, dict):
            vals = {k: rec(node[k]) for k in sorted(node)}
            return _same_dict(node, ((k, vals[k]) for k in node))
        if isinstance(node, list):
            return [rec(v) for v in node]
        if isinstance(node, tuple):
            vals = [rec(v) for v in node]
            return type(node)(*vals) if hasattr(node, "_fields") else tuple(vals)
        return _place(next(it), node)

    return rec(target)


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (orbax-style async save):
    ``save`` snapshots to host memory synchronously (one device-to-host copy
    a CUDA tensor) and writes on a background thread; ``wait`` joins the
    in-flight write and raises what it raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, tree: Any, directory: str) -> None:
        # Torch updates tensors in place (JAX arrays are immutable), so the
        # snapshot is a copy of every tensor, taken before save returns.
        host_tree = _map_leaves(lambda x: _host_leaf(x, copy=True), tree)
        # raylint: ignore[untimed-wait] — joins our own writer thread, not
        # a peer; bounded by the filesystem write
        self.wait()

        def run():
            try:
                save_pytree(host_tree, directory)
            except BaseException as e:  # surfaced from wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


@dataclass(order=True)
class _TrackedCheckpoint:
    score: float
    index: int
    checkpoint: "Checkpoint" = field(compare=False)
    metrics: Dict = field(compare=False, default_factory=dict)


class CheckpointManager:
    """Top-k retention (reference: ``_internal/checkpoint_manager.py``)."""

    def __init__(self, storage_path: str, config: Optional["CheckpointConfig"] = None):
        from ray_tpu_torch.train.config import CheckpointConfig

        self.storage_path = storage_path
        self.config = config or CheckpointConfig()
        self._tracked: List[_TrackedCheckpoint] = []
        self._index = 0
        os.makedirs(storage_path, exist_ok=True)

    def register(self, checkpoint: Checkpoint, metrics: Dict) -> Checkpoint:
        """Persist ``checkpoint`` into storage and apply retention."""
        dest = os.path.join(self.storage_path, f"checkpoint_{self._index:06d}")
        if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.copytree(checkpoint.path, dest)
        persisted = Checkpoint(dest)

        attr = self.config.checkpoint_score_attribute
        if attr is not None and attr in metrics:
            score = float(metrics[attr])
            if self.config.checkpoint_score_order == "min":
                score = -score
        else:
            score = float(self._index)  # recency
        self._tracked.append(_TrackedCheckpoint(score, self._index, persisted, dict(metrics)))
        self._index += 1

        k = self.config.num_to_keep
        if k is not None and len(self._tracked) > k:
            self._tracked.sort()
            evicted = self._tracked.pop(0)
            shutil.rmtree(evicted.checkpoint.path, ignore_errors=True)
        return persisted

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        return max(self._tracked).checkpoint

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        return max(self._tracked, key=lambda t: t.index).checkpoint

    def checkpoints(self) -> List[Tuple[Checkpoint, Dict]]:
        return [(t.checkpoint, t.metrics) for t in sorted(self._tracked, key=lambda t: t.index)]

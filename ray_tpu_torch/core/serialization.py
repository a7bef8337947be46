"""Object serialization with out-of-band buffers.

Counterpart of ``ray_tpu/core/serialization.py``'s one-shot half,
:func:`dumps` and :func:`loads`: cloudpickle (plain pickle where it can)
with protocol-5 out-of-band buffers, so a large numpy array rides beside the
pickle as raw bytes and comes back as a view of the blob.

Where the JAX package materializes a ``jax.Array`` to host numpy before
pickling, the port does the same for a ``torch.Tensor``: the tensor is
copied to the host and travels as its raw bytes (an integer view of the
same width, so bfloat16, which numpy has no dtype for, survives bit for
bit) beside its torch dtype and shape; :func:`loads` rebuilds a CPU tensor
of that dtype. The object plane's framing helpers (``SerializedObject``'s
``write_into``, the in-band task-spec encoding, the ref collection) come
with the core runtime (ROADMAP Queue 1).
"""

from __future__ import annotations

import io
import pickle
from dataclasses import dataclass

import cloudpickle
import numpy as np
import torch

# A torch dtype's raw bytes travel as the numpy integer type of its width.
_RAW = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def _rebuild_tensor(raw: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    # The buffer may be a read-only view of the blob: copy once, then
    # reinterpret the bytes as the tensor's own dtype.
    return torch.from_numpy(np.array(raw)).view(
        getattr(torch, dtype_name)).reshape(shape)


class _HostTensor:
    """A tensor's bytes on the host, pickled as the raw integer view (out
    of band under protocol 5) plus its dtype name and shape."""

    __slots__ = ("raw", "dtype_name", "shape")

    def __init__(self, t: torch.Tensor):
        t = t.detach().to("cpu").contiguous()
        self.raw = t.reshape(-1).view(torch.uint8).numpy().view(
            _RAW[t.element_size()])
        self.dtype_name = str(t.dtype).removeprefix("torch.")
        self.shape = tuple(t.shape)

    def __reduce__(self):
        return (_rebuild_tensor, (self.raw, self.dtype_name, self.shape))


def _devicify_for_pickle(obj):
    """Convert a torch tensor to its host form; leave everything else."""
    if isinstance(obj, torch.Tensor):
        return _HostTensor(obj)
    return obj


@dataclass
class SerializedObject:
    """Wire format: header bytes + out-of-band payload buffers."""

    header: bytes
    buffers: list  # list of bytes-like (memoryview/bytes/np buffers)

    def to_bytes(self) -> bytes:
        """Flatten to a single contiguous blob (header-length-prefixed)."""
        out = io.BytesIO()
        out.write(len(self.header).to_bytes(8, "big"))
        out.write(self.header)
        out.write(len(self.buffers).to_bytes(4, "big"))
        for b in self.buffers:
            mv = memoryview(b).cast("B")
            out.write(len(mv).to_bytes(8, "big"))
            out.write(mv)
        return out.getvalue()

    @classmethod
    def from_bytes(cls, blob) -> "SerializedObject":
        """Parse a ``to_bytes`` blob; bytes after its last buffer are
        ignored (a caller may pad it)."""
        mv = memoryview(blob).cast("B")
        off = 0
        hlen = int.from_bytes(mv[off:off + 8], "big")
        off += 8
        header = bytes(mv[off:off + hlen])
        off += hlen
        nbuf = int.from_bytes(mv[off:off + 4], "big")
        off += 4
        buffers = []
        for _ in range(nbuf):
            blen = int.from_bytes(mv[off:off + 8], "big")
            off += 8
            buffers.append(mv[off:off + blen])  # zero-copy views into blob
            off += blen
        return cls(header=header, buffers=buffers)


class _NeedCloudpickle(Exception):
    pass


class _FastPickler(pickle.Pickler):
    """Plain pickle with a tripwire: anything plain pickle would serialize
    BY REFERENCE into a module the receiving process may not have
    (``__main__``-defined classes/functions, interactively defined code)
    aborts the fast path so cloudpickle serializes it by value."""

    def reducer_override(self, obj):
        if isinstance(obj, type) or callable(obj):
            mod = getattr(obj, "__module__", None)
            if mod in ("__main__", "__mp_main__", None):
                raise _NeedCloudpickle
            registry = cloudpickle.list_registry_pickle_by_value()
            if registry and any(
                    mod == r or mod.startswith(r + ".") for r in registry):
                raise _NeedCloudpickle
        return NotImplemented


def serialize(obj) -> SerializedObject:
    buffers: list = []

    obj = _devicify_for_pickle(obj)

    def _buffer_callback(pickle_buffer):
        buffers.append(pickle_buffer.raw())
        return False  # do not serialize in-band

    try:
        out = io.BytesIO()
        _FastPickler(out, protocol=5,
                     buffer_callback=_buffer_callback).dump(obj)
        header = out.getvalue()
    except Exception:  # noqa: BLE001 — closures/lambdas/__main__ classes
        buffers.clear()
        header = cloudpickle.dumps(obj, protocol=5,
                                   buffer_callback=_buffer_callback)
    return SerializedObject(header=header, buffers=buffers)


def deserialize(serialized: SerializedObject):
    return pickle.loads(serialized.header, buffers=serialized.buffers)


def dumps(obj) -> bytes:
    """One-shot contiguous serialization."""
    return serialize(obj).to_bytes()


def loads(blob):
    return deserialize(SerializedObject.from_bytes(blob))

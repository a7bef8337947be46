"""Object serialization with zero-copy buffer extraction.

Counterpart of ``ray_tpu/core/serialization.py``: cloudpickle (plain pickle
where it can) with protocol-5 out-of-band buffers, so a large numpy array
rides beside the pickle as raw bytes and comes back as a view of the blob.
:class:`SerializedObject` is the object plane's framing (``to_bytes``,
``framed_size``/``write_into`` straight into a shared-memory slot,
``from_bytes``); :func:`dumps_inband` is the compact form without it; the
ref collection (:func:`collecting_refs`) records every ``ObjectRef``
pickled inside a value.

Where the JAX package materializes a ``jax.Array`` to host numpy before
pickling, the port does the same for a ``torch.Tensor`` — anywhere in the
object, not only at its top: the tensor is copied to the host and travels
as its raw bytes (an integer view of the same width, so bfloat16, which
numpy has no dtype for, survives bit for bit) beside its torch dtype and
shape; deserialization rebuilds a CPU tensor of that dtype. The object
plane is a host-RAM plane: a consumer moves the tensor back to its device.
"""

from __future__ import annotations

import contextlib
import io
import pickle
import sys
import threading
from dataclasses import dataclass

import cloudpickle
import numpy as np

# Serialize-time ObjectRef collection (nested-ref borrow protocol): while a
# collection scope is open on this thread, ObjectRef.__reduce__ records every
# ref pickled. Scopes nest (spec serialization inside value serialization).
_COLLECT = threading.local()


def note_serialized_ref(ref) -> None:
    lst = getattr(_COLLECT, "refs", None)
    if lst is not None:
        lst.append(ref)


@contextlib.contextmanager
def collecting_refs():
    """Collect ObjectRefs pickled on this thread; yields the list."""
    prev = getattr(_COLLECT, "refs", None)
    out: list = []
    _COLLECT.refs = out
    try:
        yield out
    finally:
        _COLLECT.refs = prev


# A torch dtype's raw bytes travel as the numpy integer type of its width
# (bytes for any other width).
_RAW = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def _is_tensor(obj) -> bool:
    """Whether ``obj`` is a ``torch.Tensor``, without importing torch: a
    process that has not imported torch holds no tensor, so the worker,
    daemon and GCS processes pay torch's import only when one arrives."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(obj, torch.Tensor)


def _rebuild_tensor(raw: np.ndarray, dtype_name: str, shape):
    # The buffer may be a read-only view of the blob: copy once, then
    # reinterpret the bytes as the tensor's own dtype.
    import torch

    return torch.from_numpy(np.array(raw)).view(
        getattr(torch, dtype_name)).reshape(shape)


class _HostTensor:
    """A tensor's bytes on the host, pickled as the raw integer view (out
    of band under protocol 5) plus its dtype name and shape."""

    __slots__ = ("raw", "dtype_name", "shape")

    def __init__(self, t):
        import torch

        t = t.detach().to("cpu").contiguous()
        self.raw = t.reshape(-1).view(torch.uint8).numpy().view(
            _RAW.get(t.element_size(), np.uint8))
        self.dtype_name = str(t.dtype).removeprefix("torch.")
        self.shape = tuple(t.shape)

    def __reduce__(self):
        return (_rebuild_tensor, (self.raw, self.dtype_name, self.shape))


def _host_reduce(obj):
    """The reduction of ``obj`` if it is a tensor, else NotImplemented."""
    if _is_tensor(obj):
        return _HostTensor(obj).__reduce__()
    return NotImplemented


@dataclass
class SerializedObject:
    """Wire format: header bytes + out-of-band payload buffers."""

    header: bytes
    buffers: list  # list of bytes-like (memoryview/bytes/np buffers)

    def total_size(self) -> int:
        return len(self.header) + sum(len(memoryview(b).cast("B")) for b in self.buffers)

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

    def framed_size(self) -> int:
        """Exact size of the ``to_bytes`` flattening — lets a producer
        allocate the destination (e.g. a shm arena slot) up front and
        ``write_into`` it with no intermediate contiguous copy."""
        return (12 + len(self.header)
                + sum(8 + len(memoryview(b).cast("B")) for b in self.buffers))

    def write_into(self, dest) -> None:
        """Write the ``to_bytes`` layout directly into a writable buffer of
        ``framed_size()`` bytes (no intermediate contiguous copy)."""
        off = 0
        off += fast_copy_into(dest, off, len(self.header).to_bytes(8, "big"))
        off += fast_copy_into(dest, off, self.header)
        off += fast_copy_into(dest, off, len(self.buffers).to_bytes(4, "big"))
        for b in self.buffers:
            mv = memoryview(b).cast("B")
            off += fast_copy_into(dest, off, len(mv).to_bytes(8, "big"))
            off += fast_copy_into(dest, off, mv)

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


def fast_copy_into(dest, dest_offset: int, src) -> int:
    """memcpy-speed buffer copy: ``dest[dest_offset:...] = src`` through
    numpy, because memoryview slice assignment degrades to ~75 MB/s on
    large (especially cross-process shm) buffers. Returns bytes written.
    One definition for every bulk copy in the object plane."""
    src_mv = memoryview(src).cast("B")
    out = np.frombuffer(memoryview(dest).cast("B"), dtype=np.uint8)
    out[dest_offset:dest_offset + len(src_mv)] = np.frombuffer(
        src_mv, dtype=np.uint8)
    return len(src_mv)


class _NeedCloudpickle(Exception):
    pass


class _FastPickler(pickle.Pickler):
    """Plain pickle with a tripwire: anything plain pickle would serialize
    BY REFERENCE into a module the receiving process may not have
    (``__main__``-defined classes/functions, interactively defined code)
    aborts the fast path so cloudpickle serializes it by value. Tensors go
    to the host as :class:`_HostTensor`."""

    def reducer_override(self, obj):
        if _is_tensor(obj):
            return _host_reduce(obj)
        if isinstance(obj, type) or callable(obj):
            mod = getattr(obj, "__module__", None)
            if mod in ("__main__", "__mp_main__", None):
                raise _NeedCloudpickle
            registry = cloudpickle.list_registry_pickle_by_value()
            if registry and any(
                    mod == r or mod.startswith(r + ".") for r in registry):
                # register_pickle_by_value(pkg) covers submodules too —
                # mirror cloudpickle's parent-package walk.
                raise _NeedCloudpickle
        return NotImplemented


class _CloudPickler(cloudpickle.Pickler):
    """cloudpickle, with tensors going to the host as in the fast path."""

    def reducer_override(self, obj):
        if _is_tensor(obj):
            return _host_reduce(obj)
        return super().reducer_override(obj)


def _cloudpickle(obj, buffer_callback=None) -> bytes:
    out = io.BytesIO()
    _CloudPickler(out, protocol=5, buffer_callback=buffer_callback).dump(obj)
    return out.getvalue()


def serialize(obj) -> SerializedObject:
    buffers: list = []

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
        header = _cloudpickle(obj, _buffer_callback)
    return SerializedObject(header=header, buffers=buffers)


def deserialize(serialized: SerializedObject):
    return pickle.loads(serialized.header, buffers=serialized.buffers)


def dumps(obj) -> bytes:
    """One-shot contiguous serialization."""
    return serialize(obj).to_bytes()


def loads(blob):
    return deserialize(SerializedObject.from_bytes(blob))


def dumps_inband(obj) -> bytes:
    """Compact one-shot pickle with every buffer IN-BAND — no
    SerializedObject framing (the JAX package's cached task-spec encoding
    rides this form)."""
    try:
        out = io.BytesIO()
        _FastPickler(out, protocol=5).dump(obj)
        return out.getvalue()
    except Exception:  # noqa: BLE001 — closures/lambdas/__main__ classes
        return _cloudpickle(obj)


def loads_inband(blob):
    return pickle.loads(blob)


# -- reading a spec without importing what its arguments need ---------------
#
# The GCS and the node daemons decode an actor's creation spec for its
# options, and re-encode it, but never touch its arguments. An argument
# holding a torch object (a dtype, a device, a config with a dtype, a
# tensor) would make them import torch, and whatever module defines it,
# only to carry it on. ``loads_deferred`` leaves every global of a module
# this process has not imported as a placeholder that re-encodes to the
# same object: the process that unpickles it next (the worker) imports it.


def _load_global(module: str, name: str):
    """The global ``module.name`` (``name`` may be dotted), imported."""
    import importlib

    obj = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _new_object(cls, args, kwargs):
    """``cls.__new__(cls, *args, **kwargs)``: what pickle's NEWOBJ does."""
    return cls.__new__(cls, *args, **kwargs)


class _Deferred:
    """A global this process has not imported, a call of one, or an object
    built from one (``__new__`` then ``__setstate__``), kept as data and
    re-encoded as the same global, call or object."""

    __slots__ = ("kind", "parts", "state")

    def __new__(cls, *args, **kwargs):
        if isinstance(cls, _Deferred):   # NEWOBJ / NEWOBJ_EX on a deferred class
            return _Deferred._make("new", (cls, args, kwargs))
        return object.__new__(cls)

    @staticmethod
    def _make(kind, parts):
        d = object.__new__(_Deferred)
        d.kind, d.parts, d.state = kind, parts, None
        return d

    def __call__(self, *args):
        return _Deferred._make("call", (self, args))

    def __setstate__(self, state):
        self.state = state

    def __reduce__(self):
        if self.kind == "global":
            return (_load_global, self.parts)
        out = self.parts if self.kind == "call" else (_new_object, self.parts)
        return out + (self.state,) if self.state is not None else out


def _subimport_or_defer(name: str):
    """cloudpickle's ``subimport`` (a module that a by-value function or
    class names as a global) as a deferring reader runs it: the module if
    this process has it, else a placeholder re-encoded as the same import.
    Running it would import torch in the GCS, whose health loop then stalls
    for as long as torch's libraries take to load."""
    if name in sys.modules:
        return sys.modules[name]
    return _Deferred._make("call", (cloudpickle.cloudpickle.subimport,
                                    (name,)))


def _load_global_or_defer(module: str, name: str):
    """``_load_global`` as a deferring reader runs it (for a placeholder
    another deferring process re-encoded)."""
    return _DeferringUnpickler.resolve(module, name)


def _new_object_or_defer(cls, args, kwargs):
    if isinstance(cls, _Deferred):
        return _Deferred._make("new", (cls, args, kwargs))
    return _new_object(cls, args, kwargs)


class _DeferringUnpickler(pickle._Unpickler):
    # This module's own reconstructors, as a deferring reader calls them: a
    # tensor stays a call of _rebuild_tensor (which imports torch), and a
    # placeholder re-encoded by another deferring process stays one.
    _OWN = {"_rebuild_tensor": None, "_load_global": _load_global_or_defer,
            "_new_object": _new_object_or_defer}

    @classmethod
    def resolve(cls, module, name):
        if module == __name__ and name in cls._OWN:
            own = cls._OWN[name]
            if own is not None:
                return own
        elif module in sys.modules:
            return _load_global(module, name)
        return _Deferred._make("global", (module, name))

    def find_class(self, module, name):
        if module == "cloudpickle.cloudpickle" and name == "subimport":
            return _subimport_or_defer
        if module == __name__ or module not in sys.modules:
            return self.resolve(module, name)
        return super().find_class(module, name)


def loads_deferred(blob):
    """:func:`loads`, except that a global of a module this process has not
    imported (torch, a model config's module, a tensor's rebuild) stays a
    placeholder that :func:`dumps` re-encodes unchanged. For a process that
    carries an object on without using the parts it has not imported (a
    spec's arguments in the GCS or a node daemon); where a placeholder
    cannot stand in, the plain :func:`loads`."""
    ser = SerializedObject.from_bytes(blob)
    try:
        return _DeferringUnpickler(io.BytesIO(ser.header),
                                   buffers=ser.buffers).load()
    except Exception:  # noqa: BLE001 — an object a placeholder cannot build
        return deserialize(ser)

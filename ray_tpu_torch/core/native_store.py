"""ctypes binding for the C++ shared-memory object store.

The port's copy of ``ray_tpu/core/native_store.py``, over the port's own copy
of the arena (``ray_tpu_torch/_native/object_store.cc``; the Python-native
seam is a C ABI + ctypes, as in the JAX package). Buffers come back as
ZERO-COPY memoryviews over the shm mapping; ``NativeObjectStore.put/get``
move bytes once (producer memcpy into the arena) and never again
in-process.

The library is built with ``g++`` at first use (never at import) into
``build/native/`` at the root of the checkout, named by a hash of the source
and the flags, as ``ops/_build.py`` names the kernels: an edited source
rebuilds, an unchanged one loads the existing file, and a build goes to a
per-process temporary name first and is renamed into place, so concurrent
test workers can race. It never builds into or loads from
``ray_tpu/_native/``, whose library belongs to the JAX package. Importers
catch ``NativeStoreUnavailable`` and fall back to heap bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("native_store")

SOURCE = Path(__file__).resolve().parents[1] / "_native" / "object_store.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-Wall", "-fPIC", "-std=c++17", "-shared")
LD_FLAGS = ("-lpthread", "-lrt")

ID_SIZE = 20


class NativeStoreUnavailable(RuntimeError):
    pass


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """The library's path, named by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return BUILD_DIR / f"libray_tpu_store-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library if it is not there yet; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeStoreUnavailable(
            f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            path = build()
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeStoreUnavailable(
                f"cannot build native store: {e}") from e
        lib = ctypes.CDLL(str(path))
        lib.rt_store_create.restype = ctypes.c_void_p
        lib.rt_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
        lib.rt_store_open.restype = ctypes.c_void_p
        lib.rt_store_open.argtypes = [ctypes.c_char_p]
        lib.rt_store_create_object.restype = ctypes.c_void_p
        lib.rt_store_create_object.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.rt_store_seal.restype = ctypes.c_int
        lib.rt_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_store_get.restype = ctypes.c_void_p
        lib.rt_store_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rt_store_release.restype = ctypes.c_int
        lib.rt_store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_store_contains.restype = ctypes.c_int
        lib.rt_store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_store_delete.restype = ctypes.c_int
        lib.rt_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        for f in ("rt_store_bytes_in_use", "rt_store_num_objects", "rt_store_capacity"):
            getattr(lib, f).restype = ctypes.c_uint64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.rt_store_close.argtypes = [ctypes.c_void_p]
        lib.rt_store_destroy.restype = ctypes.c_int
        lib.rt_store_destroy.argtypes = [ctypes.c_char_p]
        lib.rt_store_prefault.restype = None
        lib.rt_store_prefault.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                          ctypes.c_uint32, ctypes.c_uint64]
        _lib = lib
        return lib


def _pad_id(object_id: bytes) -> bytes:
    if len(object_id) > ID_SIZE:
        # Truncating would alias two ids sharing a 20-byte prefix onto the
        # same shm slot; callers construct exact 20-byte keys, so reject.
        raise ValueError(
            f"object id longer than {ID_SIZE} bytes: {object_id!r}"
        )
    return object_id.ljust(ID_SIZE, b"\0")


class _Pin:
    """Releases one shm refcount when collected."""

    __slots__ = ("_store", "_oid")

    def __init__(self, store: "NativeObjectStore", oid: bytes):
        self._store = store
        self._oid = oid

    def __del__(self):
        try:
            self._store.release(self._oid)
        except Exception:  # noqa: BLE001 — interpreter teardown
            log_swallowed(logger, "shm view release")


class NativeObjectStore:
    """One shm segment; open from any process by name."""

    def __init__(self, name: str, capacity: int = 256 * 1024 * 1024,
                 max_entries: int = 4096, create: bool = True):
        self._lib = _load()
        self.name = name if name.startswith("/") else "/" + name
        self._handle = (
            self._lib.rt_store_create(self.name.encode(), capacity, max_entries)
            if create
            else self._lib.rt_store_open(self.name.encode())
        )
        if not self._handle:
            raise NativeStoreUnavailable(
                f"rt_store_{'create' if create else 'open'}({self.name}) failed"
            )
        self._owner = create

    @classmethod
    def open(cls, name: str) -> "NativeObjectStore":
        return cls(name, create=False)

    def _require_handle(self):
        if not self._handle:
            raise NativeStoreUnavailable(f"store {self.name} is closed")

    # -- object API ----------------------------------------------------------
    def put(self, object_id: bytes, data) -> None:
        self._require_handle()
        oid = _pad_id(object_id)
        mv = memoryview(data).cast("B")
        ptr = self._lib.rt_store_create_object(self._handle, oid, len(mv))
        if not ptr:
            raise MemoryError(
                f"store full or id exists (in_use={self.bytes_in_use()}, "
                f"capacity={self.capacity()})"
            )
        # Single copy producer->arena via memmove: the memoryview
        # slice-assignment path degrades to ~75 MB/s on large cross-process
        # writes; raw memmove runs at memcpy speed. ctypes only takes bytes
        # or raw addresses, so borrow the buffer's address through numpy
        # (handles read-only buffers; no copy).
        import numpy as _np

        if not mv.c_contiguous:
            mv = memoryview(bytes(mv))
        src = _np.frombuffer(mv, dtype=_np.uint8)
        ctypes.memmove(ptr, src.ctypes.data, len(mv))
        self._lib.rt_store_seal(self._handle, oid)
        self._lib.rt_store_release(self._handle, oid)

    def create(self, object_id: bytes, size: int) -> Optional[memoryview]:
        """Allocate an UNSEALED object and return a writable view into shm —
        the incremental-write half of ``put`` (plasma Create/Seal split):
        chunked transfers land network chunks straight in the arena with no
        assembly buffer. Call :meth:`seal` when fully written (the object is
        invisible to ``get`` until then), then :meth:`release`."""
        self._require_handle()
        oid = _pad_id(object_id)
        ptr = self._lib.rt_store_create_object(self._handle, oid, size)
        if not ptr:
            return None
        buf = (ctypes.c_char * size).from_address(ptr)
        return memoryview(buf).cast("B")

    def seal(self, object_id: bytes) -> None:
        self._require_handle()
        oid = _pad_id(object_id)
        self._lib.rt_store_seal(self._handle, oid)
        self._lib.rt_store_release(self._handle, oid)

    def abort(self, object_id: bytes) -> None:
        """Drop a created-but-unsealed object (failed transfer)."""
        if not self._handle:
            return
        oid = _pad_id(object_id)
        self._lib.rt_store_release(self._handle, oid)
        self._lib.rt_store_delete(self._handle, oid)

    def get(self, object_id: bytes) -> Optional[memoryview]:
        """Zero-copy view into shm; call ``release`` when done."""
        self._require_handle()
        oid = _pad_id(object_id)
        size = ctypes.c_uint64()
        ptr = self._lib.rt_store_get(self._handle, oid, ctypes.byref(size))
        if not ptr:
            return None
        buf = (ctypes.c_char * size.value).from_address(ptr)
        # Sealed objects are immutable; hand out read-only views so a
        # consumer mutating a zero-copy-deserialized array cannot corrupt
        # the object for other readers (plasma returns read-only buffers).
        return memoryview(buf).cast("B").toreadonly()

    def get_view(self, object_id: bytes) -> Optional[memoryview]:
        """Zero-copy view whose shm pin auto-releases when the LAST
        referencing view/array is garbage-collected (plasma client
        semantics: an object can't be evicted from under a live reader)."""
        self._require_handle()
        oid = _pad_id(object_id)
        size = ctypes.c_uint64()
        ptr = self._lib.rt_store_get(self._handle, oid, ctypes.byref(size))
        if not ptr:
            return None
        buf = (ctypes.c_char * size.value).from_address(ptr)
        buf._rt_pin = _Pin(self, object_id)  # lifetime-coupled release
        return memoryview(buf).cast("B").toreadonly()

    def release(self, object_id: bytes) -> None:
        if not self._handle:
            return  # closed: segment already destroyed, nothing to release
        self._lib.rt_store_release(self._handle, _pad_id(object_id))

    def contains(self, object_id: bytes) -> bool:
        self._require_handle()
        return bool(self._lib.rt_store_contains(self._handle, _pad_id(object_id)))

    def delete(self, object_id: bytes) -> bool:
        if not self._handle:
            return False
        return self._lib.rt_store_delete(self._handle, _pad_id(object_id)) == 0

    # -- stats ---------------------------------------------------------------
    def bytes_in_use(self) -> int:
        self._require_handle()
        return int(self._lib.rt_store_bytes_in_use(self._handle))

    def num_objects(self) -> int:
        self._require_handle()
        return int(self._lib.rt_store_num_objects(self._handle))

    def capacity(self) -> int:
        self._require_handle()
        return int(self._lib.rt_store_capacity(self._handle))

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._handle:
            self._lib.rt_store_close(self._handle)
            self._handle = None

    def destroy(self) -> None:
        self.close()
        self._lib.rt_store_destroy(self.name.encode())

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            log_swallowed(logger, "native store close")

    def prefault(self, chunk_bytes: int = 64 * 1024 * 1024,
                 sleep_us: int = 2000, max_bytes: int = 0) -> None:
        """Touch arena pages (content-preserving) so puts don't pay
        first-fault page population; run from a background thread — ctypes
        releases the GIL for the call's duration. The native side drops the
        thread to SCHED_IDLE so this never competes with real work.
        ``max_bytes`` caps how much of the arena is touched (0 = all) so a
        large arena on a small host doesn't balloon RSS at boot."""
        self._require_handle()
        self._lib.rt_store_prefault(self._handle, chunk_bytes, sleep_us,
                                    max_bytes)

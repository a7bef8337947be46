"""JAX's native shm object store tests (``tests/test_native_store.py``) on
the port's own ``ray_tpu_torch/_native/object_store.cc``: create/seal/get
lifecycle, pinning, allocator reuse/coalescing, cross-process zero-copy
access, the EOWNERDEAD rebuild and the AddressSanitizer stress run.

Where JAX's tests build its test library and stress harness with ``make``
inside ``ray_tpu/_native/``, these build the port's sources with the same
``g++`` flags into the test's temporary directory (the port builds nothing
inside its package).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ray_tpu_torch.core import native_store
from ray_tpu_torch.core.native_store import NativeObjectStore, NativeStoreUnavailable

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

NATIVE_DIR = native_store.SOURCE.parent


@pytest.fixture
def store():
    name = f"rtpu_test_{os.getpid()}"
    try:
        s = NativeObjectStore(name, capacity=8 * 1024 * 1024, max_entries=128)
    except NativeStoreUnavailable as e:
        pytest.skip(f"native store unavailable: {e}")
    yield s
    s.destroy()


class TestNativeStore:
    def test_put_get_roundtrip(self, store):
        data = np.arange(1000, dtype=np.float64).tobytes()
        store.put(b"obj1", data)
        view = store.get(b"obj1")
        assert view is not None
        assert bytes(view) == data
        store.release(b"obj1")

    def test_zero_copy_numpy(self, store):
        arr = np.random.default_rng(0).normal(size=(100, 100))
        store.put(b"arr", arr.tobytes())
        view = store.get(b"arr")
        back = np.frombuffer(view, np.float64).reshape(100, 100)
        np.testing.assert_array_equal(back, arr)
        store.release(b"arr")

    def test_contains_and_missing(self, store):
        assert not store.contains(b"nope")
        assert store.get(b"nope") is None
        store.put(b"yes", b"x")
        assert store.contains(b"yes")

    def test_duplicate_put_fails(self, store):
        store.put(b"dup", b"a")
        with pytest.raises(MemoryError):
            store.put(b"dup", b"b")

    def test_delete_respects_pins(self, store):
        store.put(b"pinned", b"data")
        view = store.get(b"pinned")  # pin
        assert not store.delete(b"pinned")  # refused: pinned
        store.release(b"pinned")
        assert store.delete(b"pinned")
        assert not store.contains(b"pinned")

    def test_allocator_reuses_freed_space(self, store):
        cap = store.capacity()
        chunk = cap // 4
        # fill-free cycles exceed capacity in total => space must be reused
        for cycle in range(8):
            oid = f"c{cycle}".encode()
            store.put(oid, b"\x07" * chunk)
            assert store.delete(oid)
        assert store.bytes_in_use() == 0

    def test_out_of_memory_raises(self, store):
        with pytest.raises(MemoryError):
            store.put(b"huge", b"x" * (store.capacity() + 1))

    def test_stats(self, store):
        assert store.num_objects() == 0
        store.put(b"a", b"12345678")
        assert store.num_objects() == 1
        assert store.bytes_in_use() >= 8

    def test_cross_process_zero_copy(self, store):
        """A second PROCESS opens the segment and reads the object —
        the multi-worker zero-copy path (reference: plasma clients)."""
        payload = np.arange(4096, dtype=np.int32)
        store.put(b"shared", payload.tobytes())
        code = f"""
import sys
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
import numpy as np
from ray_tpu_torch.core.native_store import NativeObjectStore
s = NativeObjectStore.open({store.name!r})
view = s.get(b"shared")
arr = np.frombuffer(view, np.int32)
assert arr.sum() == {int(payload.sum())}, arr.sum()
s.release(b"shared")
s.put(b"reply", b"from-child")
s.close()
print("CHILD-OK")
"""
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert "CHILD-OK" in out.stdout, out.stderr
        view = store.get(b"reply")
        assert bytes(view) == b"from-child"
        store.release(b"reply")

    def test_views_are_readonly(self, store):
        """Sealed objects are immutable: zero-copy views must be read-only so
        a consumer can't corrupt the object for other readers (plasma
        returns read-only buffers for sealed objects)."""
        arr = np.arange(16, dtype=np.int64)
        store.put(b"ro", arr.tobytes())
        view = store.get(b"ro")
        assert view.readonly
        back = np.frombuffer(view, np.int64)
        assert not back.flags.writeable
        with pytest.raises((TypeError, ValueError)):
            view[0] = 0xFF
        store.release(b"ro")
        view2 = store.get_view(b"ro")
        assert view2.readonly

    def test_long_id_rejected(self, store):
        """Ids longer than ID_SIZE must raise, not silently truncate (two
        ids sharing a 20-byte prefix would alias the same shm slot)."""
        with pytest.raises(ValueError):
            store.put(b"x" * 21, b"data")
        with pytest.raises(ValueError):
            store.get(b"y" * 40)

    def test_eownerdead_rebuilds_allocator(self, store, tmp_path):
        """A peer that dies holding the robust mutex with half-spliced
        allocator metadata: the next locker must rebuild the free list from
        the entry table (the source of truth), not just mark the mutex
        consistent."""
        import ctypes

        # The corrupt-and-hold hook is only exported from the test build.
        test_lib = str(tmp_path / "libray_tpu_store_test.so")
        subprocess.run(
            ["g++", *native_store.CXX_FLAGS, "-DRT_STORE_TEST_HOOKS",
             str(native_store.SOURCE), "-o", test_lib,
             *native_store.LD_FLAGS],
            check=True, capture_output=True, timeout=120,
        )

        payload = np.arange(2048, dtype=np.int64)
        # zero-size object: must occupy a distinct arena range (min alloc)
        # so recovery's offset walk can never conflate it with a neighbor
        store.put(b"empty", b"")
        store.put(b"survivor", payload.tobytes())
        in_use_before = store.bytes_in_use()
        num_before = store.num_objects()

        code = f"""
import sys, ctypes, os
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
# Open the segment entirely through the TEST build of the library (same
# source, plus the crash-injection hook; Store struct layout is identical).
lib = ctypes.CDLL({test_lib!r})
lib.rt_store_open.restype = ctypes.c_void_p
lib.rt_store_open.argtypes = [ctypes.c_char_p]
lib.rt_store_test_corrupt_and_hold.restype = ctypes.c_int
lib.rt_store_test_corrupt_and_hold.argtypes = [ctypes.c_void_p]
h = lib.rt_store_open({store.name!r}.encode())
assert h, "open failed"
lib.rt_store_test_corrupt_and_hold(h)
print("CORRUPTED", flush=True)
os._exit(1)  # die holding the lock -> EOWNERDEAD for the next locker
"""
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert "CORRUPTED" in out.stdout, out.stderr

        # Next op takes the EOWNERDEAD path and rebuilds; invariants restored.
        assert store.contains(b"survivor")
        assert store.bytes_in_use() == in_use_before
        assert store.num_objects() == num_before
        view = store.get(b"survivor")
        np.testing.assert_array_equal(np.frombuffer(view, np.int64), payload)
        store.release(b"survivor")
        # allocator still functional: can fill a fresh object without
        # overwriting survivors (the zero-size entry kept its own range)
        store.put(b"after", b"z" * 4096)
        assert store.contains(b"after")
        assert store.contains(b"empty")
        view2 = store.get(b"survivor")
        np.testing.assert_array_equal(np.frombuffer(view2, np.int64), payload)
        store.release(b"survivor")


def test_asan_stress_clean(tmp_path):
    """The multi-threaded arena stress harness under AddressSanitizer: no
    races/UAF/leaks in create/seal/get/delete cycles incl. tombstone reuse
    and the crash-rebuild path (the reference's asan CI job for plasma,
    ci/ray_ci/tester.py:137-144)."""
    import os
    import shutil
    import subprocess

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    harness = str(tmp_path / "stress_store_asan")
    subprocess.run(["g++", "-O1", "-g", "-fsanitize=address",
                    "-fno-omit-frame-pointer", "-std=c++17",
                    "-DRT_STORE_TEST_HOOKS", str(NATIVE_DIR / "stress_store.cc"),
                    "-o", harness, "-lpthread", "-lrt"], check=True,
                   capture_output=True, timeout=180)
    out = subprocess.run([harness, "2"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
    assert "leftover_objects=0" in out.stdout

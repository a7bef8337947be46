"""Steady-state guard: implicit device->host reads and late kernel builds.

The port's twin of ``ray_tpu/devtools/jitcheck.py``'s runtime half. The JAX
module turns the serving contract — ZERO new XLA compilations, ZERO implicit
device->host reads after warmup — into recorded violations; here the same
contract reads:

- an implicit read of a tensor's value on the host — ``item``, ``tolist``,
  ``__bool__``, ``__float__``, ``__int__``, ``__index__`` of any tensor (as
  the JAX module guards a ``jax.Array`` on every backend), and ``cpu`` /
  ``numpy`` of a CUDA tensor — inside :func:`steady_state` is a violation
  recorded with its call site; :func:`device_get` is the ONE sanctioned
  read, so "batch the step's host reads into one device_get" is enforceable
  on the CPU too;
- a kernel library that ``ray_tpu_torch.ops._build.load`` builds or loads
  for the first time in this process (the twin of a new XLA compile) inside
  :func:`steady_state` is a violation (:func:`note_build`).

:func:`steady_state` is thread-local, as the JAX module's is: the serve
engines enter it around every scheduler step once warmed, and a thread that
synchronises on purpose elsewhere (the disaggregated engine's ingest worker)
is untouched — which ``torch.cuda.set_sync_debug_mode``, a process-wide
switch, could not give.

Enable with the ``jit_check_enabled`` knob (``RAY_TPU_JIT_CHECK_ENABLED=1``:
``ray_tpu_torch/__init__`` installs at import; ``ray_tpu_torch.init``
installs when the runtime's table sets it). Disabled, :func:`steady_state`
is a no-op and :func:`device_get` a plain ``cpu()``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import traceback
from typing import Any, Dict, List

import torch

__all__ = [
    "install", "uninstall", "installed", "maybe_install",
    "steady_state", "SteadyStateViolation", "device_get", "host_reads",
    "note_build", "violations", "clear_violations", "build_counts",
]

_ENV_KNOB = "RAY_TPU_JIT_CHECK_ENABLED"

#: guards the tables below (leaf lock: nothing is acquired under it)
_lock = threading.Lock()
#: recorded steady-state violations, rendered
_violations: List[str] = []
#: kernel name -> first loads observed while installed
_builds: Dict[str, int] = {}

_tls = threading.local()
_installed = False

#: implicit reads of any tensor
_GUARDED_READS = ("item", "tolist", "__bool__", "__float__", "__int__",
                  "__index__")
#: implicit reads that copy a CUDA tensor to the host
_GUARDED_DEVICE_READS = ("cpu", "numpy")


class SteadyStateViolation(AssertionError):
    """A steady-state scope saw an implicit device->host read or a late
    kernel build (raised at scope exit when ``strict=True``)."""


def _caller_site() -> str:
    """file:line of the first frame outside this module and outside torch —
    the code that triggered the event."""
    here = os.path.normcase(__file__)
    for frame in traceback.extract_stack()[::-1]:
        fn = os.path.normcase(frame.filename)
        if fn == here or "torch" in fn.replace(os.sep, "/").split("/"):
            continue
        return f"{os.path.basename(fn)}:{frame.lineno} in {frame.name}"
    return "<unknown>"


def _steady_depth() -> int:
    return getattr(_tls, "steady", 0)


def _reads_allowed() -> bool:
    return getattr(_tls, "allow_reads", 0) > 0


def _host_reads_allowed() -> bool:
    return getattr(_tls, "host_reads", 0) > 0


def _record_violation(text: str) -> None:
    with _lock:
        _violations.append(text)
    from ray_tpu_torch.util import flightrec

    flightrec.record("jit", "steady_state", text)


def _guarded(name: str, orig, cuda_only: bool):
    def guard(self, *args, **kwargs):
        if (_steady_depth() > 0 and not _reads_allowed()
                and (self.is_cuda
                     or not (cuda_only or _host_reads_allowed()))):
            _record_violation(
                f"implicit device->host read ({name}) inside steady_state "
                f"at {_caller_site()} — use jitcheck.device_get")
        return orig(self, *args, **kwargs)

    guard.__name__ = name
    return guard


def device_get(x: Any) -> Any:
    """The sanctioned device->host read: ``x.cpu()`` for a tensor, each
    element's for a tuple or list of them."""
    _tls.allow_reads = getattr(_tls, "allow_reads", 0) + 1
    try:
        if isinstance(x, (tuple, list)):
            return type(x)(t.cpu() for t in x)
        return x.cpu()
    finally:
        _tls.allow_reads -= 1


@contextlib.contextmanager
def host_reads():
    """A scope in which reading a CPU tensor's value is host bookkeeping,
    not a device->host read — ``torch.optim``'s step counters are CPU
    tensors its ``step`` reads with ``item``. A CUDA tensor's read stays a
    violation here."""
    _tls.host_reads = getattr(_tls, "host_reads", 0) + 1
    try:
        yield
    finally:
        _tls.host_reads -= 1


def note_build(name: str) -> None:
    """``ops._build.load`` reports the first load of kernel ``name`` in this
    process; inside :func:`steady_state` that is a violation."""
    if not _installed:
        return
    with _lock:
        _builds[name] = _builds.get(name, 0) + 1
    if _steady_depth() > 0:
        _record_violation(
            f"kernel library {name} built or loaded inside steady_state at "
            f"{_caller_site()} — warm it up first")


# -- install / uninstall -----------------------------------------------------


def install() -> None:
    """Arm the steady-state guard. Idempotent."""
    global _installed
    if _installed:
        return
    for names, cuda_only in ((_GUARDED_READS, False),
                             (_GUARDED_DEVICE_READS, True)):
        for name in names:
            setattr(torch.Tensor, name,
                    _guarded(name, getattr(torch.Tensor, name), cuda_only))
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    for name in _GUARDED_READS + _GUARDED_DEVICE_READS:
        delattr(torch.Tensor, name)  # the inherited TensorBase method again
    _installed = False


def installed() -> bool:
    return _installed


def maybe_install() -> bool:
    """Install iff the ``jit_check_enabled`` knob is on."""
    from ray_tpu_torch.core.config import config

    enabled = bool(config().jit_check_enabled)
    if enabled:
        install()
    return enabled


# -- steady state ------------------------------------------------------------


@contextlib.contextmanager
def steady_state(strict: bool = False):
    """Scope in which implicit device->host reads and kernel builds are
    contract violations. Thread-local and reentrant; a no-op unless
    :func:`install` ran. Violations are recorded in :func:`violations`;
    with ``strict=True`` the scope ALSO raises
    :class:`SteadyStateViolation` at exit."""
    if not _installed:
        yield
        return
    with _lock:
        n0 = len(_violations)
    _tls.steady = _steady_depth() + 1
    try:
        yield
    finally:
        _tls.steady -= 1
        if strict:
            with _lock:
                new = _violations[n0:]
            if new:
                raise SteadyStateViolation(
                    "steady-state contract violated:\n  " + "\n  ".join(new))


# -- introspection -----------------------------------------------------------


def violations() -> List[str]:
    with _lock:
        return list(_violations)


def clear_violations() -> None:
    with _lock:
        _violations.clear()


def build_counts() -> Dict[str, int]:
    """Kernel name -> first loads observed while installed."""
    with _lock:
        return dict(_builds)

"""RuntimeEnv — per-task/actor execution environments.

Analog of the reference's runtime-env system (``python/ray/runtime_env/`` API;
plugins in ``_private/runtime_env/`` — conda/pip/working_dir/py_modules/
container). In-process runtime scope: ``env_vars`` (applied around task
execution under a global lock — one process, so env mutation must be
serialized), ``working_dir``/``py_modules`` (prepended to ``sys.path``);
``pip``/``conda``/``container`` are validated but deferred to process-backed
workers (they require spawning an isolated interpreter, which the in-process
node model doesn't do — the reference builds them in a per-node agent).

The port's copy of ``ray_tpu/runtime_env.py`` (the in-process part the
runtime applies, and the rule by which a cluster's node daemon gives a task
a dedicated worker process).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Any, Dict, List, Optional

_env_lock = threading.Lock()

_SUPPORTED = {"env_vars", "working_dir", "py_modules", "pip", "conda", "container"}
# Isolation-requiring fields the IN-PROCESS runtime cannot honor (they need
# a separate interpreter/namespace); the multiprocess daemon builds all
# three (venv / conda prefix / container wrap — node_daemon.py).
_DEFERRED = {"pip", "conda", "container"}

# Fields that force a FRESH, dedicated worker process on the multiprocess
# runtime (env at spawn / isolated interpreter). ONE definition — the
# submit paths and the daemon all consult this.
_DEDICATED = {"env_vars", "pip", "conda", "container"}


def needs_dedicated_worker(env: Optional[Dict[str, Any]]) -> bool:
    """Whether this runtime env requires a fresh worker process (rather
    than a pooled vanilla one)."""
    return bool(env) and any(env.get(k) for k in _DEDICATED)


class RuntimeEnv(dict):
    """Validated runtime-env spec (reference: ``ray.runtime_env.RuntimeEnv``)."""

    def __init__(
        self,
        *,
        env_vars: Optional[Dict[str, str]] = None,
        working_dir: Optional[str] = None,
        py_modules: Optional[List[str]] = None,
        **kwargs,
    ):
        unknown = set(kwargs) - _SUPPORTED
        if unknown:
            raise ValueError(f"unsupported runtime_env fields: {sorted(unknown)}")
        spec: Dict[str, Any] = dict(kwargs)
        if "conda" in spec and not isinstance(spec["conda"], (str, dict)):
            raise TypeError("conda must be an env name/prefix (str) or an "
                            "environment.yml dict")
        if "container" in spec:
            if (not isinstance(spec["container"], dict)
                    or not spec["container"].get("image")):
                raise TypeError("container must be a dict with 'image'")
        if env_vars:
            if not all(isinstance(k, str) and isinstance(v, str) for k, v in env_vars.items()):
                raise TypeError("env_vars must be Dict[str, str]")
            spec["env_vars"] = dict(env_vars)
        if working_dir:
            if not os.path.isdir(working_dir):
                raise ValueError(f"working_dir {working_dir!r} does not exist")
            spec["working_dir"] = os.path.abspath(working_dir)
        if py_modules:
            spec["py_modules"] = [os.path.abspath(p) for p in py_modules]
        super().__init__(spec)

    def deferred_plugins(self) -> List[str]:
        """Fields requiring process-isolated workers (built by the node agent
        in the reference; inert in the in-process runtime)."""
        return sorted(set(self) & _DEFERRED)


@contextlib.contextmanager
def applied(env: Optional[Dict[str, Any]]):
    """Apply a runtime env around a task/actor execution."""
    if not env:
        yield
        return
    env_vars: Dict[str, str] = env.get("env_vars") or {}
    paths: List[str] = []
    if env.get("working_dir"):
        paths.append(env["working_dir"])
    paths.extend(env.get("py_modules") or [])

    with _env_lock:
        old_vars = {k: os.environ.get(k) for k in env_vars}
        os.environ.update(env_vars)
        old_sys_path = list(sys.path)
        for p in reversed(paths):
            sys.path.insert(0, p)
        try:
            yield
        finally:
            for k, v in old_vars.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            sys.path[:] = old_sys_path

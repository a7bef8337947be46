"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

The JAX package ``ray_tpu`` is the reference; this package carries its
counterparts slice by slice, with PyTorch for tensor code and kernels
written by hand for NVIDIA Hopper in place of the Pallas TPU kernels. It
imports nothing of ``ray_tpu`` and nothing of JAX.

The top level is the in-process core runtime's API, as ``ray_tpu``'s is:
``init``/``shutdown``, ``remote``, ``get``/``put``/``wait``, actors, placement
groups, with the card (``GPU``) as the accelerator resource.
"""

import os as _os

if _os.environ.get("RAY_TPU_LOCK_ORDER_CHECK_ENABLED", "").lower() in (
        "1", "true", "yes", "on"):
    # Instrument threading BEFORE the submodule imports below create the
    # package's module-level locks (config._lock, runtime._init_lock, ...):
    # installing any later leaves those invisible to the lock-order
    # validator. devtools imports nothing back from the package, so this is
    # cycle-safe; with the knob off devtools is never imported at all.
    from ray_tpu_torch.devtools import lockcheck as _lockcheck

    _lockcheck.install()

if _os.environ.get("RAY_TPU_LEAK_CHECK_ENABLED", "").lower() in (
        "1", "true", "yes", "on"):
    # Same top-of-import rule: threads and fds created while the submodules
    # below import must already carry allocation-site stamps.
    from ray_tpu_torch.devtools import leakcheck as _leakcheck

    _leakcheck.install()

if _os.environ.get("RAY_TPU_JIT_CHECK_ENABLED", "").lower() in (
        "1", "true", "yes", "on"):
    # The steady-state guard wraps torch.Tensor's implicit-read methods;
    # installed here, as the JAX package installs its jit guard at import.
    from ray_tpu_torch.devtools import jitcheck as _jitcheck

    _jitcheck.install()

from ray_tpu_torch.api import (  # noqa: E402
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch.core.actor import ActorHandle, get_actor  # noqa: E402
from ray_tpu_torch.core.exceptions import (  # noqa: E402
    ActorDiedError,
    ActorError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
)
from ray_tpu_torch.core.object_ref import ObjectRef, ObjectRefGenerator  # noqa: E402
from ray_tpu_torch.core.placement_group import (  # noqa: E402
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.core.task_spec import (  # noqa: E402
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy,
)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "nodes",
    "cluster_resources",
    "available_resources",
    "get_runtime_context",
    "get_actor",
    "timeline",
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorHandle",
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "placement_group_table",
    "PlacementGroupSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "SpreadSchedulingStrategy",
    "RayTpuError",
    "TaskError",
    "ActorError",
    "ActorDiedError",
    "ActorUnavailableError",
    "ObjectLostError",
    "GetTimeoutError",
    "TaskCancelledError",
]

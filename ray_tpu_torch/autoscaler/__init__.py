from ray_tpu_torch.autoscaler.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    GcsAutoscalerView,
    bin_pack,
)
from ray_tpu_torch.autoscaler.node_provider import (
    FakeNodeProvider,
    LocalDaemonNodeProvider,
    NodeInstance,
    NodeProvider,
    NodeType,
)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "GcsAutoscalerView",
    "bin_pack",
    "NodeProvider",
    "NodeType",
    "NodeInstance",
    "FakeNodeProvider",
    "LocalDaemonNodeProvider",
]

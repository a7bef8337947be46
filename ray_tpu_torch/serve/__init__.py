"""ray_tpu_torch.serve — model serving over the in-process runtime.

The port's copy of ``ray_tpu/serve/__init__.py``: @deployment/bind/run,
DeploymentHandle, HTTP and gRPC ingress, autoscaling, batching,
multiplexing; ``llm.llm_deployment`` builds the LLM deployment around the
engines.
"""

from ray_tpu_torch.serve.api import (
    delete,
    drain_proxy,
    get_deployment_handle,
    grpc_proxy_address,
    proxy_grpc_addresses,
    run,
    run_pipeline,
    shutdown,
    start_proxies,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.dag_pipeline import (PipelineHandle,
                                              SequentialPipelineHandle)
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.errors import Saturated
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

__all__ = [
    "deployment",
    "Deployment",
    "Application",
    "run",
    "run_pipeline",
    "PipelineHandle",
    "SequentialPipelineHandle",
    "shutdown",
    "status",
    "delete",
    "get_deployment_handle",
    "DeploymentHandle",
    "DeploymentResponse",
    "AutoscalingConfig",
    "DeploymentConfig",
    "Saturated",
    "batch",
    "multiplexed",
    "get_multiplexed_model_id",
    "start_proxies",
    "drain_proxy",
    "proxy_grpc_addresses",
    "grpc_proxy_address",
]

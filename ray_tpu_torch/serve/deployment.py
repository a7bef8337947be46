"""@serve.deployment / bind / Application.

The port's copy of ``ray_tpu/serve/deployment.py``: the decorator wraps a
class/function into a ``Deployment``; ``.bind(*args)`` produces an ``Application`` node graph (constructor args may
themselves be bound deployments — composed apps); ``serve.run`` deploys the
graph to the controller and returns the ingress handle.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    config: DeploymentConfig = field(default_factory=DeploymentConfig)
    route_prefix: Optional[str] = None

    def options(self, **kwargs) -> "Deployment":
        cfg_fields = {
            "num_replicas", "max_ongoing_requests", "autoscaling_config",
            "ray_actor_options", "user_config", "health_check_period_s",
            "graceful_shutdown_timeout_s", "max_concurrency",
            "tenant_quotas",
        }
        cfg_updates = {k: v for k, v in kwargs.items() if k in cfg_fields}
        asc = cfg_updates.get("autoscaling_config")
        if isinstance(asc, dict):
            cfg_updates["autoscaling_config"] = AutoscalingConfig(**asc)
        if cfg_updates.get("num_replicas") == "auto":
            cfg_updates["num_replicas"] = 1
            cfg_updates.setdefault("autoscaling_config", AutoscalingConfig())
        new_cfg = replace(self.config, **cfg_updates)
        other = {k: v for k, v in kwargs.items() if k not in cfg_fields}
        return replace(self, config=new_cfg, **other)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


@dataclass
class Application:
    """A bound deployment DAG node (reference: ``serve/_private/build_app``)."""

    deployment: Deployment
    init_args: tuple
    init_kwargs: dict

    def walk(self) -> List["Application"]:
        """All nodes, dependencies first."""
        seen: List[Application] = []

        def rec(node: "Application"):
            for a in list(node.init_args) + list(node.init_kwargs.values()):
                if isinstance(a, Application):
                    rec(a)
            if node not in seen:
                seen.append(node)

        rec(self)
        return seen


def deployment(
    _func_or_class: Optional[Any] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Any = 1,
    max_ongoing_requests: int = 100,
    autoscaling_config: Optional[Any] = None,
    ray_actor_options: Optional[Dict] = None,
    user_config: Optional[Dict] = None,
    route_prefix: Optional[str] = None,
    max_concurrency: int = 1,
    tenant_quotas: Optional[Dict[str, float]] = None,
):
    """``@serve.deployment`` (reference: ``serve/api.py``)."""

    def decorate(target):
        if isinstance(autoscaling_config, dict):
            asc = AutoscalingConfig(**autoscaling_config)
        else:
            asc = autoscaling_config
        n_replicas = num_replicas
        if n_replicas == "auto":
            n_replicas = asc.min_replicas if asc else 1
            asc_final = asc or AutoscalingConfig()
        else:
            asc_final = asc
        cfg = DeploymentConfig(
            num_replicas=n_replicas,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=asc_final,
            ray_actor_options=ray_actor_options or {},
            user_config=user_config,
            max_concurrency=max_concurrency,
            tenant_quotas=tenant_quotas,
        )
        return Deployment(
            target, name or target.__name__, cfg, route_prefix=route_prefix
        )

    if _func_or_class is not None:
        return decorate(_func_or_class)
    return decorate

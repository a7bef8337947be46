"""Shared builder surface for algorithm configs.

The reference's ``AlgorithmConfig`` (``rllib/algorithms/algorithm_config.py``)
gives every algorithm the same fluent ``.environment().env_runners()
.training()`` builder; this mixin is that shared surface for the dataclass
configs here (PPOConfig, ImpalaConfig subclass it and add their fields).
"""

from __future__ import annotations


class AlgorithmConfigBase:
    """Fluent builders over dataclass fields; validation by hasattr."""

    def environment(self, env):
        self.env = env
        return self

    def env_runners(self, *, num_env_runners=None,
                    num_envs_per_env_runner=None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(
                    f"unknown {type(self).__name__} option {k}")
            setattr(self, k, v)
        return self

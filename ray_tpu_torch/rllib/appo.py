"""APPO — asynchronous PPO on the IMPALA machinery.

Analog of the reference's ``rllib/algorithms/appo/appo.py`` (which
subclasses IMPALA exactly this way): the async sample/aggregate/update
pipeline, v-trace off-policy correction, and learner-group path all come
from :class:`IMPALA`; the policy update swaps the plain policy gradient
for PPO's CLIPPED SURROGATE over the v-trace advantages — stable learning
at higher sample staleness than raw IMPALA tolerates.

Counterpart of ``ray_tpu/rllib/appo.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.impala import IMPALA, ImpalaConfig, ImpalaLearner


class APPOLearner(ImpalaLearner):
    """V-trace targets + PPO clipped surrogate (appo_torch_policy's loss)."""

    def _pg_loss(self, logp, behavior_logp, adv, w):
        clip = self.config.get("clip_param", 0.2)
        ratio = torch.exp(logp - behavior_logp)
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        return -torch.sum(surr * w)


@dataclass
class APPOConfig(ImpalaConfig):
    clip_param: float = 0.2

    def build(self) -> "APPO":
        return APPO(self)


class APPO(IMPALA):
    _LEARNER_CLS = APPOLearner

    def _learner_config(self, config) -> Dict[str, Any]:
        cfg = super()._learner_config(config)
        cfg["clip_param"] = config.clip_param
        return cfg

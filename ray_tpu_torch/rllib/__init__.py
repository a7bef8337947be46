"""ray_tpu_torch.rllib — reinforcement learning on the new-stack shape.

Public surface mirrors the reference's new API stack (RLModule / Learner /
LearnerGroup / EnvRunner). Counterpart of ``ray_tpu/rllib``, with the same
exports: the module, the learner, the env runners, PPO, IMPALA/APPO with
the inference actors and rollout lanes, DQN, SAC, CQL, BC/MARWIL, the
multi-agent PPO, LLM post-training, the replay buffers and the Atari
stand-in.

The environments stand on gymnasium, which is imported only where an env is
made: ``SyntheticAtariEnv`` and ``make_atari`` load ``envs`` on first use,
so the learner side imports on a machine without gymnasium.
"""

from ray_tpu_torch.rllib.appo import APPO, APPOConfig, APPOLearner
from ray_tpu_torch.rllib.cql import CQL, CQLConfig, CQLLearner
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNLearner, ReplayBuffer
from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.impala import (IMPALA, AggregatorActor, ImpalaConfig,
                                        ImpalaLearner, vtrace)
from ray_tpu_torch.rllib.inference import InferenceActor, InferencePool
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.llm_rl import LLMRL, LLMRLConfig, LLMRLLearner
from ray_tpu_torch.rllib.multi_agent import (MultiAgentEnvRunner, MultiAgentPPO,
                                             MultiAgentPPOConfig)
from ray_tpu_torch.rllib.offline import (BC, MARWIL, BCConfig, MARWILConfig,
                                         episodes_to_dataset)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, PPOLearner, compute_gae
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer, nstep_columns
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec, spec_for_env
from ray_tpu_torch.rllib.rollout_lanes import RolloutLanes
from ray_tpu_torch.rllib.sac import SAC, SACConfig, SACLearner, SACModule

_ENVS = ("SyntheticAtariEnv", "make_atari")


def __getattr__(name):
    if name in _ENVS:
        from ray_tpu_torch.rllib import envs

        return getattr(envs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "RLModule",
    "RLModuleSpec",
    "spec_for_env",
    "SingleAgentEnvRunner",
    "SyntheticAtariEnv",
    "make_atari",
    "Learner",
    "LearnerGroup",
    "PPO",
    "PPOConfig",
    "PPOLearner",
    "compute_gae",
    "IMPALA",
    "ImpalaConfig",
    "ImpalaLearner",
    "AggregatorActor",
    "vtrace",
    "DQN",
    "DQNConfig",
    "DQNLearner",
    "ReplayBuffer",
    "PrioritizedReplayBuffer",
    "nstep_columns",
    "SAC",
    "SACConfig",
    "SACLearner",
    "SACModule",
    "BC",
    "MARWIL",
    "BCConfig",
    "MARWILConfig",
    "episodes_to_dataset",
    "MultiAgentEnvRunner",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "APPO",
    "APPOConfig",
    "APPOLearner",
    "InferenceActor",
    "InferencePool",
    "RolloutLanes",
    "LLMRL",
    "LLMRLConfig",
    "LLMRLLearner",
    "CQL",
    "CQLConfig",
    "CQLLearner",
]

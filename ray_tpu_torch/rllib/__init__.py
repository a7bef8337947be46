"""ray_tpu_torch.rllib — reinforcement learning on the new-stack shape.

Public surface mirrors the reference's new API stack (RLModule / Learner /
LearnerGroup / EnvRunner). Counterpart of ``ray_tpu/rllib``'s first group:
the module, the learner, the env runner, PPO, the replay buffer and the
Atari stand-in. IMPALA/APPO, DQN, SAC, CQL, the offline and multi-agent
algorithms and ``llm_rl`` are not ported yet.

The environments stand on gymnasium, which is imported only where an env is
made: ``SyntheticAtariEnv`` and ``make_atari`` load ``envs`` on first use,
so the learner side imports on a machine without gymnasium.
"""

from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, PPOLearner, compute_gae
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer, nstep_columns
from ray_tpu_torch.rllib.rl_module import RLModule, RLModuleSpec, spec_for_env

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
    "PrioritizedReplayBuffer",
    "nstep_columns",
]

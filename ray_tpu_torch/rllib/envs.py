"""Environment helpers — Atari-style pixel envs for the north-star bench.

The reference's PPO-Atari baseline runs ALE through gymnasium wrappers
(grayscale, resize to 84×84, frame-stack 4 — ``rllib/env/wrappers/
atari_wrappers.py``). This image has no ALE ROMs, so the bench gate runs on
:class:`SyntheticAtariEnv` — a pixel env with the exact Atari interface
(uint8 [84, 84, 4] observations, Discrete(6) actions, episodic structure)
and non-trivial learnable dynamics, so the measured pipeline cost (conv
inference per env step, pixel batches through the object plane, conv
training on device) matches the real thing. ``make_atari`` transparently
prefers real ALE when available.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import gymnasium as gym
from gymnasium import spaces


class SyntheticAtariEnv(gym.Env):
    """Pong-like synthetic pixel env.

    A ball bounces around an 84×84 screen; the agent moves a paddle on the
    right edge (actions: NOOP×2, UP×2, DOWN×2 — six to match ALE's minimal
    action sets). Reward +1 for touching the ball with the paddle, -1 when
    the ball exits right. Episodes cap at ``max_steps``. Observations are
    the latest 4 rendered frames stacked on the channel axis, uint8 — the
    standard frame-stack layout.
    """

    metadata = {"render_modes": []}

    def __init__(self, max_steps: int = 1000, size: int = 84):
        self.size = size
        self.max_steps = max_steps
        self.observation_space = spaces.Box(0, 255, (size, size, 4), np.uint8)
        self.action_space = spaces.Discrete(6)
        self._rng = np.random.default_rng(0)
        self._frames = np.zeros((size, size, 4), np.uint8)

    def _render_frame(self) -> np.ndarray:
        s = self.size
        frame = np.zeros((s, s), np.uint8)
        frame[0, :] = frame[-1, :] = 40  # walls
        bx, by = int(self._ball[0]), int(self._ball[1])
        frame[max(0, by - 2):by + 2, max(0, bx - 2):bx + 2] = 255
        py = int(self._paddle)
        frame[max(0, py - 6):py + 6, s - 3:s - 1] = 180
        return frame

    def _obs(self) -> np.ndarray:
        self._frames = np.roll(self._frames, -1, axis=-1)
        self._frames[..., -1] = self._render_frame()
        return self._frames.copy()

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        s = self.size
        self._ball = np.array([s * 0.3, self._rng.uniform(10, s - 10)])
        self._vel = np.array([self._rng.uniform(1.5, 2.5),
                              self._rng.uniform(-2, 2)])
        self._paddle = s / 2.0
        self._t = 0
        self._frames[:] = 0
        return self._obs(), {}

    def step(self, action):
        s = self.size
        if action in (2, 3):
            self._paddle = max(6.0, self._paddle - 3.0)
        elif action in (4, 5):
            self._paddle = min(s - 6.0, self._paddle + 3.0)
        self._ball += self._vel
        if self._ball[1] <= 2 or self._ball[1] >= s - 2:
            self._vel[1] = -self._vel[1]
        reward = 0.0
        terminated = False
        if self._ball[0] >= s - 4:
            if abs(self._ball[1] - self._paddle) < 7:
                reward = 1.0
                self._vel[0] = -abs(self._vel[0])
            else:
                reward = -1.0
                terminated = True
        if self._ball[0] <= 2:
            self._vel[0] = abs(self._vel[0])
        self._t += 1
        truncated = self._t >= self.max_steps
        return self._obs(), reward, terminated, truncated, {}


def make_atari(name: str = "ALE/Pong-v5", **kwargs):
    """Real ALE with standard preprocessing when available, else the
    synthetic stand-in (this image carries no ROMs)."""
    try:
        import ale_py  # noqa: F401

        env = gym.make(name, frameskip=1)
        env = gym.wrappers.AtariPreprocessing(env, frame_skip=4,
                                              grayscale_obs=True)
        env = gym.wrappers.FrameStackObservation(env, 4)
        return gym.wrappers.TransformObservation(
            env, lambda o: np.transpose(np.asarray(o), (1, 2, 0)),
            spaces.Box(0, 255, (84, 84, 4), np.uint8))
    except Exception:  # noqa: BLE001 — missing package, ROMs, or namespace
        return SyntheticAtariEnv(**kwargs)

"""Replay buffers — prioritized experience replay + n-step returns.

Analog of the reference's replay stack
(``rllib/utils/replay_buffers/prioritized_episode_buffer.py`` — proportional
PER per Schaul et al. 2016, and the n-step preprocessing its DQN/SAC configs
apply before insertion). Storage is columnar numpy (ring arrays), priorities
live in a binary-indexed sum tree so sampling and priority updates are
O(log N) without touching the payload arrays.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class _SumTree:
    """Fixed-size sum tree over leaf priorities (prefix-sum sampling)."""

    def __init__(self, capacity: int):
        # Round up to a power of two: the vectorized descent assumes every
        # leaf sits at the same depth (a ragged last level would let some
        # lanes run past their leaf). Unused leaves keep priority 0 and are
        # never sampled.
        self.capacity = 1 << (capacity - 1).bit_length()
        # Full binary tree in an array; leaves at [capacity, 2*capacity).
        self._tree = np.zeros(2 * self.capacity, np.float64)

    def set(self, idx: np.ndarray, priority: np.ndarray) -> None:
        i = np.asarray(idx, np.int64) + self.capacity
        self._tree[i] = priority
        i //= 2
        # Propagate sums up level by level (vectorized over the batch; dedup
        # per level so parents are recomputed from CURRENT children).
        while i[0] > 0 or len(i) > 1:
            i = np.unique(i)
            if i[0] == 0:
                i = i[1:]
                if len(i) == 0:
                    break
            self._tree[i] = self._tree[2 * i] + self._tree[2 * i + 1]
            i //= 2

    @property
    def total(self) -> float:
        return float(self._tree[1])

    def sample(self, prefix: np.ndarray) -> np.ndarray:
        """Leaf indices whose cumulative-priority interval contains each
        prefix value (vectorized descent)."""
        idx = np.ones(len(prefix), np.int64)
        prefix = prefix.astype(np.float64).copy()
        while idx[0] < self.capacity:
            left = 2 * idx
            left_sum = self._tree[left]
            go_right = prefix > left_sum
            prefix = np.where(go_right, prefix - left_sum, prefix)
            idx = np.where(go_right, left + 1, left)
        return idx - self.capacity

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self._tree[np.asarray(idx, np.int64) + self.capacity]


class PrioritizedReplayBuffer:
    """Proportional PER: P(i) ∝ p_i^alpha, importance weights
    w_i = (N * P(i))^-beta / max w (Schaul et al. 2016, the reference DQN
    default). ``sample`` returns ``indices`` + ``weights`` columns; call
    ``update_priorities(indices, td_errors)`` after the gradient step."""

    def __init__(self, capacity: int, *, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6, seed: int = 0):
        self.capacity = capacity
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self._storage: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)
        self._tree = _SumTree(capacity)
        self._max_priority = 1.0

    def add_batch(self, transitions: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(transitions.values())))
        if n == 0:
            return
        if not self._storage:
            for k, v in transitions.items():
                shape = (self.capacity,) + v.shape[1:]
                self._storage[k] = np.zeros(shape, v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in transitions.items():
            self._storage[k][idx] = v
        # New transitions get max priority so they are seen at least once.
        self._tree.set(idx, np.full(n, self._max_priority ** self.alpha))
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self.capacity, self._size + n)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        total = self._tree.total
        # Stratified prefix sampling over the cumulative priority mass.
        bounds = np.linspace(0.0, total, batch_size + 1)
        prefix = self._rng.uniform(bounds[:-1], bounds[1:])
        idx = self._tree.sample(np.minimum(prefix, total * (1 - 1e-12)))
        idx = np.minimum(idx, self._size - 1)
        p = self._tree.get(idx) / max(total, 1e-12)
        w = (self._size * np.maximum(p, 1e-12)) ** (-self.beta)
        w = w / w.max()
        out = {k: v[idx] for k, v in self._storage.items()}
        out["indices"] = idx
        out["weights"] = w.astype(np.float32)
        return out

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray) -> None:
        pr = (np.abs(np.asarray(td_errors, np.float64)) + self.eps)
        self._max_priority = max(self._max_priority, float(pr.max()))
        self._tree.set(np.asarray(indices, np.int64), pr ** self.alpha)

    def __len__(self) -> int:
        return self._size


def nstep_columns(
    obs: np.ndarray,            # [T, N, ...]
    rewards: np.ndarray,        # [T, N]
    terminateds: np.ndarray,    # [T, N]
    valids: np.ndarray,         # [T, N] (0 = autoreset junk step)
    bootstrap_obs: np.ndarray,  # [N, ...] obs after step T-1
    *,
    n_step: int,
    gamma: float,
) -> Dict[str, np.ndarray]:
    """n-step return preprocessing on [T, N] rollout columns (the layout
    env runners emit — flattening first would interleave sub-envs and
    corrupt the temporal chains). For each (t, n): R = Σ_{k<s} γ^k r_{t+k},
    next_obs = obs_{t+s}, discount = γ^s, where the chain length s ≤ n_step
    stops at terminations, fragment end, or an autoreset junk step (the
    reference applies the same preprocessing before buffer insertion —
    its DQN/SAC n-step connector). TD targets then use the PER-SAMPLE
    ``discounts`` column: y = R + γ^s (1 - done) max_a Q(s', a)."""
    T, N = rewards.shape
    rewards = rewards.astype(np.float32)
    terms = terminateds.astype(np.float32)
    next_obs_all = np.concatenate([obs[1:], bootstrap_obs[None]], axis=0)
    R = rewards.copy()
    nxt = next_obs_all.copy()
    term_out = terms.copy()
    disc = np.full((T, N), gamma, np.float32)
    # alive: the chain starting at t may still extend past step t+k-1.
    alive = (1.0 - terms) > 0
    t_idx = np.arange(T)[:, None]
    for k in range(1, n_step):
        src = t_idx + k                       # [T, 1] + k
        in_range = (src < T)
        src_c = np.minimum(src, T - 1)
        row = np.broadcast_to(src_c, (T, N))
        col = np.broadcast_to(np.arange(N)[None, :], (T, N))
        can = in_range & alive & (valids[row, col] > 0)
        R = R + (gamma ** k) * rewards[row, col] * can
        nxt[can] = next_obs_all[row[can], col[can]]
        term_out = np.where(can, terms[row, col], term_out)
        disc = np.where(can, gamma ** (k + 1), disc).astype(np.float32)
        alive = alive & can & ((1.0 - terms[row, col]) > 0)
    flat_keep = valids.reshape(T * N) > 0
    obs_flat = obs.reshape((T * N,) + obs.shape[2:])
    return {
        "obs": obs_flat[flat_keep],
        "rewards": R.reshape(T * N)[flat_keep],
        "next_obs": nxt.reshape((T * N,) + obs.shape[2:])[flat_keep],
        "terminateds": term_out.reshape(T * N)[flat_keep],
        "discounts": disc.reshape(T * N)[flat_keep],
        "_keep": flat_keep,  # for callers to filter aligned extra columns
    }

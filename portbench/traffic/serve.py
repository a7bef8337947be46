"""Serving traffic: the request streams of a closed loop of clients.

One general generator reads a mix file. The sizes (prompt and output
lengths, system prompts, turns) are drawn once from the mix's own
``sizes_seed``, so every run's seed sees the same set of sizes; the run's
seed orders them, within consecutive groups as large as the client count,
and draws every token and sampling seed. So the seed changes the tokens and
the order, not the work.

Modes (``mode`` in the mix):

- ``independent``: each request is a fresh prompt of random tokens;
  ``prompt`` and ``output`` give lognormal lengths (``median``, ``sigma``,
  ``min``, ``max``); ``greedy_share`` of the requests are greedy, the rest
  sample at ``temperature``.
- ``sessions``: multi-turn chat. A session draws one of ``system_prompts``
  shared system prompts (lengths uniform in ``system_len``), then turns of
  ``user_len`` new user tokens asking for ``output_len`` tokens; the next
  turn's prompt is the whole history, the served answers included. A
  session ends when the next prompt plus the longest answer would pass
  ``max_len``. With ``share: false`` every turn is instead an independent
  request of fresh random tokens with the same prompt and output lengths
  (the control that bypasses the prefix cache).

Each request carries ``known_prefix``: how many of its leading tokens an
earlier request of the run already sent or received whole (a later turn's
history; a first turn's system prompt cut to whole KV blocks). It is the
least prefill work the inputs need, for the roofline counts.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from portbench.weights import mix as mix_seed


@dataclass
class Turn:
    user: np.ndarray            # new tokens of this turn (the whole prompt
    max_new: int                # for an independent request)
    temperature: float
    seed: int


@dataclass
class Session:
    """A stream of turns run one after another by one client; an
    independent request is a session of one turn with no system prompt."""
    system: Optional[np.ndarray]
    turns: List[Turn] = field(default_factory=list)


def _lognormal(rng, spec: Dict, n: int) -> np.ndarray:
    x = np.exp(np.log(spec["median"]) + spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


class Generator:
    """Thread-safe source of sessions for ``clients`` closed-loop clients."""

    def __init__(self, mix: Dict, seed: int, vocab: int, clients: int,
                 block_tokens: int):
        self.mix = mix
        self.seed = seed
        self.vocab = vocab
        self.block_tokens = block_tokens
        self._lock = threading.Lock()
        self._next = 0
        sizes = np.random.default_rng(mix["sizes_seed"])
        n = mix["pool"]
        if mix["mode"] == "independent":
            self._sizes = [[(int(p), int(o))] for p, o in zip(
                _lognormal(sizes, mix["prompt"], n),
                _lognormal(sizes, mix["output"], n))]
            self._sys_of = [None] * n
            greedy = np.zeros(n, bool)
            greedy[:int(round(mix["greedy_share"] * n))] = True
            self._greedy = sizes.permutation(greedy)
        elif mix["mode"] == "sessions":
            lo, hi = mix["system_len"]
            sys_lens = sizes.integers(lo, hi + 1, mix["system_prompts"])
            self._sys_of, self._sizes = [], []
            longest = mix["output_len"][1]
            for _ in range(n):
                s = int(sizes.integers(mix["system_prompts"]))
                hist, turns = int(sys_lens[s]), []
                while True:
                    u = int(sizes.integers(mix["user_len"][0],
                                           mix["user_len"][1] + 1))
                    o = int(sizes.integers(mix["output_len"][0],
                                           mix["output_len"][1] + 1))
                    if hist + u + longest > mix["max_len"]:
                        break
                    turns.append((u, o))
                    hist += u + o
                self._sys_of.append(s)
                self._sizes.append(turns)
            self._greedy = np.ones(n, bool)
            self._sys_lens = sys_lens
            if not mix.get("share", True):      # each turn on its own
                flat, hist = [], None
                for s, turns in zip(self._sys_of, self._sizes):
                    hist = int(sys_lens[s])
                    for u, o in turns:
                        flat.append([(hist + u, o)])
                        hist += u + o
                self._sizes = flat
                self._sys_of = [None] * len(flat)
                self._greedy = np.ones(len(flat), bool)
        else:
            raise ValueError(f"unknown serve mode {mix['mode']!r}")
        # The run's order: a permutation within each group of `clients`.
        order = np.random.default_rng([seed & (2**63 - 1), 7]).permutation
        n = len(self._sizes)
        self._order = np.concatenate([
            g + order(min(clients, n - g)) for g in range(0, n, clients)])
        self._system = None
        if mix["mode"] == "sessions" and mix.get("share", True):
            rng = np.random.default_rng([seed & (2**63 - 1), 11])
            self._system = [rng.integers(0, vocab, int(x))
                            for x in self._sys_lens]
        self._system_seen = set()

    def _tokens(self, idx: int, turn: int, n: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed & (2**63 - 1), 13, idx, turn])
        return rng.integers(0, self.vocab, n)

    def next_session(self):
        """``(session, known_system)``: the next session in the run's order
        (the pool repeats when it runs out) and how many of its system
        prompt's tokens an earlier session already sent, cut to whole KV
        blocks."""
        with self._lock:
            k = self._next
            self._next += 1
            idx = int(self._order[k % len(self._order)])
            sys_idx = self._sys_of[idx]
            known = 0
            if sys_idx is not None and self._system is not None:
                if sys_idx in self._system_seen:
                    n = len(self._system[sys_idx])
                    known = n // self.block_tokens * self.block_tokens
                self._system_seen.add(sys_idx)
        temp = self.mix.get("temperature", 0.0)
        greedy = bool(self._greedy[idx])
        turns = [Turn(self._tokens(k, t, u), o,
                      0.0 if greedy else float(temp),
                      mix_seed(self.seed, 3, k, t) & 0x7FFFFFFF)
                 for t, (u, o) in enumerate(self._sizes[idx])]
        system = (self._system[sys_idx]
                  if sys_idx is not None and self._system is not None
                  else None)
        return Session(system, turns), known

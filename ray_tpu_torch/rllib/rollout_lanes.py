"""Compiled-DAG rollout lanes — shm fragment transport for IMPALA/APPO.

Counterpart of ``ray_tpu/rllib/rollout_lanes.py`` on the port's compiled
DAG (``ray_tpu_torch/dag``). The rollout loop gets a lane tier for its
N-producers→1-consumer shape: every env runner parks in a resident stage
loop (``actor_dag_loop``) and streams sample fragments to the driver over
multi-slot shm ring channels, gathered per tick by a ``MultiOutputNode``.

What the lane replaces, per fragment, vs the task path:
- the ``ray_tpu_torch.wait`` readiness poll + ObjectRef store round trip,
- a fresh ``sample.remote`` task submission to keep the pipeline full,
- the per-iteration ``get_metrics`` RPCs that queue behind in-flight
  ``sample`` calls on the serial runner actors (metrics ride the fragment
  instead — see ``SingleAgentEnvRunner.sample_dag``).

Backpressure is the ring's deferred ack: with ``dag_channel_slots`` ticks
in flight on an edge, a slow learner blocks the runners' next write — no
fragment is ever dropped. Weight broadcasts ride the tick payload (a
lane-parked actor cannot serve ``set_weights`` calls), which makes
broadcast staleness exactly the submission pipeline depth.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional, Sequence, Tuple

from ray_tpu_torch.dag.dag_node import InputNode, MultiOutputNode


class RolloutLanes:
    """One compiled DAG: driver input fans out to every runner's
    ``sample_dag`` stage; the per-tick gather returns one fragment per
    runner, in runner order."""

    def __init__(
        self,
        runners: Sequence[Any],
        num_steps: int,
        *,
        depth: int = 2,
        channel_capacity: int = 16 * 1024 * 1024,
        execute_timeout_s: float = 120.0,
    ):
        assert len(runners) >= 1
        self._runners = list(runners)
        self._num_steps = int(num_steps)
        self._depth = max(1, int(depth))
        self._execute_timeout_s = float(execute_timeout_s)
        with InputNode() as inp:
            leaves = [r.sample_dag.bind(inp) for r in self._runners]
        out = MultiOutputNode(leaves) if len(leaves) > 1 else leaves[0]
        self._multi = len(leaves) > 1
        self._dag = out.experimental_compile(
            channel_capacity=channel_capacity)
        self._pending: deque = deque()

    @property
    def num_runners(self) -> int:
        return len(self._runners)

    def in_flight(self) -> int:
        return len(self._pending)

    def submit(self, weights: Optional[Any] = None) -> None:
        """Launch one tick. ``weights`` (or None) reaches every runner
        before it samples — the broadcast path in lane mode."""
        ref = self._dag.execute(
            {"num_steps": self._num_steps, "weights": weights},
            timeout=self._execute_timeout_s)
        self._pending.append(ref)

    def fill(self, weights: Optional[Any] = None) -> None:
        """Top the submission pipeline up to ``depth`` in-flight ticks.
        Only the first backfilled tick carries ``weights``: the runners
        apply it once, the rest of the window samples under it."""
        while len(self._pending) < self._depth:
            self.submit(weights)
            weights = None

    def next(self, timeout: Optional[float] = None) -> Tuple[Dict, ...]:
        """Fetch the oldest in-flight tick: one fragment dict per runner.
        Raises TimeoutError/RuntimeError on a lost or failed stage — the
        caller (IMPALA) tears the lane down, respawns dead runners and
        rebuilds."""
        if not self._pending:
            self.fill()
        ref = self._pending[0]
        result = ref.get(timeout=timeout)
        self._pending.popleft()
        return result if self._multi else (result,)

    def teardown(self) -> None:
        self._pending.clear()
        self._dag.teardown()

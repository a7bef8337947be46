"""IMPALA — asynchronous actor-learner with V-trace off-policy correction.

Analog of the reference's ``rllib/algorithms/impala/impala.py`` (async
``training_step`` with aggregator workers and in-flight request
management). The shape:

- EnvRunner actors sample continuously under a (slightly stale) policy; the
  driver keeps ``max_requests_in_flight`` sample calls outstanding per
  runner and consumes whichever finishes first (``ray_tpu_torch.wait``) —
  or, with the rollout lanes on, streams fragments over a compiled DAG.
- Optional **aggregator actors** concatenate several rollout fragments into
  one learner-sized batch off the driver's critical path.
- The Learner applies **V-trace** (Espeholt et al. 2018): importance-clipped
  off-policy returns computed inside the loss with the current policy's
  log-probs.
- Weights broadcast to runners (or to the shared inference pool) every
  ``broadcast_interval`` updates (the staleness knob).

Counterpart of ``ray_tpu/rllib/impala.py``: ``vtrace``'s reverse
``lax.scan`` is a right-to-left loop over T on tensors, ``stop_gradient``
is ``.detach()``, and the learners take the port's ``Learner`` device
policy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.core.config import config as _get_config
from ray_tpu_torch.core.exceptions import ActorError
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfigBase
from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.rl_module import spec_for_env
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger(__name__)


def vtrace(
    behavior_logp,   # [T, N]
    target_logp,     # [T, N]
    rewards,         # [T, N]
    values,          # [T, N]  V(x_t) under the CURRENT policy's critic
    bootstrap_value,  # [N]    V(x_T)
    terminateds,     # [T, N]  1.0 where the episode truly ended at t
    *,
    gamma: float,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    valids=None,     # [T, N]  0 on autoreset (junk) steps — see compute_gae
):
    """V-trace targets vs_t and policy-gradient advantages, as tensors
    (numpy inputs are taken as they are).

    vs_t = V_t + Σ_{k≥t} γ^{k-t} (Π_{i<k} c_i) δ_k with clipped importance
    weights ρ, c (Espeholt et al. 2018 eq. 1), computed right to left.
    Discounts are cut at terminations. ``valids`` zeros the accumulator at
    autoreset steps (the same trick as ``compute_gae``): the junk step's vs
    collapses to V_t, so the PRECEDING step's delta bootstraps through
    V(final obs) — the truncation bootstrap — and nothing leaks across the
    episode boundary.
    """
    (behavior_logp, target_logp, rewards, values, bootstrap_value,
     terminateds) = (torch.as_tensor(x) for x in (
         behavior_logp, target_logp, rewards, values, bootstrap_value,
         terminateds))
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_bar)
    c = torch.clamp(ratio, max=c_bar)
    discount = gamma * (1.0 - terminateds)
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rho * (rewards + discount * next_values - values)
    valids = (torch.ones_like(rewards) if valids is None
              else torch.as_tensor(valids))

    acc = torch.zeros_like(bootstrap_value)
    rows = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        acc = (deltas[t] + discount[t] * c[t] * acc) * valids[t]
        rows.append(acc)
    vs = torch.stack(rows[::-1]) + values
    # PG advantage uses vs_{t+1} (bootstrap for the final step).
    vs_next = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = rho * (rewards + discount * vs_next - values)
    return vs, pg_adv


class ImpalaLearner(Learner):
    """V-trace actor-critic loss over [T, N] trajectory batches."""

    def loss_fn(self, params, batch):
        cfg = self.config
        T, N = batch["rewards"].shape
        obs = batch["obs"].reshape((T * N,) + tuple(batch["obs"].shape[2:]))
        actions = batch["actions"].reshape(
            (T * N,) + tuple(batch["actions"].shape[2:]))
        logp, entropy, values = self.module.logp_and_entropy(
            params, obs, actions)
        logp = logp.reshape(T, N)
        values = values.reshape(T, N)
        entropy = entropy.reshape(T, N)
        bootstrap = self.module.forward_train(
            params, batch["bootstrap_obs"])["vf_preds"]
        valids = batch.get("valids")
        if valids is None:
            valids = torch.ones_like(logp)
        # Targets and advantages carry no gradient (JAX's stop_gradient):
        # V-trace runs on detached inputs.
        vs, pg_adv = vtrace(
            batch["logp"], logp.detach(), batch["rewards"], values.detach(),
            bootstrap.detach(), batch["terminateds"],
            gamma=cfg["gamma"],
            rho_bar=cfg.get("rho_bar", 1.0),
            c_bar=cfg.get("c_bar", 1.0),
            valids=valids,
        )
        w = valids / torch.clamp(valids.sum(), min=1.0)
        pg_loss = self._pg_loss(logp, batch["logp"], pg_adv, w)
        vf_loss = 0.5 * torch.sum((values - vs) ** 2 * w)
        ent = torch.sum(entropy * w)
        return (pg_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                - cfg.get("entropy_coeff", 0.01) * ent)

    def _pg_loss(self, logp, behavior_logp, adv, w):
        """Plain policy gradient over the v-trace advantages; APPO swaps
        in the clipped surrogate."""
        return -torch.sum(logp * adv * w)


class AggregatorActor:
    """Concatenates rollout fragments into learner batches
    (reference: ``impala.py`` AggregatorWorker)."""

    def aggregate(self, *fragments: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for key in fragments[0]:
            if key in ("bootstrap_value", "bootstrap_obs"):
                out[key] = np.concatenate([f[key] for f in fragments], axis=0)
            else:
                # [T, N, ...] fragments concat on the env axis.
                out[key] = np.concatenate([f[key] for f in fragments], axis=1)
        return out


@dataclass
class ImpalaConfig(AlgorithmConfigBase):
    env: Optional[Callable[[], Any]] = None
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 64
    num_aggregators: int = 0
    # >0: updates run on a LearnerGroup of remote learner actors with
    # allreduced gradients instead of a driver-local learner.
    num_learners: int = 0
    max_requests_in_flight: int = 2
    broadcast_interval: int = 1          # updates between weight broadcasts
    train_batch_fragments: int = 1       # fragments per learner update
    # Sebulba split (rllib/inference.py): >0 moves action selection into a
    # shared pool of this many batching InferenceActors; 0 keeps
    # runner-local params (the Anakin/colocated mode).
    num_inference_actors: int = 0
    # Rollout transport: None defers to the rollout_lanes_enabled knob;
    # True/False force the compiled-DAG lane / task path for this run.
    rollout_lanes: Optional[bool] = None
    # Ticks kept in flight on the lane (the max_requests_in_flight analog;
    # also the weight-broadcast staleness in lane mode).
    lane_depth: int = 2
    # Bound on waiting for any one fragment (task-path wait and lane fetch)
    # before the driver declares the sampler lost.
    sample_timeout_s: float = 120.0
    gamma: float = 0.99
    lr: float = 5e-4
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rho_bar: float = 1.0
    c_bar: float = 1.0
    grad_clip: float = 40.0
    seed: int = 0
    hidden: Optional[tuple] = None

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA:
    """Async actor-learner algorithm (Tune-compatible train() contract)."""

    # Subclasses (APPO) swap the learner while reusing the async
    # sample/aggregate/update machinery (the reference's APPO subclasses
    # IMPALA the same way).
    _LEARNER_CLS = ImpalaLearner

    def _learner_config(self, config) -> Dict[str, Any]:
        return {
            "lr": config.lr, "gamma": config.gamma,
            "vf_loss_coeff": config.vf_loss_coeff,
            "entropy_coeff": config.entropy_coeff,
            "rho_bar": config.rho_bar, "c_bar": config.c_bar,
            "grad_clip": config.grad_clip,
        }

    def __init__(self, config: ImpalaConfig):
        assert config.env is not None, "config.environment(env_creator) required"
        self.config = config
        probe = config.env()
        self.spec = spec_for_env(probe)
        if config.hidden and not self.spec.conv:
            import dataclasses

            self.spec = dataclasses.replace(self.spec,
                                            hidden=tuple(config.hidden))
        probe.close()

        learner_cfg = self._learner_config(config)
        if config.num_learners > 0:
            import uuid

            from ray_tpu_torch.rllib.learner import LearnerGroup

            # [T, N] trajectory columns shard on the ENV axis so each
            # learner sees whole time series; [N, ...] bootstrap rows on 0.
            self.learner = LearnerGroup(
                type(self)._LEARNER_CLS, self.spec, learner_cfg,
                num_learners=config.num_learners,
                group_name=f"impala-learners-{uuid.uuid4().hex[:8]}",
                seed=config.seed,
                shard_axes={"obs": 1, "actions": 1, "logp": 1, "values": 1,
                            "rewards": 1, "terminateds": 1, "valids": 1,
                            "bootstrap_obs": 0, "bootstrap_value": 0},
            )
        else:
            self.learner = type(self)._LEARNER_CLS(self.spec, learner_cfg,
                                                   seed=config.seed)

        flags = _get_config()
        self._use_lanes = (bool(flags.rollout_lanes_enabled)
                           if config.rollout_lanes is None
                           else bool(config.rollout_lanes))
        if config.num_inference_actors > 0:
            from ray_tpu_torch.rllib.inference import InferencePool

            self._pool = InferencePool(
                config.num_inference_actors, self.spec, seed=config.seed,
                num_clients=max(1, config.num_env_runners))
        else:
            self._pool = None
        self._runner_cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
        self._runners = [self._make_runner(i)
                         for i in range(max(1, config.num_env_runners))]
        self._lanes = None  # built on first lane-mode train()
        self._pending_weights = None  # lane mode: ride the next tick payload
        if config.num_aggregators > 0:
            agg_cls = ray_tpu_torch.remote(AggregatorActor)
            self._aggregators = [agg_cls.remote()
                                 for _ in range(config.num_aggregators)]
        else:
            self._aggregators = []
        self._agg_rr = 0
        self._inflight: Dict[Any, Any] = {}  # sample ref -> runner
        self._pending_frags: List[Any] = []  # carried across train() calls
        self._updates = 0
        self._iteration = 0
        self._timesteps = 0
        self._broadcast()

    def _make_runner(self, i: int):
        kwargs: Dict[str, Any] = dict(
            num_envs=self.config.num_envs_per_runner,
            seed=self.config.seed + 1000 * i, spec=self.spec)
        if self._pool is not None:
            kwargs["inference"] = self._pool.handle_for(i)
        return self._runner_cls.remote(self.config.env, **kwargs)

    def _broadcast(self):
        weights = self.learner.get_weights()
        if self._pool is not None:
            # Sebulba: K inference actors hold the only sampling params —
            # the broadcast never touches the N runners.
            self._pool.set_weights(weights)
        elif self._lanes is not None:
            # Lane-parked runners can't serve set_weights calls; the
            # weights ride the next tick's input payload instead.
            self._pending_weights = weights
        else:
            # Per-runner ack: one dead runner must not abort the whole
            # broadcast (its respawn reloads current weights anyway).
            refs = [(r, r.set_weights.remote(weights))
                    for r in list(self._runners)]
            for runner, ref in refs:
                try:
                    ray_tpu_torch.get(ref)
                except ActorError:
                    self._respawn_runner(runner)

    def _launch(self, runner):
        ref = runner.sample.remote(self.config.rollout_fragment_length)
        self._inflight[ref] = runner

    def _respawn_runner(self, runner):
        """A runner died (ActorError from sample/get_metrics): replace it
        in place with current weights and relaunch its in-flight quota so
        training continues at full sampling width."""
        i = self._runners.index(runner)
        logger.warning("env runner %d died; respawning", i)
        for ref in [r for r, w in list(self._inflight.items())
                    if w is runner]:
            del self._inflight[ref]
        new = self._make_runner(i)
        if self._pool is None:
            ray_tpu_torch.get(new.set_weights.remote(
                self.learner.get_weights()))
        self._runners[i] = new
        if not self._use_lanes:
            for _ in range(self.config.max_requests_in_flight):
                self._launch(new)
        return new

    # -- lane mode -----------------------------------------------------------
    def _ensure_lanes(self):
        if self._lanes is None:
            from ray_tpu_torch.rllib.rollout_lanes import RolloutLanes

            self._lanes = RolloutLanes(
                self._runners, self.config.rollout_fragment_length,
                depth=self.config.lane_depth,
                execute_timeout_s=self.config.sample_timeout_s)
        return self._lanes

    def _recover_lanes(self, err: BaseException) -> None:
        """A lane tick failed (stage error or a dead runner starving the
        gather): tear the lane down, respawn whoever doesn't answer a ping,
        and let the next tick rebuild it."""
        logger.warning("rollout lane failed (%s); rebuilding", err)
        try:
            self._lanes.teardown()
        except Exception:  # noqa: BLE001
            log_swallowed(logger, "rollout lane teardown")
        self._lanes = None
        for runner in list(self._runners):
            try:
                ray_tpu_torch.get(runner.ping.remote(), timeout=10.0)
            except Exception:  # noqa: BLE001 — dead or wedged either way
                self._respawn_runner(runner)

    def _to_train_batch(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        batch = dict(sample)
        # V-trace bootstraps through V(x_T) of the CURRENT policy — ship the
        # final obs, drop the runner's stale value estimate.
        batch.pop("bootstrap_value", None)
        return batch

    def _observe_idle(self, idle: float) -> None:
        from ray_tpu_torch.core.metrics_export import (metrics_enabled,
                                                       rl_learner_idle_hist)

        if metrics_enabled():
            rl_learner_idle_hist().observe(idle)

    def train(self) -> Dict[str, Any]:
        """One iteration: consume ``num_env_runners`` fragments worth of
        experience asynchronously, updating as results land."""
        cfg = self.config
        t0 = time.perf_counter()
        target_fragments = max(len(self._runners), cfg.train_batch_fragments)
        run = self._train_lanes if self._use_lanes else self._train_tasks
        if self._iteration >= 1:
            # Iteration 1 built every kernel and warmed every path; from
            # here on the driver-side loop is steady state — a kernel build
            # or an implicit device->host read is a regression (recorded
            # when jitcheck is installed).
            from ray_tpu_torch.devtools import jitcheck

            with jitcheck.steady_state():
                stats = run(target_fragments)
        else:
            stats = run(target_fragments)
        sampled_steps, losses, returns, idle_s = stats

        self._timesteps += sampled_steps
        self._iteration += 1
        dt = time.perf_counter() - t0
        from ray_tpu_torch.core.metrics_export import (metrics_enabled,
                                                       rl_env_steps_total)

        if metrics_enabled():
            rl_env_steps_total().inc(sampled_steps)
        return {
            "training_iteration": self._iteration,
            "timesteps_total": self._timesteps,
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "env_steps_per_sec": sampled_steps / dt,
            "num_updates": self._updates,
            "learner_idle_s": idle_s,
            "time_total_s": dt,
        }

    def _update(self, batch: Dict[str, np.ndarray]) -> float:
        """One learner step, then the broadcast every broadcast_interval."""
        loss = self.learner.update(batch)["loss"]
        self._updates += 1
        if self._updates % self.config.broadcast_interval == 0:
            self._broadcast()
        return loss

    def _update_from_fragments(self, frags: List[Dict[str, np.ndarray]]):
        """One learner step from materialized fragments (lane mode and the
        driver-side task-path fallback share this)."""
        batch = (AggregatorActor().aggregate(*frags)
                 if len(frags) > 1 else dict(frags[0]))
        return self._update(self._to_train_batch(batch))

    def _train_tasks(self, target_fragments: int):
        """The per-fragment task path (``rollout_lanes_enabled=0``): keep
        ``max_requests_in_flight`` sample calls outstanding per runner and
        consume whichever lands first via ``ray_tpu_torch.wait``."""
        cfg = self.config
        for runner in self._runners:
            while sum(1 for r, w in self._inflight.items() if w is runner) \
                    < cfg.max_requests_in_flight:
                self._launch(runner)

        consumed = 0
        losses = []
        sampled_steps = 0
        idle_s = 0.0
        # Every fragment trains exactly once: leftovers persist on self so
        # aggregation never discards experience, and the loop runs until at
        # least one update landed.
        while consumed < target_fragments or not losses:
            w0 = time.perf_counter()
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                          timeout=cfg.sample_timeout_s)
            idle = time.perf_counter() - w0
            idle_s += idle
            self._observe_idle(idle)
            if not ready:
                raise TimeoutError(
                    f"no sample fragment arrived in {cfg.sample_timeout_s}s")
            ref = ready[0]
            runner = self._inflight.pop(ref)
            try:
                # Probe before counting: a runner death surfaces here (and
                # the object-store get is a cache hit for the batch below).
                ray_tpu_torch.get(ref)
            except ActorError:
                self._respawn_runner(runner)
                continue
            self._launch(runner)  # keep the pipeline full
            consumed += 1
            sampled_steps += (cfg.rollout_fragment_length
                              * cfg.num_envs_per_runner)
            if cfg.train_batch_fragments > 1:
                self._pending_frags.append(ref)
                if len(self._pending_frags) < cfg.train_batch_fragments:
                    continue
                if self._aggregators:
                    agg = self._aggregators[self._agg_rr % len(self._aggregators)]
                    self._agg_rr += 1
                    batch = ray_tpu_torch.get(
                        agg.aggregate.remote(*self._pending_frags))
                else:
                    # No aggregator actors: concatenate on the driver so the
                    # configured batch size still holds.
                    batch = AggregatorActor().aggregate(
                        *ray_tpu_torch.get(self._pending_frags))
                self._pending_frags = []
            else:
                batch = ray_tpu_torch.get(ref)
            losses.append(self._update(self._to_train_batch(batch)))

        returns = []
        metric_refs = [(r, r.get_metrics.remote()) for r in list(self._runners)]
        for runner, mref in metric_refs:
            try:
                m = ray_tpu_torch.get(mref, timeout=cfg.sample_timeout_s)
            except ActorError:
                self._respawn_runner(runner)
                continue
            if m["num_episodes"] > 0:
                returns.append(m["episode_return_mean"])
        return sampled_steps, losses, returns, idle_s

    def _train_lanes(self, target_fragments: int):
        """The compiled-DAG lane path: fragments stream over multi-slot shm
        channels, gathered a full tick (one fragment per runner) at a time.
        Episode metrics ride each fragment; weight broadcasts ride the next
        tick's payload."""
        cfg = self.config
        consumed = 0
        losses = []
        sampled_steps = 0
        idle_s = 0.0
        returns = []
        while consumed < target_fragments or not losses:
            lanes = self._ensure_lanes()
            w0 = time.perf_counter()
            try:
                weights, self._pending_weights = self._pending_weights, None
                lanes.fill(weights)
                frags = lanes.next(timeout=cfg.sample_timeout_s)
            except Exception as err:  # noqa: BLE001 — lane fetch/stage loss
                self._recover_lanes(err)
                continue
            idle = time.perf_counter() - w0
            idle_s += idle
            self._observe_idle(idle)
            for frag in frags:
                frag = dict(frag)
                m = frag.pop("metrics", None)
                if m and m.get("num_episodes", 0) > 0:
                    returns.append(m["episode_return_mean"])
                consumed += 1
                sampled_steps += (cfg.rollout_fragment_length
                                  * cfg.num_envs_per_runner)
                # Leftovers persist across ticks/iterations so aggregation
                # never discards experience (same contract as the task path).
                self._pending_frags.append(frag)
                if len(self._pending_frags) >= max(1, cfg.train_batch_fragments):
                    pend, self._pending_frags = self._pending_frags, []
                    losses.append(self._update_from_fragments(pend))
        return sampled_steps, losses, returns, idle_s

    def save(self, path: str) -> str:
        from ray_tpu_torch.train.checkpoint import save_pytree

        save_pytree({"params": self.learner.get_state()["params"],
                     "iteration": self._iteration,
                     "timesteps": self._timesteps}, path)
        return path

    def restore(self, path: str) -> None:
        from ray_tpu_torch.train.checkpoint import load_pytree

        data = load_pytree(path)
        state = self.learner.get_state()
        state["params"] = data["params"]
        self.learner.set_state(state)
        self._iteration = int(data["iteration"])
        self._timesteps = int(data["timesteps"])
        self._broadcast()

    def stop(self) -> None:
        self._inflight.clear()
        if self._lanes is not None:
            try:
                self._lanes.teardown()
            except Exception:  # noqa: BLE001
                log_swallowed(logger, "rollout lane teardown")
            self._lanes = None
        if hasattr(self.learner, "shutdown"):
            self.learner.shutdown()
        if self._pool is not None:
            self._pool.stop()
        for r in self._runners + self._aggregators:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001 — already-dead actor at teardown
                log_swallowed(logger, "actor kill during IMPALA.stop")

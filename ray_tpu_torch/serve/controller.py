"""ServeController — the reconciler control plane.

The port's copy of ``ray_tpu/serve/controller.py``: a singleton actor
owning desired state; a background reconcile thread starts/stops replica
actors to match; handles learn replica sets via versioned long-poll
snapshots. The request path NEVER touches the controller.

One difference by design: a replica's ``num_gpus`` (and its alias
``num_tpus``) reaches the replica actor as the port's ``GPU`` grant and
counts as ``GPU`` in the replica's shape. The JAX controller forwards only
``num_cpus``, ``num_tpus`` and ``resources``; copied so, a replica would
use the card without holding a grant for it.

The cluster KV tier's drain-then-retire paths run behind
``kv_tier_enabled``: a draining victim ships its warm chains to a survivor
through the engines' ``kv_migrate_out``/``kv_migrate_in`` before it
retires.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.config import config
from ray_tpu_torch.serve.autoscaling import (DeploymentSignals,
                                             GangPreemption, SLOPolicy,
                                             TTFTRollup)
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.replica import ReplicaActor
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.utils.logging import get_logger, log_swallowed

logger = get_logger("serve_controller")

CONTROLLER_NAME = "SERVE_CONTROLLER"


def _runtime_preempt(resources: Dict[str, float], count: int,
                     min_priority: int) -> int:
    """Route a gang-preemption request to whichever runtime this controller
    replica lives in (CoreWorker RPC in multiprocess, the in-process
    PlacementGroupManager otherwise)."""
    from ray_tpu_torch.core.runtime import get_runtime

    fn = getattr(get_runtime(), "preempt_gangs", None)
    return int(fn(resources, count, min_priority)) if fn is not None else 0


def _replica_shape(t: "_DeploymentTarget") -> Dict[str, float]:
    """One replica's resource demand, from its actor options (the shape a
    preemption must make placeable)."""
    opts = t.config.ray_actor_options or {}
    shape: Dict[str, float] = {}
    if opts.get("num_cpus"):
        shape["CPU"] = float(opts["num_cpus"])
    n_gpus = opts.get("num_gpus", opts.get("num_tpus"))
    if n_gpus:
        shape["GPU"] = float(n_gpus)
    for k, v in (opts.get("resources") or {}).items():
        shape[k] = float(v)
    return shape or {"CPU": 1.0}


@dataclass
class _DeploymentTarget:
    name: str
    callable_or_class: Any
    init_args: tuple
    init_kwargs: dict
    config: DeploymentConfig
    route_prefix: Optional[str] = None
    target_replicas: int = 1
    version: int = 0  # bumped on redeploy; stale-version replicas are culled


class ServeControllerActor:
    def __init__(self):
        self._targets: Dict[str, _DeploymentTarget] = {}
        # name -> [(version, actor handle)]
        self._replicas: Dict[str, List[Any]] = {}
        self._version = 0
        self._lock = threading.Lock()
        self._running = True
        self._metrics: Dict[str, float] = {}  # deployment -> ongoing EWMA
        self._metrics_t: Dict[str, float] = {}  # deployment -> last report
        # SLO autoscaling state: one policy per deployment (holds the
        # hysteresis/cooldown timers) + the rate-limited TTFT rollup reader.
        self._policies: Dict[str, SLOPolicy] = {}
        # SLO-pressure capacity reclaim: an upscale decision under a TTFT
        # breach may revoke lower-gang_priority training gangs through the
        # runtime's preempt_gangs path before the new replicas try to place.
        self._gang_preemption = GangPreemption(_runtime_preempt)
        self._ttft = TTFTRollup(
            min_interval_s=config().serve_slo_rollup_interval_s)
        self._last_slo_eval: Dict[str, float] = {}
        # deployment -> {replica key -> loaded multiplexed model ids}
        self._model_ids: Dict[str, Dict[str, list]] = {}
        # deployment -> {replica key -> metrics dict (ongoing, slot
        # occupancy, queue depth, ...)} — the routers' occupancy signal.
        self._replica_load: Dict[str, Dict[str, dict]] = {}
        self._model_poll_tick = 0
        # Rolling updates: old-version replicas keep serving until the new
        # version is fully up, then retire here — excluded from routing,
        # killed only once drained (or past the grace cap). Entries are
        # (replica, since, pending get_metrics ref or None).
        self._retiring: Dict[str, List[Any]] = {}
        # Serializes the reconcile body: actor calls (deploy/delete) and
        # the background loop both reconcile; unsynchronized passes would
        # double-spawn replicas or clobber _retiring.
        self._reconcile_lock = threading.Lock()
        # Replicas confirmed ready (answered check_health); rollouts only
        # retire the old version once every NEW replica is ready.
        self._ready: set = set()
        self._ready_probes: Dict[str, Any] = {}  # actor id -> in-flight ref
        # Replica actor ids observed DEAD (ActorError from a health probe or
        # the state poll): reconcile culls them from the fleet so the
        # scale-up loop respawns replacements — a replica lost mid-scale-up
        # must still converge to the target count.
        self._dead: set = set()
        # Drain-then-retire (cluster KV tier): deployment -> {victim actor
        # key -> survivor actor key}. Published in get_snapshot as
        # "migrations" so routers REWRITE the victim's prefix-affinity
        # entries to the survivor instead of sweeping them.
        self._drain_map: Dict[str, Dict[str, str]] = {}
        # victim actor key -> (out_ref, in_ref, started_at): in-flight KV
        # migrations; _collect_retired holds the kill until the victim's
        # kv_migrate_out resolves (or the drain timeout lapses).
        self._migrations: Dict[str, tuple] = {}
        self._reconcile_thread = threading.Thread(target=self._loop, daemon=True)
        self._reconcile_thread.start()

    # -- control API ---------------------------------------------------------
    def deploy(
        self,
        name: str,
        callable_or_class: Any,
        init_args: tuple,
        init_kwargs: dict,
        config: DeploymentConfig,
        route_prefix: Optional[str],
    ) -> bool:
        with self._lock:
            target = _DeploymentTarget(
                name, callable_or_class, init_args, init_kwargs, config, route_prefix
            )
            asc = config.autoscaling_config
            target.target_replicas = (
                max(asc.min_replicas, 1) if asc else config.num_replicas
            )
            prev = self._targets.get(name)
            target.version = prev.version + 1 if prev is not None else 0
            self._targets[name] = target
        self._reconcile_once()
        return True

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            self._targets.pop(name, None)
        self._reconcile_once()
        return True

    def list_deployments(self) -> Dict[str, dict]:
        with self._lock:
            return {
                n: {
                    "target_replicas": t.target_replicas,
                    "num_replicas": len(
                        [r for v, r in self._replicas.get(n, []) if v == t.version]
                    ),
                    "route_prefix": t.route_prefix,
                    "max_ongoing_requests": t.config.max_ongoing_requests,
                }
                for n, t in self._targets.items()
            }

    def set_target_replicas(self, name: str, n: int) -> bool:
        """Pin a deployment's replica count (operator override / tests).
        With autoscaling configured the next policy decision may move it
        again; the scale-down path is the same drain-then-retire either
        way."""
        with self._lock:
            t = self._targets.get(name)
            if t is None:
                return False
            t.target_replicas = max(0, int(n))
        self._reconcile_once()
        return True

    def shutdown(self) -> bool:
        self._running = False
        with self._lock:
            self._targets.clear()
        # The reconcile thread is exiting: kill every replica NOW (graceful
        # draining is for rollouts, not controller teardown) — parking them
        # in _retiring here would leak them forever.
        with self._reconcile_lock:
            victims = [r for reps in self._replicas.values()
                       for _v, r in reps]
            victims += [r for lst in self._retiring.values()
                        for r, _since, _ref in lst]
            self._replicas.clear()
            self._retiring.clear()
            self._migrations.clear()
            self._drain_map.clear()
        for r in victims:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                log_swallowed(logger, "replica kill at shutdown")
        return True

    # -- long poll (reference: long_poll.py LongPollHost) --------------------
    def get_snapshot(self, known_version: int = -1, timeout_s: float = 0.0):
        """Routing table snapshot; blocks up to timeout_s for a new version."""
        deadline = time.monotonic() + timeout_s
        while self._version == known_version and time.monotonic() < deadline:
            time.sleep(0.005)
        with self._lock:
            table = {}
            for name, t in self._targets.items():
                all_reps = self._replicas.get(name, [])
                fresh = [r for v, r in all_reps if v == t.version]
                ready = [r for r in fresh
                         if r.actor_id.hex() in self._ready]
                outgoing = [r for v, r in all_reps if v != t.version]
                # Rolling redeploy gate: NEW-version replicas join routing
                # only once they pass readiness, and the outgoing fleet
                # keeps serving ALONGSIDE them until it retires (reconcile
                # drains it once every fresh replica is ready) — shifting
                # 100% of traffic onto the first ready new replica would
                # overload it mid-rollout (the reference's rolling update
                # keeps both serving the same way,
                # serve/_private/deployment_state.py). On a first deploy
                # there is no outgoing version: route to the initializing
                # replicas so requests queue instead of 503ing.
                if outgoing:
                    reps = ready + outgoing
                else:
                    reps = ready or fresh
                table[name] = {
                    "replicas": reps,
                    "max_ongoing_requests": t.config.max_ongoing_requests,
                    "route_prefix": t.route_prefix,
                    # model-aware routing (pow_2_scheduler.py:127-135)
                    "model_ids": dict(self._model_ids.get(name, {})),
                    # KV-occupancy-aware routing + admission shedding:
                    # last-polled per-replica metrics (slots_busy,
                    # queue_depth, ...). Advisory — may lag the poll period.
                    "replica_load": dict(self._replica_load.get(name, {})),
                    # Per-tenant admission quotas (serve/admission.py);
                    # handles enforce them in front of the router.
                    "tenant_quotas": t.config.tenant_quotas,
                    # Drain-then-retire rewrites: victim actor key ->
                    # survivor actor key. Routers follow these to move a
                    # drained replica's prefix-affinity entries to the
                    # replica that imported its KV chains.
                    "migrations": dict(self._drain_map.get(name, {})),
                }
            return self._version, table

    # -- metrics / autoscaling ----------------------------------------------
    def record_autoscaling_metrics(self, deployment: str, ongoing: float) -> bool:
        """Handle-side ongoing-requests report (0.2s push cadence). Stores
        an EWMA so one quiet sample between bursts doesn't zero the scaling
        signal. This hook ONLY updates the signal — the scaling decision
        lives solely in the loop's ``_autoscale`` (one decision path; no
        per-report resize trigger)."""
        prev = self._metrics.get(deployment)
        self._metrics[deployment] = (
            float(ongoing) if prev is None else 0.5 * prev + 0.5 * ongoing)
        self._metrics_t[deployment] = time.monotonic()
        return True

    # -- reconcile loop ------------------------------------------------------
    def _loop(self):
        while self._running:
            try:
                self._autoscale()
                self._reconcile_once()
                self._model_poll_tick += 1
                if self._model_poll_tick % 10 == 0:
                    self._poll_multiplexed_ids()
            except Exception:  # noqa: BLE001 — loop must survive
                log_swallowed(logger, "controller reconcile tick")
            time.sleep(0.05)

    def _poll_multiplexed_ids(self):
        """Collect each replica's loaded model set AND load metrics in one
        ``get_state`` RPC (the reference pushes from replicas via
        record_multiplexed_model_ids; polling keeps the replica surface
        passive). A replica that doesn't answer in time — e.g. serially busy
        with a long inference — KEEPS its last-known entry: stale
        warm-routing info beats flapping the routers' tables exactly when
        the replica is loaded. Model-set changes bump the long-poll version;
        pure load changes do NOT (load flaps every poll — routers pick it up
        on their next periodic refresh instead of long-poll churn)."""
        with self._lock:
            replicas = {n: list(rs) for n, rs in self._replicas.items()}
        changed = False
        for name, pairs in replicas.items():
            with self._lock:
                table = dict(self._model_ids.get(name, {}))
            load: Dict[str, dict] = {}
            live_keys = set()
            for _v, replica in pairs:
                key = replica.actor_id.hex()
                live_keys.add(key)
                try:
                    state = ray_tpu_torch.get(
                        replica.get_state.remote(), timeout=0.5)
                except Exception as e:  # noqa: BLE001 — busy or mid-restart:
                    from ray_tpu_torch.core.exceptions import ActorError

                    if isinstance(e, ActorError):
                        self._dead.add(key)  # reconcile respawns it
                    continue       # keep the previous entry
                ids = state.get("model_ids") or []
                if ids:
                    table[key] = ids
                else:
                    table.pop(key, None)
                load[key] = state.get("metrics", {})
            table = {k: v for k, v in table.items() if k in live_keys}
            with self._lock:
                prev_load = self._replica_load.get(name, {})
                # Keep last-known load for replicas that didn't answer.
                kept = {k: v for k, v in prev_load.items()
                        if k in live_keys and k not in load}
                self._replica_load[name] = {**kept, **load}
                if self._model_ids.get(name) != table:
                    self._model_ids[name] = table
                    changed = True
        if changed:
            with self._lock:
                self._version += 1

    # Ongoing-EWMA reports older than this are treated as zero — a handle
    # process that died mid-burst must not pin the signal high forever.
    METRICS_STALE_S = 5.0

    def _autoscale(self):
        """ONE decision path for every scaling signal: delegate each
        deployment to its :class:`SLOPolicy` over a fused
        :class:`DeploymentSignals` snapshot (handle EWMA + replica-poll
        engine stats + TTFT rollup). Rate-limited per deployment by
        serve_autoscaling_interval_s — the 50ms reconcile tick is far
        faster than the signals refresh."""
        with self._lock:
            targets = list(self._targets.values())
        now = time.monotonic()
        interval = config().serve_autoscaling_interval_s
        for t in targets:
            asc = t.config.autoscaling_config
            if asc is None:
                self._policies.pop(t.name, None)
                continue
            if now - self._last_slo_eval.get(t.name, float("-inf")) < interval:
                continue
            self._last_slo_eval[t.name] = now
            policy = self._policies.get(t.name)
            if policy is None or policy.config is not asc:
                # New deployment or redeploy with a new config: fresh
                # policy (cooldown timers reset with the new targets).
                policy = SLOPolicy(asc)
                self._policies[t.name] = policy
            # With the KV tier on every downscale is a drain-by-migration:
            # one victim per decision so each gets a survivor to drain to.
            policy.drain_single_step = bool(config().kv_tier_enabled)
            sig = self._build_signals(t, asc, now)
            desired = policy.desired(t.target_replicas, sig, now)
            if desired > t.target_replicas and policy.ttft_violated(sig):
                # Latency SLO breached AND we're growing: reclaim capacity
                # from lower-priority gangs so the new replicas can place.
                self._gang_preemption.maybe_reclaim(
                    t.name, _replica_shape(t),
                    desired - t.target_replicas, now)
            if desired != t.target_replicas:
                logger.info(
                    "autoscale %s: %d -> %d (pressure=%.2f ttft_p99=%s)",
                    t.name, t.target_replicas, desired,
                    policy.pressure(sig), sig.ttft_p99_s)
                with self._lock:
                    t.target_replicas = desired

    def _build_signals(self, t: _DeploymentTarget, asc: AutoscalingConfig,
                       now: float) -> DeploymentSignals:
        """Fuse the per-replica ``get_state`` poll (engine queue/slot/KV
        stats) with the handle-side ongoing EWMA into one snapshot."""
        with self._lock:
            load = dict(self._replica_load.get(t.name, {}))
            replicas = len([r for v, r in self._replicas.get(t.name, [])
                            if v == t.version])
        ongoing = self._metrics.get(t.name, 0.0)
        if now - self._metrics_t.get(t.name, float("-inf")) \
                > self.METRICS_STALE_S:
            ongoing = 0.0
        queue = busy = total = kv_active = kv_total = polled_ongoing = 0.0
        for m in load.values():
            queue += float(m.get("queue_depth") or 0)
            busy += float(m.get("slots_busy") or 0)
            total += float(m.get("slots_total") or 0)
            active = float(m.get("kv_blocks_active") or 0)
            kv_active += active
            # Cached blocks are reclaimable; only active vs whole pool
            # counts as occupancy pressure.
            kv_total += (active + float(m.get("kv_blocks_cached") or 0)
                         + float(m.get("kv_blocks_free") or 0))
            polled_ongoing += float(m.get("ongoing") or 0)
        ttft = None
        if asc.ttft_p99_slo_s is not None:
            ttft = self._ttft.p99(t.name, now)
        return DeploymentSignals(
            replicas=max(1, replicas),
            # The replica poll also counts in-flight requests — take the
            # larger of the two views (handles may be gone; polls may lag).
            ongoing=max(ongoing, polled_ongoing),
            queue_depth=queue, slots_busy=busy, slots_total=total,
            kv_active=kv_active, kv_total=kv_total, ttft_p99_s=ttft)

    # How long a retiring replica may linger past the router-snapshot age
    # while finishing in-flight requests before it is force-killed.
    RETIRE_GRACE_MAX_S = 15.0
    # Minimum retirement age: at least one router snapshot refresh must
    # elapse so no router is still picking the retiree when it exits.
    RETIRE_MIN_S = 1.5

    def _reconcile_once(self):
        with self._reconcile_lock:
            self._reconcile_locked()

    def _reconcile_locked(self):
        with self._lock:
            targets = dict(self._targets)
        changed = False
        # scale up/down existing deployments — ROLLING on redeploy: the new
        # version spins up to full strength AND turns ready while the old
        # one keeps serving; old replicas then retire (unrouted, drained)
        # rather than being killed under live requests
        # (deployment_state.py's rolling update).
        # Readiness transitions re-publish the routing table: get_snapshot
        # gates new-version replicas on self._ready, so a replica turning
        # ready must bump the long-poll version or routers never pick it up.
        ready_before = set(self._ready)
        # Cull replicas observed dead (ActorError on a probe/poll): dropping
        # them from the fleet makes the scale-up loop below spawn
        # replacements — death during scale-up still converges to target.
        if self._dead:
            dead, self._dead = self._dead, set()
            for key in dead:
                flightrec.record("serve", key[:16], "replica dead")
            for name in list(self._replicas):
                kept = [(v, r) for v, r in self._replicas[name]
                        if r.actor_id.hex() not in dead]
                if len(kept) != len(self._replicas[name]):
                    self._replicas[name] = kept
                    changed = True
            self._ready -= dead
            for key in dead:
                self._ready_probes.pop(key, None)
        for name, t in targets.items():
            current = self._replicas.setdefault(name, [])
            fresh = [(v, r) for v, r in current if v == t.version]
            stale = [(v, r) for v, r in current if v != t.version]
            while len(fresh) < t.target_replicas:
                opts = dict(t.config.ray_actor_options)
                actor_opts: Dict[str, Any] = {}
                if "num_cpus" in opts:
                    actor_opts["num_cpus"] = opts.pop("num_cpus")
                # The card: num_gpus, or num_tpus as its alias (the
                # runtime's option table maps both to GPU).
                for key in ("num_gpus", "num_tpus"):
                    if key in opts:
                        actor_opts[key] = opts.pop(key)
                if "resources" in opts:
                    actor_opts["resources"] = opts.pop("resources")
                if t.config.max_concurrency > 1:
                    # Threaded replica: concurrent streams run inside one
                    # actor (continuous-batching engines need this).
                    actor_opts["max_concurrency"] = t.config.max_concurrency
                replica_cls = ray_tpu_torch.remote(ReplicaActor)
                replica = replica_cls.options(**actor_opts).remote(
                    name,
                    t.callable_or_class,
                    t.init_args,
                    t.init_kwargs,
                    t.config.user_config,
                )
                fresh.append((t.version, replica))
                changed = True
            while len(fresh) > t.target_replicas:
                _, victim = fresh.pop()
                self._retiring.setdefault(name, []).append(
                    (victim, time.monotonic(), None))
                changed = True
            # Probe readiness EVERY tick (not only mid-rollout): the
            # routing gate above needs self._ready populated for first
            # deploys and scale-ups too.
            fresh_all_ready = self._all_ready(r for _v, r in fresh)
            if stale and fresh_all_ready:
                # New version fully up AND ready (answered check_health):
                # stop routing to the old one (the snapshot lists
                # current-version replicas) and drain it. Until then the
                # old version keeps serving — no availability stall while
                # slow replica __init__s run.
                self._retiring.setdefault(name, []).extend(
                    (r, time.monotonic(), None) for _, r in stale)
                stale = []
                changed = True
            current[:] = fresh + stale
        # drop deleted deployments (their replicas drain too)
        for name in list(self._replicas):
            if name not in targets:
                self._retiring.setdefault(name, []).extend(
                    (r, time.monotonic(), None)
                    for _, r in self._replicas.pop(name))
                changed = True
        self._collect_retired()
        if changed or self._ready != ready_before:
            with self._lock:
                self._version += 1

    def _all_ready(self, replicas) -> bool:
        """Non-blocking readiness: fire one check_health per replica, then
        harvest on later ticks — the reconcile loop must never block on a
        slow replica __init__."""
        all_ready = True
        for r in replicas:
            key = r.actor_id.hex()
            if key in self._ready:
                continue
            ref = self._ready_probes.get(key)
            if ref is None:
                self._ready_probes[key] = r.check_health.remote()
                all_ready = False
                continue
            done, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
            if not done:
                all_ready = False
                continue
            self._ready_probes.pop(key, None)
            try:
                ray_tpu_torch.get(ref, timeout=1.0)
                self._ready.add(key)
            except Exception as e:  # noqa: BLE001 — probe again next tick
                from ray_tpu_torch.core.exceptions import ActorError

                if isinstance(e, ActorError):
                    self._dead.add(key)  # reconcile respawns it
                all_ready = False
        if len(self._ready) > 4096:  # dead replicas' entries
            self._ready.clear()
        return all_ready

    def _collect_retired(self):
        now = time.monotonic()
        for name in list(self._retiring):
            keep = []
            for replica, since, probe in self._retiring[name]:
                age = now - since
                done = age > self.RETIRE_GRACE_MAX_S
                if not done and age > self.RETIRE_MIN_S:
                    # Async drain probe: fire get_metrics, harvest next
                    # tick — never block the reconcile loop on a busy
                    # replica.
                    if probe is None:
                        probe = replica.get_metrics.remote()
                    else:
                        ready, _ = ray_tpu_torch.wait([probe], num_returns=1,
                                                timeout=0)
                        if ready:
                            try:
                                metrics = ray_tpu_torch.get(probe, timeout=1.0)
                                done = metrics.get("ongoing", 0) <= 0
                            except Exception:  # noqa: BLE001 — dead
                                done = True
                            probe = None
                if done:
                    # Drain-THEN-retire (cluster KV tier): the replica has
                    # finished its in-flight streams — before the kill,
                    # migrate its warm prefix chains (now including those
                    # streams' final turns) to a survivor and hold the
                    # kill until the migration resolves or times out.
                    done = self._migration_settled(name, replica, now)
                if done:
                    try:
                        ray_tpu_torch.kill(replica)
                    except Exception:  # noqa: BLE001 — already dead
                        log_swallowed(logger, "retired replica kill")
                else:
                    keep.append((replica, since, probe))
            if keep:
                self._retiring[name] = keep
            else:
                self._retiring.pop(name, None)

    def _migration_settled(self, name: str, replica, now: float) -> bool:
        """True when the drained replica's KV migration is complete (or the
        tier is off / no survivor exists / the drain timed out) — only then
        may the kill proceed. First call starts the migration."""
        try:
            if not bool(config().kv_tier_enabled):
                return True
        except Exception:  # noqa: BLE001 — config gone mid-teardown
            return True
        key = replica.actor_id.hex()
        mig = self._migrations.get(key)
        if mig is None:
            return not self._start_migration(name, replica)
        out_ref, in_ref, started = mig
        try:
            timeout = float(config().kv_tier_drain_timeout_s)
        except Exception:  # noqa: BLE001
            timeout = 10.0
        resolved, _ = ray_tpu_torch.wait([out_ref], num_returns=1, timeout=0)
        # +2s: the survivor's kv_migrate_in holds the lane open for the
        # same drain timeout — give the victim's send loop that long too.
        if not resolved and now - started <= timeout + 2.0:
            return False
        self._migrations.pop(key, None)
        for ref in (out_ref, in_ref):  # harvest so errors don't go unread
            try:
                n = ray_tpu_torch.get(ref, timeout=0.5)
                flightrec.record("serve", name, f"kv drain moved {n}")
            except Exception:  # noqa: BLE001 — victim died / timed out
                log_swallowed(logger, "kv drain migration result")
        return True

    def _start_migration(self, name: str, victim) -> bool:
        """Kick off victim -> survivor KV migration: survivor CREATES the
        lane (kv_migrate_in), victim attaches and ships (kv_migrate_out),
        and the routing snapshot learns the affinity rewrite. False when
        there is nothing to migrate to (last replica / none ready)."""
        vkey = victim.actor_id.hex()
        with self._lock:
            t = self._targets.get(name)
            if t is None:
                return False
            fresh = [r for v, r in self._replicas.get(name, [])
                     if v == t.version]
            ready = [r for r in fresh if r.actor_id.hex() in self._ready]
        candidates = [r for r in (ready or fresh)
                      if r.actor_id.hex() != vkey]
        if not candidates:
            return False
        survivor = candidates[0]
        skey = survivor.actor_id.hex()
        lane = f"kvdrain-{name}-{vkey[:12]}"
        try:
            in_ref = survivor.kv_migrate_in.remote(lane)
            out_ref = victim.kv_migrate_out.remote(lane)
        except Exception:  # noqa: BLE001 — either side already dead
            log_swallowed(logger, "kv drain migration start")
            return False
        self._migrations[vkey] = (out_ref, in_ref, time.monotonic())
        with self._lock:
            dm = self._drain_map.setdefault(name, {})
            dm[vkey] = skey
            while len(dm) > 64:  # bounded history; routers refresh fast
                dm.pop(next(iter(dm)))
            self._version += 1  # long-poll: routers must see the rewrite
        flightrec.record("serve", name,
                         f"kv drain {vkey[:12]} -> {skey[:12]}")
        return True


def get_or_create_controller():
    """Singleton via named DETACHED actor — the control plane, like the
    per-node proxy actors, outlives the process that created it
    (serve.shutdown() kills it)."""
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        cls = ray_tpu_torch.remote(ServeControllerActor)
        return cls.options(name=CONTROLLER_NAME, num_cpus=0,
                           lifetime="detached").remote()

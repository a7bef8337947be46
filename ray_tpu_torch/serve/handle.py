"""DeploymentHandle + Router — the request data plane.

The port's copy of ``ray_tpu/serve/handle.py``: the handle pulls the
replica set from the controller via long-poll snapshots, then routes each
call with power-of-two-choices over client-tracked ongoing counts (with the
replicas' reported KV-slot occupancy and prompt-prefix affinity on top),
respecting ``max_ongoing_requests`` (queueing locally when all replicas are
saturated). The controller is not on this path.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util import flightrec


class DeploymentResponse:
    """Future-like response (reference: ``serve/handle.py
    DeploymentResponse``).

    ``resubmit`` (router + call snapshot) lets ``result()`` transparently
    retry on a DIFFERENT replica when the chosen one died before answering
    (rolling redeploys, scale-downs, node loss) — the reference's router
    retries replica-unavailable the same way."""

    MAX_REPLICA_RETRIES = 3

    def __init__(self, ref, router: "Router", replica_key: str,
                 resubmit=None, trace=None, release=None):
        self._ref = ref
        self._router = router
        self._replica_key = replica_key
        self._resubmit = resubmit
        self._done = False
        # (parent_ctx, req_ctx, submit_wall_time) from the handle — the
        # serve.request root span closes when the response finishes.
        self._trace = trace
        # Idempotent tenant-quota release (serve/admission.py); retries
        # after a replica death run WITHOUT re-acquiring — a request the
        # tenant was already admitted for is never shed mid-flight.
        self._release = release

    @property
    def trace_id(self) -> Optional[str]:
        """Trace id of this request, or None when tracing didn't sample."""
        if self._trace and self._trace[1] is not None and self._trace[1][2]:
            return self._trace[1][0]
        return None

    def result(self, timeout_s: Optional[float] = None):
        from ray_tpu_torch.core.exceptions import ActorError

        attempts = 0
        while True:
            try:
                value = ray_tpu_torch.get(self._ref, timeout=timeout_s)
            except ActorError:
                self._finish()
                attempts += 1
                if self._resubmit is None or attempts > self.MAX_REPLICA_RETRIES:
                    raise
                self._ref, self._replica_key = self._resubmit()
                self._done = False
            except BaseException:
                # User exceptions / timeouts are NOT retried, but the
                # router's ongoing slot must still be released.
                self._finish()
                raise
            else:
                self._finish()
                return value

    def _finish(self):
        if not self._done:
            self._done = True
            self._router._dec(self._replica_key)
            if self._release is not None:
                self._release()
            _emit_request_span(self._trace, self._replica_key)

    @property
    def ref(self):
        return self._ref


def _emit_request_span(trace, replica_key: str) -> None:
    """Close the serve.request root span (submission → response finished)."""
    if trace is None:
        return
    from ray_tpu_torch.util import tracing

    parent_ctx, req_ctx, submit_t = trace
    if req_ctx is None or not req_ctx[2]:
        return
    # The span's own id was pre-allocated as req_ctx's span (children
    # already parented to it); its parent is the caller's span, if any.
    tracing.emit(
        "serve.request",
        (req_ctx[0], parent_ctx[1] if parent_ctx else None, req_ctx[2]),
        span_id=req_ctx[1],
        duration=max(0.0, time.time() - submit_t),
        attrs={"replica": replica_key})


class DeploymentResponseGenerator:
    def __init__(self, gen, router: "Router", replica_key: str, trace=None,
                 release=None):
        self._gen = gen
        self._router = router
        self._replica_key = replica_key
        self._done = False
        self._trace = trace
        self._release = release

    @property
    def trace_id(self) -> Optional[str]:
        """Trace id of this request, or None when tracing didn't sample."""
        if self._trace and self._trace[1] is not None and self._trace[1][2]:
            return self._trace[1][0]
        return None

    def __iter__(self):
        try:
            for ref in self._gen:
                yield ray_tpu_torch.get(ref)
        finally:
            if not self._done:
                self._done = True
                self._router._dec(self._replica_key)
                if self._release is not None:
                    self._release()
                _emit_request_span(self._trace, self._replica_key)


class Router:
    """Pow-2-choices with client-side ongoing tracking and prefix affinity."""

    SNAPSHOT_MAX_AGE_S = 1.0
    # Bound on the prefix-hash -> replica affinity map (LRU-evicted): enough
    # for every live conversation prefix without growing with total traffic.
    AFFINITY_CAP = 4096

    def __init__(self, controller, deployment_name: str):
        self._controller = controller
        self._name = deployment_name
        self._version = -1
        self._replicas: List[Any] = []
        self._max_ongoing = 100
        self._model_ids: Dict[str, list] = {}  # replica key -> loaded models
        # replica key -> controller-polled load metrics (slots_busy,
        # queue_depth, ...) — advisory, may lag by a poll period.
        self._replica_load: Dict[str, dict] = {}
        self._ongoing: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._last_refresh = 0.0
        self._refresh(block=True)

    def _affinity_map(self) -> Dict[bytes, str]:
        """Prefix-hash -> replica-key map, insertion-ordered (LRU via
        re-insert). Lazily created: unit tests build routers via __new__."""
        m = self.__dict__.get("_affinity")
        if m is None:
            m = self.__dict__["_affinity"] = {}
        return m

    def _admission(self):
        """Per-router tenant-quota ledger (serve/admission.py). Lazily
        created for the same reason as ``_affinity_map``."""
        adm = self.__dict__.get("_tenant_admission")
        if adm is None:
            from ray_tpu_torch.serve.admission import TenantAdmission

            adm = self.__dict__["_tenant_admission"] = TenantAdmission()
        return adm

    def acquire_tenant(self, tenant, deployment: str):
        """Admit one request for ``tenant`` against the deployment's quota
        table; returns the idempotent release callable (or None when no
        quota applies). Raises Saturated(reason="quota") when over."""
        return self._admission().acquire(tenant, deployment)

    # -- replica set maintenance --------------------------------------------
    def _refresh(self, block: bool = False) -> None:
        now = time.monotonic()
        if not block and now - self._last_refresh < self.SNAPSHOT_MAX_AGE_S:
            return
        deadline = time.monotonic() + 10.0
        while True:
            version, table = ray_tpu_torch.get(
                self._controller.get_snapshot.remote(self._version, 0.0)
            )
            entry = table.get(self._name)
            if entry and entry["replicas"]:
                with self._lock:
                    self._version = version
                    self._replicas = entry["replicas"]
                    self._max_ongoing = entry["max_ongoing_requests"]
                    self._model_ids = entry.get("model_ids", {})
                    # Evict state for replicas that left the snapshot: a
                    # stale load/ongoing entry (or affinity pin) would keep
                    # winning — or losing — the pow-2 pick for a replica
                    # that no longer exists.
                    live = {self._key(r) for r in entry["replicas"]}
                    self._replica_load = {
                        k: v
                        for k, v in entry.get("replica_load", {}).items()
                        if k in live}
                    for k in [k for k in self._ongoing if k not in live]:
                        del self._ongoing[k]
                    self._sweep_affinity_locked(
                        live, entry.get("migrations") or {})
                # Quota table rides the same snapshot: serve.run updates
                # apply to in-flight handles on their next refresh.
                self._admission().update(entry.get("tenant_quotas"))
                self._last_refresh = now
                return
            if not block or time.monotonic() > deadline:
                self._last_refresh = now
                return
            time.sleep(0.02)

    def _key(self, replica) -> str:
        return replica.actor_id.hex()

    def _sweep_affinity_locked(self, live: set,
                               migrations: Dict[str, str]) -> None:
        """Affinity entries for a replica that left the snapshot: a DRAINED
        replica's entries are REWRITTEN to its migration target (the
        survivor imported its KV chains, so the prefix is warm there),
        chain-following in case the target itself drained since; only
        entries with no live target are swept. Under ``_lock``."""
        aff = self._affinity_map()
        for h, k in list(aff.items()):
            if k in live:
                continue
            seen = set()
            while k in migrations and k not in live and k not in seen:
                seen.add(k)
                k = migrations[k]
            if k in live:
                aff[h] = k
            else:
                del aff[h]

    def _dec(self, key: str) -> None:
        with self._lock:
            if key in self._ongoing:
                self._ongoing[key] = max(0, self._ongoing[key] - 1)

    def _slots_exhausted(self, key: str) -> bool:
        """True when the replica REPORTS a full slot set (engines exporting
        slot occupancy via get_engine_stats). Unknown/plain replicas are
        never exhausted — routing degrades to pure pow-2 on ongoing."""
        load = self._replica_load.get(key)
        if not load:
            return False
        total = load.get("slots_total", 0)
        return total > 0 and load.get("slots_busy", 0) >= total

    def _all_shedding(self, replicas) -> bool:
        """Admission control: shed (fast Saturated) only when EVERY replica
        reports an admission queue at/over ``serve_admission_queue_limit`` —
        a replica with headroom, or one that doesn't report a queue at all
        (non-engine deployments), keeps the blocking-queue behavior."""
        from ray_tpu_torch.core.config import config

        try:
            limit = config().serve_admission_queue_limit
        except Exception:  # noqa: BLE001 — config unavailable mid-teardown
            return False
        if not limit or not replicas:
            return False
        for r in replicas:
            load = self._replica_load.get(self._key(r))
            if not load or load.get("queue_depth") is None:
                return False
            if load["queue_depth"] < limit:
                return False
        return True

    def _note_affinity(self, prefix_hash: bytes, key: str) -> None:
        """Record (under ``_lock``) that ``key`` now holds this prefix's KV
        blocks; re-insert for LRU order, evict oldest past AFFINITY_CAP."""
        aff = self._affinity_map()
        aff.pop(prefix_hash, None)
        aff[prefix_hash] = key
        while len(aff) > self.AFFINITY_CAP:
            del aff[next(iter(aff))]

    def _pick(self, model_id: str = "",
              prefix_hash: Optional[bytes] = None):
        """Pow-2: sample two replicas, choose the lower client-side queue —
        replicas reporting FREE KV slots beat replicas reporting a full slot
        set (occupancy-aware tie-break ahead of the ongoing count). With a
        ``model_id``, replicas that already hold the model are preferred
        (pow_2_scheduler.py:127-135) — cold replicas only load it when every
        warm one is saturated. A ``prefix_hash`` (leading prompt blocks,
        keyed exactly as the engines' KV block managers hash them) is
        layered ON TOP: the replica that last served this prefix still holds
        its KV blocks, so it wins outright unless it reports a full slot set
        or is at max_ongoing — then the pow-2 pick runs and INHERITS the
        affinity, migrating the prefix to the new replica. Blocks (with
        periodic refresh) while all candidates are saturated, unless every
        replica also reports an over-limit admission queue — then sheds with
        ``Saturated``."""
        from ray_tpu_torch.serve.errors import Saturated

        deadline = time.monotonic() + 60.0
        while True:
            self._refresh()
            with self._lock:
                replicas = list(self._replicas)
                warm_keys = {
                    k for k, ids in self._model_ids.items() if model_id in ids
                } if model_id else set()
                aff_key = (self._affinity_map().get(prefix_hash)
                           if prefix_hash is not None else None)
            if replicas:
                if self._all_shedding(replicas):
                    from ray_tpu_torch.core.metrics_export import observe_shed

                    observe_shed(self._name, "saturated")
                    raise Saturated(
                        f"deployment {self._name}: every replica's admission "
                        "queue is over serve_admission_queue_limit",
                        retry_after_s=self._retry_after_hint(replicas))
                if aff_key is not None and not self._slots_exhausted(aff_key):
                    pref = next((r for r in replicas
                                 if self._key(r) == aff_key), None)
                    if pref is not None:
                        with self._lock:
                            if self._ongoing.get(aff_key, 0) < \
                                    self._max_ongoing:
                                self._ongoing[aff_key] = \
                                    self._ongoing.get(aff_key, 0) + 1
                                self._note_affinity(prefix_hash, aff_key)
                                return pref, aff_key
                pool = replicas
                if model_id:
                    warm = [r for r in replicas if self._key(r) in warm_keys]
                    # Saturated warm replicas fall through to the full pool.
                    warm_free = [r for r in warm if self._ongoing.get(
                        self._key(r), 0) < self._max_ongoing]
                    if warm_free:
                        pool = warm_free
                if len(pool) == 1:
                    cands = [pool[0]]
                else:
                    cands = random.sample(pool, 2)
                cands.sort(key=lambda r: (
                    self._slots_exhausted(self._key(r)),
                    self._ongoing.get(self._key(r), 0)))
                best = cands[0]
                key = self._key(best)
                with self._lock:
                    if self._ongoing.get(key, 0) < self._max_ongoing:
                        self._ongoing[key] = self._ongoing.get(key, 0) + 1
                        if prefix_hash is not None:
                            self._note_affinity(prefix_hash, key)
                        return best, key
            if time.monotonic() > deadline:
                raise TimeoutError(f"no capacity on deployment {self._name}")
            time.sleep(0.002)

    def _retry_after_hint(self, replicas) -> Optional[float]:
        """Backoff hint for a saturated shed: how long the LEAST-loaded
        replica's admission queue likely needs to drain back under the
        limit, at serve_retry_after_item_s per queued item. Advisory."""
        from ray_tpu_torch.core.config import config

        try:
            cfg = config()
            limit = cfg.serve_admission_queue_limit
            item_s = cfg.serve_retry_after_item_s
        except Exception:  # noqa: BLE001 — config unavailable mid-teardown
            return None
        if not limit:
            return None
        depths = []
        for r in replicas:
            load = self._replica_load.get(self._key(r))
            if load and load.get("queue_depth") is not None:
                depths.append(load["queue_depth"])
        if not depths:
            return None
        return max(1, min(depths) - limit + 1) * item_s

    # -- metrics push (feeds autoscaling) ------------------------------------
    def total_ongoing(self) -> int:
        with self._lock:
            return sum(self._ongoing.values())


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller=None, method_name: str = "__call__"):
        from ray_tpu_torch.serve.controller import get_or_create_controller

        self._name = deployment_name
        self._controller = controller or get_or_create_controller()
        self._method = method_name
        self._router = Router(self._controller, deployment_name)
        self._stream = False
        self._metrics_thread = threading.Thread(target=self._push_metrics, daemon=True)
        self._metrics_thread.start()

    def options(self, *, method_name: Optional[str] = None, stream: bool = False,
                multiplexed_model_id: Optional[str] = None,
                tenant: Optional[str] = None) -> "DeploymentHandle":
        h = DeploymentHandle.__new__(DeploymentHandle)
        h._name = self._name
        h._controller = self._controller
        h._method = method_name or self._method
        h._router = self._router
        h._stream = stream
        # None = inherit; explicit "" clears a pinned model id.
        h._model_id = (multiplexed_model_id
                       if multiplexed_model_id is not None
                       else getattr(self, "_model_id", ""))
        # Tenant for per-tenant admission quotas; None = inherit, "" clears.
        h._tenant = (tenant if tenant is not None
                     else getattr(self, "_tenant", ""))
        h._metrics_thread = self._metrics_thread
        return h

    def _trace_root(self):
        """Stamp this request's trace frame: ``(parent_ctx, req_ctx)``.

        ``req_ctx`` carries the ``serve.request`` span id — installed as the
        ambient context around pick+submit so the router-pick span and the
        replica task parent to it — and the head-based sampling decision,
        made HERE when the handle call is the trace root (inherited when the
        caller already opened a span). (None, None) when tracing is off."""
        from ray_tpu_torch.util import tracing

        parent = tracing.current_context()
        root = parent if parent is not None else tracing.new_root_context()
        if root is None:
            return None, None
        return parent, tracing.child_context(root, tracing.new_span_id())

    def _emit_pick_span(self, req_ctx, key: str, elapsed_s: float) -> None:
        """Router-pick span: the chosen replica plus the occupancy snapshot
        the choice was made on (ongoing count, reported KV-slot load)."""
        from ray_tpu_torch.util import tracing

        attrs = {"replica": key, "deployment": self._name}
        router = self._router
        with router._lock:
            attrs["ongoing"] = router._ongoing.get(key, 0)
            load = router._replica_load.get(key)
        if load:
            for stat in ("slots_busy", "slots_total", "queue_depth"):
                if stat in load:
                    attrs[stat] = load[stat]
        tracing.emit("serve.router_pick", req_ctx, duration=elapsed_s,
                     attrs=attrs)

    @staticmethod
    def _affinity_hash(args) -> Optional[bytes]:
        """Block-aligned hash of the payload prompt's leading blocks — the
        same keying the engines' KV block managers use, so "the replica that
        holds this prefix" agrees with the cache byte-for-byte. None (no
        affinity) for non-LLM payloads, sub-block prompts, or when the knob
        is off."""
        if not args or not isinstance(args[0], dict):
            return None
        prompt = args[0].get("prompt_ids")
        if not prompt:
            return None
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.util.blockhash import prefix_head_hash

        try:
            cfg = config()
            if not cfg.serve_prefix_affinity_enabled:
                return None
            return prefix_head_hash(
                [int(t) for t in prompt],
                int(cfg.serve_kv_block_tokens),
                int(cfg.serve_prefix_affinity_blocks))
        except Exception:  # noqa: BLE001 — affinity is advisory, never fatal
            return None

    def _resolve_tenant(self, args) -> Optional[str]:
        """Tenant for quota accounting: ``options(tenant=...)`` wins, else a
        ``"tenant"`` key on a dict payload (the LLM request shape)."""
        tenant = getattr(self, "_tenant", "")
        if tenant:
            return tenant
        if args and isinstance(args[0], dict):
            t = args[0].get("tenant")
            if t:
                return str(t)
        return None

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.util import tracing
        from ray_tpu_torch.core.metrics_export import observe_shed
        from ray_tpu_torch.serve.errors import Saturated

        model_id = getattr(self, "_model_id", "")
        parent_ctx, req_ctx = self._trace_root()
        sampled = req_ctx is not None and req_ctx[2]
        submit_t = time.time()
        t0 = time.monotonic()
        prefix_hash = self._affinity_hash(args)
        # Tenant quota gate sits in FRONT of the router: an over-quota
        # tenant sheds here without consuming any replica queue slot.
        try:
            release = self._router.acquire_tenant(
                self._resolve_tenant(args), self._name)
        except Saturated:
            observe_shed(self._name, "quota")
            raise
        try:
            if req_ctx is not None:
                tracing.set_context(req_ctx)
            replica, key = self._router._pick(model_id, prefix_hash)
            flightrec.record(
                "serve", self._name[:32],
                f"admit -> {key[:12]}"
                + (f" trace={req_ctx[0]}" if req_ctx is not None else ""))
            if sampled:
                self._emit_pick_span(req_ctx, key, time.monotonic() - t0)
                kwargs["_trace_submit_ts"] = time.time()
            if model_id:
                kwargs["_multiplexed_model_id"] = model_id
            if self._stream:
                gen = replica.handle_request_streaming.options(
                    num_returns="streaming"
                ).remote(self._method, *args, **kwargs)
                return DeploymentResponseGenerator(
                    gen, self._router, key,
                    trace=(parent_ctx, req_ctx, submit_t),
                    release=release)
            ref = replica.handle_request.remote(self._method, *args, **kwargs)

            def resubmit(method=self._method, a=args, kw=kwargs,
                         mid=model_id, ph=prefix_hash):
                rep, k = self._router._pick(mid, ph)
                return rep.handle_request.remote(method, *a, **kw), k

            return DeploymentResponse(ref, self._router, key,
                                      resubmit=resubmit,
                                      trace=(parent_ctx, req_ctx, submit_t),
                                      release=release)
        except BaseException:
            # Pick/submit failed (saturated shed, timeout): the admission
            # was never handed to a response object — release it here.
            if release is not None:
                release()
            raise
        finally:
            if req_ctx is not None:
                tracing.set_context(parent_ctx)

    def _push_metrics(self):
        """Reference: ``replica.py:214 _push_autoscaling_metrics`` (pushed
        from the data plane on a timer)."""
        while True:
            time.sleep(0.2)
            try:
                self._controller.record_autoscaling_metrics.remote(
                    self._name, float(self._router.total_ongoing())
                )
            except Exception:
                return

"""Env-overridable configuration: the knobs the port's modules read.

Counterpart of ``ray_tpu/core/config.py`` cut to the knobs the ported
modules read. Each flag resolves from (1) the ``system_config`` dict given
to ``init()``, (2) the ``RAY_TPU_<NAME>`` environment variable, (3) its
default — the same names, order and defaults as the JAX package, so one
environment configures both alike. A knob this table does not declare is
refused by ``init(system_config=...)``, as the JAX table refuses it.

While a runtime is up, :func:`config` returns the table ``init()`` resolved
(as the JAX package's does); with none up it resolves a fresh one at each
call, so an engine built after an env change sees the change.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional


class _Flag:
    __slots__ = ("name", "default", "type")

    def __init__(self, default):
        self.default = default
        self.type = type(default)
        self.name = None  # filled by __set_name__

    def __set_name__(self, owner, name):
        self.name = name

    def resolve(self, overrides: dict):
        if self.name in overrides:
            return self._coerce(overrides[self.name])
        env = os.environ.get(f"RAY_TPU_{self.name.upper()}")
        if env is not None:
            return self._coerce(env)
        return self.default

    def _coerce(self, value):
        if self.type is bool:
            if isinstance(value, str):
                return value.lower() in ("1", "true", "yes", "on")
            return bool(value)
        try:
            return self.type(value)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"invalid value {value!r} for config flag '{self.name}': "
                f"expected {self.type.__name__} (set via the "
                f"RAY_TPU_{self.name.upper()} env var or the system_config "
                f"dict passed to init())") from e


class Config:
    """Resolved knobs; read them through :func:`config`."""

    # -- object store ---------------------------------------------------------
    # In-process object-store capacity in bytes: the heap budget past which
    # objects spill to disk, and the size of the shared-memory arena.
    object_store_memory = _Flag(2 * 1024 * 1024 * 1024)
    # Spill directory for objects evicted from the heap. "" (the default) =
    # ray_tpu_spill under the temporary directory (TMPDIR), resolved at the
    # first spill; the JAX package's default is /tmp/ray_tpu_spill.
    object_spilling_dir = _Flag("")
    # Put buffers of at least native_store_threshold bytes into the native
    # shared-memory arena (built with g++ at first use; heap bytes when the
    # build fails).
    use_native_store = _Flag(True)
    # Buffers at or above this size go to the native shm arena.
    native_store_threshold = _Flag(64 * 1024)
    # Entries kept in the store's deserialized-value cache (values of at
    # most 1 MiB; eviction is LRU).
    deser_cache_entries = _Flag(256)
    # Task-argument reads that run concurrently: a task with several ref
    # arguments materializes them on a pool of this many threads.
    get_fanout = _Flag(8)
    # Objects at or below this size ride inline in RPC replies instead of
    # the node's shared-memory store (the multiprocess cluster).
    max_inline_object_size = _Flag(100 * 1024)
    # GCS snapshots are mirrored to this many node daemons per tick, so a
    # fresh head can restore after losing its disk. 0 disables mirroring.
    gcs_snapshot_mirrors = _Flag(2)
    # Node-to-node transfer: objects above pull_chunk_size move as a
    # pipeline of chunk frames, at most pull_chunk_concurrency in flight,
    # with all in-flight pulled bytes capped by pull_memory_budget.
    pull_chunk_size = _Flag(8 * 1024 * 1024)
    # Remote fetches at or below this ride whole in one reply frame; above
    # it the chunked pull lands straight in the local arena and registers
    # this node as a new replica.
    whole_frame_fetch_max = _Flag(1 * 1024 * 1024)
    # Chunks of one pull in flight at once (the transfer pipeline depth).
    pull_chunk_concurrency = _Flag(4)
    # Total bytes of in-flight pulled chunks across all concurrent pulls.
    pull_memory_budget = _Flag(512 * 1024 * 1024)
    # Chunked pulls of objects at or above this size stripe their chunks
    # across every replica location at once.
    stripe_min_size = _Flag(16 * 1024 * 1024)
    # Waiters blocked in get() subscribe to the GCS object-location channel
    # and wake on seal instead of sleeping through a poll backoff.
    location_sub_enabled = _Flag(True)

    # -- scheduling -----------------------------------------------------------
    # Hybrid policy: below this utilization a node scores 0 (nodes tie and
    # the local one is preferred), above it the least loaded wins.
    scheduler_spread_threshold = _Flag(0.5)
    # Top-k fraction of the tied best nodes to pick among at random.
    scheduler_top_k_fraction = _Flag(0.2)
    # Seconds a leased worker stays bound to a scheduling key while idle
    # before it is returned to its node (multiprocess cluster).
    idle_lease_ttl_s = _Flag(1.0)
    # Most worker processes in one node daemon's pool.
    max_workers_per_node = _Flag(8)
    # Workers spawned into the idle pool at daemon start, capped by the
    # node's CPU count.
    prestart_workers_per_node = _Flag(4)
    # Atomic gang placement: multi-bundle PACK/STRICT_PACK placement groups
    # are planned as one all-or-nothing reservation over capacity blocks,
    # packed into one slice where one has room. 0 keeps the per-bundle
    # two-phase path.
    gang_scheduling_enabled = _Flag(True)
    # Node topology labels: "auto" honors daemon-supplied topo.pod /
    # topo.slice / topo.tier labels; "off" makes the gang planner
    # topology-blind.
    topology_labels = _Flag("auto")
    # Preemption classes: preempt_gangs may revoke placement groups of
    # strictly lower gang_priority. 0 disables preemption.
    gang_preemption_enabled = _Flag(True)
    # Simulated-cluster harness (core/sim_cluster.py): hosts per synthetic
    # slice when fabricating topology labels for stub daemons.
    sim_hosts_per_slice = _Flag(16)
    # Simulated-cluster harness: slices per synthetic pod.
    sim_slices_per_pod = _Flag(4)
    # Simulated-cluster harness: stub-daemon heartbeat period. Keep well
    # under health_check_period_s * health_check_failure_threshold or the
    # watchdog will declare sim nodes dead.
    sim_heartbeat_period_s = _Flag(0.5)
    # Memory monitor: above this node memory-usage fraction the daemon
    # kills the newest busy task worker. >= 1.0 disables it.
    memory_monitor_threshold = _Flag(0.95)
    # Seconds between memory-monitor sweeps.
    memory_monitor_period_s = _Flag(1.0)
    # Health-check period: seconds between node heartbeats.
    health_check_period_s = _Flag(1.0)
    # Missed heartbeats before a node is declared dead.
    health_check_failure_threshold = _Flag(5)
    # A node (or component) whose last report is older than this many
    # periods, but younger than the death bound, is classified stalled.
    health_stall_factor = _Flag(2.5)
    # Default task retries (max_retries when the caller gives none).
    default_max_retries = _Flag(3)
    # Streaming generators: items a producer may run ahead of its consumer
    # before it blocks.
    streaming_backpressure_items = _Flag(64)

    # -- control store --------------------------------------------------------
    # Lock domains of the GCS internal KV: keys hash-partition across this
    # many independent shards. 1 = one dict under one lock.
    gcs_shards = _Flag(8)
    # Batched leases: a submitter asks its node for up to lease_batch_max
    # workers in one RPC (a capacity block) instead of one at a time.
    lease_batch_enabled = _Flag(True)
    # Max leases requested in one capacity block (the batch amortization
    # ceiling; partial grants below this are normal).
    lease_batch_max = _Flag(16)
    # Bound on concurrent lease-request threads of one process.
    lease_requester_threads = _Flag(16)
    # The GCS takes task events and metric reports on a bounded queue,
    # drained by its own thread; past gcs_ingest_queue_max it drops (and
    # counts) the oldest.
    gcs_ingest_async_enabled = _Flag(True)
    # Staging-queue capacity of that ingest; overflow drops (and counts)
    # the oldest, never blocks.
    gcs_ingest_queue_max = _Flag(4096)

    # -- RPC ------------------------------------------------------------------
    # TCP connect timeout of every RpcClient.
    rpc_connect_timeout_s = _Flag(10.0)
    # An untimed get() logs a warning after waiting this long for a seal.
    get_timeout_warn_s = _Flag(30.0)
    # Frame-coalescing window in microseconds for non-urgent lone frames
    # on a hot connection; 0 (the default) never delays a frame.
    rpc_coalesce_window_us = _Flag(0.0)
    # Caps on one coalesced sendmsg batch: at most this many frames...
    rpc_max_batch_frames = _Flag(64)
    # ...and at most this many payload bytes (a single larger frame still
    # goes out alone — the cap bounds added latency, not frame size).
    rpc_max_batch_bytes = _Flag(1 * 1024 * 1024)
    # Entries kept in each process's task-spec template caches (encoder and
    # store); eviction only costs a re-send of the template.
    spec_cache_size = _Flag(4096)

    # KV-cache slots per continuous-batching engine: sequences that decode
    # together in one batched dispatch.
    serve_llm_slots = _Flag(4)
    # Prefill token budget per engine iteration (the first admission of a
    # step is always exempt, so the budget bounds batching, never progress).
    serve_llm_prefill_tokens = _Flag(128)
    # Admission-control shed threshold: past this many waiting requests,
    # submit raises Saturated. 0 disables shedding.
    serve_admission_queue_limit = _Flag(32)
    # Tokens per KV block in the paged pool.
    serve_kv_block_tokens = _Flag(16)
    # Engine selection for llm_deployment: 1 serves replicas on the paged
    # prefix-caching engine (PagedLLMEngine), 0 on the slotted LLMEngine.
    serve_kv_paged_enabled = _Flag(True)
    # Prefill/decode disaggregation: 1 builds each llm_deployment replica on
    # a DisaggregatedLLMEngine (a prefill engine feeding a decode engine
    # over a shm KV handoff lane); 0 keeps the colocated engine.
    serve_disaggregation_enabled = _Flag(False)
    # Router prefix affinity: 1 makes DeploymentHandle hash the prompt's
    # leading KV blocks and prefer the replica that served that prefix last
    # (its pool likely still caches those blocks).
    serve_prefix_affinity_enabled = _Flag(True)
    # Leading serve_kv_block_tokens-sized blocks of the prompt that feed the
    # affinity hash.
    serve_prefix_affinity_blocks = _Flag(4)
    # Blocks in the shared pool (block 0 is trash). 0 = auto: 2x a full slot
    # set at max_len, plus the trash block.
    serve_kv_pool_blocks = _Flag(0)
    # Paged-attention implementation: "auto" picks the CUDA kernel for a
    # CUDA pool and the plain version for a CPU pool; "cuda" / "plain" force
    # one of those (and must match the pool's device); "gather" runs the
    # table-gather + dense-mask formulation.
    serve_paged_attention_kernel = _Flag("auto")
    # Per-queued-request service-time estimate (seconds) behind the
    # Saturated.retry_after_s hint.
    serve_retry_after_item_s = _Flag(0.05)
    # Speculative decoding: draft tokens each slot proposes a step, verified
    # in ONE batched target forward. 0 disables it; > 0 needs a draft model
    # (PagedLLMEngine draft_params/draft_config). Greedy output stays
    # token-identical; sampled output keeps the target's distribution.
    serve_spec_tokens = _Flag(0)
    # Per-slot acceptance floor: a slot whose acceptance EWMA sinks below it
    # stops proposing for the rest of its request.
    serve_spec_accept_floor = _Flag(0.35)
    # EWMA factor of that acceptance rate (new = (1-a)*old + a*step_rate).
    serve_spec_accept_alpha = _Flag(0.3)
    # Cluster-wide KV tier (serve/kv_tier.py): 1 spills retired prefix
    # chains to the object plane as content-addressed payloads, publishes
    # them in the GCS prefix directory for cross-replica fetch, and turns
    # scale-down into drain-by-migration (the victim ships its warm chains
    # to a survivor over a KVHandoffLane before retiring). 0 (the default)
    # keeps KV engine-private and downscale sweep-only.
    kv_tier_enabled = _Flag(False)
    # Minimum FULL blocks a retired chain must hold before the engine
    # spills it to the store: shorter chains recompute faster than they
    # fetch, so publishing them only churns the directory.
    kv_tier_min_spill_blocks = _Flag(1)
    # Prefix-directory capacity (entries, cluster-wide). Publishing past
    # the cap evicts the least-recently-matched entries and frees their
    # spilled objects.
    kv_tier_dir_max_entries = _Flag(4096)
    # Prefix-directory entry TTL (seconds) since the last publish or match;
    # expired entries are swept on directory mutations and their objects
    # freed. <= 0 disables the TTL (the capacity still holds).
    kv_tier_dir_ttl_s = _Flag(600.0)
    # Upper bound (seconds) the serve controller waits for a drain
    # migration (victim kv_migrate_out + survivor kv_migrate_in) before it
    # retires the victim anyway; the store tier catches anything unshipped.
    kv_tier_drain_timeout_s = _Flag(10.0)
    # Minimum seconds between SLO-autoscaler evaluations per deployment:
    # the controller ticks at 50 ms, but its signals refresh more slowly.
    serve_autoscaling_interval_s = _Flag(0.25)
    # Minimum seconds between reads of the cluster TTFT histogram for the
    # p99 override (one read per deployment).
    serve_slo_rollup_interval_s = _Flag(1.0)

    # -- rllib ----------------------------------------------------------------
    # Rollout transport of IMPALA/APPO: 1 parks the env runners in a
    # compiled-DAG rollout lane (rllib/rollout_lanes.py), fragments fanning
    # in over multi-slot shm channels with deferred acks, so a slow learner
    # backpressures the runners instead of dropping work. 0 keeps the
    # per-fragment task path (ray_tpu_torch.wait + an ObjectRef hop).
    rollout_lanes_enabled = _Flag(True)
    # The JAX package's InferenceActor flush quorum and wait window, kept
    # with its names and defaults so one configuration serves both
    # packages. The port reads neither: its InferenceActor
    # (rllib/inference.py) fuses no requests, since a fused CPU forward
    # would break bit-identity with runner-local sampling, so it runs each
    # request on arrival and waits for nothing.
    rl_inference_max_batch = _Flag(0)
    # JAX's flush window for a partial inference batch, in seconds (unread
    # here, as above).
    rl_inference_window_s = _Flag(0.001)

    # -- timeouts -------------------------------------------------------------
    # Wait budget of internal loops that re-check a predicate; a blocked
    # channel endpoint is recorded as stalled after a quarter of it.
    internal_wait_timeout_s = _Flag(60.0)

    # -- eager collectives ----------------------------------------------------
    # Two-level collectives: ranks sharing a node store reduce through shm
    # at a node leader, leaders run the inter-node ring, results fan back
    # out by shm key. 0 restores the flat topology-blind ring everywhere.
    collective_hierarchy_enabled = _Flag(True)
    # Segment size (bytes) of the pipelined inter-node ring: segment k's
    # reduction overlaps segment k+1's transfer.
    collective_segment_size = _Flag(1 * 1024 * 1024)
    # Timeout of every blocking collective step (mailbox take, ring recv,
    # p2p recv without an explicit timeout).
    collective_timeout_s = _Flag(120.0)

    # -- channels and compiled DAGs -------------------------------------------
    # Ring depth of an shm channel: values in flight on one edge before the
    # writer blocks on the reader's ack (1 = strict lock-step).
    dag_channel_slots = _Flag(8)
    # Busy-spin iterations before a blocked channel endpoint sleep-polls.
    dag_channel_tight_spins = _Flag(0)
    # Sleep-poll granularity (microseconds) of a blocked channel endpoint;
    # backs off exponentially to 40x this while idle.
    dag_channel_spin_us = _Flag(50.0)
    # Credit window of a cross-host SocketChannel edge: frames the writer
    # may send ahead of the reader's acks (1 = per-frame lock-step).
    dag_socket_window = _Flag(8)
    # Bound on CompiledDAG.teardown's drain: how long the stage loops get to
    # see the close pill and detach before the driver unlinks the channels.
    dag_teardown_timeout_s = _Flag(10.0)

    # -- observability --------------------------------------------------------
    # Gate of every built-in metric observation (off = one flag check).
    metrics_export_enabled = _Flag(True)
    # Request tracing master gate: off, every potential span costs one flag
    # check; on, head-based sampling below decides per trace at its root.
    trace_enabled = _Flag(True)
    # Head-based sampling probability in [0, 1], decided once at a trace
    # root and carried in the context.
    trace_sample_rate = _Flag(1.0)
    # RPC-level spans (client call, server handle) under a sampled trace.
    trace_rpc_enabled = _Flag(False)
    # Per-process flight recorder (util.flightrec): a bounded mmap'd event
    # ring under the session dir. Off = every record site costs one check.
    flightrec_enabled = _Flag(True)
    # Flight-recorder ring size per process, KiB (128-byte slots).
    flightrec_ring_kb = _Flag(256)
    # Seconds between the runtime's metrics-exporter ticks (read every
    # tick).
    metrics_export_interval_s = _Flag(10.0)
    # Bound on the GCS trace_id -> event-index side table; the oldest
    # traces are evicted first.
    trace_max_traces = _Flag(2048)

    # -- debugging ------------------------------------------------------------
    # Opt-in runtime lock-order validator (ray_tpu_torch.devtools.lockcheck):
    # threading.Lock/RLock/Condition are replaced with instrumented wrappers
    # that track per-thread held-sets, maintain a global acquisition-order
    # graph, and raise LockOrderError on an inversion. Dev/test only — adds
    # per-acquire bookkeeping to every lock in the process.
    lock_order_check_enabled = _Flag(False)
    # Opt-in runtime leak validator (ray_tpu_torch.devtools.leakcheck):
    # threads, os.open/os.pipe fds and sockets are stamped with their
    # allocation site; a caller snapshots live threads/fds/shm segments
    # before its work and names what survives its teardown. Dev/test only.
    leak_check_enabled = _Flag(False)
    # Opt-in steady-state guard (ray_tpu_torch.devtools.jitcheck): inside
    # jitcheck.steady_state() — entered by the serve engines after warmup —
    # an implicit device->host read of a tensor or a kernel library built
    # after warmup is recorded as a contract violation. Dev/test only.
    jit_check_enabled = _Flag(False)

    def __init__(self, system_config: Optional[dict] = None):
        overrides = dict(system_config or {})
        flags = {n: f for n, f in vars(type(self)).items()
                 if isinstance(f, _Flag)}
        unknown = set(overrides) - set(flags)
        if unknown:
            raise ValueError(f"Unknown system_config keys: {sorted(unknown)}")
        for name, flag in flags.items():
            setattr(self, name, flag.resolve(overrides))

    def to_dict(self) -> dict[str, Any]:
        return {n: getattr(self, n) for n, f in vars(type(self)).items()
                if isinstance(f, _Flag)}


_global: Optional[Config] = None
_lock = threading.Lock()


def config() -> Config:
    """The runtime's table while one is up, else the knobs as the
    environment sets them now."""
    cfg = _global
    return cfg if cfg is not None else Config()


def set_config(cfg: Optional[Config]) -> None:
    """Install ``cfg`` as the table :func:`config` returns (``init`` does;
    ``None`` goes back to resolving at each call)."""
    global _global
    with _lock:
        _global = cfg

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches an error and goes on):

1. device — the card's name and power limit (``nvidia-smi``), the torch
   device name and count, the size and free space of /dev/shm; no CUDA
   device is a failure;
2. build — every kernel under ``ray_tpu_torch/ops/csrc`` from the checkout's
   sources, one ``nvcc`` per source, all started together; prints the
   ``-Xptxas -v`` lines (registers, shared memory, spills); a spill in a
   tensor-core kernel (``*_mma_kernel``, ``*_wgmma_kernel``) is a failure;
3. kernels — each kernel's wrapper against its plain PyTorch version at the
   main paths' shapes, in bf16 and f32, with its time, the plain version's
   time, one library call's time (a yardstick only) and the bound, each
   with its route, TFLOP/s, and times over the bound and the library call:
   the paged-attention kernels at the engine's shapes (bf16 prefill on
   wgmma; decode, and every f32 call, split over the context on the CUDA
   cores; NaN in the trash block must leave every output bit for bit;
   both routes timed at T in {2, 4, 5, 8, 9, 16}, the threshold's
   measurement), the three flash-attention kernels at the train step's
   (B=16, L=1024, H=12, D=64, causal; bf16 K1 and K2 on wgmma, bf16 K3 on
   mma.sync, f32 on the CUDA cores), and K2 + K3 against SDPA's whole
   backward; there the bf16 tensor-core kernels' errors (o, dq, dk, dv)
   must stay within twice those of torch's SDPA against the same plain
   versions; the MLP epilogue's kernel pair (``csrc/bias_gelu.cu``) at
   GPT-2 XL's [16384, 6400] and medium's [16384, 4096] activations and at
   ragged shapes, against its plain versions (within one bf16 rounding of
   the f32 expression), timed beside the eager chain it replaces and
   ``F.gelu(approximate="tanh")``. Times are
   device times: the card sleeps before each timed call until the host
   has queued it (see ``Timer``);
4. engine — ``PagedLLMEngine`` on ``gpt2_small()`` at full width (bf16,
   random weights from a seed) answers 8 requests from concurrent threads,
   with a shared-prefix hit and a copy-on-write tail fork; the kernels'
   launch counts (K4's also by route) are set to 0 just before and read
   just after; then a short decode window runs under torch.profiler
   (device busy and idle share, time by kernel);
5. end to end — the same greedy requests through the kernel path and
   through the plain (gather) path, at gpt2_small widths with 2 layers in
   f32, must give the same tokens; then the bf16 prefill forward (prompts
   of 150 and 900 tokens) through the wgmma K4 and through gather, each
   held to an f32 gather run: the kernel within twice gather-bf16's error
   plus one bf16 step;
6. train — ``bench.py``'s configuration: ``gpt2_small(max_seq_len=1024,
   remat=True)``, 16 × 1024 tokens a step, AdamW(3e-4, weight_decay=0.1),
   3 warm-up and 10 timed steps with the launch counts set to 0 just
   before and read just after (per step: the flash forward 2 × n_layers,
   forward plus the remat recompute, dq and dkv n_layers each, and the
   bias-GELU forward 2 × n_layers and backward n_layers); a finite,
   falling loss; tokens/s, step time, peak memory; then one step under
   torch.profiler;
7. train end to end — gpt2_small widths with 2 layers, f32, B=2, L=1024:
   the flash kernels and ``attn_impl="dense"`` give the same loss and
   gradients, then the same losses over 3 AdamW steps; then both in bf16
   compute (where K1 and K3 run on the tensor cores), each held to the f32
   dense run: the flash errors in loss and gradients within twice dense
   bf16's plus one bf16 step (K1-K3 all run on the tensor cores there);
8. slotted engine — ``LLMEngine`` (the slotted cache, attended without the
   paged kernel) on ``gpt2_small()`` at full width, bf16, answers phase 4's
   8 requests: decode tokens/s and TTFT beside phase 4's paged figures;
   ``device_metrics()`` of both engines; then at gpt2_small widths with 2
   layers in f32 the slotted engine, the paged engine on the kernel and
   ``Generator`` (the single-sequence oracle) give the same greedy tokens;
9. speculative decoding — ``PagedLLMEngine`` on ``gpt2_small()`` at full
   width, bf16, with three drafts (the target itself; the target + 0.05 x
   an independent init; an independent 6-layer init) at k = 3 (the T = 4
   verify on the split K4) and k = 4 (T = 5, on the wgmma K4): the counts
   set to 0 just before each run and read just after must equal what the
   engine's prefill, decode, verify and draft forwards imply, per layer
   and by route; blocks drain; the aligned draft accepts >= 90 %; decode
   tokens/s and the accept ratio beside the plain engine's on the same
   requests (8 for aligned, 4 for the others); then at 2 layers in f32
   every draft at k = 3 and 4 gives the plain engine's greedy tokens;
10. disaggregated — ``DisaggregatedLLMEngine`` (a prefill engine feeding a
   decode engine over the shm KV handoff lane, in one process) on
   ``gpt2_small()`` at full width, bf16, answers phase 4's 8 requests from
   concurrent threads after a check that its lane fits in /dev/shm: K4's
   launches, set to 0 just before and read just after, must be n_layers x
   the prefill engine's prefills on the wgmma route and n_layers x the
   decode engine's steps on the split route (the decode engine never
   prefills); blocks drain on both engines; after ``close()`` no worker
   thread and no lane file is left; decode tokens/s and TTFT beside phase
   4's; then the handoff of one 1024-token prompt alone (gather, send into
   the slot, recv, insert with its synchronise) beside pinned copies of the
   same bytes; then at 2 layers in f32 disaggregated, colocated
   paged-on-kernel and ``Generator`` greedy streams are equal, each
   disaggregated request's spans are one admission wait, one prefill and
   one decode chunk per step, and ``serve_tokens_total`` counts the tokens
   delivered;
11. runtime — the in-process core runtime: ``ray_tpu_torch.init()`` with no
   arguments must register the card (``GPU`` and a ``GPU-<model>`` marker,
   no ``TPU``) and build its shared-memory arena; a ``num_gpus=1,
   max_concurrency=8`` actor hosts phase 4's engine (``gpt2_small`` at full
   width, bf16, the same seed) and answers phase 4's 8 requests as
   streaming ``.remote()`` calls from concurrent threads, its threads the
   engine's request threads: K4's launches, set to 0 just before and read
   from the actor just after, must be n_layers x its prefills on the wgmma
   route and n_layers x its decode steps on the split route; blocks drain;
   decode tokens/s and TTFT beside phase 4's and the mean round trip of a
   no-op actor method; ``serve_tokens_total``, shipped by the runtime's
   exporter into its GCS aggregator, must equal the tokens delivered; a
   second ``num_gpus=1`` actor must stay pending while the first holds the
   card and come up after ``kill``, and at 2 layers in f32 its greedy
   streams must equal a direct engine's on the kernel and ``Generator``'s;
   ``num_gpus=2`` work must be infeasible; a ``num_gpus=1`` task returns
   phase 10's 1024-token K/V gather (bf16, on the card) and ``get`` must
   give the same bytes back as CPU tensors, through the arena, with
   ``put``/``get`` timed beside a pinned ``copy_``; a placement group
   ``[{GPU: 1, CPU: 1}]`` must become ready and host an engine actor; the
   steady-state guard must record no violation in any warm step; after
   ``shutdown()`` no actor or exporter thread and no arena of the process
   is left;
12. serve — the Serve stack on the card: ``init()``, then
   ``serve.run(llm_deployment(gpt2_small(), ...))`` at full width (bf16,
   phase 4's weights from its seed, engine defaults) with
   ``ray_actor_options={"num_gpus": 1}``; the replica's engine must be the
   ``PagedLLMEngine`` on the card with the CUDA kernel, holding the card;
   phase 4's 8 requests as concurrent streaming handle calls keep the
   deployment's contract (contiguous ``index``, ``finish_reason`` and
   ``ttft_s`` on the last item) and K4's launches, set to 0 just before
   and read just after, must be n_layers x the replica's prefills (wgmma)
   and decode steps (split) from ``get_engine_stats``; blocks drain; then
   two ``num_gpus=0.5`` replicas (8 slots each) on the one card answer
   phase 4's requests twice over (16): both replicas serve, the two
   requests sharing a 256-token prefix land on one replica (prefix
   affinity) whose prefix hits rise, K4's launches equal the sum over both
   replicas, and a third ``num_gpus=0.5`` replica asked for on top stays
   pending and is never built; at 2 layers in f32 the greedy streams
   through a deployment equal a direct engine's on the kernel and
   ``Generator``'s, and, where aiohttp imports, one streamed request over
   the HTTP ingress gives the handle's tokens (whether grpcio imports is
   printed); a no-op deployment's round trip through its handle is timed
   beside phase 11's no-op actor call; a replica whose constructor fails
   fails the run with its own error; after ``serve.shutdown()`` and
   ``shutdown()`` no replica, controller or proxy thread, no arena and no
   listening socket is left.

13. cluster — the multi-process cluster on the card: after a check that two
   node arenas (``object_store_memory``, 2 GiB each; a cut is printed)
   fit in /dev/shm, ``Cluster`` starts a GCS process and two node daemons
   (``python -m ray_tpu_torch.core.*``): node A ``{CPU: 8, GPU: 1}``, node
   B ``{CPU: 4}``; ``init(address=...)`` must see ``GPU`` 1 and no
   ``TPU``. Phase 4's engine (``gpt2_small``, full width, bf16, its seed)
   in a ``num_gpus=1, max_concurrency=8`` actor in a worker process answers
   phase 4's 8 requests as streaming calls: the engine, reported from the
   worker, is the ``PagedLLMEngine`` on the card with the CUDA kernel; K4's
   launches, set to 0 and read in the worker, are n_layers x its prefills
   (wgmma) and decode steps (split), and the driver's own counters stay 0;
   blocks drain; decode tokens/s, TTFT and a no-op call's round trip
   beside phase 11's. A second ``num_gpus=1`` actor pends; SIGKILL of the
   engine actor's process: its next call raises ``ActorDiedError``, its
   card memory is back within 10 s (``nvidia-smi`` where it lists this
   process's pid, else the card's free memory less this process's own),
   and the pending actor comes up; through it, at 2 layers in f32, the
   greedy streams equal a direct engine's on the kernel and
   ``Generator``'s. A ``num_gpus=1`` task on node A returns phase 10's
   1024-token K/V gather: ``get`` in the driver and in a task pinned to
   node B (the chunked pull of ``core/object_transfer.py``) give the
   worker's bytes (sha256), the pull and ``put``/``get`` timed beside
   phase 11's. ``serve.run(llm_deployment(gpt2_small, ...))`` on the
   cluster (the controller and replicas in worker processes; the
   deployment's class gains reads of its own process's counters): one
   ``num_gpus=1`` replica on phase 4's requests, then two ``num_gpus=0.5``
   replicas of 8 slots in two processes on the requests twice over — both
   serve, the prefix pair lands on one, each replica's K4 launches, read in
   its own process, equal n_layers x its own forwards, a third half-card
   replica waits as a ``{GPU: 0.5}`` demand and is never built; decode
   tokens/s, tokens over wall, TTFT and ms of wall a forward beside phase
   12's. After ``serve.shutdown()``, ``shutdown()`` and
   ``cluster.shutdown()`` no GCS, daemon or worker process of the phase is
   alive, no ``raytpu-*`` arena of theirs is left, and no other process
   holds the card.
14. KV tier — on phase 13's cluster, after its measured runs and before
   its teardown: two ``num_gpus=0.5`` engine actors (phase 4's engine,
   ``block_tokens=16``, ``max_len=1024``) with
   ``RAY_TPU_KV_TIER_ENABLED=1`` in their ``runtime_env`` alone, started
   together. P serves a 1008-token prompt and 16 greedy tokens and spills
   its 1024-token chain: 64 blocks, 37,748,736 bytes of bf16 K/V in the
   object store, the entries in the GCS prefix directory; the spilling
   step's wall time beside the median step; the payload's same-node
   ``get`` and its pull to node B (sha256 equal to P's). F serves the same
   prompt cold: a 992-token store hit (the probe's cap) whose K4 prefill
   runs at T = 16; its TTFT beside a fresh prefill's (F's local cache and
   the chain's directory entries cleared), the fetch and the insert timed
   in F, and the pull plus the insert printed as the hit's cost across
   nodes. A drain migration P -> F over a named ``KVHandoffLane``; F's next
   turn on P's session hits migrated tokens. P is killed: F's fetch of a
   chain only P published misses and drops its entry (the directory loses
   one). K4's launches by route, read in each actor's process, equal
   n_layers x its prefills and decode steps.

15. mesh — after phase 7, on the one card: ``make_mesh(MeshSpec(data=-1))``
   starts a world-1 NCCL group itself and gives the six-axis mesh; phase
   6's train step through the sharded ``make_train_step`` (parameters and
   AdamW moments DTensors on the card, the batch placed on ``batch``),
   once with ``remat_policy="full"`` and once with ``"dots"``: 3 warm-up
   steps whose losses equal phase 6's within 1e-3 relative, then 10 timed
   steps with the counts set to 0 just before and read just after (flash
   2n / n / n a step under both policies), a finite, falling loss, step
   time, tokens/s and peak memory beside phase 6's, one profiled step;
   ring attention at seq=1 (f32, B=2, L=1024) equal to
   ``reference_attention``; a gpt2_small-width Switch FFN (d 768, d_ff
   3072, 8 experts, 16 x 1024 tokens, f32) on the mesh equal to the plain
   forward, then 3 AdamW steps with a falling loss; ``entry()``'s forward.
   The group is destroyed before phase 8.
16. compiled DAG — on phase 13's cluster, after phase 14 and before the
   teardown; the phase's worker start-up is printed apart from its
   measured work. 16a: two ``num_gpus=0.25`` actors on node A form a
   compiled DAG over device channels (``channel_type="device"``, 2 slots,
   after a check that their rings fit in /dev/shm): stage A holds four
   1024-token K/V gathers of phase 4's engine (``gpt2_small``, bf16, its
   seed; 37,748,736 bytes each) and returns the one each tick's index
   picks; stage B must receive a CUDA bf16 tensor on its own device, its
   sha256 equal to A's (4 ticks one at a time, 16 as a burst); 16 ticks
   one at a time and 16 as a burst are timed (ms a tick, GB/s) beside
   phase 13's ``put``/``get`` and pull of the same bytes. Two CPU stages,
   one a node, carry a 4 KiB payload over socket edges, then over
   ``channel_type="auto"``, which must pick shm for every edge (one
   host): round trips beside phase 13's no-op actor call. 16c: a ``gloo``
   group of 4 ranks (2 on node A holding CUDA tensors, 2 on node B
   holding CPU tensors: the hierarchical schedule) allreduces a 25 MiB
   f32 bucket (sum, mean) against a torch f32 oracle at rtol 1e-6, timed
   (ms, algorithm bandwidth); ``backend="device"`` in 4 rank threads of
   this process on CUDA tensors: every result on the card, equal to the
   torch sum. 16b: ``serve.run_pipeline([Pre, Model, Post])``, ``Model``
   a ``num_gpus=1`` deployment running phase 4's engine (engine
   defaults, the CUDA kernel): phase 4's 6 greedy requests one at a time
   through ``compiled=False``, then through compiled lanes built over the
   same replicas (one cold ``num_gpus=1`` replica), one at a time and as
   a burst, must give the same tokens; K4's launches by route, set to 0
   and read in the replica's process, equal n_layers x its prefills and
   decode steps; the replica's ongoing and total counts hold; the
   ``ray_tpu_dag_tick_s`` histogram reaches ``gcs.metrics_summary()``; a
   3-stage no-op pipeline's round trip, compiled against sequential.
   16c runs before 16b: its card ranks start with 16a's actors, and 16b's
   replica takes the whole card.
17. Train and Tune — after phase 16, at ``bench.py``'s configuration
   (phase 6's: ``gpt2_small(max_seq_len=1024, remat=True)``, bf16 compute,
   f32 parameters, its seed and batch), in a directory of the phase's own
   under ``build/`` (run storage, checkpoints, TMPDIR) that must have room
   for 4 full checkpoints (else a ``CUT:`` line and a 2-layer model in
   17b), removed at the end. 17b, last on phase 13's cluster:
   ``TorchTrainer`` with ``TorchConfig(init_distributed=True)`` and one
   ``use_gpu`` worker process: a world-1 NCCL group, phase 15's sharded
   step (remat "full") on a mesh over it, a checkpoint every 2 steps; the
   worker ``os._exit``s once at step 5 and ``FailureConfig(max_failures=1)``
   restarts the group in a new process, which re-forms the group and
   resumes from the last checkpoint: no report goes back to step 0, every
   step's loss in both incarnations within 1e-3 of phase 6's (and of
   17a's), flash 2n / n / n a step read in the worker, the ``GPU`` grant
   back after ``fit()``; each incarnation's start-up, NCCL init and step
   time beside phase 15's. Then, on the in-process runtime, 17a:
   ``TorchTrainer`` with one ``use_gpu`` worker and no process group, 3 +
   10 steps reported with their losses (within 1e-3 of phase 6's), times
   and K1-K3 launches (exactly 2n / n / n a step), one checkpoint (params,
   the AdamW state as optax's tree, the step) through ``report``;
   ``result.checkpoint`` restored into a fresh bundle steps to the
   uninterrupted run's next loss; tokens/s and step time beside phase 6's,
   ``report()``'s cost and a report round's, the checkpoint's bytes, save,
   snapshot, the manager's copy and the restore. 17c: ``Tuner`` over a
   function trainable, 4 trials on a learning-rate grid with ``{"CPU": 1,
   "GPU": 0.5}`` each and ``ASHAScheduler(max_t=8, grace_period=2,
   reduction_factor=2)``, one step of gpt2_small at B=4, L=1024 an
   iteration: every trial ends, at most 2 at once, ASHA stops one at a
   rung at least and every decision it made is its rule's on the reported
   losses, ``get_best_result()`` is the lowest final loss, and K1-K3's
   launches are 2n / n / n x the iterations run.
18. Data and RLlib — which of pyarrow, gymnasium and pandas import here;
   a leg whose package is absent prints so and does not run. 18a, on the
   in-process runtime after phase 17: 4,096 rows of 1,024 int32 tokens
   below GPT-2's vocab (16 MiB, from the seed) in 16 parquet files under
   ``build/phase18/`` through ``read_parquet`` → ``map_batches`` (the
   tokens column) → ``random_shuffle(seed=0)`` →
   ``streaming_split(1, equal=True)`` → ``iter_torch_batches(batch_size=16,
   dtypes={"tokens": torch.int64})`` onto the card (its default device):
   rows/s, GB/s to the card, the host batch and the pin + copy a batch,
   the wait in ``next()`` (median, max); every row reaches the card once
   (a digest a row, read back). 18c, last on phase 13's cluster: the same
   pipeline with its read and map tasks pinned to node B's CPU workers
   (``ray_remote_args``), the split iterated onto the card by this process
   on node A, the same gate. 18b: 17a's in-process ``TorchTrainer`` at
   phase 6's configuration, each of its 3 + 10 steps' batches taken from
   a ``StreamSplitDataIterator`` passed in ``train_loop_config`` (the
   corpus: phase 6's batch 13 times, 16 rows a file): every batch phase
   6's, int64 on the card before its step, K1-K3 2n / n / n a step, every
   loss phase 6's bit for bit; step time and tokens/s beside 17a's and
   phase 6's, the wait on the iterator a step. 18d: the Nature-CNN PPO
   learner (1.69 M parameters, 14.45 M by the device policy's count, so
   ``"auto"`` puts it on the card; without one the policy raises) over 3
   iterations' minibatches of 64, then one update on the card from a CPU
   learner's parameters against the same update on the CPU, TF32 off,
   within 1e-4 a leaf; where gymnasium
   imports, ``PPOConfig().environment(SyntheticAtariEnv)`` with 2 env
   runners of 2 envs, fragments of 64, one epoch, minibatches of 64, 3
   iterations: env steps/s, the learner's update time, its device, finite
   losses.
19. RL — on the in-process runtime after phase 18. 19a: ``LLMRL`` (the
   RLAX-style post-training loop) at GPT-2 124M widths through ``tiny(**kw)``
   (d_model 768, 12 layers, 12 heads, d_ff 3072, vocab 50304 so it pads to
   itself, max_seq_len 1024, bf16 compute, f32 parameters, random weights
   from a seed): 2 generation actors sharing the card, each a
   ``PagedLLMEngine`` (K4), the learner on the card (its forward over
   [8, 1024] sequences takes flash: K1 forward, K2/K3 backward), prompts of
   32-128 tokens from a seeded rng, 32 new tokens, 3 iterations of 8
   rollouts and 2 updates at lr 1e-5, the reward the share of completion
   tokens in the vocab's lower half. Counts set to 0 just before the 3
   iterations and read just after: K4 by route = n_layers x (prefills,
   decode steps) of both engines; K1 = n_layers x (behavior forwards +
   updates), K2 = K3 = n_layers x updates. Gates: a greedy rollout batch
   through the kernel equals the plain path's (a departure only at a near
   tie within the bf16 tolerance); behavior log-probs through flash and
   one learner update through flash (loss, grad norm) within twice dense
   bf16's error against f32 dense plus one bf16 step (phase 7's rule);
   after a weight sync the generators' pools are drained and a greedy
   rollout equals a fresh actor's on the learner's weights; rewards and
   losses finite. Rollout tokens/s, an iteration's wall, the behavior
   forward, the update, the weight sync (learner -> 2 generators, reset
   included) and the reward an iteration. 19b: one ``ImpalaLearner`` and one
   ``APPOLearner`` update on the card from a CPU learner's parameters on a
   synthetic [T=50, N=8] CartPole-shaped batch with autoreset steps,
   against the CPU's, TF32 off, within 1e-4 a leaf. 19c: an
   ``InferencePool`` serving 4 runners' steps on the host CPU:
   actions, log-probs and values bit for bit those of each runner sampling
   locally with its own generator. The env loops of IMPALA, APPO, DQN,
   SAC, CQL and the multi-agent PPO wait for gymnasium where it is absent.

20. cluster operations — last on phase 13's cluster, before its teardown.
   20a: a driver script written into ``build/phase20/`` is submitted with
   ``JobSubmissionClient.submit_job`` (``working_dir`` that directory, both
   runtime checkers on through ``env_vars``, the GCS address on its command
   line); it attaches, builds phase 13's engine actor (``num_gpus=1``,
   gpt2_small at full width, bf16, seed-0 weights, K4), serves phase 4's six
   greedy requests, then phase 13's eight (their decode rate set beside
   phase 13's actor's), and prints one line: the streams (equal to phase 13's
   actor's), K4's launches by route read in the actor (= 12 x prefills,
   decode steps), its lock-order violations and its leaks after
   ``shutdown()`` (none of either); the job ends ``SUCCEEDED`` and the
   card's ``GPU`` is free again. A job exiting 3 ends ``FAILED``, a sleeping
   one ``STOPPED`` under ``stop_job`` with its process group gone (the
   seconds to that, and its members if it outlived SIGTERM). 20b,
   where aiohttp imports: the dashboard's ``/api/nodes`` (the card node,
   ``GPU`` 1, no ``TPU`` key), ``/api/jobs`` (the three end states),
   ``/api/node_stats`` (both daemons) and ``/metrics`` (the job actor's
   ``ray_tpu_serve_tokens_total`` and TTFT count). 20c: ``python -m
   ray_tpu_torch.scripts status --gcs --json`` (both nodes, ``GPU`` 1) and
   ``debug --session --gcs --json`` (phase 13's SIGKILLed worker DEAD, the
   job's driver a clean exit, the job's actor worker, which ``rt.kill``
   SIGKILLs, DEAD). 20d: the ``Autoscaler`` over
   ``GcsAutoscalerView`` and ``LocalDaemonNodeProvider``, one CPU node type
   with a probe resource (``max_workers`` 1, idle 5 s): a task needing the
   probe parks as a demand, a daemon is launched, registers and runs it
   (its worker imports no torch), then idles out and leaves the alive set;
   the card node untouched. Phase 13 ends by printing the GCS's late health
   ticks (``health_loop_stats``) and copies its stall stacks, if any, to
   ``chiprun_out/gcs_stall_stacks.txt``.
21. lint — last, in this process, after phase 19. 21a:
   ``ray_tpu_torch.devtools.lint.main(["--check-baseline", "--profile"])``
   (the port's raylint and its torch tier over ``ray_tpu_torch/``) must
   return 0; the findings by check and each check's ms are printed. 21b:
   phase 4's engine (``gpt2_small``, full width, bf16, its seed and
   defaults) answers phase 4's 8 requests, then one 16-token
   ``Generator.generate`` runs, all with the steady-state guard
   (``jitcheck``) installed, while ``sys.monitoring`` local ``PY_START``
   events on the code objects of the lint's declared hot scopes in
   ``serve/llm.py`` and ``models/generate.py`` count their entries: every
   declared serving scope must be entered, K4's launches, set to 0 just
   before and read just after, must be n_layers x the engine's prefills on
   the wgmma route and n_layers x its decode steps on the split route, and
   the guard must record no violation.

At the end of phase 13's cluster run (after 16, 17b and 18c) and of the
in-process runtimes of phases 17, 18 and 19, the GCS must hold none of the
train step's phase spans (``train.step``, ``lm.forward``, ``lm.loss``,
``train.backward``, ``train.optimizer``): no phase traces its steps, and
the step opens its spans only inside a trace (``tracing.step_span``); the
count and the GCS's event total are printed.

In phases 5 and 8-14 a greedy stream that departs from its reference must
do so at a near tie: the plain path's top-2 logit gap there under 1e-3.

It prints the kernels line ``{"kernels": [...]}`` and, last, the line
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # outside the tensor cores
TOL = {"float32": 1e-4,              # f32 sums over up to 1280 keys in another order
       "bfloat16": 1e-2}             # one rounding of the bf16 output (2^-8 rel.)
TOP2_TIE = 1e-3                      # end-to-end: a first divergence is a tie below this
LSE_TOL = 1e-4                       # flash lse: f32 in both versions
TRAIN_GRAD_TOL = 1e-4                # train e2e: per leaf, relative to its scale
TRAIN_LOSS_TOL = 1e-4                # train e2e: relative, losses of 3 steps
BF16_E2E_FLOOR = 4e-3                # bf16 e2e checks: one bf16 step (2^-8) of slack
DEVICE = "cuda"

# Kernel name -> (module of ray_tpu_torch.ops, its launch counter).
COUNTERS = {
    "paged_attention": ("paged_attention", "launches"),
    "paged_attention/wgmma": ("paged_attention", "prefill_launches"),
    "paged_attention/split": ("paged_attention", "decode_launches"),
    "flash_forward": ("flash_attention", "forward_launches"),
    "flash_dq": ("flash_attention", "dq_launches"),
    "flash_dkv": ("flash_attention", "dkv_launches"),
    "bias_gelu_forward": ("bias_gelu", "bias_gelu_forward_launches"),
    "bias_gelu_backward": ("bias_gelu", "bias_gelu_backward_launches"),
}
# The train step's shape (bench.py's configuration).
TRAIN_B, TRAIN_L, TRAIN_WARMUP, TRAIN_STEPS = 16, 1024, 3, 10


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 -----------------------------------------------------------------
def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{kind} x{count}")
    st = os.statvfs("/dev/shm")
    log(f"[device] /dev/shm: {st.f_blocks * st.f_frsize} bytes, "
        f"{st.f_bavail * st.f_frsize} free")
    return card, kind, count


# -- phase 2 -----------------------------------------------------------------
def phase_build():
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    spilled = []
    for name, text in logs.items():
        log(f"[build] {name}.cu (sm_90a)")
        entry = ""
        for line in text.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry", "stack frame")):
                log(f"[build]   {line.strip()}")
            # The tensor-core kernels hold their tiles in registers: a
            # spill would put them in local memory on every step.
            if (("_mma_kernel" in entry or "_wgmma_kernel" in entry)
                    and any(_spill_counts(line))):
                spilled.append(entry)
    log(f"[build] {len(logs)} kernel(s) ready in {dt:.1f} s")
    if spilled:
        fail(f"tensor-core kernels spill registers: {spilled}")
    return logs


def _spill_counts(line):
    """The byte counts of a ``-Xptxas -v`` line's "N bytes spill ..." parts."""
    words = line.replace(",", " ").split()
    return [int(words[i - 2]) for i, w in enumerate(words)
            if w == "spill" and i >= 2 and words[i - 2].isdigit()]


# -- phase 3 -----------------------------------------------------------------
class Timer:
    """Mean device time of a call over ``iters`` launches, each started with
    a cold L2 (a 256 MB buffer is written between launches: in the engine,
    a layer's weights pass through the cache between two attention calls).

    Before each start event the card runs ``torch.cuda._sleep`` long enough
    for the host to queue the whole call behind it, so the events time the
    call's kernels back to back, not the card waiting on the host that
    feeds them (a call of many launches, such as an autograd backward, is
    otherwise timed at the host's pace). If the card reached a start event
    before the host had queued the call, the run is repeated with a sleep
    four times as long."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device=DEVICE)
        self.cycles = 2_000_000      # ~1 ms at the H100's clock

    def __call__(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        for _ in range(4):
            starts = [torch.cuda.Event(enable_timing=True)
                      for _ in range(iters)]
            ends = [torch.cuda.Event(enable_timing=True)
                    for _ in range(iters)]
            late = False
            for i in range(iters):
                self.flush.zero_()
                torch.cuda._sleep(self.cycles)
                starts[i].record()
                fn()
                ends[i].record()
                late = late or starts[i].query()
            torch.cuda.synchronize()
            if not late:
                return sum(s.elapsed_time(e)
                           for s, e in zip(starts, ends)) / iters
            self.cycles *= 4
        fail(f"timer: the card reached a start event before the host had "
             f"queued the call, even after a sleep of {self.cycles // 4} "
             f"cycles")


def _paged_case(torch, rng, dtype, lengths, T, *, H=12, D=64, bt=16, NB=64,
                num_blocks=513, poison=(1e9, -1e9)):
    """Operands at the engine's shapes: random pools, one live chain per
    slot on shuffled blocks, the trash block and dead entries poisoned."""
    S = len(lengths)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=DEVICE).to(dt)

    q, kp, vp = rnd(S, T, H, D), rnd(num_blocks, bt, H, D), rnd(
        num_blocks, bt, H, D)
    kp[0], vp[0] = poison
    tables = torch.zeros((S, NB), dtype=torch.int32)
    perm = rng.permutation(num_blocks - 1) + 1
    nxt = 0
    for s, ln in enumerate(lengths):
        live = min(-(-(ln + T) // bt), NB)
        tables[s, :live] = torch.tensor(perm[nxt:nxt + live])
        nxt += live
    lens = torch.tensor(lengths, dtype=torch.int32)
    return q, kp, vp, tables.to(DEVICE), lens.to(DEVICE)


def _paged_bound(case, dtype):
    """Least time for the work these inputs need: each input read once
    (q, the LIVE K/V rows, tables, lengths), the output written once, and
    4*D flops per attended (query, key) pair per head."""
    q, kp, vp, tables, lens = case
    S, T, H, D = q.shape
    cap = tables.shape[1] * kp.shape[1]
    el = q.element_size()
    live = sum(min(int(ln) + T, cap) for ln in lens.tolist())
    nbytes = (2 * q.numel() * el + 2 * live * H * D * el
              + tables.numel() * 4 + lens.numel() * 4)
    pairs = sum(min(int(ln) + t + 1, cap) for ln in lens.tolist()
                for t in range(T))
    flops = 4 * D * H * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def _library_attention(torch, q, kp, vp, tables, lens):
    """Yardstick only (never called by the port): the table gather plus
    torch's scaled_dot_product_attention with the causal/validity mask."""
    import torch.nn.functional as F

    S, T, H, D = q.shape
    bt, NB = kp.shape[1], tables.shape[1]
    idx = tables.long()
    kc = kp[idx].reshape(S, NB * bt, H, D).transpose(1, 2)
    vc = vp[idx].reshape(S, NB * bt, H, D).transpose(1, 2)
    kv_pos = torch.arange(NB * bt, device=q.device)[None, None, None, :]
    q_pos = (lens.long()[:, None, None, None]
             + torch.arange(T, device=q.device)[None, None, :, None])
    out = F.scaled_dot_product_attention(q.transpose(1, 2), kc, vc,
                                         attn_mask=kv_pos <= q_pos)
    return out.transpose(1, 2)


def paged_route_name(route):
    """The design behind a route of ``ops/paged_attention.paged_route``."""
    return {"wgmma": "tensor cores (wgmma)",
            "split": "CUDA cores, split over the context"}[route]


def phase_kernels(torch, np, card):
    from ray_tpu_torch.ops import paged_attention as pa

    timer = Timer(torch)
    rng = np.random.default_rng(0)
    shapes = [("decode", [0, 15, 16, 1000], 1)]
    for T in (16, 256, 1024):
        for start in (0, 256):
            shapes.append((f"prefill T={T} start={start}", [start], T))
    cases = []
    for dtype in ("bfloat16", "float32"):
        for label, lengths, T in shapes:
            case = _paged_case(torch, rng, dtype, lengths, T)
            route = pa.paged_route(T, getattr(torch, dtype))
            got = pa.paged_attention(*case)
            torch.cuda.synchronize()
            want = pa.paged_attention_reference(*case)
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            if not torch.isfinite(got).all():
                fail(f"paged_attention {label} {dtype}: non-finite output")
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                fail(f"paged_attention {label} {dtype} ({route}): max abs "
                     f"err {err} over tolerance {tol}")
            # NaN in the trash block: neither kernel lets a dead page reach
            # a live output (the split kernel never reads one; the wgmma
            # kernel zero-fills them), so the outputs stay bit for bit.
            nan_case = (case[0], case[1].clone(), case[2].clone()) + case[3:]
            nan_case[1][0] = float("nan")
            nan_case[2][0] = float("nan")
            if not torch.equal(pa.paged_attention(*nan_case), got):
                fail(f"paged_attention {label} {dtype} ({route}): NaN in the "
                     f"trash block reached a live output")
            del nan_case
            lib = _library_attention(torch, *case)
            lib_err = (lib.float() - want.float()).abs().max().item()
            ms = timer(lambda: pa.paged_attention(*case))
            plain_ms = timer(lambda: pa.paged_attention_reference(*case))
            lib_ms = timer(lambda: _library_attention(torch, *case))
            bound_ms, bound_by, nbytes, flops = _paged_bound(case, dtype)
            rec = {"case": label, "dtype": dtype, "S": len(lengths), "T": T,
                   "lengths": lengths, "route": route,
                   "design": paged_route_name(route), "max_abs_err": err,
                   "tol": tol, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "library_max_abs_err": lib_err,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": nbytes, "flops": flops,
                   "tflops": flops / ms / 1e9, "x_bound": ms / bound_ms,
                   "x_library": ms / lib_ms}
            cases.append(rec)
            log(f"[kernel] paged_attention {label:24s} {dtype:8s} {route:5s} "
                f"err {err:.2e} (tol {tol:g})  kernel {ms:.4f} ms = "
                f"{rec['tflops']:.2f} TFLOP/s, {rec['x_bound']:.1f}x bound, "
                f"{rec['x_library']:.2f}x library  plain {plain_ms:.4f} ms  "
                f"library {lib_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by})  [{card}]")
    return cases, _paged_threshold(torch, np, pa, timer, card)


def _paged_threshold(torch, np, pa, timer, card):
    """Both K4 routes at the T where one takes over from the other (bf16):
    the decode slots and a one-slot prefill from a 256-token prefix, so the
    threshold ``pa.WGMMA_MIN_T`` rests on a measurement."""
    rng = np.random.default_rng(5)
    rows = []
    for lengths in ([0, 15, 16, 1000], [256]):
        for T in (2, 4, 5, 8, 9, 16):
            case = _paged_case(torch, rng, "bfloat16", lengths, T)
            s = 1.0 / case[0].shape[-1] ** 0.5
            want = pa.paged_attention_reference(*case).float()
            row = {"lengths": lengths, "T": T,
                   "route": pa.paged_route(T, torch.bfloat16)}
            for route in ("split", "wgmma"):
                got = pa._paged_attention_cuda(*case, s, route=route)
                if not torch.allclose(got.float(), want, atol=TOL["bfloat16"],
                                      rtol=TOL["bfloat16"]):
                    fail(f"paged_attention {route} route at T={T} "
                         f"{lengths}: over tolerance")
                row[f"{route}_ms"] = timer(
                    lambda: pa._paged_attention_cuda(*case, s, route=route),
                    iters=10)
            rows.append(row)
            log(f"[kernel] paged_attention route threshold bf16 S="
                f"{len(lengths)} T={T:2d}: split {row['split_ms']:.4f} ms, "
                f"wgmma {row['wgmma_ms']:.4f} ms -> takes {row['route']}  "
                f"[{card}]")
    return rows


# -- phase 4 -----------------------------------------------------------------
def _requests(np):
    """8 requests: prompt lengths 12..900, two sharing a 256-token prefix
    (a prefix hit: start_pos > 0), one follow-up turn of a finished request
    (a partial tail hit: a copy-on-write fork), 6 greedy and 2 sampled."""
    rng = np.random.default_rng(1)

    def toks(n):
        return rng.integers(0, 50257, n).tolist()

    shared = toks(256)
    return [
        dict(name="prefix-a", prompt=shared + toks(100), max_new=48),
        dict(name="prefix-b", prompt=shared + toks(40), max_new=40,
             after="prefix-a:first"),
        dict(name="short", prompt=toks(12), max_new=64),
        dict(name="long", prompt=toks(900), max_new=32),
        dict(name="sampled-a", prompt=toks(500), max_new=48, temperature=0.8,
             seed=11),
        dict(name="sampled-b", prompt=toks(77), max_new=32, temperature=1.0,
             seed=12),
        dict(name="mid", prompt=toks(600), max_new=40),
        dict(name="followup", prompt=None, extra=toks(5), max_new=32,
             after="short:done", extends="short"),
    ]


def _serve(torch, eng, reqs, label):
    """Answer ``reqs`` (``_requests``) on ``eng`` from one thread each: a
    request with ``after`` waits for another's first token or end, one that
    ``extends`` another prompts with that one's prompt, output and its own
    ``extra``. Returns (results by name, wall seconds), the card
    synchronised at the end; a failed or unfinished request is fatal."""
    by_name = {r["name"]: r for r in reqs}
    events = {f"{r['name']}:{k}": threading.Event() for r in reqs
              for k in ("first", "done")}
    results, errors = {}, []

    def client(r):
        try:
            if "after" in r:
                if not events[r["after"]].wait(timeout=600):
                    raise TimeoutError(f"{r['name']} waited for {r['after']}")
            if r.get("extends"):
                base = by_name[r["extends"]]
                r["prompt"] = (base["prompt"] + results[base["name"]]["tokens"]
                               + r["extra"])
            out = {}
            toks = []
            for tok in eng.stream(r["prompt"], max_new_tokens=r["max_new"],
                                  temperature=r.get("temperature", 0.0),
                                  seed=r.get("seed", 0), result=out):
                toks.append(tok)
                events[f"{r['name']}:first"].set()
            results[r["name"]] = dict(tokens=toks, **out)
        except BaseException as e:  # noqa: BLE001 — reported, then fatal
            errors.append(f"{r['name']}: {e!r}")
        finally:
            events[f"{r['name']}:first"].set()
            events[f"{r['name']}:done"].set()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail(f"{label} requests did not finish within 900 s")
    if errors:
        fail(f"{label} requests failed: {errors}")
    return results, wall


def _check_streams(reqs, results, vocab):
    for r in reqs:
        res = results[r["name"]]
        toks = res["tokens"]
        if len(toks) != r["max_new"]:
            fail(f"request {r['name']}: {len(toks)} tokens, wanted "
                 f"{r['max_new']} (finish {res.get('finish_reason')})")
        if not all(0 <= t < vocab for t in toks):
            fail(f"request {r['name']}: token out of [0, {vocab})")


def _serve_summary(eng, reqs, results, wall, rate=None):
    """Tokens, wall rate, decode tokens/s (``rate``, else the engine's
    lifetime rate) and TTFT of one ``_serve`` run."""
    n_tok = sum(len(results[r["name"]]["tokens"]) for r in reqs)
    ttfts = sorted(results[r["name"]]["ttft_s"] * 1e3 for r in reqs)
    return {
        "requests": len(reqs), "tokens": n_tok, "wall_s": wall,
        "tokens_per_s_wall": n_tok / wall,
        "decode_tokens_per_s": (rate if rate is not None
                                else eng.decode_tokens_per_sec()),
        "ttft_ms": {r["name"]: results[r["name"]]["ttft_s"] * 1e3
                    for r in reqs},
        "ttft_ms_median": ttfts[len(ttfts) // 2], "ttft_ms_max": ttfts[-1],
        "prompt_lens": {r["name"]: len(r["prompt"]) for r in reqs},
    }


class Counts:
    """The kernels' launch counters, set to 0 and read together."""

    def __init__(self):
        import importlib

        self.where = {name: (importlib.import_module(
            f"ray_tpu_torch.ops.{mod}"), attr)
            for name, (mod, attr) in COUNTERS.items()}

    def reset(self):
        for mod, attr in self.where.values():
            setattr(mod, attr, 0)

    def read(self):
        return {name: getattr(mod, attr)
                for name, (mod, attr) in self.where.items()}


def phase_engine(torch, np, card, counts):
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import PagedLLMEngine

    cfg = transformer.gpt2_small()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device=DEVICE)
    eng = PagedLLMEngine(params, cfg, device=DEVICE)
    del params
    eng.warmup()
    torch.cuda.synchronize()
    log(f"[engine] gpt2_small ({transformer.param_count(eng.params)} params, "
        f"{cfg.dtype}) slots {eng.slots} chunk {eng.chunk} block_tokens "
        f"{eng.block_tokens} pool {eng.kv.num_blocks} blocks, buckets "
        f"{eng.buckets}; set-up + warmup {time.perf_counter() - t0:.1f} s")
    if eng._pg.attention_kernel != "cuda":
        fail(f"engine resolved attention to {eng._pg.attention_kernel!r}")

    reqs = _requests(np)
    # Counts to 0 just before the run, read just after.
    counts.reset()
    st0 = eng.stats()
    results, wall = _serve(torch, eng, reqs, "engine")
    launches = counts.read()
    st1 = eng.stats()
    _check_streams(reqs, results, cfg.vocab_size)
    d_pref = int(st1["prefill_forwards"] - st0["prefill_forwards"])
    d_dec = int(st1["decode_forwards"] - st0["decode_forwards"])
    expected = cfg.n_layers * (d_pref + d_dec)
    if launches["paged_attention"] <= 0 or \
            launches["paged_attention"] != expected:
        fail(f"paged_attention launches {launches['paged_attention']} != "
             f"n_layers x (prefill {d_pref} + decode steps {d_dec}) = "
             f"{expected}")
    by_route = {r: launches[f"paged_attention/{r}"]
                for r in ("wgmma", "split")}
    if sum(by_route.values()) != expected or not all(by_route.values()):
        fail(f"paged_attention launches by route {by_route}: both routes "
             f"must run and add up to {expected}")
    hits = st1["kv_hit_tokens"] - st0["kv_hit_tokens"]
    cows = st1["kv_cow_copies"] - st0["kv_cow_copies"]
    if hits < 256 or cows < 1:
        fail(f"prefix paths not exercised: hit tokens {hits}, COW forks "
             f"{cows}")
    if eng.kv.active_blocks() != 0:
        fail(f"{eng.kv.active_blocks()} blocks still pinned after the run")

    summary = _serve_summary(eng, reqs, results, wall)
    summary.update({
        "prefill_forwards": d_pref, "decode_forwards": d_dec,
        "launches": launches, "kv_hit_tokens": hits, "kv_cow_copies": cows,
    })
    n_tok = summary["tokens"]
    log(f"[engine] {len(reqs)} requests, {n_tok} tokens in {wall:.2f} s: "
        f"{n_tok / wall:.1f} tokens/s wall, decode "
        f"{eng.decode_tokens_per_sec():.1f} tokens/s  [{card}]")
    log(f"[engine] TTFT median {summary['ttft_ms_median']:.1f} ms, max "
        f"{summary['ttft_ms_max']:.1f} ms  [{card}]")
    log(f"[engine] prefill dispatches {d_pref}, decode steps {d_dec}, "
        f"paged_attention launches {launches['paged_attention']} = "
        f"{cfg.n_layers} x {d_pref + d_dec} (wgmma {by_route['wgmma']}, "
        f"split {by_route['split']}); prefix hit tokens {hits:.0f}, "
        f"COW forks {cows:.0f}; blocks pinned after: 0")
    summary["profile"] = _profile_decode(torch, np, eng, card)
    return summary


def _device_rows(torch, prof):
    """(kernels, operators) as (name, self device µs, calls), largest first.
    Kernel rows are the device's own events, so their sum is the device's
    busy time on one stream; an operator row sums the kernels it launched
    itself, which groups the same time by torch operator."""
    kernels, ops = [], []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            on_device = e.device_type == torch.autograd.DeviceType.CUDA
            (kernels if on_device else ops).append((e.key, dev, e.count))
    kernels.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    return kernels, ops


def _profile_decode(torch, np, eng, card):
    """Where a decode step's time goes: torch.profiler over 4 concurrent
    greedy requests (500-token prompts, 64 new tokens) on the warm engine.
    Device busy time is the sum of the kernels' own times (one stream);
    the rest of the window the card idles, waiting on the host."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 50257, 500).tolist() for _ in range(4)]
    errors = []

    def client(p):
        try:
            if len(eng.generate(p, max_new_tokens=64)) != 64:
                errors.append("short stream")
        except BaseException as e:  # noqa: BLE001 — reported, then fatal
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(p,)) for p in prompts]
    st0 = eng.stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if errors or any(t.is_alive() for t in threads):
        fail(f"profiled requests failed: {errors or 'timeout'}")
    steps = int(eng.stats()["decode_forwards"] - st0["decode_forwards"])
    rows, _ = _device_rows(torch, prof)
    busy_us = sum(r[1] for r in rows)
    out = {"wall_ms": wall_us / 1e3, "decode_steps": steps,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / wall_us if rows else None,
           "top_kernels": [{"name": k[:90], "device_ms": d / 1e3,
                            "calls": c} for k, d, c in rows[:12]]}
    if not rows:
        log("[profile] the profiler recorded no device time: not measured")
        return out
    log(f"[profile] 4 requests x 64 tokens, {steps} decode steps in "
        f"{wall_us / 1e3:.1f} ms ({wall_us / 1e3 / max(steps, 1):.2f} ms a "
        f"step); device busy {busy_us / 1e3:.1f} ms, idle share "
        f"{out['device_idle_share']:.3f}  [{card}]")
    for k, d, c in rows[:8]:
        log(f"[profile]   {d / 1e3:9.2f} ms {c:6d}x  {k[:80]}")
    return out


# -- phase 5 -----------------------------------------------------------------
def phase_end_to_end(torch, np):
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import PagedLLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = transformer.gpt2_small(n_layers=2, dtype=torch.float32)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(2),
                                     device=DEVICE)
    kern = PagedLLMEngine(params, cfg, device=DEVICE, attention_kernel="cuda",
                          name="e2e-kernel")
    plain = PagedLLMEngine(params, cfg, device=DEVICE,
                           attention_kernel="gather", name="e2e-plain")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 150, 400, 700)]

    ties = []
    for p in prompts:
        a = kern.generate(p, max_new_tokens=24)
        b = plain.generate(p, max_new_tokens=24)
        ties += _same_greedy(torch, plain.params, cfg, p, b, {"kernel": a},
                             "e2e")
    log(f"[e2e] {len(prompts)} greedy requests, gpt2_small widths x 2 "
        f"layers, f32: kernel path == plain path"
        + (f" up to {len(ties)} near tie(s)" if ties else ""))
    return {"prompts": [len(p) for p in prompts], "ties": ties,
            "prefill_bf16": _prefill_bf16(torch, np)}


def _prefill_bf16(torch, np):
    """bf16 on the engine's own prefill forward, where the wgmma K4 runs:
    ``_forward_prefill_paged`` at gpt2_small widths x 2 layers, prompts of
    150 and 900 tokens padded to their buckets, through the kernel and
    through the gather path in bf16 compute, each held to an f32 gather run
    on the same parameters: the kernel's error in the last position's
    logits (relative to their largest) within twice gather-bf16's plus one
    bf16 step."""
    from ray_tpu_torch.models import generate, transformer
    from ray_tpu_torch.ops import paged_attention as pa

    f32 = transformer.gpt2_small(n_layers=2, dtype=torch.float32)
    bf16 = f32.replace(dtype=torch.bfloat16)
    params = transformer.init_params(f32, torch.Generator().manual_seed(6),
                                     device=DEVICE)
    rng = np.random.default_rng(6)
    table = torch.arange(1, 65, dtype=torch.int32, device=DEVICE)
    out = []
    for n in (150, 900):
        bucket = 256 if n <= 256 else 1024
        padded = torch.zeros((1, bucket), dtype=torch.long, device=DEVICE)
        padded[0, :n] = torch.tensor(rng.integers(0, f32.vocab_size, n))
        logits = {}
        for name, cfg, kernel in (("f32 gather", f32, "gather"),
                                  ("bf16 gather", bf16, "gather"),
                                  ("bf16 kernel", bf16, "cuda")):
            kp, vp = generate.init_block_pool(cfg, 65, 16, DEVICE)
            before = pa.prefill_launches
            lg, _, _ = generate._forward_prefill_paged(
                params, padded, kp, vp, table, 0, n, cfg, 16, kernel=kernel)
            if kernel == "cuda" and pa.prefill_launches - before != 2:
                fail(f"e2e bf16 prefill of {n} tokens: the wgmma kernel ran "
                     f"{pa.prefill_launches - before} times, not 2")
            logits[name] = lg[0, n - 1, :f32.vocab_size].float()
        ref = logits["f32 gather"]
        top = ref.abs().max().item()
        errs = {k: (logits[k] - ref).abs().max().item() / top
                for k in ("bf16 gather", "bf16 kernel")}
        if errs["bf16 kernel"] > 2 * errs["bf16 gather"] + BF16_E2E_FLOOR:
            fail(f"e2e bf16 prefill of {n} tokens: kernel logits err "
                 f"{errs['bf16 kernel']:.2e} over twice gather-bf16's "
                 f"{errs['bf16 gather']:.2e} plus {BF16_E2E_FLOOR}")
        out.append({"prompt_len": n, "bucket": bucket, "rel_err": errs})
        log(f"[e2e] bf16 prefill of {n} tokens (bucket {bucket}), gpt2_small "
            f"widths x 2 layers, last-position logits against f32 gather: "
            f"wgmma kernel {errs['bf16 kernel']:.2e}, gather bf16 "
            f"{errs['bf16 gather']:.2e} (kernel within 2x gather + "
            f"{BF16_E2E_FLOOR})")
    return out


def _top2(torch, params, cfg, tokens):
    """Top-2 logits of the plain (gather) path at the next position."""
    from ray_tpu_torch.models import generate

    P = 1024
    kp, vp = generate.init_block_pool(cfg, 65, 16, DEVICE)
    table = torch.arange(1, 65, dtype=torch.int32, device=DEVICE)
    padded = torch.zeros((1, P), dtype=torch.long, device=DEVICE)
    padded[0, :len(tokens)] = torch.tensor(tokens)
    logits, _, _ = generate._forward_prefill_paged(
        params, padded, kp, vp, table, 0, len(tokens), cfg, 16,
        kernel="gather")
    top = logits[0, len(tokens) - 1, :cfg.vocab_size].float().topk(2).values
    return top[0].item(), top[1].item()


def _same_greedy(torch, params, cfg, prompt, want, got, tag, bf16=False):
    """Each greedy stream of ``got`` (name -> tokens) equals ``want``, or
    first diverges at a near tie: the plain path's top-2 gap there below
    ``TOP2_TIE`` — in bf16 compute, below the bf16 tolerance of the top
    logit plus one bf16 step (``TOL["bfloat16"] * |top| +
    BF16_E2E_FLOOR``). Returns the ties."""
    ties = []
    for name, toks in got.items():
        if toks == want:
            continue
        i = next((i for i, (x, y) in enumerate(zip(toks, want)) if x != y),
                 min(len(toks), len(want)))
        if i >= min(len(toks), len(want)):
            fail(f"{tag}: {name} gave {len(toks)} tokens, wanted {len(want)}")
        first, second = _top2(torch, params, cfg, prompt + want[:i])
        gap = first - second
        tie = (TOL["bfloat16"] * abs(first) + BF16_E2E_FLOOR if bf16
               else TOP2_TIE)
        if gap >= tie:
            fail(f"{tag}: prompt of {len(prompt)} tokens, {name} diverges at "
                 f"token {i} ({toks[i]} vs {want[i]}) with a top-2 gap of "
                 f"{gap:.2e} >= {tie:.2e}")
        ties.append({"stream": name, "prompt_len": len(prompt),
                     "position": i, "gap": gap})
        log(f"[{tag}] prompt of {len(prompt)} tokens: {name}'s first "
            f"divergence at token {i} is a near tie (plain top-2 gap "
            f"{gap:.2e} < {tie:.2e})")
    return ties


# -- phase 3, flash attention --------------------------------------------------
# (label, B, Lq, Lk, dtype, causal); "train" is the train step's and is timed.
FLASH_SHAPES = [("train", TRAIN_B, TRAIN_L, TRAIN_L, "bfloat16", True),
                ("train B=4", 4, TRAIN_L, TRAIN_L, "float32", True),
                ("ragged full", 2, 333, 333, "bfloat16", False),
                ("Lq<Lk", 2, 200, 520, "float32", True)]
FLASH = {  # kernel name -> (TPU kernel it replaces, flops per attended pair / D)
    "flash_forward": ("ray_tpu/ops/flash_attention.py:39", 4),
    "flash_dq": ("ray_tpu/ops/flash_attention.py:146", 6),
    "flash_dkv": ("ray_tpu/ops/flash_attention.py:200", 8),
}


def _flash_bound(name, B, Lq, Lk, H, D, dtype, causal):
    """Least time for the work: each input read once and each output
    written once (q, k, v; g, lse and delta for the backward; o and lse,
    dq, or dk and dv), and 4, 6 or 8 · D flops per attended (query, key)
    pair per head — the score product, dO·Vᵀ, and one product per
    output."""
    el = 2 if dtype == "bfloat16" else 4
    pairs = (sum(min(r + 1, Lk) for r in range(Lq)) if causal
             else Lq * Lk) * B * H
    q_el, kv_el, rows = B * Lq * H * D, B * Lk * H * D, B * H * Lq
    if name == "flash_forward":
        nbytes = (2 * q_el + 2 * kv_el) * el + 4 * rows
    elif name == "flash_dq":
        nbytes = (3 * q_el + 2 * kv_el) * el + 8 * rows
    else:
        nbytes = (2 * q_el + 4 * kv_el) * el + 8 * rows
    flops = FLASH[name][1] * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def flash_route(name, dtype):
    """Which design of ``csrc/flash_attention.cu`` runs: the dtype alone
    picks it."""
    if dtype != "bfloat16":
        return "CUDA cores"
    if name == "flash_dkv":
        return "tensor cores (mma.sync)"
    return "tensor cores (wgmma)"


def phase_flash_kernels(torch, np, card):
    """K1-K3 against their plain versions: the train step's shape in bf16
    (timed, with SDPA's errors against the same plain versions beside the
    kernels'), at B=4 in f32, and ragged, non-causal and Lk != Lq cases."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(torch)
    rng = np.random.default_rng(7)
    H, D = 12, 64
    cases = []
    for label, B, Lq, Lk, dtype, causal in FLASH_SHAPES:
        dt = getattr(torch, dtype)

        def rnd(L):
            return torch.tensor(rng.standard_normal((B, L, H, D)),
                                dtype=torch.float32, device=DEVICE).to(dt)

        q, k, v, g = rnd(Lq), rnd(Lk), rnd(Lk), rnd(Lq)
        s = 1.0 / D ** 0.5
        o, lse = fa.flash_forward(q, k, v, scale=s, causal=causal)
        grads = fa.flash_backward(q, k, v, g, o, lse, scale=s, causal=causal)
        torch.cuda.synchronize()
        want_o, want_lse = fa.flash_forward_reference(q, k, v, scale=s,
                                                      causal=causal)
        delta = fa._delta(g, o)
        want_dq = fa.flash_dq_reference(q, k, v, g, lse, delta, scale=s,
                                        causal=causal)
        want_dk, want_dv = fa.flash_dkv_reference(q, k, v, g, lse, delta,
                                                  scale=s, causal=causal)
        tol = TOL[dtype]
        checks = {"flash_forward": [("o", o, want_o, tol),
                                    ("lse", lse, want_lse, LSE_TOL)],
                  "flash_dq": [("dq", grads[0], want_dq, tol)],
                  "flash_dkv": [("dk", grads[1], want_dk, tol),
                                ("dv", grads[2], want_dv, tol)]}
        for name, outs in checks.items():
            errs = {}
            for out, got, want, t in outs:
                if not torch.isfinite(got).all():
                    fail(f"{name} {label} {dtype}: non-finite {out}")
                e = (got.float() - want.float()).abs().max().item()
                if not torch.allclose(got.float(), want.float(), atol=t,
                                      rtol=t):
                    fail(f"{name} {label} {dtype}: {out} max abs err {e} "
                         f"over tolerance {t}")
                errs[out] = e
            rec = {"kernel": name, "case": label, "dtype": dtype, "B": B,
                   "Lq": Lq, "Lk": Lk, "H": H, "D": D, "causal": causal,
                   "route": flash_route(name, dtype),
                   "max_abs_err": max(errs.values()), "errs": errs,
                   "tol": tol,
                   "plain_max_abs": max(w.abs().max().item()
                                        for _, _, w, _ in outs)}
            if label == "train":
                bound_ms, bound_by, nbytes, flops = _flash_bound(
                    name, B, Lq, Lk, H, D, dtype, causal)
                rec.update(bound_ms=bound_ms, bound_by=bound_by,
                           bytes=nbytes, flops=flops)
            cases.append(rec)
        if label != "train":
            errs = ", ".join(f"{c['kernel']} {c['max_abs_err']:.2e}"
                             for c in cases[-3:])
            log(f"[kernel] flash {label:12s} {dtype:8s} B={B} Lq={Lq} "
                f"Lk={Lk} causal={causal}: within tolerance ({errs})")
            continue
        # At the train step's shape: torch's scaled_dot_product_attention on
        # the same [B, H, L, D] views, as a yardstick of time and of error
        # against the same plain versions. The port never calls it.
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        gt = g.transpose(1, 2)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_grads = torch.autograd.grad(lib_out, (qt, kt, vt), gt,
                                        retain_graph=True)
        lib_errs = {
            out: (got.transpose(1, 2).float() - want.float()).abs().max(
            ).item()
            for out, got, want in zip(
                ("o", "dq", "dk", "dv"), (lib_out,) + lib_grads,
                (want_o, want_dq, want_dk, want_dv))}

        def lib_bwd():
            torch.autograd.grad(lib_out, (qt, kt, vt), gt, retain_graph=True)

        def lib_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            torch.autograd.grad(out, (qt, kt, vt), gt)

        with torch.no_grad():
            times = {
                "flash_forward": (
                    timer(lambda: fa.flash_forward(q, k, v, scale=s,
                                                   causal=True)),
                    timer(lambda: fa.flash_forward_reference(
                        q, k, v, scale=s, causal=True), iters=5)),
                "flash_dq": (
                    timer(lambda: fa.flash_dq(q, k, v, g, lse, delta,
                                              scale=s, causal=True)),
                    timer(lambda: fa.flash_dq_reference(
                        q, k, v, g, lse, delta, scale=s, causal=True),
                        iters=5)),
                "flash_dkv": (
                    timer(lambda: fa.flash_dkv(q, k, v, g, lse, delta,
                                               scale=s, causal=True)),
                    timer(lambda: fa.flash_dkv_reference(
                        q, k, v, g, lse, delta, scale=s, causal=True),
                        iters=5)),
            }
            lib_fwd_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
        lib_bwd_ms = timer(lib_bwd)
        lib_fwd_bwd_ms = timer(lib_fwd_bwd)
        for rec in cases[-3:]:
            name = rec["kernel"]
            ms, plain_ms = times[name]
            lib_ms = lib_fwd_ms if name == "flash_forward" else lib_bwd_ms
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_fwd_ms=lib_fwd_ms, library_bwd_ms=lib_bwd_ms,
                       library_fwd_bwd_ms=lib_fwd_bwd_ms,
                       library_errs={o: lib_errs[o] for o in rec["errs"]
                                     if o in lib_errs},
                       tflops=rec["flops"] / ms / 1e9,
                       x_bound=ms / rec["bound_ms"], x_library=ms / lib_ms)
            # The tensor-core kernels round P (and dS) to bf16 before their
            # products, as SDPA does: their errors stay within twice SDPA's.
            if rec["route"].startswith("tensor cores"):
                for out, e in rec["library_errs"].items():
                    if e and rec["errs"][out] > 2 * e:
                        fail(f"{name} train: {out} max abs err "
                             f"{rec['errs'][out]:.3e} over twice SDPA's "
                             f"{e:.3e}")
            errs = ", ".join(
                f"{o} {e:.2e}" + (f" (SDPA {rec['library_errs'][o]:.2e})"
                                  if o in rec["library_errs"] else "")
                for o, e in rec["errs"].items())
            log(f"[kernel] {name:13s} train {dtype} B={B} L={Lq} H={H} "
                f"D={D} causal, {rec['route']}: err {errs} (tol {tol:g}, "
                f"outputs up to {rec['plain_max_abs']:.3g})  kernel "
                f"{ms:.4f} ms = {rec['tflops']:.1f} TFLOP/s, "
                f"{rec['x_bound']:.1f}x bound, {rec['x_library']:.2f}x "
                f"library  plain {plain_ms:.4f} ms  library {lib_ms:.4f} ms"
                f"  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})  "
                f"[{card}]")
        log(f"[kernel] library yardstick (SDPA, is_causal): forward "
            f"{lib_fwd_ms:.4f} ms, backward {lib_bwd_ms:.4f} ms, forward + "
            f"backward {lib_fwd_bwd_ms:.4f} ms  [{card}]")
        bwd_ms = times["flash_dq"][0] + times["flash_dkv"][0]
        for rec in cases[-3:]:
            rec["k2_k3_ms"] = bwd_ms
        log(f"[kernel] backward: K2 + K3 {bwd_ms:.4f} ms against the whole "
            f"SDPA backward {lib_bwd_ms:.4f} ms = "
            f"{bwd_ms / lib_bwd_ms:.2f}x  [{card}]")
        del qt, kt, vt, lib_out, lib_grads
    return cases


# The MLP epilogue's kernel pair: (label, rows, cols, timed). Rows are the
# train step's tokens (16 x 1024); 4099 rows and 1000 columns leave a ragged
# row split and a ragged column tile.
BIAS_GELU_SHAPES = [("gpt2-xl", 16384, 6400, True),
                    ("gpt2-medium", 16384, 4096, True),
                    ("ragged rows", 4099, 6400, False),
                    ("ragged columns", 4099, 1000, False)]
BIAS_GELU_REL = 2 ** -7   # one bf16 step (2^-8) of either side's rounding


def _bias_gelu_bound(rows, cols):
    """Least bytes a direction: forward reads y (f32) and b and writes pre
    and out (bf16); backward reads g and pre and writes dpre and db."""
    fwd = rows * cols * (4 + 2 + 2) + cols * 2
    bwd = rows * cols * (2 + 2 + 2) + cols * 2
    return {"forward": fwd, "backward": bwd}


def _within_bf16(torch, got, want, what):
    """``got`` within one bf16 step of ``want`` (relative), plus 1e-5 of
    ``want``'s largest entry where the value itself nears 0 (gelu' crosses
    0 near -0.75: both sides cancel there). Returns the largest error."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"bias_gelu {what}: non-finite output")
    err = (got - want).abs()
    lim = BIAS_GELU_REL * want.abs() + 1e-5 * want.abs().max()
    if (err > lim).any():
        fail(f"bias_gelu {what}: {int((err > lim).sum())} elements beyond "
             f"one bf16 step, max abs err {err.max().item():.3e}")
    return err.max().item()


def phase_bias_gelu(torch, card):
    """The MLP epilogue's forward and backward kernels against their plain
    versions (the same expressions in f32 torch ops), their launch
    counters, and at GPT-2 XL's and medium's train shapes their device
    times beside the bytes bound, the eager chain they replace and the
    library's ``F.gelu(approximate="tanh")`` (a yardstick only: the port
    never calls it)."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import bias_gelu as bg
    from ray_tpu_torch.ops import layers

    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    cases = []
    for label, rows, cols, timed in BIAS_GELU_SHAPES:
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=DEVICE) * scale

        # Pre-activations of a few units, over GELU's curved part and its
        # flat tails; gradients as the down-projection hands them back.
        y, b = rnd(rows, cols, scale=2.0), rnd(cols, scale=0.5).bfloat16()
        g = rnd(rows, cols, scale=0.05).bfloat16()
        f0 = bg.bias_gelu_forward_launches
        b0 = bg.bias_gelu_backward_launches
        pre, out = bg.bias_gelu_forward(y, b)
        no_pre, out2 = bg.bias_gelu_forward(y, b, keep_pre=False)
        dpre, db = bg.bias_gelu_backward(g, pre)
        dpre2, db2 = bg.bias_gelu_backward(g, pre)
        torch.cuda.synchronize()
        if (bg.bias_gelu_forward_launches - f0,
                bg.bias_gelu_backward_launches - b0) != (2, 2):
            fail(f"bias_gelu {label}: launches not counted")
        want_pre, want_out = bg.bias_gelu_reference(y, b)
        want_dpre, _ = bg.bias_gelu_backward_reference(g, pre)
        if not torch.equal(pre, want_pre):
            fail(f"bias_gelu {label}: pre is not bf16(y + b) bit for bit")
        if no_pre is not None or not torch.equal(out, out2):
            fail(f"bias_gelu {label}: the forward without pre differs")
        if not (torch.equal(dpre, dpre2) and torch.equal(db, db2)):
            fail(f"bias_gelu {label}: two backward calls differ")
        errs = {"out": _within_bf16(torch, out, want_out, f"{label} out"),
                "dpre": _within_bf16(torch, dpre, want_dpre,
                                     f"{label} dpre")}
        # db against the f32 sum of the kernel's own rounded dpre: the
        # partials and their reduction alone (f32 sums in another order).
        want_db = dpre.float().sum(0)
        errs["db"] = (db - want_db).abs().max().item()
        if errs["db"] > 1e-5 * want_db.abs().max().item() + 1e-6:
            fail(f"bias_gelu {label}: db max abs err {errs['db']:.3e} from "
                 f"the column sums of dpre")
        rec = {"case": label, "rows": rows, "cols": cols, "errs": errs,
               "splits": {"forward": bg._splits(y.device, rows, cols, 0),
                          "backward": bg._splits(y.device, rows, cols, 1)}}
        if not timed:
            log(f"[kernel] bias_gelu {label} [{rows}, {cols}]: within one "
                f"bf16 step ({errs})")
            cases.append(rec)
            continue

        # The eager chain it replaces (linear's bias add and cast, then
        # gelu's bf16 ops) and the library's GELU, each with its autograd.
        ye = y.detach().requires_grad_(True)
        be = b.detach().requires_grad_(True)

        def eager():
            return layers.gelu((ye + be.float()).to(torch.bfloat16))

        def library():
            return F.gelu((ye + be).to(torch.bfloat16), approximate="tanh")

        out_e, out_l = eager(), library()

        def grad_of(o):
            # The f32 gradient of y re-cast to bf16, as the GEMM's backward
            # takes it.
            dy, dbe = torch.autograd.grad(o, (ye, be), g, retain_graph=True)
            return dy.to(torch.bfloat16), dbe

        with torch.no_grad():
            ms = {"forward": timer(lambda: bg.bias_gelu_forward(y, b)),
                  "no_pre": timer(lambda: bg.bias_gelu_forward(
                      y, b, keep_pre=False)),
                  "backward": timer(lambda: bg.bias_gelu_backward(g, pre))}
        with torch.enable_grad():
            plain = {"forward": timer(eager, iters=5),
                     "backward": timer(lambda: grad_of(out_e), iters=5)}
            lib = {"forward": timer(library, iters=5),
                   "backward": timer(lambda: grad_of(out_l), iters=5)}
        nbytes = _bias_gelu_bound(rows, cols)
        bound = {d: n / HBM_BYTES_PER_S * 1e3 for d, n in nbytes.items()}
        rec.update(ms=ms["forward"], backward_ms=ms["backward"],
                   no_pre_ms=ms["no_pre"], plain_ms=plain["forward"],
                   plain_backward_ms=plain["backward"],
                   library_ms=lib["forward"],
                   library_backward_ms=lib["backward"],
                   bound_ms=bound["forward"],
                   backward_bound_ms=bound["backward"], bound_by="bytes",
                   bytes=nbytes,
                   x_bound=ms["forward"] / bound["forward"],
                   backward_x_bound=ms["backward"] / bound["backward"])
        cases.append(rec)
        for d in ("forward", "backward"):
            log(f"[kernel] bias_gelu {d:8s} {label} [{rows}, {cols}]: err "
                f"{errs}  kernel {ms[d]:.4f} ms = "
                f"{nbytes[d] / ms[d] / 1e6:.0f} GB/s, "
                f"{ms[d] / bound[d]:.2f}x bound  plain (eager chain) "
                f"{plain[d]:.4f} ms  library {lib[d]:.4f} ms  bound "
                f"{bound[d]:.4f} ms (bytes)  [{card}]")
        log(f"[kernel] bias_gelu forward without pre {label}: "
            f"{ms['no_pre']:.4f} ms  [{card}]")
        del ye, be, out_e, out_l
    return cases


# -- phase 6 -----------------------------------------------------------------
def _profile_step(torch, step, card):
    """Where a train step's time goes: torch.profiler over one step. Device
    busy time is the sum of the kernels' own times (one stream)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, ops = _device_rows(torch, prof)
    busy_us = sum(r[1] for r in rows)
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / wall_us if rows else None,
           "top_kernels": [{"name": k[:90], "device_ms": d / 1e3,
                            "calls": c} for k, d, c in rows[:20]],
           "top_ops": [{"name": k[:90], "device_ms": d / 1e3, "calls": c}
                       for k, d, c in ops[:20]]}
    if not rows:
        log("[profile] the profiler recorded no device time: not measured")
        return out
    log(f"[profile] one train step: {wall_us / 1e3:.1f} ms wall under the "
        f"profiler; device busy {busy_us / 1e3:.1f} ms, idle share "
        f"{out['device_idle_share']:.3f}  [{card}]")
    for k, d, c in rows[:10]:
        log(f"[profile]   {d / 1e3:9.2f} ms {c:6d}x  {k[:80]}")
    log("[profile] by torch operator:")
    for k, d, c in ops[:10]:
        log(f"[profile]   {d / 1e3:9.2f} ms {c:6d}x  {k[:80]}")
    return out


def phase_train(torch, np, card, counts):
    from ray_tpu_torch.models import training, transformer

    cfg = transformer.gpt2_small(max_seq_len=TRAIN_L, remat=True)
    t0 = time.perf_counter()
    bundle = training.make_train_step(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg),
        init_params_fn=lambda seed: transformer.init_params(cfg, seed,
                                                            device=DEVICE),
        optimizer=training.adamw(3e-4, weight_decay=0.1), device=DEVICE)
    params, opt = bundle.init(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_L)), device=DEVICE)}
    losses, norms = [], []
    for _ in range(TRAIN_WARMUP):
        params, opt, m = bundle.step(params, opt, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    per_step = []
    # Counts to 0 just before the timed run, read just after.
    counts.reset()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = counts.read()
        params, opt, m = bundle.step(params, opt, batch)
        after = counts.read()
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    norms = [x.item() for x in norms]
    n = cfg.n_layers
    want = {"flash_forward": 2 * n, "flash_dq": n, "flash_dkv": n,
            "paged_attention": 0, "paged_attention/wgmma": 0,
            "paged_attention/split": 0, "bias_gelu_forward": 2 * n,
            "bias_gelu_backward": n}
    for i, got in enumerate(per_step):
        if got != want:
            fail(f"train step {i}: launches {got}, wanted {want} (forward "
                 f"+ remat recompute = 2 x {n}, backward {n} each)")
    if not all(np.isfinite(losses + norms)):
        fail(f"train: non-finite loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall: {losses}")
    tokens = TRAIN_B * TRAIN_L * TRAIN_STEPS
    out = {"config": "gpt2_small(max_seq_len=1024, remat=True) bf16, f32 "
                     "params, AdamW(3e-4, wd 0.1)",
           "batch": [TRAIN_B, TRAIN_L], "warmup": TRAIN_WARMUP,
           "steps": TRAIN_STEPS, "setup_and_warmup_s": setup_s,
           "wall_s": wall, "step_ms": wall / TRAIN_STEPS * 1e3,
           "tokens_per_s": tokens / wall, "peak_memory_bytes": peak,
           "losses": losses, "grad_norms": norms, "launches": launches,
           "launches_per_step": want}
    log(f"[train] gpt2_small L={TRAIN_L} B={TRAIN_B} remat bf16: "
        f"{TRAIN_STEPS} steps in {wall:.3f} s = {out['step_ms']:.1f} ms a "
        f"step, {out['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB  [{card}]")
    log(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad norm "
        f"{norms[0]:.3f} -> {norms[-1]:.3f}; launches a step: flash forward "
        f"{2 * n}, dq {n}, dkv {n}, bias-GELU forward {2 * n}, backward {n} "
        f"(total {launches})")

    def one_step():
        nonlocal params, opt
        params, opt, _ = bundle.step(params, opt, batch)

    out["profile"] = _profile_step(torch, one_step, card)
    return out


# -- phase 7 -----------------------------------------------------------------
def phase_train_end_to_end(torch, np, counts):
    from ray_tpu_torch.models import training, transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    base = transformer.gpt2_small(n_layers=2, dtype=torch.float32,
                                  max_seq_len=1024)
    tokens = torch.tensor(np.random.default_rng(8).integers(
        0, base.vocab_size, (2, 1024)), device=DEVICE)
    res = {}
    for attn in ("flash", "dense"):
        cfg = base.replace(attn_impl=attn, remat=True)
        bundle = training.make_train_step(
            loss_fn=lambda p, b, cfg=cfg: transformer.lm_loss(p, b, cfg),
            init_params_fn=lambda seed: transformer.init_params(
                base, seed, device=DEVICE),
            optimizer=training.adamw(3e-4, weight_decay=0.1), device=DEVICE)
        params, opt = bundle.init(5)
        loss = transformer.lm_loss(params, {"tokens": tokens}, cfg)
        loss.backward()
        grads = {name: p.grad.clone() for name, p in zip(
            _leaf_names(params), training._leaves(params))}
        losses = []
        for _ in range(3):
            params, opt, m = bundle.step(params, opt, {"tokens": tokens})
            losses.append(m["loss"].item())
        res[attn] = (loss.item(), grads, losses)
        del params, opt, bundle
    (lf, gf, sf), (ld, gd, sd) = res["flash"], res["dense"]
    if abs(lf - ld) > 1e-5 * abs(ld):
        fail(f"train e2e: loss {lf} (flash) vs {ld} (dense)")
    # Each leaf relative to its largest entry, floored at 1e-3 of the
    # model's largest: bk's gradient is 0 in exact arithmetic (softmax does
    # not see a per-row constant), so both paths give rounding noise there.
    floor = 1e-3 * max(g.abs().max().item() for g in gd.values())
    worst = 0.0
    for name in gd:
        rel = ((gf[name] - gd[name]).abs().max().item()
               / max(gd[name].abs().max().item(), floor))
        worst = max(worst, rel)
        if rel > TRAIN_GRAD_TOL:
            fail(f"train e2e: gradient {name} differs by {rel:.2e} of its "
                 f"scale (tolerance {TRAIN_GRAD_TOL})")
    for a, b in zip(sf, sd):
        if abs(a - b) > TRAIN_LOSS_TOL * abs(b):
            fail(f"train e2e: step losses {sf} (flash) vs {sd} (dense)")
    log(f"[train e2e] gpt2_small widths x 2 layers, f32, B=2 L=1024: loss "
        f"{lf:.6f} (flash) vs {ld:.6f} (dense); gradients within "
        f"{worst:.2e} of each leaf's max (tol {TRAIN_GRAD_TOL}); 3 AdamW "
        f"steps {sf} vs {sd}")

    # bf16 compute, where the tensor-core K1-K3 run: the flash kernels
    # and dense attention (f32 softmax, bf16 in and out), each held to the
    # f32 dense run above on the same parameters and tokens.
    def rel_errs(grads):
        return max(((grads[n] - gd[n]).abs().max().item()
                    / max(gd[n].abs().max().item(), floor)) for n in gd)

    bf16 = {}
    for attn in ("flash", "dense"):
        cfg = base.replace(attn_impl=attn, remat=True, dtype=torch.bfloat16)
        params = training._tree_map(
            lambda t: t.detach().requires_grad_(True),
            transformer.init_params(base, 5, device=DEVICE))
        before = counts.read()
        loss = transformer.lm_loss(params, {"tokens": tokens}, cfg)
        loss.backward()
        ran = {k: v - before[k] for k, v in counts.read().items()}
        if attn == "flash" and not all(
                ran[n] for n in ("flash_forward", "flash_dq", "flash_dkv",
                                 "bias_gelu_forward", "bias_gelu_backward")):
            fail(f"train e2e bf16: the flash or bias-GELU kernels did not "
                 f"run ({ran})")
        grads = {name: p.grad for name, p in zip(
            _leaf_names(params), training._leaves(params))}
        bf16[attn] = (abs(loss.item() - ld) / abs(ld), rel_errs(grads))
        del params, grads, loss
    (fl, fg), (dl, dg) = bf16["flash"], bf16["dense"]
    if fl > 2 * dl + BF16_E2E_FLOOR or fg > 2 * dg + BF16_E2E_FLOOR:
        fail(f"train e2e bf16: flash loss/gradient errors {fl:.2e}/{fg:.2e} "
             f"against f32 over twice dense bf16's {dl:.2e}/{dg:.2e} plus "
             f"{BF16_E2E_FLOOR}")
    log(f"[train e2e] bf16 compute against the f32 dense run: loss rel. err "
        f"{fl:.2e} (flash) vs {dl:.2e} (dense), worst gradient leaf "
        f"{fg:.2e} vs {dg:.2e} of its max (flash within 2x dense + "
        f"{BF16_E2E_FLOOR})")
    return {"loss": [lf, ld], "grad_worst_rel": worst, "step_losses":
            {"flash": sf, "dense": sd},
            "bf16_vs_f32_dense": {"flash": {"loss_rel": fl, "grad_rel": fg},
                                  "dense": {"loss_rel": dl, "grad_rel": dg}}}


# -- phase 15 ----------------------------------------------------------------
MESH_LOSS_TOL = 1e-3                 # mesh step vs phase 6: relative, 3 warm-up losses
MOE_TOKENS = (16, 1024)              # the Switch FFN's batch: phase 6's tokens
MOE_EXPERTS = 8


def _mesh_step_run(torch, np, card, counts, mesh, policy, want_losses):
    """Phase 6's train step on the mesh under one remat policy."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import training, transformer
    from ray_tpu_torch.parallel.sharding import ShardingRules

    rules = ShardingRules()
    cfg = transformer.gpt2_small(max_seq_len=TRAIN_L, remat=True,
                                 remat_policy=policy)
    t0 = time.perf_counter()
    bundle = training.make_train_step(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg, mesh=mesh,
                                                 rules=rules),
        init_params_fn=lambda seed: transformer.init_params(cfg, seed,
                                                            device=DEVICE),
        logical_params=transformer.logical_axes(cfg), mesh=mesh, rules=rules,
        optimizer=training.adamw(3e-4, weight_decay=0.1),
        batch_logical=("batch", None))
    params, opt = bundle.init(0)
    leaves = list(training._leaves(params))
    moments = [opt.state[p][k] for p in leaves
               for k in ("exp_avg", "exp_avg_sq")]
    if not all(isinstance(t, DTensor) and t.device.type == DEVICE
               for t in leaves + moments):
        fail(f"mesh {policy}: parameters and AdamW moments must be DTensors "
             f"on the card")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_L)), device=DEVICE)}
    losses, norms = [], []
    for _ in range(TRAIN_WARMUP):
        params, opt, m = bundle.step(params, opt, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warm = [x.item() for x in losses]
    for a, b in zip(warm, want_losses):
        if not abs(a - b) <= MESH_LOSS_TOL * abs(b):
            fail(f"mesh {policy}: warm-up losses {warm} against phase 6's "
                 f"unsharded step {want_losses} (tolerance {MESH_LOSS_TOL} "
                 f"relative)")
    torch.cuda.reset_peak_memory_stats()
    per_step = []
    counts.reset()                   # this path's counts: 0 just before
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = counts.read()
        params, opt, m = bundle.step(params, opt, batch)
        after = counts.read()
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()          # ... and read just after
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    norms = [x.item() for x in norms]
    n = cfg.n_layers
    # DTensor activations keep linear_gelu's eager chain: no bias-GELU.
    want = {"flash_forward": 2 * n, "flash_dq": n, "flash_dkv": n,
            "paged_attention": 0, "paged_attention/wgmma": 0,
            "paged_attention/split": 0, "bias_gelu_forward": 0,
            "bias_gelu_backward": 0}
    for i, got in enumerate(per_step):
        if got != want:
            fail(f"mesh {policy} step {i}: launches {got}, wanted {want}")
    if not all(np.isfinite(losses + norms)):
        fail(f"mesh {policy}: non-finite loss or grad norm: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"mesh {policy}: loss did not fall: {losses}")
    tokens = TRAIN_B * TRAIN_L * TRAIN_STEPS
    out = {"remat_policy": policy, "setup_and_warmup_s": setup_s,
           "wall_s": wall, "step_ms": wall / TRAIN_STEPS * 1e3,
           "tokens_per_s": tokens / wall, "peak_memory_bytes": peak,
           "losses": losses, "grad_norms": norms, "launches": launches,
           "warmup_losses_vs_phase6": [warm, list(want_losses)]}

    def one_step():
        nonlocal params, opt
        params, opt, _ = bundle.step(params, opt, batch)

    out["profile"] = _profile_step(torch, one_step, card)
    log(f"[mesh] {policy}: {out['step_ms']:.1f} ms a step, "
        f"{out['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"warm-up losses within {MESH_LOSS_TOL} of phase 6's; flash "
        f"{2 * n}/{n}/{n} a step  [{card}]")
    del params, opt, bundle, moments, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_ring(torch, np, mesh):
    """Ring attention on the seq=1 mesh at phase 7's width, f32."""
    from ray_tpu_torch.parallel.ring_attention import (make_ring_attention,
                                                       reference_attention)

    rng = np.random.default_rng(11)
    q, k, v = (torch.tensor(rng.standard_normal((2, TRAIN_L, 12, 64)),
                            dtype=torch.float32, device=DEVICE)
               for _ in range(3))
    got = make_ring_attention(mesh, causal=True)(q, k, v).full_tensor()
    want = reference_attention(q, k, v, causal=True)
    err = (got - want).abs().max().item()
    if not err <= TOL["float32"]:
        fail(f"mesh ring attention: {err:.2e} from reference_attention "
             f"(tolerance {TOL['float32']})")
    return err


def _mesh_moe(torch, np, card, mesh):
    """A gpt2_small-width Switch FFN on the mesh (expert=1): its forward
    equal to the plain one-device one, then 3 AdamW steps on phase 6's
    token count, f32."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import training
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.parallel.sharding import ShardingRules

    cfg = moe.MoEConfig(d_model=768, d_ff=3072, num_experts=MOE_EXPERTS)
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.standard_normal(MOE_TOKENS + (768,)),
                     dtype=torch.float32, device=DEVICE)
    tgt = torch.tensor(rng.standard_normal(MOE_TOKENS + (768,)),
                       dtype=torch.float32, device=DEVICE)
    with torch.no_grad():
        plain, plain_m = moe.moe_ffn(moe.init_params(cfg, 3, device=DEVICE),
                                     x, cfg)
    plain_dropped = plain_m["dropped_fraction"].item()

    def loss_fn(p, b):
        y, m = moe.moe_ffn(p, b["x"], cfg)
        return ((y - b["tgt"]) ** 2).mean() + 0.01 * m["aux_loss"]

    bundle = training.make_train_step(
        loss_fn=loss_fn,
        init_params_fn=lambda seed: moe.init_params(cfg, seed, device=DEVICE),
        logical_params=moe.logical_axes(cfg), mesh=mesh,
        rules=ShardingRules(), optimizer=training.adamw(1e-3),
        batch_logical=None)
    params, opt = bundle.init(3)
    with torch.no_grad():
        xd = training.place_batch({"x": x}, mesh, bundle.batch_sharding,
                                  x.device)["x"]
        y, m = moe.moe_ffn(params, xd, cfg)
        err = (y.full_tensor() - plain).abs().max().item()
        dropped = m["dropped_fraction"].full_tensor().item()
    if not isinstance(y, DTensor) or err > TOL["float32"]:
        fail(f"mesh moe: the mesh forward is {err:.2e} from the plain one "
             f"(tolerance {TOL['float32']})")
    if dropped != plain_dropped:
        fail(f"mesh moe: dropped fraction {dropped} vs plain {plain_dropped}")
    del y, m, xd, plain
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(3):
        params, opt, mm = bundle.step(params, opt, {"x": x, "tgt": tgt})
        losses.append(mm["loss"].item())
    wall = time.perf_counter() - t0
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"mesh moe: loss did not fall: {losses}")
    log(f"[mesh] moe d 768 d_ff 3072 E {MOE_EXPERTS}, {MOE_TOKENS[0]} x "
        f"{MOE_TOKENS[1]} tokens f32: mesh forward {err:.2e} from the plain "
        f"one, dropped fraction {dropped:.4f}; 3 steps {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} in {wall:.2f} s  [{card}]")
    del params, opt, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err_vs_plain": err, "dropped_fraction": dropped,
            "losses": losses, "steps_wall_s": wall,
            "capacity": cfg.capacity(MOE_TOKENS[0] * MOE_TOKENS[1])}


def phase_mesh(torch, np, card, counts, train):
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh, mesh_shape

    if dist.is_initialized():
        fail("mesh: a process group was already started")
    t0 = time.perf_counter()
    mesh = make_mesh(MeshSpec(data=-1), device_type=DEVICE)
    init_s = time.perf_counter() - t0
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if dist.get_backend() != backend or dist.get_world_size() != 1:
        fail(f"mesh: backend {dist.get_backend()} world "
             f"{dist.get_world_size()}, wanted a world-1 {backend} group")
    log(f"[mesh] make_mesh(MeshSpec(data=-1)): {mesh_shape(mesh)} on "
        f"{backend}, world 1, started in {init_s * 1e3:.1f} ms")
    runs = {}
    for policy in ("full", "dots"):
        runs[policy] = _mesh_step_run(torch, np, card, counts, mesh, policy,
                                      train["losses"][:TRAIN_WARMUP])
    ring_err = _mesh_ring(torch, np, mesh)
    log(f"[mesh] ring attention at seq=1, f32 B=2 L={TRAIN_L} H=12 D=64: "
        f"{ring_err:.2e} from reference_attention")
    moe_out = _mesh_moe(torch, np, card, mesh)
    shape = mesh_shape(mesh)
    dist.destroy_process_group()
    from ray_tpu_torch import entry

    fn, args = entry.entry()          # the port's twin of __graft_entry__
    with torch.no_grad():
        logits = fn(*args)
    if (tuple(logits.shape) != (1, 512, 50304) or logits.device.type != DEVICE
            or not torch.isfinite(logits.float()).all()):
        fail(f"entry(): logits {tuple(logits.shape)} on {logits.device}")
    del fn, args, logits
    p6 = train
    log(f"[mesh] phase 6 unsharded beside: {p6['step_ms']:.1f} ms a step, "
        f"{p6['tokens_per_s']:.0f} tokens/s, peak "
        f"{p6['peak_memory_bytes'] / 2**30:.2f} GiB, device busy "
        f"{p6['profile']['device_busy_ms']:.1f} ms; mesh full/dots device "
        f"busy {runs['full']['profile']['device_busy_ms']:.1f}/"
        f"{runs['dots']['profile']['device_busy_ms']:.1f} ms  [{card}]")
    return {"init_ms": init_s * 1e3, "mesh": shape, "runs": runs,
            "ring_max_abs_err": ring_err, "moe": moe_out,
            "launches": {k: runs["full"]["launches"][k]
                         + runs["dots"]["launches"][k]
                         for k in runs["full"]["launches"]}}


# -- phase 8 -----------------------------------------------------------------
def _decode_rate(eng, before):
    """Decode tokens/s of an engine since ``before`` = (tokens, seconds)."""
    return ((eng.decode_tokens - before[0])
            / max(eng.decode_seconds - before[1], 1e-9))


def phase_slotted(torch, np, card, paged_summary):
    """The slotted engine at full width on phase 4's requests, with the
    paged engine's figures beside it; ``device_metrics`` of both engines;
    then greedy identity of the slotted engine, the paged engine on the
    kernel and ``Generator`` at 2 layers in f32. Returns (summary, the warm
    paged engine, its f32 parameters) for phase 9."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import LLMEngine, PagedLLMEngine

    cfg = transformer.gpt2_small()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device=DEVICE)
    slotted = LLMEngine(params, cfg, device=DEVICE, name="slotted")
    slotted.warmup()
    reqs = _requests(np)
    results, wall = _serve(torch, slotted, reqs, "slotted")
    _check_streams(reqs, results, cfg.vocab_size)
    if slotted.stats()["slots_busy"] != 0:
        fail("slotted: a slot is still busy after every request finished")
    summary = _serve_summary(slotted, reqs, results, wall)
    summary["decode_forwards"] = slotted._sg.decode_forwards
    log(f"[slotted] gpt2_small ({cfg.dtype}) slots {slotted.slots} chunk "
        f"{slotted.chunk}: {len(reqs)} requests, {summary['tokens']} tokens "
        f"in {wall:.2f} s: decode {summary['decode_tokens_per_s']:.1f} "
        f"tokens/s (paged, phase 4: "
        f"{paged_summary['decode_tokens_per_s']:.1f}), TTFT median "
        f"{summary['ttft_ms_median']:.1f} ms (paged "
        f"{paged_summary['ttft_ms_median']:.1f}), max "
        f"{summary['ttft_ms_max']:.1f} ms (paged "
        f"{paged_summary['ttft_ms_max']:.1f})  [{card}]")
    paged = PagedLLMEngine(params, cfg, device=DEVICE, name="paged")
    paged.warmup()
    summary["device_metrics"] = {"slotted": slotted.device_metrics(),
                                 "paged": paged.device_metrics()}
    del slotted
    for name, m in summary["device_metrics"].items():
        log(f"[slotted] device_metrics {name:7s}: TTFT "
            f"{m['device_ttft_ms']} ms, decode "
            f"{m['device_decode_tokens_per_sec']} tokens/s (one slot, "
            f"prompt 16, chained chunks)  [{card}]")
    summary["f32_ties"] = _slotted_identity(torch, np)
    return summary, paged, params


def _slotted_identity(torch, np):
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.generate import Generator
    from ray_tpu_torch.serve.llm import LLMEngine, PagedLLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = transformer.gpt2_small(n_layers=2, dtype=torch.float32)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(9),
                                     device=DEVICE)
    slotted = LLMEngine(params, cfg, device=DEVICE, name="f32-slotted")
    paged = PagedLLMEngine(params, cfg, device=DEVICE,
                           attention_kernel="cuda", name="f32-paged")
    oracle = Generator(params, cfg, device=DEVICE)
    rng = np.random.default_rng(9)
    ties = []
    for n in (20, 150, 400, 700):
        p = rng.integers(0, cfg.vocab_size, n).tolist()
        want = oracle.generate(p, max_new_tokens=24)
        ties += _same_greedy(
            torch, oracle.params, cfg, p, want,
            {"slotted": slotted.generate(p, max_new_tokens=24),
             "paged kernel": paged.generate(p, max_new_tokens=24)},
            "slotted")
    log(f"[slotted] 4 greedy requests, gpt2_small widths x 2 layers, f32: "
        f"slotted engine == paged engine on the kernel == Generator"
        + (f" up to {len(ties)} near tie(s)" if ties else ""))
    return ties


# -- phase 9 -----------------------------------------------------------------
SPEC_KS = (3, 4)                      # verify T = 4 (split), 5 (wgmma)
SPEC_FEW = ("prefix-a", "short", "sampled-b", "mid")  # near / miss requests
FORWARDS = ("prefill_forwards", "decode_forwards", "spec_forwards",
            "draft_prefill_forwards", "draft_forwards")


def _spec_drafts(torch, cfg, params, seed):
    """The three drafts, as ``test_spec_decode.py`` builds them: ``aligned``
    the target itself, ``near`` the target + 0.05 × an independent init,
    ``miss`` an independent init at distilgpt2's depth (6 layers; 1 under a
    shallower target), so that its config differs from the target's."""
    from ray_tpu_torch.models import transformer

    def plus(a, b):
        return {k: plus(v, b[k]) if isinstance(v, dict) else v + 0.05 * b[k]
                for k, v in a.items()}

    other = transformer.init_params(
        cfg, torch.Generator().manual_seed(seed + 1), device=DEVICE)
    miss_cfg = cfg.replace(n_layers=6 if cfg.n_layers > 6 else 1)
    return {"aligned": (params, cfg), "near": (plus(params, other), cfg),
            "miss": (transformer.init_params(
                miss_cfg, torch.Generator().manual_seed(seed + 2),
                device=DEVICE), miss_cfg)}


def phase_spec(torch, np, card, counts, plain, params):
    """Speculative decoding on ``gpt2_small`` at full width, bf16: each
    draft at k = 3 (verify on the split K4) and k = 4 (verify on the wgmma
    K4), K4's launches by route against the engine's forwards, blocks
    drained, decode tokens/s beside the plain engine's on the same
    requests; then greedy identity with the plain engine at 2 layers, f32."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve.llm import PagedLLMEngine

    cfg = plain.config
    if pa.paged_route(min(plain.buckets), cfg.dtype) != "wgmma":
        fail("spec: the prefill buckets no longer all take the wgmma K4")
    plain_rates = {}
    for label in ("all", "few"):
        reqs = [r for r in _requests(np)
                if label == "all" or r["name"] in SPEC_FEW]
        before = (plain.decode_tokens, plain.decode_seconds)
        results, wall = _serve(torch, plain, reqs, "spec plain")
        _check_streams(reqs, results, cfg.vocab_size)
        plain_rates[label] = _decode_rate(plain, before)
    runs = []
    for draft, (dp, dc) in _spec_drafts(torch, cfg, params, 0).items():
        label = "all" if draft == "aligned" else "few"
        for k in SPEC_KS:
            eng = PagedLLMEngine(params, cfg, device=DEVICE, draft_params=dp,
                                 draft_config=dc, spec_tokens=k,
                                 name=f"spec-{draft}-{k}")
            eng.warmup()
            reqs = [r for r in _requests(np)
                    if label == "all" or r["name"] in SPEC_FEW]
            # Counts to 0 just before the run, read just after.
            counts.reset()
            st0 = eng.stats()
            results, wall = _serve(torch, eng, reqs, f"spec {draft} k={k}")
            launches = counts.read()
            st1 = eng.stats()
            _check_streams(reqs, results, cfg.vocab_size)
            if eng.kv.active_blocks() != 0:
                fail(f"spec {draft} k={k}: {eng.kv.active_blocks()} blocks "
                     f"still pinned")
            d = {n: int(st1[n] - st0[n]) for n in FORWARDS}
            verify = pa.paged_route(k + 1, cfg.dtype)
            L, Ld = cfg.n_layers, dc.n_layers
            want = {
                "split": L * (d["decode_forwards"] + d["spec_forwards"]
                              * (verify == "split"))
                + Ld * d["draft_forwards"],
                "wgmma": L * (d["prefill_forwards"] + d["spec_forwards"]
                              * (verify == "wgmma"))
                + Ld * d["draft_prefill_forwards"]}
            got = {r: launches[f"paged_attention/{r}"] for r in want}
            if d["spec_forwards"] <= 0 or got != want:
                fail(f"spec {draft} k={k}: K4 launches {got}, wanted {want} "
                     f"from the forwards {d} (target {L} layers, draft "
                     f"{Ld}; verify on {verify})")
            prop = st1["spec_proposed_total"] - st0["spec_proposed_total"]
            ratio = ((st1["spec_accepted_total"] - st0["spec_accepted_total"])
                     / prop if prop else 0.0)
            if draft == "aligned" and ratio < 0.9:
                fail(f"spec aligned k={k}: accept ratio {ratio:.3f} < 0.9")
            rec = _serve_summary(eng, reqs, results, wall)
            rec.update(draft=draft, k=k, draft_layers=Ld, verify_route=verify,
                       accept_ratio=ratio, forwards=d, launches=got,
                       plain_decode_tokens_per_s=plain_rates[label])
            runs.append(rec)
            log(f"[spec] {draft:7s} k={k} ({len(reqs)} requests, draft "
                f"{Ld} layers): decode {rec['decode_tokens_per_s']:.1f} "
                f"tokens/s (plain {plain_rates[label]:.1f}), accept ratio "
                f"{ratio:.3f}; K4 split {got['split']}, wgmma "
                f"{got['wgmma']} = target {L} x (prefill "
                f"{d['prefill_forwards']}, decode {d['decode_forwards']}, "
                f"verify {d['spec_forwards']} on {verify}) + draft {Ld} x "
                f"(prefill {d['draft_prefill_forwards']}, chain "
                f"{d['draft_forwards']})  [{card}]")
            del eng
    return {"runs": runs, "plain_decode_tokens_per_s": plain_rates,
            "f32_ties": _spec_identity(torch, np)}


def _spec_identity(torch, np):
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import PagedLLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = transformer.gpt2_small(n_layers=2, dtype=torch.float32)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(10),
                                     device=DEVICE)
    plain = PagedLLMEngine(params, cfg, device=DEVICE,
                           attention_kernel="cuda", name="f32-plain")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 150, 400)]
    want = [plain.generate(p, max_new_tokens=24) for p in prompts]
    ties = []
    for draft, (dp, dc) in _spec_drafts(torch, cfg, params, 10).items():
        for k in SPEC_KS:
            eng = PagedLLMEngine(params, cfg, device=DEVICE,
                                 attention_kernel="cuda", draft_params=dp,
                                 draft_config=dc, spec_tokens=k,
                                 name=f"f32-spec-{draft}-{k}")
            for p, w in zip(prompts, want):
                ties += _same_greedy(
                    torch, plain.params, cfg, p, w,
                    {f"{draft} k={k}": eng.generate(p, max_new_tokens=24)},
                    "spec")
            if eng.kv.active_blocks() != 0:
                fail(f"spec f32 {draft} k={k}: blocks still pinned")
    log(f"[spec] 3 greedy requests, gpt2_small widths x 2 layers, f32: "
        f"every draft at k = 3 and 4 == the plain engine on the kernel"
        + (f" up to {len(ties)} near tie(s)" if ties else ""))
    return ties


# -- phase 10 ----------------------------------------------------------------
DISAGG_LANE_SLOTS = 4                 # the engine's default lane depth
DISAGG_POOL_BLOCKS = 513              # phase 4's pool: 2 x 4 slots x 64 + 1
HANDOFF_TOKENS = 1024                 # the handoff alone: 64 blocks of 16


def _lane_fits(cfg, block_tokens, max_len, slots):
    """Fail unless /dev/shm has room for the disaggregated engine's lane:
    ``slots`` slots of JAX's capacity formula at this configuration."""
    from ray_tpu_torch.dag import channel
    from ray_tpu_torch.serve.llm import lane_capacity

    cap = lane_capacity(cfg, block_tokens, -(-max_len // block_tokens),
                        cfg.padded_vocab)
    need = channel.shm_footprint(cap, slots)
    total, free = channel.shm_room()
    if need > free:
        fail(f"disagg: the KV handoff lane needs {slots} x {cap} bytes "
             f"({need} in all) of /dev/shm, which has {free} free of "
             f"{total}")
    log(f"[disagg] lane: {slots} slots x {cap} bytes = {need} bytes of "
        f"/dev/shm ({free} free)")
    return cap


def phase_disagg(torch, np, card, counts, paged_summary):
    """Prefill/decode disaggregation on ``gpt2_small`` at full width, bf16:
    phase 4's 8 requests from concurrent threads, K4's launches by route
    against the two engines' forwards, blocks drained, no lane file or
    worker left after ``close()``; the handoff of one 1024-token prompt
    alone; then greedy identity of disaggregated, colocated paged-on-kernel
    and ``Generator`` at 2 layers in f32, with each request's spans and the
    tokens counter."""
    from ray_tpu_torch.dag.channel import SHM_DIR
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import DisaggregatedLLMEngine

    cfg = transformer.gpt2_small()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device=DEVICE)
    _lane_fits(cfg, 16, cfg.max_seq_len, DISAGG_LANE_SLOTS)
    t0 = time.perf_counter()
    # Both halves get phase 4's pool (its auto size at 4 slots): the prefill
    # engine's own auto size (1 slot: 129 blocks) would evict the shared
    # prefix before its second request arrives, with the 8 prompts' 156
    # blocks passing through it.
    eng = DisaggregatedLLMEngine(params, cfg, device=DEVICE, name="disagg",
                                 pool_blocks=DISAGG_POOL_BLOCKS,
                                 lane_slots=DISAGG_LANE_SLOTS)
    del params
    eng.warmup()
    torch.cuda.synchronize()
    lane_file = os.path.join(SHM_DIR, eng.lane.name)
    log(f"[disagg] gpt2_small ({cfg.dtype}) decode slots {eng.slots}, "
        f"prefill slots {eng.prefill.slots}, lane {eng.lane.chan.slots} "
        f"slots; set-up + warmup {time.perf_counter() - t0:.1f} s")
    for half in (eng.prefill, eng.decode):
        if half._pg.attention_kernel != "cuda":
            fail(f"disagg {half.name} resolved attention to "
                 f"{half._pg.attention_kernel!r}")

    reqs = _requests(np)
    halves = {"prefill": eng.prefill, "decode": eng.decode}
    # Where a request's TTFT goes: the workers' two calls, timed on the
    # host clock (each ends in a host copy or a synchronise).
    calls = {"prefill_to_blocks": [], "admit_prefilled": []}
    for half, fn in ((eng.prefill, "prefill_to_blocks"),
                     (eng.decode, "admit_prefilled")):
        setattr(half, fn, _timed_calls(getattr(half, fn), calls[fn]))
    # Counts to 0 just before the run, read just after.
    counts.reset()
    st0 = {h: e.stats() for h, e in halves.items()}
    hit0 = eng.stats()["prefill_kv_hit_tokens"]
    results, wall = _serve(torch, eng, reqs, "disagg")
    launches = counts.read()
    st1 = {h: e.stats() for h, e in halves.items()}
    del eng.prefill.prefill_to_blocks, eng.decode.admit_prefilled
    _check_streams(reqs, results, cfg.vocab_size)
    d = {h: {n: int(st1[h][n] - st0[h][n])
             for n in ("prefill_forwards", "decode_forwards")}
         for h in halves}
    if d["decode"]["prefill_forwards"] or d["prefill"]["decode_forwards"]:
        fail(f"disagg: the decode engine prefilled or the prefill engine "
             f"decoded: {d}")
    L = cfg.n_layers
    want = {"wgmma": L * d["prefill"]["prefill_forwards"],
            "split": L * d["decode"]["decode_forwards"]}
    got = {r: launches[f"paged_attention/{r}"] for r in want}
    if got != want or not all(got.values()):
        fail(f"disagg: K4 launches by route {got}, wanted {want} = "
             f"{L} layers x (prefill engine's prefills, decode engine's "
             f"steps) {d}")
    hits = eng.stats()["prefill_kv_hit_tokens"] - hit0
    cows = (st1["prefill"]["kv_cow_copies"]
            - st0["prefill"]["kv_cow_copies"])
    if hits < 256 or cows < 1:
        fail(f"disagg: prefix paths not exercised on the prefill engine: "
             f"hit tokens {hits}, COW forks {cows}")
    pinned = {h: e.kv.active_blocks() for h, e in halves.items()}
    if any(pinned.values()):
        fail(f"disagg: blocks still pinned after the run: {pinned}")
    summary = _serve_summary(eng, reqs, results, wall)
    worker_ms = {fn: {"calls": len(t), "mean": 1e3 * sum(t) / len(t),
                      "max": 1e3 * max(t), "sum": 1e3 * sum(t)}
                 for fn, t in calls.items()}
    summary.update(forwards=d, launches=got, prefill_kv_hit_tokens=hits,
                   prefill_kv_cow_copies=cows, worker_ms=worker_ms,
                   tokens_per_decode_step=(summary["tokens"]
                                           / d["decode"]["decode_forwards"]))
    log(f"[disagg] {len(reqs)} requests, {summary['tokens']} tokens in "
        f"{wall:.2f} s: decode {summary['decode_tokens_per_s']:.1f} "
        f"tokens/s (colocated, phase 4: "
        f"{paged_summary['decode_tokens_per_s']:.1f}), TTFT median "
        f"{summary['ttft_ms_median']:.1f} ms (colocated "
        f"{paged_summary['ttft_ms_median']:.1f}), max "
        f"{summary['ttft_ms_max']:.1f} ms (colocated "
        f"{paged_summary['ttft_ms_max']:.1f})  [{card}]")
    colo_per_step = (paged_summary["tokens"]
                     / paged_summary["decode_forwards"])
    log(f"[disagg] prefill worker: {len(calls['prefill_to_blocks'])} "
        f"prefill_to_blocks, mean "
        f"{worker_ms['prefill_to_blocks']['mean']:.1f} ms, max "
        f"{worker_ms['prefill_to_blocks']['max']:.1f} ms, "
        f"{worker_ms['prefill_to_blocks']['sum']:.0f} ms in all; ingest "
        f"worker: admit_prefilled (alloc, step lock, insert, synchronise) "
        f"mean {worker_ms['admit_prefilled']['mean']:.1f} ms, max "
        f"{worker_ms['admit_prefilled']['max']:.1f} ms; "
        f"{summary['tokens_per_decode_step']:.2f} tokens a decode step "
        f"(colocated {colo_per_step:.2f})  [{card}]")
    log(f"[disagg] K4 wgmma {got['wgmma']} = {L} x "
        f"{d['prefill']['prefill_forwards']} prefills (prefill engine), "
        f"split {got['split']} = {L} x {d['decode']['decode_forwards']} "
        f"steps (decode engine); prefill-side hit tokens {hits:.0f}, COW "
        f"forks {cows:.0f}; blocks pinned after: 0 and 0")
    summary["handoff"] = _handoff(torch, np, eng, card)

    eng.close()
    eng.close()
    left = [t.name for t in threading.enumerate() if "-disagg-" in t.name]
    if left or os.path.exists(lane_file):
        fail(f"disagg: after close(), threads {left} alive, lane file "
             f"{lane_file} present: {os.path.exists(lane_file)}")
    log("[disagg] close(): no worker thread alive, no lane file in "
        "/dev/shm")
    del eng
    summary["f32_identity"] = _disagg_identity(torch, np)
    return summary


def _timed_calls(fn, into):
    """``fn`` wrapped to append each call's host-clock seconds to ``into``."""
    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            into.append(time.perf_counter() - t0)
    return timed


def _handoff(torch, np, eng, card, reps=5):
    """The handoff of one 1024-token prompt (64 blocks) alone, each step
    timed on the host clock around work that ends in a synchronise, the
    median of ``reps``: the gather on the prefill engine's pool, ``send``
    (the device-to-host copy straight into the lane slot), ``recv`` and the
    insert into the decode pool with its synchronise; beside a pinned
    ``copy_`` of the same bytes each way."""
    from ray_tpu_torch.serve.dag_pipeline import KVHandoffLane

    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 50257, HANDOFF_TOKENS).tolist()
    k, v, last, _ = eng.prefill.prefill_to_blocks(prompt, seed=0)
    nb = int(k.shape[1])
    nbytes = k.nbytes + v.nbytes
    ids = np.arange(1, nb + 1, dtype=np.int32)
    ef = eng.prefill._pg.extract_fn(nb)
    inf = eng.decode._pg.insert_fn(nb)
    lane = KVHandoffLane(capacity=eng.lane.chan.capacity, slots=2)
    dst = eng.decode.kv.alloc(nb)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    flat = torch.cat([k.reshape(-1).view(torch.uint8),
                      v.reshape(-1).view(torch.uint8)])
    times = {n: [] for n in ("extract", "send", "recv", "insert",
                             "pinned_d2h", "pinned_h2d")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    meta = {"prompt": np.asarray(prompt, np.int32), "last_row": last}
    try:
        for _ in range(reps + 1):
            kk, vv = timed("extract", lambda: ef(eng.prefill._k_pool,
                                                 eng.prefill._v_pool, ids))
            timed("send", lambda: lane.send(meta, kk, vv, timeout=10))
            _, rk, rv, token = timed("recv", lambda: lane.recv(timeout=10))
            timed("insert", lambda: inf(eng.decode._k_pool,
                                        eng.decode._v_pool, rk, rv, dst))
            if not (torch.equal(eng.decode._k_pool[:, dst[0]],
                                kk[:, 0]) and torch.equal(
                    eng.decode._v_pool[:, dst[-1]], vv[:, -1])):
                fail("handoff: the decode pool does not hold the extracted "
                     "blocks bit for bit")
            del rk, rv
            lane.ack(token)
            timed("pinned_d2h", lambda: pinned.copy_(flat))
            timed("pinned_h2d", lambda: flat.copy_(pinned))
    finally:
        eng.decode.kv.release(dst)
        lane.destroy()
    ms = {n: sorted(t[1:])[len(t[1:]) // 2] for n, t in times.items()}
    rate = {n: nbytes / (ms[n] * 1e-3) / 1e9 for n in ms}
    out = {"tokens": HANDOFF_TOKENS, "blocks": nb, "bytes": nbytes,
           "ms": ms, "gb_per_s": rate, "reps": reps}
    log(f"[disagg] handoff of {HANDOFF_TOKENS} tokens ({nb} blocks, "
        f"{nbytes} bytes of K+V), median of {reps}: extract (gather on the "
        f"card) {ms['extract']:.3f} ms, send (device to slot) "
        f"{ms['send']:.3f} ms = {rate['send']:.2f} GB/s, recv "
        f"{ms['recv']:.3f} ms, insert + synchronise {ms['insert']:.3f} ms "
        f"= {rate['insert']:.2f} GB/s; pinned copy_ device to host "
        f"{ms['pinned_d2h']:.3f} ms = {rate['pinned_d2h']:.2f} GB/s, host "
        f"to device {ms['pinned_h2d']:.3f} ms = {rate['pinned_h2d']:.2f} "
        f"GB/s  [{card}]")
    return out


def _disagg_identity(torch, np):
    """Greedy identity at 2 layers f32: disaggregated == colocated paged on
    the kernel == ``Generator``, each disaggregated request under a sampled
    root trace context whose spans must be one ``llm.admission_wait``, one
    ``llm.prefill`` and one ``llm.decode_chunk`` per 8-token chunk, all in
    the root's trace; ``serve_tokens_total`` must count the tokens
    delivered."""
    from ray_tpu_torch.core import metrics_export
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.generate import Generator
    from ray_tpu_torch.serve.llm import (DisaggregatedLLMEngine,
                                         PagedLLMEngine)
    from ray_tpu_torch.util import tracing

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = transformer.gpt2_small(n_layers=2, dtype=torch.float32)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(11),
                                     device=DEVICE)
    name = "f32-disagg"
    disagg = DisaggregatedLLMEngine(params, cfg, device=DEVICE, name=name)
    paged = PagedLLMEngine(params, cfg, device=DEVICE,
                           attention_kernel="cuda", name="f32-colocated")
    oracle = Generator(params, cfg, device=DEVICE)
    tokens_ctr = metrics_export.serve_tokens_total()
    tok0 = tokens_ctr.get({"deployment": name})
    rng = np.random.default_rng(11)
    ties, delivered, n_new = [], 0, 24
    try:
        for n in (20, 150, 400, 700):
            p = rng.integers(0, cfg.vocab_size, n).tolist()
            want = oracle.generate(p, max_new_tokens=n_new)
            spans = []
            tracing.set_sink(spans.append)
            root = tracing.new_root_context()
            tracing.set_context(root)
            try:
                got = disagg.generate(p, max_new_tokens=n_new)
            finally:
                tracing.set_context(None)
                tracing.set_sink(None)
            delivered += len(got)
            names = {}
            for s in spans:
                if s["trace_id"] != root[0]:
                    fail(f"disagg f32: a span of another trace: {s}")
                names[s["name"]] = names.get(s["name"], 0) + 1
            steps = -(-n_new // disagg.chunk)
            if names != {"llm.admission_wait": 1, "llm.prefill": 1,
                         "llm.decode_chunk": steps}:
                fail(f"disagg f32: prompt of {n} tokens gave spans {names}, "
                     f"wanted 1 admission_wait, 1 prefill and {steps} "
                     f"decode_chunk")
            ties += _same_greedy(
                torch, oracle.params, cfg, p, want,
                {"disaggregated": got,
                 "colocated kernel": paged.generate(p, max_new_tokens=n_new)},
                "disagg")
        counted = tokens_ctr.get({"deployment": name}) - tok0
        if counted != delivered:
            fail(f"disagg f32: serve_tokens_total counted {counted}, "
                 f"{delivered} delivered")
        pinned = (disagg.decode.kv.active_blocks(),
                  disagg.prefill.kv.active_blocks())
        if any(pinned):
            fail(f"disagg f32: blocks still pinned: {pinned}")
    finally:
        disagg.close()
    log(f"[disagg] 4 greedy requests, gpt2_small widths x 2 layers, f32: "
        f"disaggregated == colocated paged on the kernel == Generator"
        + (f" up to {len(ties)} near tie(s)" if ties else "")
        + f"; spans as the steps imply, serve_tokens_total {delivered}")
    return ties


# -- phase 11 ----------------------------------------------------------------
RUNTIME_NOOP_CALLS = 200              # round trips timed for the per-call cost
RUNTIME_KV_TOKENS = 1024              # phase 10's handoff prompt: 64 blocks


def _process_age_s():
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


class _EngineActor:
    """The paged engine hosted in an actor: built from ``cfg`` and a weight
    seed on the card and warmed, answering ``.remote()`` calls from the
    actor's threads (the engine's request threads)."""

    def __init__(self, cfg, seed, name, **kw):
        t0 = time.perf_counter()
        age = _process_age_s()
        import torch
        from ray_tpu_torch.models import transformer
        from ray_tpu_torch.serve.llm import PagedLLMEngine

        t1 = time.perf_counter()
        if DEVICE == "cuda":
            torch.cuda.init()
        t2 = time.perf_counter()
        params = transformer.init_params(
            cfg, torch.Generator().manual_seed(seed), device=DEVICE)
        t3 = time.perf_counter()
        self.eng = PagedLLMEngine(params, cfg, device=DEVICE, name=name,
                                  **kw)
        t4 = time.perf_counter()
        self.eng.warmup()
        # Where a cold process's set-up goes (a warm one imports nothing).
        self.setup_s = {"process_age": age, "init_at": time.time() - (
                            time.perf_counter() - t0), "imports": t1 - t0,
                        "cuda_init": t2 - t1,
                        "params": t3 - t2, "engine": t4 - t3,
                        "warmup": time.perf_counter() - t4}

    def stream(self, prompt, max_new_tokens, temperature, seed):
        """The request's tokens, then its result dict (TTFT, finish)."""
        out = {}
        yield from self.eng.stream(prompt, max_new_tokens=max_new_tokens,
                                   temperature=temperature, seed=seed,
                                   result=out)
        yield out

    def generate(self, prompt, max_new_tokens):
        return self.eng.generate(prompt, max_new_tokens=max_new_tokens)

    def generate_whole(self, prompt, max_new_tokens, temperature, seed):
        """The request's tokens and result dict in one return."""
        out = {}
        toks = list(self.eng.stream(prompt, max_new_tokens=max_new_tokens,
                                    temperature=temperature, seed=seed,
                                    result=out))
        return toks, out

    def info(self):
        from ray_tpu_torch.models import transformer

        e = self.eng
        return {"attention_kernel": e._pg.attention_kernel,
                "engine": type(e).__name__,
                "device": str(e.device), "slots": e.slots, "chunk": e.chunk,
                "pool_blocks": e.kv.num_blocks,
                "params": transformer.param_count(e.params),
                "kv_tier": getattr(e, "_tier", None) is not None,
                "pid": os.getpid(), "setup_s": self.setup_s}

    def stats(self):
        return self.eng.stats()

    # -- phase 14's reads and levers (the KV tier) ---------------------------
    def instrument(self):
        """From now on record each prefill's bucket (the T of its K4
        prefill), each scheduler step's wall time, with the blocks its
        ``_post_step`` spilled and how long that took, and each tier
        fetch's (and its publisher ping's) and insert's wall time."""
        eng = self.eng
        self.buckets, self.steps, self._post = [], [], (0, 0.0)
        self.fetches, self.inserts, self.pings = [], [], []
        prefill_fn, step, post_step = (eng._pg.prefill_fn, eng._step,
                                       eng._post_step)
        fetch, insert = eng._tier.fetch, eng._tier_insert_blocks
        backend = eng._tier._resolve()
        alive = backend._publisher_alive

        def timed_alive(*args):
            t0 = time.perf_counter()
            try:
                return alive(*args)
            finally:
                self.pings.append(time.perf_counter() - t0)

        def recorded_prefill_fn(bucket):
            self.buckets.append(int(bucket))
            return prefill_fn(bucket)

        def timed_fetch(*args):
            t0 = time.perf_counter()
            try:
                return fetch(*args)
            finally:
                self.fetches.append(time.perf_counter() - t0)

        def timed_insert(*args):
            t0 = time.perf_counter()
            try:
                return insert(*args)
            finally:
                self.inserts.append(time.perf_counter() - t0)

        def timed_post_step():
            spilled = sum(entry[2] for entry in eng._tier_spill_q)
            t0 = time.perf_counter()
            post_step()
            self._post = (spilled, time.perf_counter() - t0)

        def timed_step():
            self._post = (0, 0.0)
            t0 = time.perf_counter()
            try:
                step()
            finally:
                self.steps.append((time.perf_counter() - t0, *self._post))

        eng._pg.prefill_fn = recorded_prefill_fn
        eng._post_step = timed_post_step
        eng._step = timed_step
        eng._tier.fetch = timed_fetch
        eng._tier_insert_blocks = timed_insert
        backend._publisher_alive = timed_alive

    def records(self):
        """What was recorded since the last call: prefill buckets, steps
        (seconds, blocks spilled, seconds of the spill), and the seconds of
        each tier fetch, of the publisher ping inside it, and of each
        insert."""
        out = {"buckets": self.buckets, "steps": self.steps,
               "fetches": self.fetches, "inserts": self.inserts,
               "pings": self.pings}
        self.buckets, self.steps = [], []
        self.fetches, self.inserts, self.pings = [], [], []
        return out

    def clear_local(self):
        """Drop the engine's local prefix cache (a fresh pool)."""
        with self.eng._step_lock:
            self.eng._reset_device_state()

    def set_min_spill(self, blocks):
        self.eng._tier_min_spill = int(blocks)

    def pinned_payload_digest(self, head_hex):
        """sha256 of the K/V of the payload this process published under
        ``head_hex``, read through the pin its tier client holds."""
        import ray_tpu_torch as rt

        ref = self.eng._tier._backend._pins[bytes.fromhex(head_hex)]
        payload = rt.get(ref, timeout=60)
        return _kv_bytes(payload["k"], payload["v"])

    def kv_migrate_in(self, lane):
        return self.eng.kv_migrate_in(lane)

    def kv_migrate_out(self, lane):
        return self.eng.kv_migrate_out(lane)

    def launches(self):
        """The kernels' launch counters as this actor reads them."""
        return Counts().read()

    def reset_launches(self):
        """The kernels' launch counters of this actor's process set to 0."""
        Counts().reset()

    def decode_counters(self):
        return self.eng.decode_tokens, self.eng.decode_seconds

    def active_blocks(self):
        return self.eng.kv.active_blocks()

    def flush_metrics(self):
        """Export this process's metrics to the GCS now, not at the next
        tick."""
        from ray_tpu_torch.core.runtime import get_runtime

        get_runtime()._metrics_exporter.flush()

    def noop(self):
        return None


class _ActorStreams:
    """``eng.stream`` over an ``_EngineActor``: ``_serve`` drives it as it
    drives an engine. Each call is one streaming ``.remote()`` whose tokens
    come back through ``get`` as the actor yields them, or, with
    ``whole=True``, one ``.remote()`` returning the request's tokens at
    its end."""

    def __init__(self, rt, actor, whole=False):
        self.rt, self.actor, self.whole = rt, actor, whole
        self.first_token_s = {}

    def stream(self, prompt, *, max_new_tokens, temperature, seed, result):
        t0 = time.perf_counter()
        if self.whole:
            toks, out = self.rt.get(self.actor.generate_whole.remote(
                prompt, max_new_tokens, temperature, seed), timeout=600)
            result.update(out)
            self.first_token_s[id(result)] = time.perf_counter() - t0
            yield from toks
            return
        gen = self.actor.stream.options(num_returns="streaming").remote(
            prompt, max_new_tokens, temperature, seed)
        for ref in gen:
            item = self.rt.get(ref, timeout=600)
            if isinstance(item, dict):
                result.update(item)
                continue
            self.first_token_s.setdefault(id(result),
                                          time.perf_counter() - t0)
            yield item


def _noop_round_trip_us(rt, actor):
    """Mean µs of ``get(actor.noop.remote())``, one call at a time."""
    rt.get(actor.noop.remote())
    t0 = time.perf_counter()
    for _ in range(RUNTIME_NOOP_CALLS):
        rt.get(actor.noop.remote())
    return 1e6 * (time.perf_counter() - t0) / RUNTIME_NOOP_CALLS


def _kv_gather(eng, prompt, keep):
    """A task on the card: the prefill of ``prompt`` into ``eng``'s pool and
    the gather of its blocks (phase 10's handoff gather), returned as two
    bf16 tensors on the card. ``keep`` (an in-process argument, passed by
    reference) holds the same tensors for the bit-for-bit check."""
    k, v, _, _ = eng.prefill_to_blocks(prompt, seed=0)
    keep["kv"] = (k, v)
    return k, v


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def phase_runtime(torch, np, card, kind, count, counts, paged_summary):
    """The in-process core runtime on the card: ``init()`` registers the
    card; phase 4's engine and requests through a ``num_gpus=1`` actor;
    a pending and an infeasible ``GPU`` request; the 2-layer f32 identity
    through an actor; the K/V gather through a task and the object plane;
    a placement group hosting an engine actor; the tokens counter through
    the exporter; and nothing left after ``shutdown()``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.accelerators import gpu_model
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.devtools import jitcheck
    from ray_tpu_torch.models import transformer

    pid = os.getpid()
    rt.init()
    res = rt.cluster_resources()
    marker = f"GPU-{gpu_model(kind)}"
    if (res.get("GPU") != float(count) or res.get(marker) != float(count)
            or "TPU" in res or any(k.startswith("TPU") for k in res)):
        fail(f"runtime: init() registered {res}, wanted GPU and {marker} "
             f"at {count} and no TPU")
    store = get_runtime().store
    if store._native is None:
        fail("runtime: the shared-memory arena did not build (g++)")
    log(f"[runtime] init(): GPU {res['GPU']:.0f}, {marker} "
        f"{res[marker]:.0f}, CPU {res['CPU']:.0f}; arena "
        f"{store._native.name} ({store._native.capacity()} bytes)")
    jitcheck.install()
    jitcheck.clear_violations()
    summary = {"resources": res}

    # The engine actor on phase 4's requests.
    cfg = transformer.gpt2_small()
    name = "runtime-actor"
    engine_actor = rt.remote(num_gpus=1, max_concurrency=8)(_EngineActor)
    t0 = time.perf_counter()
    a = engine_actor.remote(cfg, 0, name)
    info = rt.get(a.info.remote(), timeout=600)
    log(f"[runtime] engine actor (num_gpus=1, max_concurrency=8): "
        f"gpt2_small ({info['params']} params, {cfg.dtype}) on "
        f"{info['device']}, attention {info['attention_kernel']}; set-up + "
        f"warmup {time.perf_counter() - t0:.1f} s")
    if info["attention_kernel"] != "cuda":
        fail(f"runtime: the actor's engine resolved attention to "
             f"{info['attention_kernel']!r}")
    if rt.available_resources().get("GPU", 0) != float(count) - 1:
        fail(f"runtime: the engine actor does not hold its card: "
             f"{rt.available_resources()}")
    reqs = _requests(np)
    proxy = _ActorStreams(rt, a)
    st0 = rt.get(a.stats.remote())
    dec0 = rt.get(a.decode_counters.remote())
    counts.reset()
    results, wall = _serve(torch, proxy, reqs, "runtime")
    launches = rt.get(a.launches.remote())
    st1 = rt.get(a.stats.remote())
    dec1 = rt.get(a.decode_counters.remote())
    _check_streams(reqs, results, cfg.vocab_size)
    d_pref = int(st1["prefill_forwards"] - st0["prefill_forwards"])
    d_dec = int(st1["decode_forwards"] - st0["decode_forwards"])
    L = cfg.n_layers
    want = {"wgmma": L * d_pref, "split": L * d_dec}
    got = {r: launches[f"paged_attention/{r}"] for r in want}
    if got != want or not all(got.values()):
        fail(f"runtime: K4 launches by route {got}, wanted {want} = {L} "
             f"layers x (prefills {d_pref}, decode steps {d_dec})")
    pinned = rt.get(a.active_blocks.remote())
    if pinned:
        fail(f"runtime: {pinned} blocks still pinned after the run")
    rate = (dec1[0] - dec0[0]) / (dec1[1] - dec0[1])
    summary.update(_serve_summary(None, reqs, results, wall, rate=rate))
    summary.update(prefill_forwards=d_pref, decode_forwards=d_dec,
                   launches=got)
    first = sorted(1e3 * v for v in proxy.first_token_s.values())
    summary["client_first_token_ms_median"] = first[len(first) // 2]
    summary["noop_round_trip_us"] = _noop_round_trip_us(rt, a)
    log(f"[runtime] {len(reqs)} requests as streaming .remote() calls, "
        f"{summary['tokens']} tokens in {wall:.2f} s: decode {rate:.1f} "
        f"tokens/s (direct engine, phase 4: "
        f"{paged_summary['decode_tokens_per_s']:.1f}), TTFT median "
        f"{summary['ttft_ms_median']:.1f} ms (phase 4 "
        f"{paged_summary['ttft_ms_median']:.1f}), max "
        f"{summary['ttft_ms_max']:.1f} ms (phase 4 "
        f"{paged_summary['ttft_ms_max']:.1f}); first token at the caller "
        f"median {summary['client_first_token_ms_median']:.1f} ms; a no-op "
        f"actor method's round trip {summary['noop_round_trip_us']:.1f} us "
        f"(mean of {RUNTIME_NOOP_CALLS})  [{card}]")
    log(f"[runtime] K4 wgmma {got['wgmma']} = {L} x {d_pref} prefills, "
        f"split {got['split']} = {L} x {d_dec} decode steps (read from the "
        f"actor); blocks pinned after: 0")
    # The same requests again as whole-request calls (one .remote() and
    # one get a request): what per-token streaming costs the engine.
    whole_reqs = _requests(np)
    results_w, wall_w = _serve(torch, _ActorStreams(rt, a, whole=True),
                               whole_reqs, "runtime whole")
    dec2 = rt.get(a.decode_counters.remote())
    _check_streams(whole_reqs, results_w, cfg.vocab_size)
    rate_w = (dec2[0] - dec1[0]) / (dec2[1] - dec1[1])
    summary["whole_request"] = _serve_summary(None, whole_reqs, results_w,
                                              wall_w, rate=rate_w)
    log(f"[runtime] the same requests as whole-request calls: "
        f"{summary['whole_request']['tokens']} tokens in {wall_w:.2f} s, "
        f"decode {rate_w:.1f} tokens/s (streamed {rate:.1f})  [{card}]")

    # The tokens counter, through the exporter into the GCS aggregator.
    delivered = sum(len(res[r["name"]]["tokens"]) for res in
                    (results, results_w) for r in reqs)
    get_runtime()._metrics_exporter.flush()
    counted = [float(ln.rsplit(" ", 1)[1])
               for ln in get_runtime().gcs.metrics_text().splitlines()
               if ln.startswith("ray_tpu_serve_tokens_total{")
               and f'deployment="{name}"' in ln]
    if counted != [delivered]:
        fail(f"runtime: serve_tokens_total in the GCS aggregator "
             f"{counted}, {delivered} tokens delivered")
    log(f"[runtime] serve_tokens_total through the exporter into the GCS "
        f"aggregator: {delivered:.0f} = tokens delivered")

    # A second num_gpus=1 actor pends while the first holds the card, and
    # runs after kill(); it carries the 2-layer f32 identity.
    f32 = transformer.gpt2_small(n_layers=2, dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    b = rt.remote(num_gpus=1)(_EngineActor).remote(f32, 13, "runtime-f32")
    b_info = b.info.remote()
    ready, _ = rt.wait([b_info], timeout=2.0)
    state = get_runtime().gcs.get_actor(b.actor_id).state
    if ready or state != "PENDING":
        fail(f"runtime: a second num_gpus=1 actor ran while the first held "
             f"the card (state {state})")
    rt.kill(a)
    rt.get(b_info, timeout=600)
    log("[runtime] a second num_gpus=1 actor stayed PENDING while the "
        "engine actor held the card and came up after kill()")
    summary["noop_round_trip_us_one_thread"] = _noop_round_trip_us(rt, b)
    log(f"[runtime] a no-op method's round trip on a one-thread actor "
        f"{summary['noop_round_trip_us_one_thread']:.1f} us (eight "
        f"threads: {summary['noop_round_trip_us']:.1f})  [{card}]")
    summary["f32_identity"] = _runtime_identity(torch, np, rt, b, f32)
    rt.kill(b)

    for what in ("task", "actor"):
        try:
            if what == "task":
                rt.get(rt.remote(num_gpus=2)(_median).remote([1]),
                       timeout=60)
            else:
                c = rt.remote(num_gpus=2)(_EngineActor).remote(f32, 13, "x")
                rt.get(c.noop.remote(), timeout=60)
        except (RuntimeError, rt.ActorDiedError) as e:
            if "no feasible node" not in str(e):
                fail(f"runtime: num_gpus=2 {what} failed otherwise: {e}")
        else:
            fail(f"runtime: a num_gpus=2 {what} ran on {count} card(s)")
    log("[runtime] num_gpus=2 task and actor: no feasible node")

    summary["object_plane"] = _runtime_object_plane(torch, np, rt, card)

    pg = rt.placement_group([{"GPU": 1, "CPU": 1}], strategy="STRICT_PACK")
    if not pg.ready(timeout=60):
        fail("runtime: the placement group {GPU: 1, CPU: 1} is not ready")
    strategy = rt.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)
    c = rt.remote(num_gpus=1)(_EngineActor).options(
        scheduling_strategy=strategy).remote(f32, 13, "runtime-pg")
    prompt = summary["f32_identity"]["first_prompt"]
    got_pg = rt.get(c.generate.remote(prompt, 24), timeout=600)
    if got_pg != summary["f32_identity"]["first_want_actor"]:
        fail("runtime: the engine actor in the placement group gave "
             "another stream than the actor outside it")
    rt.kill(c)
    rt.remove_placement_group(pg)
    log("[runtime] placement group [{GPU: 1, CPU: 1}] ready; an engine "
        "actor in its bundle gave the same greedy stream")

    violations = jitcheck.violations()
    jitcheck.uninstall()
    if violations:
        fail(f"runtime: steady-state violations on the card: {violations}")
    log("[runtime] steady-state guard: no implicit device-to-host read and "
        "no kernel build in any warm engine step")

    rt.shutdown()
    for t in threading.enumerate():
        if t.name.startswith(("actor-", "metrics-export-")):
            t.join(timeout=30)
    threads = [t.name for t in threading.enumerate()
               if t.name.startswith(("actor-", "metrics-export-"))]
    arenas = [n for n in os.listdir("/dev/shm")
              if n.startswith(f"rtpu_store_{pid}_")]
    if threads or arenas:
        fail(f"runtime: after shutdown(), threads {threads} and arenas "
             f"{arenas} are left")
    log("[runtime] shutdown(): no actor or exporter thread, no arena of "
        "this process in /dev/shm")
    return summary


def _runtime_identity(torch, np, rt, actor, cfg):
    """Greedy identity at 2 layers f32: streams through the actor == a
    direct engine on the kernel == ``Generator``, the same weights."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.generate import Generator
    from ray_tpu_torch.serve.llm import PagedLLMEngine

    params = transformer.init_params(cfg, torch.Generator().manual_seed(13),
                                     device=DEVICE)
    direct = PagedLLMEngine(params, cfg, device=DEVICE,
                            attention_kernel="cuda", name="runtime-direct")
    oracle = Generator(params, cfg, device=DEVICE)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 150, 400, 700)]
    through = rt.get([actor.generate.remote(p, 24) for p in prompts],
                     timeout=600)
    ties = []
    for p, got in zip(prompts, through):
        want = oracle.generate(p, max_new_tokens=24)
        ties += _same_greedy(
            torch, oracle.params, cfg, p, want,
            {"actor": got,
             "direct kernel": direct.generate(p, max_new_tokens=24)},
            "runtime")
    log(f"[runtime] 4 greedy requests, gpt2_small widths x 2 layers, f32: "
        f"through the actor == direct paged engine on the kernel == "
        f"Generator" + (f" up to {len(ties)} near tie(s)" if ties else ""))
    return {"ties": ties, "first_prompt": prompts[0],
            "first_want_actor": through[0]}


def _runtime_object_plane(torch, np, rt, card, reps=5):
    """Phase 10's 1024-token K/V gather returned by a ``num_gpus=1`` task:
    ``get`` gives the same bytes back as CPU tensors; then ``put`` and
    ``get`` of those bf16 tensors on the card timed (the bytes in the
    shared-memory arena) beside a pinned ``copy_`` of the same bytes."""
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import PagedLLMEngine

    cfg = transformer.gpt2_small()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device=DEVICE)
    eng = PagedLLMEngine(params, cfg, device=DEVICE, name="runtime-kv")
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, RUNTIME_KV_TOKENS).tolist()
    keep = {}
    ref = rt.remote(num_gpus=1)(_kv_gather).remote(eng, prompt, keep)
    k_host, v_host = rt.get(ref, timeout=600)
    k, v = keep["kv"]
    nbytes = k.nbytes + v.nbytes
    if not (k.device.type == torch.device(DEVICE).type
            and k.dtype == torch.bfloat16):
        fail(f"runtime: the gather is not bf16 on the card: {k.dtype} "
             f"{k.device}")
    if not (k_host.device.type == "cpu" and k_host.dtype == torch.bfloat16
            and torch.equal(k_host.view(torch.int16),
                            k.cpu().view(torch.int16))
            and torch.equal(v_host.view(torch.int16),
                            v.cpu().view(torch.int16))):
        fail("runtime: get of the task's K/V is not the gather bit for bit")
    if not get_runtime().store._objects[ref.id].shm_keys:
        fail("runtime: the task's K/V did not go to the shm arena")
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    flat = torch.cat([k.reshape(-1).view(torch.uint8),
                      v.reshape(-1).view(torch.uint8)])
    times = {"put": [], "get": [], "pinned_d2h": []}
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = rt.put((k, v))
        t1 = time.perf_counter()
        kk, vv = rt.get(r)
        t2 = time.perf_counter()
        pinned.copy_(flat)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        times["put"].append((t1 - t0) * 1e3)
        times["get"].append((t2 - t1) * 1e3)
        times["pinned_d2h"].append((t3 - t2) * 1e3)
        if not torch.equal(kk.view(torch.int16), k_host.view(torch.int16)):
            fail("runtime: put/get of the K/V is not bit for bit")
        del r, kk, vv
    ms = {n: _median(t[1:]) for n, t in times.items()}
    rate = {n: nbytes / (ms[n] * 1e-3) / 1e9 for n in ms}
    log(f"[runtime] a num_gpus=1 task returned the {RUNTIME_KV_TOKENS}-token "
        f"K/V gather ({nbytes} bytes, bf16, on the card); get gave the same "
        f"bytes as CPU tensors. Median of {reps}: put (device to host + "
        f"arena) {ms['put']:.2f} ms = {rate['put']:.2f} GB/s, get "
        f"{ms['get']:.2f} ms = {rate['get']:.2f} GB/s; pinned copy_ device "
        f"to host {ms['pinned_d2h']:.2f} ms = {rate['pinned_d2h']:.2f} "
        f"GB/s  [{card}]")
    return {"bytes": nbytes, "ms": ms, "gb_per_s": rate, "reps": reps}


# -- phase 12 ----------------------------------------------------------------
SERVE_NOOP_CALLS = 200                # handle round trips timed for Serve's cost
SERVE_TWO_SLOTS = 8                   # slots a replica of the two-replica run


class _HandleStreams:
    """``eng.stream`` over a Serve ``DeploymentHandle`` of
    ``llm_deployment``: ``_serve`` drives it as it drives an engine. Each
    call is one streaming ``.remote()``; its items must keep the deployment's
    contract (``token``, ``index`` from 0 up, ``decode_tps``; ``finish_reason``
    and ``ttft_s`` on the last item only). ``result`` also gets the key of
    the replica the router picked."""

    def __init__(self, handle):
        self.handle = handle

    def stream(self, prompt, *, max_new_tokens, temperature, seed, result):
        gen = self.handle.options(stream=True).remote(
            {"prompt_ids": prompt, "max_new_tokens": max_new_tokens,
             "temperature": temperature, "seed": seed})
        result["replica"] = gen._replica_key
        last = None
        for i, item in enumerate(gen):
            if last is not None and ({"finish_reason", "ttft_s"} & set(last)):
                fail(f"serve: item {i - 1} of {i}+ carries "
                     f"{sorted(last)}: only the last item may")
            if item.get("index") != i or not {"token", "decode_tps"} <= \
                    set(item):
                fail(f"serve: item {i} of a stream is {item}")
            last = item
            yield item["token"]
        if last is None or not {"finish_reason", "ttft_s"} <= set(last):
            fail(f"serve: a stream's last item is {last}")
        result.update(finish_reason=last["finish_reason"],
                      ttft_s=last["ttft_s"], decode_tps=last["decode_tps"])


def _replica_actors():
    """(actor id, GCS info) of every Serve replica actor the runtime made."""
    from ray_tpu_torch.core.runtime import get_runtime

    r = get_runtime()
    return [(a, r.gcs.get_actor(a)) for a, run in list(r.actors.items())
            if run.creation_spec.function_name == "ReplicaActor"]


def _fail_on_dead_replicas(what):
    """A replica that died other than by ``kill`` (its constructor raised: a
    CUDA error, out of memory, a kernel build) fails the run with its own
    error — serve.run would only time out."""
    dead = [info.death_cause for _a, info in _replica_actors()
            if info is not None and info.state == "DEAD"
            and "killed via kill()" not in (info.death_cause or "")]
    if dead:
        fail(f"serve: {what}: a replica died: {dead[0]}")


def _serve_up(rt_mod, serve, app, name, n, **run_kw):
    """``serve.run(app)``, then wait until ``n`` replicas of ``name`` are up
    (ALIVE); returns (handle, replica actor handles, their engines)."""
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.serve.controller import get_or_create_controller

    try:
        handle = serve.run(app, **run_kw)
    except TimeoutError as e:
        _fail_on_dead_replicas(f"serve.run({name})")
        fail(f"serve: serve.run({name}) timed out: {e}")
    ctrl = get_or_create_controller()
    deadline = time.monotonic() + 600
    while True:
        _fail_on_dead_replicas(name)
        _v, table = rt_mod.get(ctrl.get_snapshot.remote(-1, 0.0))
        reps = table.get(name, {}).get("replicas", [])
        states = [get_runtime().gcs.get_actor(r.actor_id).state
                  for r in reps]
        if len(reps) == n and states == ["ALIVE"] * n:
            break
        if time.monotonic() > deadline:
            fail(f"serve: {name}: replicas {states} after 600 s")
        time.sleep(0.05)
    engines = [get_runtime().actors[r.actor_id].instance._callable.engine
               for r in reps]
    return handle, reps, engines


def _retire(rt_mod, serve, name, count):
    """Delete deployment ``name`` and wait until its replicas have given
    the card back."""
    serve.delete(name)
    deadline = time.monotonic() + 120
    while rt_mod.available_resources().get("GPU", 0) != float(count):
        if time.monotonic() > deadline:
            fail(f"serve: {name}'s replicas still hold the card after "
                 f"delete: {rt_mod.available_resources()}")
        time.sleep(0.05)


def _doubled_requests(np):
    """Phase 4's 8 requests twice over: the second copy's names end in
    ``#2`` and its waits point at the second copy."""
    out = _requests(np)
    for r in _requests(np):
        r["name"] += "#2"
        if "after" in r:
            base, event = r["after"].split(":")
            r["after"] = f"{base}#2:{event}"
        if r.get("extends"):
            r["extends"] += "#2"
        out.append(r)
    return out


def _k4_by_route(cfg, stats0, stats1):
    """What K4's launches must be: n_layers x the replicas' prefills on the
    wgmma route and x their decode steps on the split route, summed."""
    d_pref = sum(int(b["prefill_forwards"] - a["prefill_forwards"])
                 for a, b in zip(stats0, stats1))
    d_dec = sum(int(b["decode_forwards"] - a["decode_forwards"])
                for a, b in zip(stats0, stats1))
    return d_pref, d_dec, {"wgmma": cfg.n_layers * d_pref,
                           "split": cfg.n_layers * d_dec}


def phase_serve(torch, np, card, count, counts, paged_summary,
                runtime_summary):
    """The Serve stack on the card: ``serve.run(llm_deployment(...))`` of
    ``gpt2_small`` at full width with ``num_gpus=1``; phase 4's requests
    through streaming handles with K4 counted by route; two ``num_gpus=0.5``
    replicas on the one card with prefix affinity and a third pending; the
    2-layer f32 identity through a deployment; a no-op deployment's round
    trip; the HTTP leg where aiohttp imports; nothing left after
    ``serve.shutdown()`` and ``shutdown()``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.controller import get_or_create_controller
    from ray_tpu_torch.serve.llm import llm_deployment

    pid = os.getpid()
    threads_before = set(threading.enumerate())
    rt.init()
    if rt.cluster_resources().get("GPU") != float(count):
        fail(f"serve: init() registered {rt.cluster_resources()}")
    summary = {}
    cfg = transformer.gpt2_small()
    L = cfg.n_layers

    def params_fn():
        return transformer.init_params(
            cfg, torch.Generator().manual_seed(0), device=DEVICE)

    # One replica, the whole card, engine defaults.
    t0 = time.perf_counter()
    handle, reps, (eng,) = _serve_up(
        rt, serve, llm_deployment(cfg, params_fn, name="serve-1",
                                  ray_actor_options={"num_gpus": 1}).bind(),
        "serve-1", 1)
    if (type(eng).__name__ != "PagedLLMEngine"
            or eng._pg.attention_kernel != "cuda"
            or eng.device.type != torch.device(DEVICE).type):
        fail(f"serve: the replica's engine is {type(eng).__name__} on "
             f"{eng.device}, attention {eng._pg.attention_kernel!r}")
    if rt.available_resources().get("GPU", 0) != float(count) - 1:
        fail(f"serve: the replica does not hold its card: "
             f"{rt.available_resources()}")
    log(f"[serve] serve.run(llm_deployment(gpt2_small, num_gpus=1)): "
        f"{type(eng).__name__} on {eng.device}, attention "
        f"{eng._pg.attention_kernel}, slots {eng.slots}, pool "
        f"{eng.kv.num_blocks} blocks; up in {time.perf_counter() - t0:.1f} s")
    reqs = _requests(np)
    st0 = [rt.get(r.get_metrics.remote()) for r in reps]
    dec0 = (eng.decode_tokens, eng.decode_seconds)
    counts.reset()
    results, wall = _serve(torch, _HandleStreams(handle), reqs, "serve")
    launches = counts.read()
    st1 = [rt.get(r.get_metrics.remote()) for r in reps]
    _check_streams(reqs, results, cfg.vocab_size)
    d_pref, d_dec, want = _k4_by_route(cfg, st0, st1)
    got = {r: launches[f"paged_attention/{r}"] for r in want}
    if got != want or not all(got.values()):
        fail(f"serve: K4 launches by route {got}, wanted {want} = {L} "
             f"layers x (prefills {d_pref}, decode steps {d_dec})")
    if st1[0]["kv_blocks_active"] != 0:
        fail(f"serve: {st1[0]['kv_blocks_active']:.0f} blocks pinned after "
             f"the run")
    one = _serve_summary(None, reqs, results, wall,
                         rate=_decode_rate(eng, dec0))
    one.update(prefill_forwards=d_pref, decode_forwards=d_dec,
               launches=got)
    summary["one_replica"] = one
    log(f"[serve] {len(reqs)} requests through streaming handles, "
        f"{one['tokens']} tokens in {wall:.2f} s: decode "
        f"{one['decode_tokens_per_s']:.1f} tokens/s (engine alone, phase 4: "
        f"{paged_summary['decode_tokens_per_s']:.1f}), TTFT median "
        f"{one['ttft_ms_median']:.1f} ms (phase 4 "
        f"{paged_summary['ttft_ms_median']:.1f}), max "
        f"{one['ttft_ms_max']:.1f} ms (phase 4 "
        f"{paged_summary['ttft_ms_max']:.1f})  [{card}]")
    log(f"[serve] K4 wgmma {got['wgmma']} = {L} x {d_pref} prefills, split "
        f"{got['split']} = {L} x {d_dec} decode steps (get_engine_stats); "
        f"blocks pinned after: 0")
    del eng
    _retire(rt, serve, "serve-1", count)

    # Two replicas of half a card each, one interpreter.
    t0 = time.perf_counter()
    handle2, reps2, engs = _serve_up(
        rt, serve, llm_deployment(
            cfg, params_fn, name="serve-2", slots=SERVE_TWO_SLOTS,
            num_replicas=2, ray_actor_options={"num_gpus": 0.5}).bind(),
        "serve-2", 2)
    log(f"[serve] two replicas of num_gpus=0.5 ({SERVE_TWO_SLOTS} slots "
        f"each) up in {time.perf_counter() - t0:.1f} s")
    reqs2 = _doubled_requests(np)
    st0 = [rt.get(r.get_metrics.remote()) for r in reps2]
    decs0 = [(e.decode_tokens, e.decode_seconds) for e in engs]
    counts.reset()
    results2, wall2 = _serve(torch, _HandleStreams(handle2), reqs2,
                             "serve two replicas")
    launches2 = counts.read()
    st1 = [rt.get(r.get_metrics.remote()) for r in reps2]
    _check_streams(reqs2, results2, cfg.vocab_size)
    d_pref2, d_dec2, want2 = _k4_by_route(cfg, st0, st1)
    got2 = {r: launches2[f"paged_attention/{r}"] for r in want2}
    if got2 != want2 or not all(got2.values()):
        fail(f"serve: two replicas: K4 launches by route {got2}, wanted "
             f"{want2} = {L} layers x (prefills {d_pref2}, decode steps "
             f"{d_dec2}) summed over both replicas")
    keys = [r.actor_id.hex() for r in reps2]
    served = {k: sum(1 for r in reqs2 if results2[r["name"]]["replica"] == k)
              for k in keys}
    if not all(served.values()):
        fail(f"serve: two replicas: requests by replica {served}")
    pair = {results2[n]["replica"] for n in ("prefix-a", "prefix-b")}
    if len(pair) != 1:
        fail("serve: two replicas: the requests sharing a 256-token prefix "
             "landed on both replicas")
    host = keys.index(next(iter(pair)))
    hits = [b["kv_hit_tokens"] - a["kv_hit_tokens"]
            for a, b in zip(st0, st1)]
    if hits[host] < 256:
        fail(f"serve: two replicas: the prefix pair's replica hit "
             f"{hits[host]:.0f} tokens")
    if any(s["kv_blocks_active"] for s in st1):
        fail("serve: two replicas: blocks pinned after the run")
    rates = [_decode_rate(e, d) for e, d in zip(engs, decs0)]
    two = _serve_summary(None, reqs2, results2, wall2, rate=sum(rates))
    two.update(prefill_forwards=d_pref2, decode_forwards=d_dec2,
               launches=got2, requests_by_replica=list(served.values()),
               decode_tokens_per_s_by_replica=rates, kv_hit_tokens=hits)
    summary["two_replicas"] = two
    log(f"[serve] {len(reqs2)} requests over two replicas ({served[keys[0]]}"
        f" + {served[keys[1]]}), {two['tokens']} tokens in {wall2:.2f} s "
        f"({two['tokens_per_s_wall']:.1f} tokens/s wall; one replica "
        f"{one['tokens_per_s_wall']:.1f}): decode {rates[0]:.1f} + "
        f"{rates[1]:.1f} = {sum(rates):.1f} tokens/s (one replica "
        f"{one['decode_tokens_per_s']:.1f}), TTFT median "
        f"{two['ttft_ms_median']:.1f} ms, max {two['ttft_ms_max']:.1f} ms  "
        f"[{card}]")
    log(f"[serve] K4 wgmma {got2['wgmma']} = {L} x {d_pref2}, split "
        f"{got2['split']} = {L} x {d_dec2} over both replicas; the "
        f"prefix pair on one replica, which hit {hits[host]:.0f} tokens")

    # A third half-card replica on top stays pending.
    ctrl = get_or_create_controller()
    rt.get(ctrl.set_target_replicas.remote("serve-2", 3))
    time.sleep(2.0)
    from ray_tpu_torch.core.runtime import get_runtime

    others = [(a, info) for a, info in _replica_actors()
              if a.hex() not in keys and info.state != "DEAD"]
    if len(others) != 1 or others[0][1].state != "PENDING" or \
            get_runtime().actors[others[0][0]].instance is not None:
        fail(f"serve: a third num_gpus=0.5 replica is "
             f"{[i.state for _a, i in others]}, wanted one PENDING")
    rt.get(ctrl.set_target_replicas.remote("serve-2", 2))
    get_runtime().kill_actor(others[0][0])
    log("[serve] a third num_gpus=0.5 replica asked for on top stayed "
        "PENDING (never built)")
    del engs
    _retire(rt, serve, "serve-2", count)

    # Identity at 2 layers, f32, with the HTTP leg.
    summary["f32_identity"] = _serve_identity(torch, np, rt, serve, card)

    # Serve's own cost a request: a no-op deployment's round trip.
    noop = serve.run(serve.deployment(name="noop")(_serve_noop).bind())
    noop.remote(None).result()
    t0 = time.perf_counter()
    for _ in range(SERVE_NOOP_CALLS):
        noop.remote(None).result()
    summary["noop_round_trip_us"] = (
        1e6 * (time.perf_counter() - t0) / SERVE_NOOP_CALLS)
    log(f"[serve] a no-op deployment's round trip through its handle "
        f"{summary['noop_round_trip_us']:.1f} us (mean of "
        f"{SERVE_NOOP_CALLS}); phase 11's no-op actor method "
        f"{runtime_summary['noop_round_trip_us_one_thread']:.1f} us  "
        f"[{card}]")

    serve.shutdown()
    rt.shutdown()
    deadline = time.monotonic() + 30
    while True:
        left = [t.name for t in set(threading.enumerate()) - threads_before
                if t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    arenas = [n for n in os.listdir("/dev/shm")
              if n.startswith(f"rtpu_store_{pid}_")]
    http_port = summary["f32_identity"].get("http_port")
    listening = http_port is not None and _listening(http_port)
    if left or arenas or listening:
        fail(f"serve: after serve.shutdown() and shutdown(): threads {left}, "
             f"arenas {arenas}, HTTP port listening {listening}")
    log("[serve] serve.shutdown() and shutdown(): no replica, controller or "
        "proxy thread, no arena, no listening socket left")
    return summary


def _serve_noop(payload):
    return None


def _listening(port):
    import socket

    with socket.socket() as s:
        s.settimeout(2)
        return s.connect_ex(("127.0.0.1", port)) == 0


def _serve_identity(torch, np, rt, serve, card):
    """Greedy identity at 2 layers f32: streams through a ``num_gpus=1``
    deployment == a direct engine on the kernel == ``Generator``; then one
    streamed request over the HTTP ingress where aiohttp imports."""
    import importlib.util

    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.generate import Generator
    from ray_tpu_torch.serve import api
    from ray_tpu_torch.serve.llm import PagedLLMEngine, llm_deployment

    f32 = transformer.gpt2_small(n_layers=2, dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False

    def params_fn():
        return transformer.init_params(
            f32, torch.Generator().manual_seed(13), device=DEVICE)

    have_http = importlib.util.find_spec("aiohttp") is not None
    have_grpc = importlib.util.find_spec("grpc") is not None
    log(f"[serve] ingress packages: aiohttp "
        f"{'present' if have_http else 'absent'}, grpcio "
        f"{'present' if have_grpc else 'absent'}")
    handle, _reps, (eng,) = _serve_up(
        rt, serve, llm_deployment(f32, params_fn, name="serve-f32",
                                  ray_actor_options={"num_gpus": 1}).bind(),
        "serve-f32", 1, route_prefix="/llm", _start_proxy=have_http,
        http_port=0)
    params = params_fn()
    direct = PagedLLMEngine(params, f32, device=DEVICE,
                            attention_kernel="cuda", name="serve-direct")
    oracle = Generator(params, f32, device=DEVICE)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, f32.vocab_size, n).tolist()
               for n in (20, 150, 400, 700)]
    through = [[it["token"] for it in handle.options(stream=True).remote(
        {"prompt_ids": p, "max_new_tokens": 24})] for p in prompts]
    ties = []
    for p, got in zip(prompts, through):
        want = oracle.generate(p, max_new_tokens=24)
        ties += _same_greedy(
            torch, oracle.params, f32, p, want,
            {"deployment": got,
             "direct kernel": direct.generate(p, max_new_tokens=24)},
            "serve")
    log(f"[serve] 4 greedy requests, gpt2_small widths x 2 layers, f32: "
        f"through the deployment == direct paged engine on the kernel == "
        f"Generator" + (f" up to {len(ties)} near tie(s)" if ties else ""))
    out = {"ties": ties, "aiohttp": have_http, "grpcio": have_grpc}
    if have_http:
        import urllib.request

        port = api._proxy.bound_port
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/llm",
            data=json.dumps({"prompt_ids": prompts[0],
                             "max_new_tokens": 24}).encode(),
            headers={"X-Serve-Stream": "1"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            items = [json.loads(ln) for ln in
                     resp.read().decode().splitlines() if ln.strip()]
        if [it["token"] for it in items] != through[0] or \
                "finish_reason" not in items[-1]:
            fail(f"serve: the HTTP stream {items} is not the handle's")
        out["http_port"] = port
        log(f"[serve] one streamed request over the HTTP ingress: the "
            f"handle's {len(items)} tokens")
    else:
        log("[serve] aiohttp is absent here: no HTTP leg")
    del eng
    return out


# -- phase 13 ----------------------------------------------------------------
CLUSTER_NODE_A = {"CPU": 8, "GPU": 1}  # the card's node
CLUSTER_NODE_B = {"CPU": 4}           # no card: the cross-node pull's target
CLUSTER_ARENA = 2 * 2**30             # object_store_memory's default, a node
CLUSTER_MIN_ARENA = 256 * 2**20       # the K/V object and its pull fit
CLUSTER_FREED_S = 10.0                # a SIGKILLed worker's card comes back


def _smi_pids():
    """The pids ``nvidia-smi`` lists as holding a context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi --query-compute-apps failed: {out.stderr.strip()}")
    return {int(w) for w in out.stdout.split() if w.strip().isdigit()}


def _held_by_others(torch, base):
    """Device memory held beyond ``base`` (``(free, reserved)`` read at the
    start) by other processes: the card's fall in free memory less what
    this process's own allocator took meanwhile."""
    free = torch.cuda.mem_get_info()[0]
    return (base[0] - free) - (torch.cuda.memory_reserved() - base[1])


def _alive(pid):
    """Whether ``pid`` is a live process (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _kv_bytes(k, v):
    """The sha256 of two tensors' raw bytes, as the host holds them."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in (k, v):
        h.update(t.detach().to("cpu").contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _kv_task(cfg, seed, prompt):
    """A ``num_gpus=1`` task in a worker process: phase 4's engine from its
    seed, the prefill of ``prompt`` and the gather of its blocks (phase
    10's handoff gather); returns the bf16 tensors on the card, the sha256
    of their bytes, their device and the worker's pid."""
    import torch

    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import PagedLLMEngine

    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(seed), device=DEVICE)
    eng = PagedLLMEngine(params, cfg, device=DEVICE, name="cluster-kv")
    k, v, _, _ = eng.prefill_to_blocks(prompt, seed=0)
    return k, v, _kv_bytes(k, v), str(k.device), os.getpid()


def _pull_task(boxed):
    """A task pinned to the node without the card: ``get`` of the K/V
    object made on the other node (the chunked pull of
    ``core/object_transfer.py`` into this node's arena), timed; returns
    the sha256 of the bytes it got, the ms, its node and its pid."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime import get_runtime

    t0 = time.perf_counter()
    k, v, _digest, _dev, _pid = rt.get(boxed[0], timeout=600)
    ms = (time.perf_counter() - t0) * 1e3
    return (_kv_bytes(k, v), ms, get_runtime().current_node_id.hex(),
            os.getpid())


def _echo_task(value):
    """A task that returns its argument: its result is a new object in its
    node's arena."""
    return value


def _counted_server(base):
    """``llm_deployment``'s server class with reads of its own process: K4's
    launch counters (and their reset), the engine's decode counters, and
    what the engine is and where it runs."""

    class CountedLLMServer(base):
        def launches(self):
            return Counts().read()

        def reset_launches(self):
            Counts().reset()

        def decode_counters(self):
            return self.engine.decode_tokens, self.engine.decode_seconds

        def engine_info(self):
            e = self.engine
            return {"engine": type(e).__name__, "device": str(e.device),
                    "attention_kernel": e._pg.attention_kernel,
                    "slots": e.slots, "pool_blocks": e.kv.num_blocks,
                    "pid": os.getpid()}

    return CountedLLMServer


def _cluster_serve_up(rt_mod, serve, dep, name, n):
    """``serve.run`` of ``dep`` with ``_counted_server``'s class, then wait
    until ``n`` replicas are ALIVE; a replica that died fails the run with
    its own death cause. Returns (handle, replica actor handles, their
    ``engine_info``)."""
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.serve.controller import get_or_create_controller

    dep = dep.options(func_or_class=_counted_server(dep.func_or_class))
    handle = serve.run(dep.bind())
    ctrl = get_or_create_controller()
    gcs = get_runtime().gcs
    deadline = time.monotonic() + 600
    while True:
        _v, table = rt_mod.get(ctrl.get_snapshot.remote(-1, 0.0))
        reps = table.get(name, {}).get("replicas", [])
        infos = [gcs.get_actor(r.actor_id) for r in reps]
        dead = [i.death_cause for i in infos
                if i is not None and i.state == "DEAD"]
        if dead:
            fail(f"cluster: {name}: a replica died: {dead[0]}")
        states = [i.state if i is not None else None for i in infos]
        if len(reps) == n and states == ["ALIVE"] * n:
            break
        if time.monotonic() > deadline:
            fail(f"cluster: {name}: replicas {states} after 600 s")
        time.sleep(0.05)
    infos = [rt_mod.get(r.handle_request.remote("engine_info"), timeout=60)
             for r in reps]
    for info in infos:
        if (info["engine"] != "PagedLLMEngine"
                or info["attention_kernel"] != "cuda"
                or torch_device_type(info["device"]) != DEVICE):
            fail(f"cluster: {name}: a replica's engine is {info}")
    return handle, reps, infos


def torch_device_type(device):
    return device.split(":", 1)[0]


def _replica_run(rt_mod, torch, cfg, handle, reps, reqs, label):
    """``reqs`` through streaming handle calls with each replica's K4
    counters set to 0 just before (in its own process) and read just
    after; K4 must equal n_layers x that replica's prefills (wgmma) and
    decode steps (split). Returns the summary and its per-replica parts."""
    def each(method):
        return [rt_mod.get(r.handle_request.remote(method), timeout=60)
                for r in reps]

    st0 = each("get_engine_stats")
    dec0 = each("decode_counters")
    each("reset_launches")
    results, wall = _serve(torch, _HandleStreams(handle), reqs, label)
    launches = each("launches")
    st1 = each("get_engine_stats")
    dec1 = each("decode_counters")
    _check_streams(reqs, results, cfg.vocab_size)
    per = []
    for i in range(len(reps)):
        d_pref, d_dec, want = _k4_by_route(cfg, [st0[i]], [st1[i]])
        got = {r: launches[i][f"paged_attention/{r}"] for r in want}
        if got != want:
            fail(f"cluster: {label}: replica {i}: K4 launches by route "
                 f"{got}, wanted {want} = {cfg.n_layers} layers x "
                 f"(prefills {d_pref}, decode steps {d_dec}) of its own")
        if st1[i]["kv_blocks_active"]:
            fail(f"cluster: {label}: replica {i}: blocks pinned after the "
                 f"run")
        dt = dec1[i][1] - dec0[i][1]
        per.append({"prefill_forwards": d_pref, "decode_forwards": d_dec,
                    "launches": got,
                    "decode_tokens_per_s": (dec1[i][0] - dec0[i][0]) / dt
                    if dt > 0 else 0.0,
                    "kv_hit_tokens": st1[i]["kv_hit_tokens"]
                    - st0[i]["kv_hit_tokens"]})
    total = {r: sum(p["launches"][r] for p in per) for r in ("wgmma", "split")}
    if not all(total.values()):
        fail(f"cluster: {label}: K4 launches by route {total}: both routes "
             f"must run")
    forwards = sum(p["prefill_forwards"] + p["decode_forwards"] for p in per)
    summary = _serve_summary(
        None, reqs, results, wall,
        rate=sum(p["decode_tokens_per_s"] for p in per))
    summary.update(launches=total, replicas=per, forwards=forwards,
                   ms_wall_per_forward=wall * 1e3 / forwards)
    return summary, results


def phase_cluster(torch, np, card, counts, runtime_summary, serve_summary,
                  train, mesh):
    """The multi-process cluster on the card: a GCS, two node daemons (one
    with the card) and their worker processes; phase 4's engine in a
    worker-process actor and through two Serve deployments; the 2-layer
    f32 identity across processes; the K/V across nodes; a SIGKILLed GPU
    worker's card and grant returned; nothing left after teardown."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.controller import get_or_create_controller
    from ray_tpu_torch.serve.llm import llm_deployment

    me = os.getpid()
    summary = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    base = (free0, torch.cuda.memory_reserved())
    smi0 = _smi_pids()
    smi_sees = me in smi0
    log(f"[cluster] nvidia-smi lists {sorted(smi0)} as holding the card "
        f"(this process {me}: "
        f"{'listed' if smi_sees else 'not listed, a PID namespace it cannot see'}"
        f"); device memory free {free0} bytes")

    # 1. The cluster: its arenas must fit in /dev/shm first.
    st = os.statvfs("/dev/shm")
    shm_free = st.f_bavail * st.f_frsize
    arena = CLUSTER_ARENA
    if 2 * arena > 0.8 * shm_free:
        arena = int(0.8 * shm_free / 2) // 2**20 * 2**20
        if arena < CLUSTER_MIN_ARENA:
            fail(f"cluster: /dev/shm has {shm_free} bytes free: two arenas "
                 f"of {CLUSTER_MIN_ARENA} bytes do not fit")
        log(f"[cluster] CUT: a node's arena {arena} bytes (default "
            f"{CLUSTER_ARENA}): two arenas must fit in /dev/shm's "
            f"{shm_free} free bytes")
    t0 = time.perf_counter()
    cluster = Cluster(num_nodes=0, system_config=(
        {"object_store_memory": arena} if arena != CLUSTER_ARENA else None))
    node_a = cluster.add_node(CLUSTER_NODE_A)
    node_b = cluster.add_node(CLUSTER_NODE_B)
    rt.init(address=cluster.gcs_address)
    res = rt.cluster_resources()
    if (res.get("GPU") != 1.0 or any(k.startswith("TPU") for k in res)
            or res.get("CPU") != CLUSTER_NODE_A["CPU"]
            + CLUSTER_NODE_B["CPU"]):
        fail(f"cluster: cluster_resources() {res}, wanted GPU 1, CPU 12 and "
             f"no TPU")
    arenas = [h.store_name for h in (node_a, node_b)]
    if not all(arenas) or not all(
            os.path.exists(f"/dev/shm/{n}") for n in arenas):
        fail(f"cluster: the nodes' arenas {arenas} are not in /dev/shm")
    summary.update(resources=res, arena_bytes=arena, arenas=arenas,
                   shm_free_bytes=shm_free,
                   start_s=time.perf_counter() - t0)
    log(f"[cluster] a GCS and two node daemons up in "
        f"{summary['start_s']:.1f} s: node A {CLUSTER_NODE_A}, node B "
        f"{CLUSTER_NODE_B}; init(address=...) sees {res}; arenas {arenas} "
        f"({arena} bytes each; /dev/shm had {shm_free} free)")
    procs = {cluster.gcs_proc.pid, node_a.proc.pid, node_b.proc.pid}

    # 2. Phase 4's engine in a worker-process actor on node A.
    cfg = transformer.gpt2_small()
    L = cfg.n_layers
    t0 = time.perf_counter()
    submitted = time.time()
    a = rt.remote(num_gpus=1, max_concurrency=8)(_EngineActor).remote(
        cfg, 0, "cluster-actor")
    info = rt.get(a.info.remote(), timeout=600)
    info["setup_s"]["to_init"] = info["setup_s"].pop("init_at") - submitted
    procs.add(info["pid"])
    if (info["engine"] != "PagedLLMEngine"
            or torch_device_type(info["device"]) != DEVICE
            or info["attention_kernel"] != "cuda" or info["pid"] == me):
        fail(f"cluster: the engine actor is {info}")
    if rt.available_resources().get("GPU", 0) != 0.0:
        fail(f"cluster: the engine actor does not hold the card: "
             f"{rt.available_resources()}")
    held = _held_by_others(torch, base)
    log(f"[cluster] engine actor (num_gpus=1, max_concurrency=8) in worker "
        f"process {info['pid']}: {info['engine']} gpt2_small "
        f"({info['params']} params, {cfg.dtype}) on {info['device']}, "
        f"attention {info['attention_kernel']}; set-up + warmup "
        f"{time.perf_counter() - t0:.1f} s in a cold process ("
        + ", ".join(f"{k} {v:.1f}" for k, v in info["setup_s"].items())
        + f" s); it holds {held} bytes of the card")
    reqs = _requests(np)
    proxy = _ActorStreams(rt, a)
    st0 = rt.get(a.stats.remote())
    dec0 = rt.get(a.decode_counters.remote())
    rt.get(a.reset_launches.remote())
    counts.reset()
    results, wall = _serve(torch, proxy, reqs, "cluster")
    launches = rt.get(a.launches.remote())
    st1 = rt.get(a.stats.remote())
    dec1 = rt.get(a.decode_counters.remote())
    _check_streams(reqs, results, cfg.vocab_size)
    d_pref = int(st1["prefill_forwards"] - st0["prefill_forwards"])
    d_dec = int(st1["decode_forwards"] - st0["decode_forwards"])
    want = {"wgmma": L * d_pref, "split": L * d_dec}
    got = {r: launches[f"paged_attention/{r}"] for r in want}
    if got != want or not all(got.values()):
        fail(f"cluster: K4 launches by route {got} (read in the worker), "
             f"wanted {want} = {L} layers x (prefills {d_pref}, decode "
             f"steps {d_dec})")
    if rt.get(a.active_blocks.remote()):
        fail("cluster: blocks still pinned after the run")
    if any(counts.read().values()):
        fail(f"cluster: the driver's own counters moved: {counts.read()}")
    rate = (dec1[0] - dec0[0]) / (dec1[1] - dec0[1])
    actor = _serve_summary(None, reqs, results, wall, rate=rate)
    actor.update(prefill_forwards=d_pref, decode_forwards=d_dec,
                 launches=got, pid=info["pid"], setup_s=info["setup_s"],
                 held_bytes=held, greedy_streams={
                     n: results[n]["tokens"] for n in GREEDY})
    actor["noop_round_trip_us"] = _noop_round_trip_us(rt, a)
    summary["actor"] = actor
    log(f"[cluster] {len(reqs)} requests as streaming .remote() calls into "
        f"the worker, {actor['tokens']} tokens in {wall:.2f} s: decode "
        f"{rate:.1f} tokens/s (phase 11's in-process actor "
        f"{runtime_summary['decode_tokens_per_s']:.1f}), TTFT median "
        f"{actor['ttft_ms_median']:.1f} ms (phase 11 "
        f"{runtime_summary['ttft_ms_median']:.1f}), max "
        f"{actor['ttft_ms_max']:.1f} ms (phase 11 "
        f"{runtime_summary['ttft_ms_max']:.1f}); a no-op call's round trip "
        f"{actor['noop_round_trip_us']:.1f} us (mean of "
        f"{RUNTIME_NOOP_CALLS}; phase 11's eight-thread actor "
        f"{runtime_summary['noop_round_trip_us']:.1f}, one-thread "
        f"{runtime_summary['noop_round_trip_us_one_thread']:.1f})  [{card}]")
    log(f"[cluster] K4 in worker {info['pid']}: wgmma {got['wgmma']} = {L} x "
        f"{d_pref} prefills, split {got['split']} = {L} x {d_dec} decode "
        f"steps (read in the worker; the driver's counters stayed 0); "
        f"blocks pinned after: 0")

    # 6 (first, as it frees the card for 3). A second num_gpus=1 actor
    # pends; SIGKILL the engine actor's process: its next call raises, its
    # card memory and grant come back, and the pending actor comes up.
    f32 = transformer.gpt2_small(n_layers=2, dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    b = rt.remote(num_gpus=1)(_EngineActor).remote(f32, 13, "cluster-f32")
    b_info = b.info.remote()
    ready, _ = rt.wait([b_info], timeout=2.0)
    if ready or get_runtime().gcs.get_actor(b.actor_id).state == "ALIVE":
        fail("cluster: a second num_gpus=1 actor came up while the engine "
             "actor held the card")
    if smi_sees and info["pid"] not in _smi_pids():
        fail(f"cluster: nvidia-smi does not list the engine actor's process "
             f"{info['pid']}")
    os.kill(info["pid"], 9)
    t_kill = time.perf_counter()
    try:
        rt.get(a.noop.remote(), timeout=120)
    except rt.ActorDiedError as e:
        died = f"{type(e).__name__}: {e}"
    else:
        fail("cluster: a call on the SIGKILLed engine actor returned")
    # The card's memory held by other processes, sampled for
    # CLUSTER_FREED_S: it must fall to what the pending actor alone holds
    # once it is up (it may start building as soon as the grant is back).
    samples = []
    while time.perf_counter() - t_kill < CLUSTER_FREED_S:
        gone = not smi_sees or info["pid"] not in _smi_pids()
        samples.append((time.perf_counter() - t_kill, gone,
                        _held_by_others(torch, base)))
        if rt.wait([b_info], timeout=0.1)[0]:
            break
    b_up = rt.get(b_info, timeout=600)
    held_b = _held_by_others(torch, base)
    freed = [t for t, gone, used in samples
             if gone and used <= max(held_b, 0) + held / 4]
    if not freed:
        fail(f"cluster: {CLUSTER_FREED_S:.0f} s after the SIGKILL the card "
             f"still held the worker: nvidia-smi {sorted(_smi_pids())}, "
             f"least device memory held {min(u for _t, _g, u in samples)} "
             f"bytes (the engine actor held {held}, the pending actor "
             f"holds {held_b} once up)")
    freed_s = freed[0]
    summary["kill"] = {"pid": info["pid"], "error": died,
                       "card_freed_s": freed_s, "smi_lists_pids": smi_sees,
                       "held_bytes": held, "pending_held_bytes": held_b,
                       "pending_up_pid": b_up["pid"]}
    log(f"[cluster] SIGKILL of worker {info['pid']}: the next call raised "
        f"{died[:80]}; its card memory came back "
        f"{'and nvidia-smi dropped it ' if smi_sees else ''}in "
        f"{freed_s:.2f} s; the pending num_gpus=1 actor came up in worker "
        f"{b_up['pid']} on the freed grant")

    # 3. Identity across processes at 2 layers in f32.
    summary["f32_identity"] = _runtime_identity(torch, np, rt, b, f32)
    rt.kill(b)

    # 4. The object plane across nodes.
    summary["object_plane"] = _cluster_object_plane(
        torch, np, rt, card, node_a, node_b, runtime_summary, procs)

    # 5. Serve on the cluster.
    def params_fn():
        return transformer.init_params(
            cfg, torch.Generator().manual_seed(0), device=DEVICE)

    t0 = time.perf_counter()
    handle, reps, infos = _cluster_serve_up(
        rt, serve, llm_deployment(cfg, params_fn, name="cluster-1",
                                  ray_actor_options={"num_gpus": 1}),
        "cluster-1", 1)
    procs.update(i["pid"] for i in infos)
    log(f"[cluster] serve.run(llm_deployment(gpt2_small, num_gpus=1)) on the "
        f"cluster: {infos[0]['engine']} on {infos[0]['device']}, attention "
        f"{infos[0]['attention_kernel']}, in worker {infos[0]['pid']}; up in "
        f"{time.perf_counter() - t0:.1f} s")
    one, _ = _replica_run(rt, torch, cfg, handle, reps, _requests(np),
                          "cluster one replica")
    summary["one_replica"] = one
    p12 = serve_summary["one_replica"]
    log(f"[cluster] one replica: {one['tokens']} tokens in "
        f"{one['wall_s']:.2f} s: decode {one['decode_tokens_per_s']:.1f} "
        f"tokens/s (phase 12 {p12['decode_tokens_per_s']:.1f}), TTFT median "
        f"{one['ttft_ms_median']:.1f} ms (phase 12 "
        f"{p12['ttft_ms_median']:.1f}), max {one['ttft_ms_max']:.1f} ms "
        f"(phase 12 {p12['ttft_ms_max']:.1f}); "
        f"{one['ms_wall_per_forward']:.1f} ms of wall a forward  [{card}]")
    log(f"[cluster] K4 in the replica's process: wgmma "
        f"{one['launches']['wgmma']}, split {one['launches']['split']} = "
        f"{L} x its prefills and decode steps")
    _cluster_retire(rt, serve, "cluster-1")

    t0 = time.perf_counter()
    handle2, reps2, infos2 = _cluster_serve_up(
        rt, serve, llm_deployment(
            cfg, params_fn, name="cluster-2", slots=SERVE_TWO_SLOTS,
            num_replicas=2, ray_actor_options={"num_gpus": 0.5}),
        "cluster-2", 2)
    pids2 = [i["pid"] for i in infos2]
    procs.update(pids2)
    if len(set(pids2)) != 2:
        fail(f"cluster: the two half-card replicas share a process: {pids2}")
    log(f"[cluster] two replicas of num_gpus=0.5 ({SERVE_TWO_SLOTS} slots "
        f"each) in workers {pids2}; up in {time.perf_counter() - t0:.1f} s")
    reqs2 = _doubled_requests(np)
    two, results2 = _replica_run(rt, torch, cfg, handle2, reps2, reqs2,
                                 "cluster two replicas")
    keys = [r.actor_id.hex() for r in reps2]
    served = [sum(1 for r in reqs2 if results2[r["name"]]["replica"] == k)
              for k in keys]
    if not all(served):
        fail(f"cluster: two replicas: requests by replica {served}")
    pair = {results2[n]["replica"] for n in ("prefix-a", "prefix-b")}
    if len(pair) != 1:
        fail("cluster: two replicas: the requests sharing a 256-token "
             "prefix landed on both replicas")
    host = keys.index(next(iter(pair)))
    if two["replicas"][host]["kv_hit_tokens"] < 256:
        fail(f"cluster: two replicas: the prefix pair's replica hit "
             f"{two['replicas'][host]['kv_hit_tokens']:.0f} tokens")
    two["requests_by_replica"] = served
    summary["two_replicas"] = two
    p12two = serve_summary["two_replicas"]
    rates = [p["decode_tokens_per_s"] for p in two["replicas"]]
    log(f"[cluster] {len(reqs2)} requests over two replica processes "
        f"({served[0]} + {served[1]}), {two['tokens']} tokens in "
        f"{two['wall_s']:.2f} s: decode {rates[0]:.1f} + {rates[1]:.1f} = "
        f"{sum(rates):.1f} tokens/s ({sum(rates) / one['decode_tokens_per_s']:.2f}"
        f"x one replica on the cluster; phase 12 in one interpreter "
        f"{p12two['decode_tokens_per_s']:.1f}), tokens over wall "
        f"{two['tokens_per_s_wall']:.1f} (one replica "
        f"{one['tokens_per_s_wall']:.1f}; phase 12 "
        f"{p12two['tokens_per_s_wall']:.1f}), TTFT median "
        f"{two['ttft_ms_median']:.1f} ms, max {two['ttft_ms_max']:.1f} ms; "
        f"{two['ms_wall_per_forward']:.1f} ms of wall a forward over both "
        f"(one {one['ms_wall_per_forward']:.1f})  [{card}]")
    log(f"[cluster] K4 by replica, each read in its own process: "
        + ", ".join(f"wgmma {p['launches']['wgmma']} = {L} x "
                    f"{p['prefill_forwards']}, split {p['launches']['split']}"
                    f" = {L} x {p['decode_forwards']}"
                    for p in two["replicas"])
        + f"; the prefix pair on replica {host}")

    # A third half-card replica on top stays pending and is never built.
    ctrl = get_or_create_controller()
    rt.get(ctrl.set_target_replicas.remote("cluster-2", 3))
    deadline = time.monotonic() + 10
    while True:
        listed = rt.get(ctrl.list_deployments.remote())["cluster-2"]
        demands = _gcs_call(cluster, "pending_resource_demands")
        if (listed["num_replicas"] == 3 and any(
                d.get("GPU") == 0.5 for d in demands)) or \
                time.monotonic() > deadline:
            break
        time.sleep(0.1)
    smi_now = _smi_pids() if smi_sees else set()
    if (listed["num_replicas"] != 3
            or rt.available_resources().get("GPU", 0) != 0.0
            or not any(d.get("GPU") == 0.5 for d in demands)
            or (smi_sees and len(smi_now - {me}) != 2)):
        fail(f"cluster: a third num_gpus=0.5 replica: deployment {listed}, "
             f"free {rt.available_resources()}, waiting demands {demands}, "
             f"nvidia-smi {sorted(smi_now)}")
    for r in reps2:
        if rt.get(r.handle_request.remote("engine_info"),
                  timeout=60)["pid"] not in pids2:
            fail("cluster: a replica moved after the third was asked for")
    rt.get(ctrl.set_target_replicas.remote("cluster-2", 2))
    log("[cluster] a third num_gpus=0.5 replica asked for on top: the "
        "deployment counts 3, no GPU is free, the GCS holds its {GPU: 0.5} "
        "demand waiting"
        + (", and nvidia-smi lists only the two replicas beside this "
           "process" if smi_sees else "") + " (never built)")
    _cluster_retire(rt, serve, "cluster-2")

    # Phase 14, the KV tier, then phase 16, the compiled DAG, run on this
    # cluster before its teardown.
    summary["tier"] = phase_tier(torch, np, rt, card, node_b, procs)
    summary["dag"] = phase_dag(torch, np, rt, card, node_a, node_b, procs,
                               summary)
    # Phase 17b, the trainer in a worker process, last on this cluster.
    summary["trainer"] = phase_trainer_cluster(torch, np, rt, card, counts,
                                               procs, train, mesh)
    # Phase 18c, the Data pipeline across processes, after it.
    summary["data"] = phase_data_cluster(torch, np, rt, card, node_b)
    summary["spans"] = _phase_spans_shipped("phase 13's cluster (16, 17b, "
                                            "18c)")
    # Phase 20, cluster operations, last on this cluster.
    summary["ops"] = phase_cluster_ops(torch, np, rt, card, cluster, node_a,
                                       node_b, procs, summary)

    # The GCS's own punctuality over the whole cluster run: health ticks
    # that woke more than a period late, and its stacks when one did.
    late = _gcs_call(cluster, "health_loop_stats")
    summary["gcs_health_ticks"] = late
    log(f"[cluster] the GCS's health loop: {late['late_ticks']} ticks woke "
        f"more than a period late, the worst by {late['worst_late_s']:.3f} s"
        + (f" (stacks in {late['stacks_path']})" if late["late_ticks"]
           else ""))
    if late["late_ticks"] and late["stacks_path"]:
        import shutil

        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        shutil.copy(late["stacks_path"],
                    ROOT / "chiprun_out" / "gcs_stall_stacks.txt")

    # 7. Tear down.
    for i in range(2):
        procs.update(cluster.worker_pids(i))
    serve.shutdown()
    rt.shutdown()
    cluster.shutdown()
    deadline = time.monotonic() + 15
    while any(_alive(p) for p in procs) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = sorted(p for p in procs if _alive(p))
    shm_left = [n for n in arenas if os.path.exists(f"/dev/shm/{n}")]
    smi_left = sorted(_smi_pids() - {me}) if smi_sees else []
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    held_after = _held_by_others(torch, base)
    if left or shm_left or smi_left or held_after > 256 * 2**20:
        fail(f"cluster: after serve.shutdown(), shutdown() and "
             f"cluster.shutdown(): processes {left}, arenas {shm_left}, "
             f"nvidia-smi {smi_left}, device memory still held "
             f"{held_after} bytes")
    summary["processes"] = len(procs)
    log(f"[cluster] serve.shutdown(), shutdown(), cluster.shutdown(): none "
        f"of the {len(procs)} GCS, daemon and worker processes is alive, "
        f"no raytpu-* arena of theirs is left, and only this process holds "
        f"the card (other processes hold {held_after} bytes of device "
        f"memory beyond the level before the cluster)")
    return summary


def _gcs_call(cluster, method, *args):
    """One call of the cluster's GCS, on a connection of its own."""
    from ray_tpu_torch.core.rpc import RpcClient

    client = RpcClient(cluster.gcs_address)
    try:
        return client.call(method, *args, timeout=60)
    finally:
        client.close()


def _cluster_retire(rt_mod, serve, name, tag="cluster"):
    """Delete deployment ``name`` and wait until its replicas have given
    the card back."""
    serve.delete(name)
    _wait_card_free(rt_mod, tag, f"{name}'s replicas after delete")


def _wait_card_free(rt_mod, tag, what):
    """Wait until the cluster's whole card is free again; fail after 120 s
    naming ``what`` still holds it."""
    deadline = time.monotonic() + 120
    while rt_mod.available_resources().get("GPU", 0) != 1.0:
        if time.monotonic() > deadline:
            fail(f"{tag}: {what} still hold the card: "
                 f"{rt_mod.available_resources()}")
        time.sleep(0.05)


def _cluster_object_plane(torch, np, rt, card, node_a, node_b,
                          runtime_summary, procs, reps=5):
    """Phase 10's 1024-token K/V gather from a ``num_gpus=1`` task in a
    worker on node A: ``get`` in the driver and in a task pinned to node B
    (the pull through ``core/object_transfer.py``) give the bytes the
    worker made; ``put``/``get`` of the K/V in the driver timed beside a
    pinned ``copy_``."""
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.models import transformer

    cfg = transformer.gpt2_small()
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, RUNTIME_KV_TOKENS).tolist()
    t0 = time.perf_counter()
    ref = rt.remote(num_gpus=1)(_kv_task).remote(cfg, 0, prompt)
    k, v, digest, dev, pid = rt.get(ref, timeout=600)
    task_s = time.perf_counter() - t0
    procs.add(pid)
    nbytes = k.nbytes + v.nbytes
    if (torch_device_type(dev) != DEVICE or k.device.type != "cpu"
            or k.dtype != torch.bfloat16 or _kv_bytes(k, v) != digest):
        fail(f"cluster: get of the task's K/V: {k.dtype} on {k.device} "
             f"(made on {dev}), bytes equal "
             f"{_kv_bytes(k, v) == digest}")
    local = get_runtime().current_node_id
    strategy = rt.NodeAffinitySchedulingStrategy(node_id=node_b.node_id,
                                                 soft=False)
    pulled = []
    for i in range(reps):
        # A fresh object each time (node B keeps what it pulled): the
        # task's own, then the same tuple put again from the driver.
        r = ref if i == 0 else rt.put((k, v, digest, dev, pid))
        d_b, ms_b, node, pid_b = rt.get(
            rt.remote(scheduling_strategy=strategy)(_pull_task).remote([r]),
            timeout=600)
        procs.add(pid_b)
        if d_b != digest or node != node_b.node_id.hex():
            fail(f"cluster: the task on node B ({node}) got other bytes "
                 f"than the worker made: {d_b == digest}")
        pulled.append(ms_b)
        del r
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    kc, vc = k.to(DEVICE), v.to(DEVICE)
    flat = torch.cat([kc.reshape(-1).view(torch.uint8),
                      vc.reshape(-1).view(torch.uint8)])
    on_local = rt.NodeAffinitySchedulingStrategy(node_id=local, soft=False)
    times = {"put": [], "get": [], "pinned_d2h": []}
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = rt.put((kc, vc))
        t1 = time.perf_counter()
        pinned.copy_(flat)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        # The driver keeps what it put in its own cache: ``get`` is timed on
        # a copy a task made in this node's arena, once it is sealed.
        echoed = rt.remote(scheduling_strategy=on_local)(_echo_task).remote(r)
        rt.wait([echoed], timeout=600)
        t3 = time.perf_counter()
        kk, vv = rt.get(echoed)
        t4 = time.perf_counter()
        times["put"].append((t1 - t0) * 1e3)
        times["pinned_d2h"].append((t2 - t1) * 1e3)
        times["get"].append((t4 - t3) * 1e3)
        if _kv_bytes(kk, vv) != digest:
            fail("cluster: put/get of the K/V is not bit for bit")
        del r, echoed, kk, vv
    ms = {n: _median(t[1:]) for n, t in times.items()}
    ms["pull_node_b"] = _median(pulled)
    rate = {n: nbytes / (ms[n] * 1e-3) / 1e9 for n in ms}
    p11 = runtime_summary["object_plane"]["ms"]
    log(f"[cluster] a num_gpus=1 task in worker {pid} returned the "
        f"{RUNTIME_KV_TOKENS}-token K/V gather ({nbytes} bytes, bf16, made "
        f"on {dev}) in {task_s:.1f} s with its engine's set-up; get in the "
        f"driver (node {'A' if local == node_a.node_id else 'B'}) and in a "
        f"task pinned to node B gave the worker's bytes (sha256). Median of "
        f"{reps}: pull to node B {ms['pull_node_b']:.2f} ms = "
        f"{rate['pull_node_b']:.2f} GB/s; put {ms['put']:.2f} ms (phase 11 "
        f"{p11['put']:.2f}), get from this node's arena {ms['get']:.2f} ms "
        f"(phase 11 {p11['get']:.2f}), pinned copy_ {ms['pinned_d2h']:.2f} "
        f"ms (phase 11 {p11['pinned_d2h']:.2f})  [{card}]")
    return {"bytes": nbytes, "ms": ms, "gb_per_s": rate, "reps": reps,
            "task_s": task_s,
            "driver_node": "A" if local == node_a.node_id else "B"}


# -- phase 14, the cluster KV tier ---------------------------------------------
TIER_ENV = {"env_vars": {"RAY_TPU_KV_TIER_ENABLED": "1"}}
TIER_PROMPT = 1008                    # + 16 new = 1024 tokens: 64 full blocks
TIER_NEW = 16
TIER_BLOCKS = 64
TIER_PROBE_TOKENS = 992               # the probe's cap: (1008 - 1) // 16 blocks
TIER_SESSION = 496                    # migration: turn 2 = 496 + 16 + 16 tokens
TIER_ONLY_P = 200                     # self-heal: a chain only P publishes


def _payload_pull_task(boxed):
    """A task pinned to the node without the card: ``get`` of a spilled
    KV-tier payload (the pull into this node's arena), timed; returns the
    sha256 of its K/V, the ms, its node and its pid."""
    import torch  # noqa: F401 — the payload's tensors need it: not timed

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime import get_runtime

    t0 = time.perf_counter()
    payload = rt.get(boxed[0], timeout=600)
    ms = (time.perf_counter() - t0) * 1e3
    return (_kv_bytes(payload["k"], payload["v"]), ms,
            get_runtime().current_node_id.hex(), os.getpid())


def _step_stall(records, blocks):
    """The wall time of the step that spilled ``blocks`` blocks beside the
    median of the steps that spilled nothing."""
    steps = records["steps"]
    spills = [(dt, post) for dt, n, post in steps if n == blocks]
    rest = [dt for dt, n, _ in steps if not n]
    if len(spills) != 1 or len(rest) < 5:
        fail(f"tier: {len(spills)} of {len(steps)} steps spilled {blocks} "
             f"blocks and {len(rest)} spilled none; wanted 1 and >= 5")
    dt, post = spills[0]
    return {"spill_step_ms": dt * 1e3, "spill_ms": post * 1e3,
            "median_step_ms": _median(rest) * 1e3, "steps": len(steps)}


def phase_tier(torch, np, rt, card, node_b, procs):
    """The cluster KV tier on phase 13's cluster: two half-card engine
    actors with the tier on in their processes alone; P spills a 64-block
    chain, F hits the store for 992 tokens and prefills 16, beside a fresh
    prefill, the payload's same-node get and its pull to node B; a drain
    migration P -> F over a named lane; P dies and F's fetch of P's other
    chain self-heals the directory; K4 by route in each actor's process."""
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_ref import ObjectRef
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.util import blockhash

    t_phase = time.perf_counter()
    cfg = transformer.gpt2_small()
    L, bt = cfg.n_layers, 16
    core = get_runtime()
    gcs = core.gcs
    summary = {}
    rng = np.random.default_rng(14)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    # 1. Two half-card engine actors, the tier on in their env alone,
    # started together (their cold set-ups overlap).
    t0 = time.perf_counter()
    host = rt.remote(num_gpus=0.5, max_concurrency=8,
                     runtime_env=TIER_ENV)(_EngineActor)
    p, f = host.remote(cfg, 0, "tier-p"), host.remote(cfg, 0, "tier-f")
    p_info, f_info = rt.get([p.info.remote(), f.info.remote()], timeout=600)
    procs.update((p_info["pid"], f_info["pid"]))
    for name, info in (("P", p_info), ("F", f_info)):
        if (not info["kv_tier"] or info["attention_kernel"] != "cuda"
                or torch_device_type(info["device"]) != DEVICE):
            fail(f"tier: actor {name} is {info}")
    if config().kv_tier_enabled:
        fail("tier: the driver's own config has the tier on")
    summary["setup_s"] = time.perf_counter() - t0
    log(f"[tier] two num_gpus=0.5 engine actors with "
        f"RAY_TPU_KV_TIER_ENABLED=1 in their env: P in worker "
        f"{p_info['pid']}, F in worker {f_info['pid']} (gpt2_small, bf16, "
        f"bt {bt}, max_len {cfg.max_seq_len}); up in "
        f"{summary['setup_s']:.1f} s")
    for a in (p, f):
        rt.get(a.instrument.remote())
        rt.get(a.reset_launches.remote())
    st0 = {"p": rt.get(p.stats.remote()), "f": rt.get(f.stats.remote())}

    def whole(actor, toks, n=TIER_NEW):
        got, out = rt.get(actor.generate_whole.remote(toks, n, 0.0, 0),
                          timeout=600)
        if len(got) != n or out.get("finish_reason") != "stop":
            fail(f"tier: {len(got)} tokens ({out}), wanted {n}")
        return got, out["ttft_s"] * 1e3

    def hits(actor, src):
        return (rt.get(actor.stats.remote())[f"kv_tier_hits_{src}"])

    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(0), device=DEVICE)

    # 2. Spill: P serves the 1008-token prompt; its 1024-token chain (64
    # full blocks) is published.
    x = prompt(TIER_PROMPT)
    px, p_ttft = whole(p, x)
    spilled = rt.get(p.stats.remote())["kv_tier_spilled_blocks"]
    digests = blockhash.block_hashes(x + px, bt, max_blocks=TIER_BLOCKS)
    m = gcs.prefix_match(digests)
    entries = gcs.prefix_stats()["prefix_dir_entries"]
    if spilled != TIER_BLOCKS or m is None or m[0] != TIER_BLOCKS - 1 \
            or m[1]["blocks"] != TIER_BLOCKS or entries < TIER_BLOCKS:
        fail(f"tier: P's spill: kv_tier_spilled_blocks {spilled}, the "
             f"directory's match {m and (m[0], m[1]['blocks'])}, "
             f"{entries} entries; wanted {TIER_BLOCKS} blocks")
    ref = ObjectRef(ObjectID(m[1]["meta"]), owner_hint=m[1]["hint"] or None)
    gets = []
    for _ in range(3):
        with core._cache_lock:
            core._cache.pop(ref.id, None)
        t0 = time.perf_counter()
        payload = rt.get(ref, timeout=600)
        gets.append((time.perf_counter() - t0) * 1e3)
    k, v = payload["k"], payload["v"]
    nbytes = k.nbytes + v.nbytes
    digest = _kv_bytes(k, v)
    want_shape = (L, TIER_BLOCKS, bt, cfg.n_heads, cfg.head_dim)
    if (k.dtype != torch.bfloat16 or tuple(k.shape) != want_shape
            or nbytes != 2 * 2 * math.prod(want_shape)
            or k.device.type != "cpu" or payload["tokens"] != x + px
            or digest != rt.get(p.pinned_payload_digest.remote(
                digests[-1].hex()), timeout=120)):
        fail(f"tier: the payload is {k.dtype} {tuple(k.shape)} on "
             f"{k.device}, tokens equal {payload['tokens'] == x + px}; "
             f"wanted bf16 {want_shape} on the host, P's own bytes")
    del payload, k, v
    on_b = rt.NodeAffinitySchedulingStrategy(node_id=node_b.node_id,
                                             soft=False)
    d_b, pull_ms, node, pid_b = rt.get(rt.remote(scheduling_strategy=on_b)(
        _payload_pull_task).remote([ref]), timeout=600)
    procs.add(pid_b)
    if d_b != digest or node != node_b.node_id.hex():
        fail(f"tier: the pull to node B ({node}) got other bytes: "
             f"{d_b == digest}")
    del ref
    # The spill's stall: another 1008-token prompt's 64-block spill while a
    # neighbour request decodes in the same steps.
    rt.get(p.records.remote())
    neighbour = p.generate_whole.remote(prompt(64), 112, 0.0, 0)
    time.sleep(0.05)
    x2 = prompt(TIER_PROMPT)
    px2, _ = whole(p, x2)
    rt.get(neighbour, timeout=600)
    stall = _step_stall(rt.get(p.records.remote()), TIER_BLOCKS)
    summary.update(spill={"blocks": spilled, "bytes": nbytes,
                          "directory_entries": entries, **stall},
                   get_ms=gets, pull_node_b_ms=pull_ms)
    log(f"[tier] P served {TIER_PROMPT} + {TIER_NEW} tokens (TTFT "
        f"{p_ttft:.1f} ms) and spilled its {TIER_BLOCKS}-block chain: "
        f"{nbytes} bytes of bf16 K/V, the GCS directory {entries} entries "
        f"(one a block). With a neighbour decoding, the step that spilled "
        f"another {TIER_BLOCKS}-block chain took {stall['spill_step_ms']:.1f}"
        f" ms (the extract and put {stall['spill_ms']:.1f} ms) against the "
        f"median step {stall['median_step_ms']:.1f} ms of "
        f"{stall['steps']}  [{card}]")
    log(f"[tier] the payload: get in the driver from node A's arena "
        + ", ".join(f"{g:.2f}" for g in gets) + f" ms; pull to node B "
        f"{pull_ms:.2f} ms (sha256 equal to P's)  [{card}]")

    # 3. Store hits: F serves the same prompt cold, then P's other
    # 1008-token prompt.
    store0 = hits(f, "store")
    hit_runs, ties = [], []
    for toks, want in ((x, px), (x2, px2)):
        before = hits(f, "store")
        got, ttft = whole(f, toks)
        rec = rt.get(f.records.remote())
        got_hit = hits(f, "store") - before
        if (got_hit != TIER_PROBE_TOKENS or rec["buckets"] != [16]
                or len(rec["fetches"]) != 1 or len(rec["inserts"]) != 1):
            fail(f"tier: F's store hit {got_hit} tokens with prefill "
                 f"buckets {rec['buckets']}, {len(rec['fetches'])} fetches "
                 f"and {len(rec['inserts'])} inserts; wanted "
                 f"{TIER_PROBE_TOKENS}, [16] and one each")
        hit_runs.append({"ttft_ms": ttft, "fetch_ms": rec["fetches"][0] * 1e3,
                         "ping_ms": rec["pings"][0] * 1e3,
                         "insert_ms": rec["inserts"][0] * 1e3})
        ties += _same_greedy(torch, params, cfg, toks, want,
                             {"F store hit": got}, "tier")
    hit_ttft, fetch_ms, insert_ms = (hit_runs[0]["ttft_ms"],
                                     hit_runs[0]["fetch_ms"],
                                     hit_runs[0]["insert_ms"])

    # 4. A fresh prefill of the same prompt: F's local cache and the
    # chain's directory entries cleared.
    rt.get(f.clear_local.remote())
    dropped = sum(bool(gcs.prefix_drop(d)) for d in digests)
    fx2, fresh_ttft = whole(f, x)
    rec = rt.get(f.records.remote())
    if (hits(f, "store") - store0 != 2 * TIER_PROBE_TOKENS
            or rec["buckets"] != [1024]):
        fail(f"tier: the fresh prefill hit the store or ran buckets "
             f"{rec['buckets']}")
    ties += _same_greedy(torch, params, cfg, x, px, {"F fresh": fx2}, "tier")
    across = hit_ttft - fetch_ms + pull_ms
    summary.update(hit_ttft_ms=hit_ttft, fresh_ttft_ms=fresh_ttft,
                   hits=hit_runs, fetch_ms=fetch_ms, insert_ms=insert_ms,
                   pull_plus_insert_ms=pull_ms + insert_ms,
                   across_nodes_hit_ttft_ms_estimate=across,
                   dropped_entries=dropped)
    log(f"[tier] F's store hits on P's two {TIER_PROMPT}-token prompts: "
        + "; ".join(f"TTFT {h['ttft_ms']:.1f} ms (fetch {h['fetch_ms']:.1f}, "
                    f"of it the publisher ping {h['ping_ms']:.2f}; insert "
                    f"{h['insert_ms']:.1f})" for h in hit_runs)
        + f"  [{card}]")
    log(f"[tier] F's TTFT on the {TIER_PROMPT}-token prompt: store hit "
        f"{hit_ttft:.1f} ms ({TIER_PROBE_TOKENS} tokens fetched and "
        f"inserted, the K4 prefill at T=16) against a fresh prefill "
        f"{fresh_ttft:.1f} ms (local cache and {dropped} directory entries "
        f"cleared; T=1024): fresh / hit = {fresh_ttft / hit_ttft:.2f}. In "
        f"the hit F's fetch (a same-node get) took {fetch_ms:.1f} ms and "
        f"the insert {insert_ms:.1f} ms; across nodes the pull "
        f"{pull_ms:.1f} ms + the insert = {pull_ms + insert_ms:.1f} ms, a "
        f"hit TTFT of about {across:.1f} ms  [{card}]")

    # 5. Drain migration P -> F over a named lane.
    s = prompt(TIER_SESSION)
    ps, _ = whole(p, s)
    lane = f"kvtier-{os.getpid()}"
    fin = f.kv_migrate_in.remote(lane)
    sent = rt.get(p.kv_migrate_out.remote(lane), timeout=120)
    imported = rt.get(fin, timeout=120)
    if sent < 1 or imported != sent:
        fail(f"tier: migration sent {sent} chains, imported {imported}")
    turn2 = s + ps + prompt(TIER_NEW)
    mig0 = hits(f, "migrated")
    f2, _ = whole(f, turn2)
    migrated = hits(f, "migrated") - mig0
    p2, _ = whole(p, turn2)
    if migrated <= 0:
        fail("tier: F's turn on P's session hit no migrated tokens")
    ties += _same_greedy(torch, params, cfg, turn2, p2,
                         {"F after migration": f2}, "tier")
    summary["migration"] = {"sent": sent, "imported": imported,
                            "hits_migrated": migrated}
    log(f"[tier] drain migration over lane {lane}: P sent {sent} chains, F "
        f"imported {imported}; F's next turn on P's session "
        f"({len(turn2)} tokens) hit {migrated:.0f} migrated tokens, its "
        f"greedy stream P's continuation")

    # 6. Self-heal: a chain only P published; P dies.
    y = prompt(TIER_ONLY_P)
    py, _ = whole(p, y)
    p_launch = rt.get(p.launches.remote())
    p_st = rt.get(p.stats.remote())
    rt.kill(p)
    deadline = time.monotonic() + 30
    while _alive(p_info["pid"]):
        if time.monotonic() > deadline:
            fail(f"tier: P's worker {p_info['pid']} outlived kill")
        time.sleep(0.05)
    rt.get(f.set_min_spill.remote(1 << 30))   # F republishes nothing now
    n0 = gcs.prefix_stats()["prefix_dir_entries"]
    store1 = hits(f, "store")
    fy, _ = whole(f, y)
    n1 = gcs.prefix_stats()["prefix_dir_entries"]
    if n1 != n0 - 1 or hits(f, "store") != store1:
        fail(f"tier: F's fetch of P's chain after P died: the directory "
             f"went {n0} -> {n1} entries, store hits "
             f"{hits(f, 'store') - store1}; wanted one entry dropped, no hit")
    ties += _same_greedy(torch, params, cfg, y, py, {"F self-heal": fy},
                         "tier")
    summary["self_heal"] = {"entries_before": n0, "entries_after": n1}
    log(f"[tier] P killed: F's fetch of the {TIER_ONLY_P}-token chain only "
        f"P published missed and dropped its entry ({n0} -> {n1}); F "
        f"prefilled in full, its greedy stream P's")

    # 7. K4 by route in each actor's own process.
    f_launch = rt.get(f.launches.remote())
    f_st = rt.get(f.stats.remote())
    launches = {}
    for name, st, st1, got in (("P", st0["p"], p_st, p_launch),
                               ("F", st0["f"], f_st, f_launch)):
        d_pref = int(st1["prefill_forwards"] - st["prefill_forwards"])
        d_dec = int(st1["decode_forwards"] - st["decode_forwards"])
        want = {"wgmma": L * d_pref, "split": L * d_dec}
        mine = {r: got[f"paged_attention/{r}"] for r in want}
        if mine != want or not all(mine.values()):
            fail(f"tier: {name}'s K4 launches by route {mine}, wanted "
                 f"{want} = {L} layers x (prefills {d_pref}, decode steps "
                 f"{d_dec}) of its own")
        launches[name] = mine
    total = {r: launches["P"][r] + launches["F"][r]
             for r in ("wgmma", "split")}
    rt.kill(f)
    summary.update(launches=total, launches_by_actor=launches, ties=ties,
                   pids=[p_info["pid"], f_info["pid"]],
                   phase_s=time.perf_counter() - t_phase)
    log(f"[tier] K4 read in each actor's process: P wgmma "
        f"{launches['P']['wgmma']}, split {launches['P']['split']}; F wgmma "
        f"{launches['F']['wgmma']}, split {launches['F']['split']} = {L} x "
        f"each one's prefills and decode steps; phase 14 took "
        f"{summary['phase_s']:.1f} s")
    return summary


# -- phase 16, the compiled DAG, device channels and eager collectives --------
DAG_GATHER_TOKENS = 1024              # a K/V gather: 64 blocks of 16
DAG_GATHERS = 4                       # stage A's gathers, picked by index
DAG_TICKS = 16                        # ticks timed one at a time and as a burst
DAG_SLOTS = 2                         # the device channels' ring depth
DAG_SHA_TICKS = (4, 16)               # sha256-checked: one at a time, burst
DAG_SOCKET_BYTES = 4096               # the socket edge's payload
PIPE_CALLS = 200                      # no-op pipeline round trips timed
COLL_BYTES = 25 * 2**20               # DDP's default bucket_cap_mb, f32
COLL_REPS = 5                         # timed allreduces a op (after one warm)
COLL_RTOL = 1e-6                      # f32 sums of 4 positive values
GREEDY = ("prefix-a", "prefix-b", "short", "long", "mid", "followup")


def _tensor_digest(t):
    """The sha256 of a tensor's raw bytes, as the host holds them."""
    import hashlib

    import torch

    return hashlib.sha256(t.detach().to("cpu").contiguous().reshape(-1)
                          .view(torch.uint8).numpy().tobytes()).hexdigest()


class _DagProducer:
    """Phase 16a's stage A: four 1024-token K/V gathers of phase 4's engine
    (bf16, on the card), made once; each tick returns the one its index
    picks."""

    def __init__(self, cfg, seed, prompts):
        import torch

        from ray_tpu_torch.models import transformer
        from ray_tpu_torch.serve.llm import PagedLLMEngine

        t0 = time.perf_counter()
        params = transformer.init_params(
            cfg, torch.Generator().manual_seed(seed), device=DEVICE)
        eng = PagedLLMEngine(params, cfg, device=DEVICE, name="dag-producer")
        self.xs = []
        for p in prompts:
            k, v, _, _ = eng.prefill_to_blocks(p, seed=0)
            self.xs.append(torch.stack([k, v]).contiguous())
        del eng, params
        if DEVICE == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        self.made_s = time.perf_counter() - t0

    def info(self):
        import torch

        x = self.xs[0]
        return {"pid": os.getpid(), "device": str(x.device),
                "dtype": str(x.dtype), "shape": tuple(x.shape),
                "bytes": x.numel() * x.element_size(), "made_s": self.made_s,
                "digests": [_tensor_digest(x) for x in self.xs],
                "last_words": [int(x.reshape(-1)[-1:].view(torch.int16)
                                   .item()) for x in self.xs]}

    def pick(self, i):
        return self.xs[i % len(self.xs)]


class _DagConsumer:
    """Phase 16a's stage B: takes each tick's tensor off its device channel
    and reports where it landed — with its sha256 (``"sha"``), or only its
    last 16-bit word, read on the card after the copy's event (``"time"``)."""

    def __init__(self):
        self.ticks = 0

    def check(self, x, mode):
        import torch

        tick, self.ticks = self.ticks, self.ticks + 1
        here = (torch.device("cuda", torch.cuda.current_device())
                if DEVICE == "cuda" else torch.device(DEVICE))
        where = (type(x).__name__, str(x.dtype), str(x.device),
                 x.device == here)
        if mode == "sha":
            return tick, where, _tensor_digest(x)
        return tick, where, int(x.reshape(-1)[-1:].view(torch.int16).item())

    def pid(self):
        return os.getpid()


class _Echo:
    """A CPU stage that returns its input (phase 16a's socket and auto
    edges)."""

    def echo(self, x):
        return x

    def where(self):
        from ray_tpu_torch.core.runtime import get_runtime

        return get_runtime().current_node_id.hex(), os.getpid()


class _CollectiveRank:
    """Phase 16c's rank: a 25 MiB f32 bucket on its device (the card on
    node A, the CPU on node B) in a ``gloo`` group of 4."""

    def __init__(self, rank, world, device, n):
        import torch

        self.rank, self.world, self.n = rank, world, n
        self.x = _coll_input(torch, rank, n).to(device)

    def join(self, group):
        from ray_tpu_torch.parallel import collectives as c

        c.init_collective_group(self.world, self.rank, backend="gloo",
                                group_name=group)
        self.group = group
        return os.getpid()

    def run(self, op, reps):
        """``reps`` + 1 allreduces of the bucket (the first warms), each
        after a barrier; returns the timed seconds, the result's largest
        relative error against a torch f32 oracle of the 4 inputs, the
        result's type and dtype, the group's stats and where the input
        lived."""
        import numpy as np
        import torch

        from ray_tpu_torch.parallel import collectives as c

        times, out = [], None
        for _ in range(reps + 1):
            c.barrier(group_name=self.group)
            t0 = time.perf_counter()
            out = c.allreduce(self.x, op=op, group_name=self.group)
            times.append(time.perf_counter() - t0)
        oracle = torch.stack([_coll_input(torch, r, self.n)
                              for r in range(self.world)]).sum(0)
        if op == "mean":
            oracle = oracle / self.world
        err = float(np.max(np.abs(np.asarray(out) - oracle.numpy())
                           / np.abs(oracle.numpy())))
        return {"s": times[1:], "rel_err": err, "type": type(out).__name__,
                "dtype": str(out.dtype), "stats": c.get_group_stats(
                    self.group), "device": str(self.x.device)}


def _coll_input(torch, rank, n):
    """Rank ``rank``'s bucket: positive f32 values, from its seed."""
    g = torch.Generator().manual_seed(1600 + rank)
    return 1.0 + torch.rand(n, generator=g, dtype=torch.float32)


class _PipelineModel:
    """Phase 16b's model stage: phase 4's engine (gpt2_small, bf16, its
    seed, engine defaults, the CUDA kernel) in a Serve replica. A request
    is ``{"prompt", "max_new", "fresh"}``; ``fresh`` starts it on an empty
    prefix cache, so each run of a prompt does the same work."""

    def __init__(self, cfg, seed):
        import torch

        from ray_tpu_torch.models import transformer
        from ray_tpu_torch.serve.llm import PagedLLMEngine

        params = transformer.init_params(
            cfg, torch.Generator().manual_seed(seed), device=DEVICE)
        self.eng = PagedLLMEngine(params, cfg, device=DEVICE,
                                  name="pipeline-model")
        self.eng.warmup()

    def __call__(self, req):
        if req.get("fresh"):
            with self.eng._step_lock:
                self.eng._reset_device_state()
        return self.eng.generate(req["prompt"],
                                 max_new_tokens=req["max_new"])

    def info(self):
        e = self.eng
        return {"engine": type(e).__name__, "device": str(e.device),
                "attention_kernel": e._pg.attention_kernel,
                "pid": os.getpid()}

    def stats(self):
        return self.eng.stats()

    def launches(self):
        return Counts().read()

    def reset_launches(self):
        Counts().reset()


def _pipeline_pre(req):
    """Phase 16b's first stage (CPU): a request as the model stage takes
    it."""
    return {"prompt": [int(t) for t in req["prompt"]],
            "max_new": int(req["max_new"]), "fresh": True}


def _pipeline_post(tokens):
    """Phase 16b's last stage (CPU): the token list as the caller gets it."""
    return {"tokens": list(tokens), "n": len(tokens)}


def _pipeline_requests(np):
    """Phase 4's six greedy requests, in order; the follow-up's prompt is
    filled in from the short request's stream by the caller."""
    return [r for r in _requests(np) if r["name"] in GREEDY]


def _replicas_of(rt_mod, name):
    from ray_tpu_torch.serve.controller import get_or_create_controller

    _v, table = rt_mod.get(get_or_create_controller().get_snapshot.remote(
        -1, 0.0))
    return table.get(name, {}).get("replicas", [])


def phase_dag(torch, np, rt, card, node_a, node_b, procs, cluster_summary):
    """The compiled DAG on phase 13's cluster: 16a device channels carrying
    K/V gathers between two card actors, socket and auto edges; 16c the
    eager collectives (a gloo group across both nodes, the device backend
    in the driver); 16b ``run_pipeline([Pre, Model, Post])`` compiled
    against sequential on phase 4's engine. 16c runs before 16b: its card
    ranks start with 16a's actors, and 16b's replica takes the whole card."""
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.dag import (Channel, DeviceChannel, InputNode,
                                   SocketChannel)
    from ray_tpu_torch.dag.channel import shm_footprint, shm_room
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.parallel import collectives

    t_phase = time.perf_counter()
    cfg = transformer.gpt2_small()
    L = cfg.n_layers
    summary = {}
    if rt.available_resources().get("GPU", 0) != 1.0:
        fail(f"dag: phase 14's actors still hold the card: "
             f"{rt.available_resources()}")

    # Every worker of 16a and 16c, started together: stage A (which makes
    # its gathers in its constructor), stage B, two CPU echo stages (one a
    # node), and the four collective ranks (two on the card on node A).
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, DAG_GATHER_TOKENS).tolist()
               for _ in range(DAG_GATHERS)]
    on = {n: rt.NodeAffinitySchedulingStrategy(node_id=h.node_id, soft=False)
          for n, h in (("A", node_a), ("B", node_b))}
    t0 = time.perf_counter()
    a = rt.remote(num_gpus=0.25, max_concurrency=2,
                  scheduling_strategy=on["A"])(_DagProducer).remote(
        cfg, 0, prompts)
    b = rt.remote(num_gpus=0.25, max_concurrency=2,
                  scheduling_strategy=on["A"])(_DagConsumer).remote()
    echo = [rt.remote(scheduling_strategy=on[n])(_Echo).remote()
            for n in ("A", "B")]
    n_coll = COLL_BYTES // 4
    ranks = [rt.remote(num_gpus=0.25 if r < 2 else 0,
                       scheduling_strategy=on["A" if r < 2 else "B"])(
        _CollectiveRank).remote(r, 4, DEVICE if r < 2 else "cpu", n_coll)
        for r in range(4)]
    a_info = rt.get(a.info.remote(), timeout=600)
    b_pid = rt.get(b.pid.remote(), timeout=600)
    echo_at = rt.get([e.where.remote() for e in echo], timeout=600)
    rank_pids = rt.get([r.join.remote("dag-bucket") for r in ranks],
                       timeout=600)
    setup_s = time.perf_counter() - t0
    procs.update([a_info["pid"], b_pid] + [p for _n, p in echo_at]
                 + rank_pids)
    nbytes = a_info["bytes"]
    if (torch_device_type(a_info["device"]) != DEVICE
            or a_info["dtype"] != "torch.bfloat16"
            or nbytes != 2 * L * DAG_GATHER_TOKENS * cfg.d_model * 2):
        fail(f"dag: stage A's gathers are {a_info}")
    if [n for n, _p in echo_at] != [node_a.node_id.hex(),
                                    node_b.node_id.hex()]:
        fail(f"dag: the echo stages run on nodes {echo_at}")
    log(f"[dag] 16a/16c workers up together in {setup_s:.1f} s (start-up, "
        f"not measured work): stage A (num_gpus=0.25) made "
        f"{DAG_GATHERS} {DAG_GATHER_TOKENS}-token K/V gathers of phase 4's "
        f"engine ({nbytes} bytes each, {a_info['dtype']}, "
        f"{a_info['shape']}) in {a_info['made_s']:.1f} s; stage B "
        f"(num_gpus=0.25), echo stages on nodes A and B, four gloo ranks "
        f"(two num_gpus=0.25 on node A, two on node B)")

    # 16a. Device channels: A -> B, 2 slots, the gathers on the card.
    capacity = nbytes + 4096
    need = 3 * shm_footprint(capacity, DAG_SLOTS)  # input, A -> B, output
    total, free = shm_room()
    if need > free:
        fail(f"dag: the device channels need {need} bytes of /dev/shm, "
             f"which has {free} free of {total}")
    dev = None if DEVICE == "cuda" else DEVICE  # None: each reader's card
    ticks = {}

    def run_dag(mode, n, burst):
        with InputNode() as inp:
            dag = b.check.bind(a.pick.bind(inp), mode)
        compiled = dag.experimental_compile(
            channel_type="device", channel_slots=DAG_SLOTS,
            channel_capacity=capacity, channel_device=dev)
        try:
            kinds = {type(ch).__name__ for ch in compiled._channels.values()}
            if kinds != {DeviceChannel.__name__}:
                fail(f"dag: channel_type='device' built {kinds}")
            compiled.execute(0).get(timeout=120)  # warm: pinned buffers
            t0 = time.perf_counter()
            if burst:
                # Up to 2 x slots ticks in flight: the driver fetches the
                # oldest before it writes past that (its output ring holds
                # 2; writing on would wait on a ring only it drains).
                outs, refs = [], []
                for i in range(n):
                    if len(refs) == 2 * DAG_SLOTS:
                        outs.append(refs.pop(0).get(timeout=120))
                    refs.append(compiled.execute(i))
                outs += [r.get(timeout=120) for r in refs]
            else:
                outs = [compiled.execute(i).get(timeout=120)
                        for i in range(n)]
            wall = time.perf_counter() - t0
        finally:
            compiled.teardown()
        first = outs[0][0]
        for i, (tick, where, check) in enumerate(outs):
            want = (a_info["digests"] if mode == "sha"
                    else a_info["last_words"])[i % DAG_GATHERS]
            if (where != ("Tensor", "torch.bfloat16", where[2], True)
                    or torch_device_type(where[2]) != DEVICE
                    or check != want or tick != first + i):
                fail(f"dag: 16a tick {i} ({mode}, "
                     f"{'burst' if burst else 'one at a time'}) landed as "
                     f"{where}, tick {tick}, check "
                     f"{'equal' if check == want else 'DIFFERENT'}")
        return wall

    for n, burst in zip(DAG_SHA_TICKS, (False, True)):
        run_dag("sha", n, burst)
    for burst in (False, True):
        ticks["burst" if burst else "one_at_a_time"] = (
            run_dag("time", DAG_TICKS, burst) / DAG_TICKS)
    rt.kill(a)
    rt.kill(b)
    p13 = cluster_summary["object_plane"]["ms"]
    ms = {k: v * 1e3 for k, v in ticks.items()}
    rate = {k: nbytes / (v * 1e-3) / 1e9 for k, v in ms.items()}
    summary["device_channel"] = {
        "bytes": nbytes, "slots": DAG_SLOTS, "ms_per_tick": ms, "gb_per_s": rate,
        "sha_ticks": sum(DAG_SHA_TICKS), "phase13_ms": p13,
        "shm_needed": need, "shm_free": free}
    log(f"[dag] 16a device channels (A -> B, {DAG_SLOTS} slots, {nbytes} "
        f"bytes of "
        f"bf16 a tick): {sum(DAG_SHA_TICKS)} ticks ({DAG_SHA_TICKS[0]} one "
        f"at a time, {DAG_SHA_TICKS[1]} as a burst) landed in B as CUDA "
        f"bf16 tensors on its own device, sha256 equal to A's; "
        f"{DAG_TICKS} ticks one at a time {ms['one_at_a_time']:.2f} ms a "
        f"tick = {rate['one_at_a_time']:.2f} GB/s, as a burst "
        f"{ms['burst']:.2f} ms = {rate['burst']:.2f} GB/s; phase 13's same "
        f"bytes: put {p13['put']:.2f} ms, get {p13['get']:.2f} ms, pull to "
        f"node B {p13['pull_node_b']:.2f} ms; /dev/shm {need} of {free} "
        f"free bytes  [{card}]")

    # Socket edges, one stage a node, then auto on the same two nodes.
    payload = bytes(range(256)) * (DAG_SOCKET_BYTES // 256)
    rtt = {}
    for kind, want_cls in (("socket", SocketChannel), ("auto", Channel)):
        with InputNode() as inp:
            dag = echo[1].echo.bind(echo[0].echo.bind(inp))
        compiled = dag.experimental_compile(channel_type=kind)
        try:
            classes = {type(ch) for ch in compiled._channels.values()}
            if classes != {want_cls}:
                fail(f"dag: channel_type={kind!r} across nodes A and B (one "
                     f"host) built {sorted(c.__name__ for c in classes)}, "
                     f"wanted {want_cls.__name__} for every edge")
            if compiled.execute(payload).get(timeout=60) != payload:
                fail(f"dag: the {kind} DAG changed its payload")
            t0 = time.perf_counter()
            for _ in range(DAG_TICKS):
                if compiled.execute(payload).get(timeout=60) != payload:
                    fail(f"dag: the {kind} DAG changed its payload")
            rtt[kind] = (time.perf_counter() - t0) / DAG_TICKS * 1e6
        finally:
            compiled.teardown()
    for e in echo:
        rt.kill(e)
    noop13 = cluster_summary["actor"]["noop_round_trip_us"]
    summary["socket_us"], summary["auto_shm_us"] = rtt["socket"], rtt["auto"]
    log(f"[dag] 16a a {DAG_SOCKET_BYTES}-byte payload through two stages "
        f"(node A, node B): socket edges {rtt['socket']:.1f} us a round "
        f"trip (mean of {DAG_TICKS}); channel_type='auto' picked shm for "
        f"every edge (one host): {rtt['auto']:.1f} us; phase 13's no-op "
        f"actor call {noop13:.1f} us  [{card}]")

    # 16c. The gloo group: 2 ranks on the card (node A), 2 on the CPU
    # (node B): the hierarchical schedule, a 25 MiB f32 bucket.
    coll = {}
    for op in ("sum", "mean"):
        outs = rt.get([r.run.remote(op, COLL_REPS) for r in ranks],
                      timeout=600)
        for r, o in enumerate(outs):
            if (o["rel_err"] > COLL_RTOL or o["type"] != "ndarray"
                    or o["dtype"] != "float32"):
                fail(f"dag: gloo allreduce {op} on rank {r} ({o['device']}):"
                     f" {o['type']} {o['dtype']}, relative error "
                     f"{o['rel_err']:.2e} against the torch f32 oracle "
                     f"(rtol {COLL_RTOL})")
        s = max(_median(o["s"]) for o in outs)
        coll[op] = {"ms": s * 1e3, "algbw_gb_per_s": COLL_BYTES / s / 1e9,
                    "rel_err": max(o["rel_err"] for o in outs)}
    stats = [o["stats"] for o in outs]
    hier = sum(st["hier_rounds"] for st in stats)
    if hier != 4 * 2 * (COLL_REPS + 1) or any(st["flat_rounds"]
                                              for st in stats):
        fail(f"dag: the gloo group's rounds {stats}: wanted every "
             f"allreduce on the hierarchical schedule (2 nodes x 2 ranks)")
    for r in ranks:
        rt.kill(r)
    # The device backend: 4 rank threads of this process, CUDA tensors.
    world, dev_out, errors = 4, {}, []
    xs = [_coll_input(torch, r, n_coll).to(DEVICE) for r in range(world)]

    def member(rank):
        try:
            collectives.init_collective_group(world, rank, backend="device",
                                              group_name="dag-device")
            times = []
            for _ in range(COLL_REPS + 1):
                t0 = time.perf_counter()
                out = collectives.allreduce(xs[rank],
                                            group_name="dag-device")
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            dev_out[rank] = (out, times[1:])
        except Exception as e:  # noqa: BLE001 — reported below, then fatal
            errors.append(f"rank {rank}: {e!r}")

    threads = [threading.Thread(target=member, args=(r,)) for r in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        fail(f"dag: device-backend allreduce: {errors or 'a rank hung'}")
    want = torch.stack(xs).sum(0)
    for rank, (out, _t) in dev_out.items():
        if (torch_device_type(str(out.device)) != DEVICE
                or not torch.equal(out, want)):
            fail(f"dag: device-backend rank {rank}: {out.device}, equal to "
                 f"the torch sum: {torch.equal(out.cpu(), want.cpu())}")
    collectives.destroy_collective_group("dag-device")
    s = max(_median(t) for _o, t in dev_out.values())
    coll["device_sum"] = {"ms": s * 1e3,
                          "algbw_gb_per_s": COLL_BYTES / s / 1e9}
    del xs, dev_out, want
    summary["collectives"] = coll
    log(f"[dag] 16c gloo allreduce of a 25 MiB f32 bucket, 4 ranks (2 on "
        f"the card on node A, 2 on the CPU on node B), hierarchical "
        f"schedule ({hier} rounds): sum {coll['sum']['ms']:.1f} ms = "
        f"{coll['sum']['algbw_gb_per_s']:.2f} GB/s algorithm bandwidth, "
        f"mean {coll['mean']['ms']:.1f} ms, relative error "
        f"{max(coll['sum']['rel_err'], coll['mean']['rel_err']):.1e} <= "
        f"{COLL_RTOL} against torch f32; backend='device', 4 rank threads "
        f"on the card: {coll['device_sum']['ms']:.2f} ms = "
        f"{coll['device_sum']['algbw_gb_per_s']:.1f} GB/s, each result on "
        f"the card, equal to the torch sum  [{card}]")

    # 16b. run_pipeline([Pre, Model, Post]): sequential, then compiled
    # lanes over the same replicas (one cold num_gpus=1 replica).
    _wait_card_free(rt, "dag", "16a's and 16c's actors")
    summary["pipeline"] = _phase_dag_pipeline(torch, np, rt, card, cfg,
                                              procs)
    summary["launches"] = summary["pipeline"]["launches"]
    summary["setup_s"] = setup_s + summary["pipeline"]["setup_s"]
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[dag] phase 16 took {summary['phase_s']:.1f} s, "
        f"{summary['setup_s']:.1f} s of it worker start-up")
    return summary


def _phase_dag_pipeline(torch, np, rt, card, cfg, procs):
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.serve.controller import get_or_create_controller
    from ray_tpu_torch.serve.dag_pipeline import build_compiled_pipeline

    L = cfg.n_layers
    out = {}
    ctrl = get_or_create_controller()
    stages = [serve.deployment(name="pipe-pre")(_pipeline_pre),
              serve.deployment(
                  name="pipe-model", max_concurrency=4,
                  ray_actor_options={"num_gpus": 1})(_PipelineModel).bind(
                  cfg, 0),
              serve.deployment(name="pipe-post")(_pipeline_post)]
    names = ["pipe-pre", "pipe-model", "pipe-post"]
    t0 = time.perf_counter()
    seq = serve.run_pipeline(stages, compiled=False)
    (model,) = _replicas_of(rt, "pipe-model")
    info = rt.get(model.handle_request.remote("info"), timeout=600)
    out["setup_s"] = time.perf_counter() - t0
    procs.add(info["pid"])
    if (info["engine"] != "PagedLLMEngine" or info["attention_kernel"] !=
            "cuda" or torch_device_type(info["device"]) != DEVICE):
        fail(f"dag: the pipeline's model replica is {info}")
    reqs = _pipeline_requests(np)

    def fill(r, results):
        if r.get("extends"):
            base = next(x for x in reqs if x["name"] == r["extends"])
            r["prompt"] = base["prompt"] + results[base["name"]] + r["extra"]
        return {"prompt": r["prompt"], "max_new": r["max_new"]}

    def one_at_a_time(handle):
        results, walls = {}, []
        for r in reqs:
            req = fill(r, results)
            t0 = time.perf_counter()
            got = handle.remote(req).result(timeout_s=600)
            walls.append(time.perf_counter() - t0)
            if got["n"] != r["max_new"]:
                fail(f"dag: {r['name']}: {got['n']} tokens, wanted "
                     f"{r['max_new']}")
            results[r["name"]] = got["tokens"]
        return results, walls

    want, seq_walls = one_at_a_time(seq)
    log(f"[dag] 16b serve.run_pipeline([Pre, Model, Post], compiled=False): "
        f"the model replica ({info['engine']} on {info['device']}, "
        f"attention {info['attention_kernel']}, worker {info['pid']}) up in "
        f"{out['setup_s']:.1f} s (start-up); phase 4's "
        f"{len(reqs)} greedy requests one at a time, "
        f"{sum(seq_walls):.2f} s")

    # Compiled lanes over the replicas the sequential run deployed.
    st0 = rt.get(model.handle_request.remote("stats"), timeout=60)
    rt.get(model.handle_request.remote("reset_launches"), timeout=60)
    # Read after those two calls: handle_request counts them too.
    total0 = rt.get(model.get_metrics.remote(), timeout=60)["total"]
    comp = build_compiled_pipeline(ctrl, names)
    try:
        got, comp_walls = one_at_a_time(comp)
        if got != want:
            bad = [n for n in want if got[n] != want[n]]
            fail(f"dag: 16b compiled streams differ from the sequential "
                 f"ones: {bad}")
        t0 = time.perf_counter()
        resps = [comp.remote(fill(r, want)) for r in reqs]
        burst = {r["name"]: resp.result(timeout_s=600)["tokens"]
                 for r, resp in zip(reqs, resps)}
        burst_wall = time.perf_counter() - t0
        if burst != want:
            bad = [n for n in want if burst[n] != want[n]]
            fail(f"dag: 16b the compiled burst's streams differ: {bad}")
        m1 = rt.get(model.get_metrics.remote(), timeout=60)
        launches = rt.get(model.handle_request.remote("launches"),
                          timeout=60)
        st1 = rt.get(model.handle_request.remote("stats"), timeout=60)
    finally:
        comp.shutdown()
    d_pref = int(st1["prefill_forwards"] - st0["prefill_forwards"])
    d_dec = int(st1["decode_forwards"] - st0["decode_forwards"])
    want_k4 = {"wgmma": L * d_pref, "split": L * d_dec}
    got_k4 = {r: launches[f"paged_attention/{r}"] for r in want_k4}
    if got_k4 != want_k4 or not all(got_k4.values()):
        fail(f"dag: 16b K4 launches by route in the model replica "
             f"{got_k4}, wanted {want_k4} = {L} layers x (prefills "
             f"{d_pref}, decode steps {d_dec})")
    if m1["ongoing"] != 0 or m1["total"] - total0 != 2 * len(reqs):
        fail(f"dag: 16b the model replica counts ongoing {m1['ongoing']}, "
             f"{m1['total'] - total0:.0f} requests; wanted 0 and "
             f"{2 * len(reqs)}")
    get_runtime()._metrics_exporter.flush()
    series = {m["name"]: m for m in get_runtime().gcs.metrics_summary()[
        "metrics"]}
    ticks = series.get("ray_tpu_dag_tick_s", {}).get("total", 0)
    if ticks < 2 * len(reqs):
        fail(f"dag: 16b ray_tpu_dag_tick_s in gcs.metrics_summary() counts "
             f"{ticks} ticks, wanted >= {2 * len(reqs)}")
    tokens = sum(len(t) for t in want.values())
    out.update(
        requests=len(reqs), tokens=tokens, launches=got_k4,
        prefill_forwards=d_pref, decode_forwards=d_dec,
        sequential_s=sum(seq_walls), compiled_s=sum(comp_walls),
        burst_s=burst_wall, dag_ticks_counted=ticks,
        replica_total=m1["total"])
    log(f"[dag] 16b compiled lanes over the same replicas: the {len(reqs)} "
        f"greedy streams one at a time equal the sequential ones token for "
        f"token ({tokens} tokens; {sum(comp_walls):.2f} s against "
        f"{sum(seq_walls):.2f} s sequential), and as a burst "
        f"({burst_wall:.2f} s; a lane runs its model stage one tick at a "
        f"time); K4 in the model replica: wgmma {got_k4['wgmma']} = {L} x "
        f"{d_pref} prefills, split {got_k4['split']} = {L} x {d_dec} decode "
        f"steps; the replica counts {m1['total']:.0f} requests, 0 ongoing; "
        f"ray_tpu_dag_tick_s counts {ticks:.0f} ticks in "
        f"gcs.metrics_summary()  [{card}]")
    serve.delete("pipe-pre")
    serve.delete("pipe-post")
    _cluster_retire(rt, serve, "pipe-model", "dag")

    # A no-op pipeline of three stages: compiled against sequential.
    noop = [serve.deployment(name=f"pipe-noop-{i}")(_serve_noop)
            for i in range(3)]
    noop_names = [d.name for d in noop]
    seq = serve.run_pipeline(noop, compiled=False)
    rtt = {}
    for kind in ("sequential", "compiled"):
        handle = (seq if kind == "sequential"
                  else build_compiled_pipeline(ctrl, noop_names))
        try:
            handle.remote(0).result(timeout_s=60)
            t0 = time.perf_counter()
            for i in range(PIPE_CALLS):
                handle.remote(i).result(timeout_s=60)
            rtt[kind] = (time.perf_counter() - t0) / PIPE_CALLS * 1e6
        finally:
            handle.shutdown()
    for n in noop_names:
        serve.delete(n)
    out["noop_us"] = rtt
    log(f"[dag] 16b a 3-stage no-op pipeline, one request at a time (mean "
        f"of {PIPE_CALLS}): compiled {rtt['compiled']:.1f} us a round trip, "
        f"sequential {rtt['sequential']:.1f} us "
        f"({rtt['sequential'] / rtt['compiled']:.1f}x)  [{card}]")
    return out


# -- phase 17, Train and Tune ------------------------------------------------
TRAINER_LOSS_TOL = 1e-3               # a trainer's step vs phase 6's: relative
PHASE_SPANS = ("train.step", "lm.forward", "lm.loss", "train.backward",
               "train.optimizer")


def _phase_spans_shipped(where):
    """The train step's phase spans among the task events of the GCS the
    driver is attached to, after this process's flush: none, since no
    phase traces its steps."""
    from ray_tpu_torch.core import runtime as runtime_mod
    from ray_tpu_torch.util import tracing

    tracing.flush()
    events = runtime_mod.get_runtime().gcs.task_events()
    n = sum(e.get("name") in PHASE_SPANS for e in events)
    log(f"[spans] {where}: {n} phase span(s) of the train step among the "
        f"GCS's {len(events)} task events")
    if n:
        fail(f"{where}: {n} phase spans of untraced train steps reached the "
             f"GCS")
    return {"phase_spans": n, "task_events": len(events)}
TRAINER_CKPT_AT_ONCE = 4              # full checkpoints on disk at once, at most
MESH_TRAINER_STEPS = 6                # 17b: steps 0..5, a checkpoint every 2
MESH_TRAINER_KILL = 5                 # 17b: the first worker dies at this step
REPORT_ROUNDS = 200                   # a no-op loop's rounds, for their cost
TUNE_LRS = (3e-3, 1e-3, 3e-4, 1e-4)   # 17c's grid, the largest first
TUNE_B, TUNE_MAX_T, TUNE_GRACE, TUNE_RF = 4, 8, 2, 2


def _phase_dir(name, fresh=False):
    """A phase's own directory (run storage, checkpoints, corpora,
    TMPDIR), under the checkout's gitignored ``build/``; removed at the
    phase's end."""
    import shutil

    d = ROOT / "build" / name
    if fresh and d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True, exist_ok=True)
    return d


def _flash_now():
    """K1-K3's launch counts in this process."""
    from ray_tpu_torch.ops import flash_attention as fa

    return {"flash_forward": fa.forward_launches, "flash_dq": fa.dq_launches,
            "flash_dkv": fa.dkv_launches}


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _ckpt_tree(training, params, opt, step):
    """A train loop's checkpoint: parameters, the AdamW state as optax's
    tree, the step."""
    return {"params": params, "opt": training.adamw_state_tree(opt, params),
            "step": step}


def _resume(training, rt_train, bundle_params, bundle_opt, path, optimizer):
    """``(params, opt, step)`` restored from the checkpoint at ``path`` into
    the structure (and placement) of a fresh bundle's state."""
    state = rt_train.restore_pytree(
        _ckpt_tree(training, bundle_params, bundle_opt, 0), path)
    params = state["params"]
    opt = training.load_adamw_state_tree(optimizer.init(params), params,
                                         state["opt"])
    return params, opt, state["step"]


def _trainer_loop(config):
    """17a's train loop, in the trainer's worker: phase 6's step (its seed,
    batch and optimizer), a report a step with its loss, time and K1-K3
    launches read here; one checkpoint after the last step (through the
    ``AsyncCheckpointer``: the snapshot timed apart from the write), then
    one more step, the uninterrupted run's next loss."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models import training, transformer

    dev = torch.device(config["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = transformer.gpt2_small(max_seq_len=config["L"], remat=True)
    bundle = training.make_train_step(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg),
        init_params_fn=lambda seed: transformer.init_params(
            cfg, seed, device=config["device"]),
        optimizer=training.adamw(3e-4, weight_decay=0.1),
        device=config["device"])
    params, opt = bundle.init(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab_size, (config["B"], config["L"])), device=dev)}
    report_us, last = [], config["steps"] - 1
    for step in range(config["steps"]):
        sync()
        t0 = time.perf_counter()
        before = _flash_now()
        params, opt, m = bundle.step(params, opt, batch)
        loss = m["loss"].item()
        t1 = time.perf_counter()
        after = _flash_now()
        metrics = {"step": step, "loss": loss, "step_ms": (t1 - t0) * 1e3,
                   "t_end": t1, "n_layers": cfg.n_layers,
                   "launches": {k: after[k] - before[k] for k in after},
                   "process_group": dist.is_initialized(),
                   "device": str(bundle.device)}
        ckpt = None
        if step == last:
            d = os.path.join(config["dir"], "worker-ckpt")
            writer = rt_train.AsyncCheckpointer()
            t2 = time.perf_counter()
            writer.save(_ckpt_tree(training, params, opt, step), d)
            t3 = time.perf_counter()
            writer.wait()
            t4 = time.perf_counter()
            metrics.update(snapshot_ms=(t3 - t2) * 1e3,
                           write_ms=(t4 - t3) * 1e3, save_ms=(t4 - t2) * 1e3,
                           checkpoint_bytes=_dir_bytes(d))
            ckpt = rt_train.Checkpoint(d)
        t5 = time.perf_counter()
        rt_train.report(metrics, checkpoint=ckpt)
        report_us.append((time.perf_counter() - t5) * 1e6)
    params, opt, m = bundle.step(params, opt, batch)
    rt_train.report({"step": config["steps"], "next_loss": m["loss"].item(),
                     "report_call_us": sorted(report_us)[len(report_us) // 2],
                     "reports": config["steps"] + 1})


def _noop_reports(config):
    from ray_tpu_torch import train as rt_train

    for i in range(config["n"]):
        rt_train.report({"i": i})


def _mesh_trainer_loop(config):
    """17b's train loop, in a GPU worker process of phase 13's cluster:
    phase 15's sharded step (remat "full") on a mesh over the process group
    ``TorchConfig`` formed; a checkpoint every 2 steps (into this process's
    own directory), resumed from the trainer's last one; the first
    incarnation dies at ``kill_step``. Every event goes to a JSON-lines log
    the driver reads, since ``Result`` keeps only the last incarnation's
    reports."""
    import json as _json
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models import training, transformer
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train.backend import process_group_setup

    def log(**event):
        event.update(pid=os.getpid(), t=time.time())
        with open(config["log"], "a") as f:
            f.write(_json.dumps(event) + "\n")

    age = _process_age_s()
    t0 = time.perf_counter()
    dev = torch.device(config["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = make_mesh(MeshSpec(data=-1), device_type=dev.type)
    rules = ShardingRules()
    kw = {} if config["n_layers"] is None else {"n_layers": config["n_layers"]}
    cfg = transformer.gpt2_small(max_seq_len=config["L"], remat=True,
                                 remat_policy="full", **kw)
    optimizer = training.adamw(3e-4, weight_decay=0.1)
    bundle = training.make_train_step(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg, mesh=mesh,
                                                 rules=rules),
        init_params_fn=lambda seed: transformer.init_params(
            cfg, seed, device=config["device"]),
        logical_params=transformer.logical_axes(cfg), mesh=mesh, rules=rules,
        optimizer=optimizer, batch_logical=("batch", None))
    params, opt = bundle.init(0)
    start = 0
    ck = rt_train.get_checkpoint()
    mine = os.path.join(config["worker_dir"], str(os.getpid()))
    if ck is not None:
        # fit() copied every checkpoint it received before it restarted the
        # group: an earlier incarnation's own files are no longer needed.
        for old in Path(config["worker_dir"]).glob("*"):
            shutil.rmtree(old)
        params, opt, last = _resume(training, rt_train, params, opt, ck.path,
                                    optimizer)
        start = last + 1
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab_size, (config["B"], config["L"])), device=dev)}
    sync()
    log(event="setup", **process_group_setup(),
        pg_backend=dist.get_backend(), pg_world=dist.get_world_size(),
        process_age_s=age, loop_setup_s=time.perf_counter() - t0,
        resumed_from=start, n_layers=cfg.n_layers,
        device=str(bundle.device))
    for step in range(start, config["steps"]):
        if step == config["kill_step"] and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            log(event="kill", step=step)
            os._exit(1)               # hard death: no cleanup, no report
        sync()
        t1 = time.perf_counter()
        before = _flash_now()
        params, opt, m = bundle.step(params, opt, batch)
        loss = m["loss"].item()
        t2 = time.perf_counter()
        after = _flash_now()
        ckpt, save_ms = None, None
        if step % 2 == 1:
            d = os.path.join(mine, f"step-{step}")
            rt_train.save_pytree(_ckpt_tree(training, params, opt, step), d)
            save_ms = (time.perf_counter() - t2) * 1e3
            ckpt = rt_train.Checkpoint(d)
        log(event="step", step=step, loss=loss, step_ms=(t2 - t1) * 1e3,
            launches={k: after[k] - before[k] for k in after},
            save_ms=save_ms)
        rt_train.report({"step": step, "loss": loss, "pid": os.getpid()},
                        checkpoint=ckpt)


def _check_step_losses(tag, got, want, tol=TRAINER_LOSS_TOL):
    """``got`` {step: loss} against ``want`` {step: loss} (relative)."""
    for step, loss in got.items():
        ref = want[step]
        if not (math.isfinite(loss) and abs(loss - ref) <= tol * abs(ref)):
            fail(f"{tag}: step {step} loss {loss} against {ref} (tolerance "
                 f"{tol} relative); all: {got} vs {want}")


def phase_trainer_cluster(torch, np, rt, card, counts, procs, train,
                          mesh_summary):
    """17b: ``TorchTrainer`` in a GPU worker process of phase 13's cluster
    with ``TorchConfig(init_distributed=True)`` — a world-1 NCCL group, the
    sharded step on a mesh over it, a checkpoint every 2 steps; the worker
    dies once at step 5 and ``FailureConfig(max_failures=1)`` restarts the
    group from the last checkpoint."""
    import shutil

    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)

    t_phase = time.perf_counter()
    _wait_card_free(rt, "trainer", "phase 16's actors")
    phase = _phase_dir("phase17", fresh=True)
    cfg = transformer.gpt2_small(max_seq_len=TRAIN_L, remat=True)
    n_params = transformer.param_count(
        transformer.init_params(cfg, 0, device="meta"))
    ckpt_bytes = 3 * 4 * n_params      # f32 parameters and two f32 moments
    free = shutil.disk_usage(phase).free
    n_layers = None
    if free < TRAINER_CKPT_AT_ONCE * ckpt_bytes:
        n_layers = 2
        log(f"[trainer] CUT: 17b checkpoints a {n_layers}-layer model of "
            f"gpt2_small's width: {TRAINER_CKPT_AT_ONCE} full checkpoints of "
            f"{ckpt_bytes} bytes do not fit in the {free} bytes free at "
            f"{phase}")
    log_path = phase / "mesh-trainer.jsonl"
    config = {"device": DEVICE, "L": TRAIN_L, "B": TRAIN_B,
              "steps": MESH_TRAINER_STEPS, "kill_step": MESH_TRAINER_KILL,
              "marker": str(phase / "killed-once"), "log": str(log_path),
              "worker_dir": str(phase / "worker"), "n_layers": n_layers}
    driver0 = counts.read()
    t_fit = time.time()
    result = TorchTrainer(
        _mesh_trainer_loop, train_loop_config=config,
        backend_config=TorchConfig(
            init_distributed=True,
            backend=None if DEVICE == "cuda" else "gloo"),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(
            name="mesh-trainer", storage_path=str(phase / "storage"),
            failure_config=FailureConfig(max_failures=1),
            checkpoint_config=CheckpointConfig(num_to_keep=1)),
    ).fit()
    fit_s = time.time() - t_fit
    if result.error is not None:
        fail(f"trainer 17b: fit() failed: {result.error}")
    _wait_card_free(rt, "trainer 17b", "the trainer's workers after fit()")
    if counts.read() != driver0:
        fail(f"trainer 17b: the driver's own counters moved: {counts.read()}")
    events = [json.loads(line) for line in open(log_path)]
    setups = [e for e in events if e["event"] == "setup"]
    kills = [e for e in events if e["event"] == "kill"]
    steps = [e for e in events if e["event"] == "step"]
    want_backend = "nccl" if DEVICE == "cuda" else "gloo"
    if (len(setups) != 2 or len({e["pid"] for e in setups}) != 2
            or any((e["backend"], e["world_size"], e["pg_backend"],
                    e["pg_world"]) != (want_backend, 1, want_backend, 1)
                   for e in setups)):
        fail(f"trainer 17b: wanted two incarnations in two processes, each "
             f"with a world-1 {want_backend} group: {setups}")
    if ([k["step"] for k in kills] != [MESH_TRAINER_KILL]
            or kills[0]["pid"] != setups[0]["pid"]):
        fail(f"trainer 17b: the kill events {kills}")
    hist = result.metrics_history
    got_steps = [h["step"] for h in hist]
    resumed = setups[1]["resumed_from"]
    if (not got_steps or got_steps[0] == 0 or resumed == 0
            or got_steps != list(range(resumed, MESH_TRAINER_STEPS))
            or any(h["pid"] != setups[1]["pid"] for h in hist)):
        fail(f"trainer 17b: the resumed run's reports {hist} (resumed from "
             f"step {resumed}): the series must go on from the checkpoint, "
             f"never back to step 0")
    n = setups[0]["n_layers"]
    want = {"flash_forward": 2 * n, "flash_dq": n, "flash_dkv": n}
    for e in steps:
        if e["launches"] != want:
            fail(f"trainer 17b step {e['step']} (pid {e['pid']}): launches "
                 f"{e['launches']}, wanted {want}")
    by_inc = [{e["step"]: e["loss"] for e in steps if e["pid"] == s["pid"]}
              for s in setups]
    # The step both incarnations ran: the resumed one equals the first's.
    _check_step_losses("trainer 17b, resumed vs first incarnation",
                       {s: by_inc[1][s] for s in by_inc[1] if s in by_inc[0]},
                       by_inc[0])
    if n_layers is None:
        _check_step_losses("trainer 17b vs phase 6",
                           {e["step"]: e["loss"] for e in steps},
                           dict(enumerate(train["losses"])))
    launches = {k: sum(e["launches"][k] for e in steps) for k in want}
    procs.update(e["pid"] for e in setups)
    first = {s["pid"]: min(e["t"] for e in steps if e["pid"] == s["pid"])
             for s in setups}
    p15 = mesh_summary["runs"]["full"]["step_ms"]
    incs = []
    for i, s in enumerate(setups):
        ms = [e["step_ms"] for e in steps if e["pid"] == s["pid"]]
        incs.append({
            "pid": s["pid"], "resumed_from": s["resumed_from"],
            "process_age_at_first_step_s": s["process_age_s"]
            + s["loop_setup_s"],
            "from_fit_or_kill_to_first_step_s": first[s["pid"]] - (
                t_fit if i == 0 else kills[0]["t"]),
            "loop_setup_s": s["loop_setup_s"], "init_ms": s["init_ms"],
            "init_method": s["init_method"], "step_ms": ms,
            # an incarnation's first step warms DTensor's dispatch caches
            "warm_step_ms_median": _median(ms[1:]) if len(ms) > 1 else None,
            "save_ms": [e["save_ms"] for e in steps
                        if e["pid"] == s["pid"] and e["save_ms"]]})
    summary = {"fit_s": fit_s, "losses_by_incarnation": by_inc,
               "incarnations": incs, "launches": launches,
               "checkpoint_bytes_estimate": ckpt_bytes, "disk_free": free,
               "n_layers": n, "cut": n_layers is not None,
               "phase15_full_step_ms": p15}
    for i, inc in enumerate(incs):
        log(f"[trainer] 17b incarnation {i + 1}: worker pid {inc['pid']}, "
            f"{want_backend} world 1 formed in {inc['init_ms']:.1f} ms "
            f"({inc['init_method']}); first step {inc['from_fit_or_kill_to_first_step_s']:.1f} s after "
            f"{'fit()' if i == 0 else 'the kill'} (the process "
            f"{inc['process_age_at_first_step_s']:.1f} s old), resumed from "
            f"step {inc['resumed_from']}; steps {[round(x, 1) for x in inc['step_ms']]} "
            f"ms (phase 15 full {p15:.1f} ms), "
            f"checkpoint saves {[round(x) for x in inc['save_ms']]} ms  "
            f"[{card}]")
    log(f"[trainer] 17b fit() {fit_s:.1f} s: killed at step "
        f"{MESH_TRAINER_KILL}, resumed at step {resumed} in a new process; "
        f"losses within {TRAINER_LOSS_TOL} of "
        f"{'phase 6' if n_layers is None else 'the first incarnation'}; the "
        f"GPU grant came back; flash {launches} in the workers")
    shutil.rmtree(phase)
    summary["phase_s"] = time.perf_counter() - t_phase
    return summary


def _no_op_trainer_s(rt_train, phase, n):
    t0 = time.perf_counter()
    result = rt_train.TorchTrainer(
        _noop_reports, train_loop_config={"n": n},
        scaling_config=rt_train.ScalingConfig(num_workers=1),
        run_config=rt_train.RunConfig(storage_path=str(phase / "noop"),
                                      name=f"noop-{n}")).fit()
    wall = time.perf_counter() - t0
    if result.error is not None or len(result.metrics_history) != n:
        fail(f"trainer: a no-op loop of {n} reports: {result}")
    return wall


def _trainer_in_process(torch, np, rt_train, card, counts, train, phase):
    """17a: ``TorchTrainer`` on the in-process runtime with one GPU worker."""
    import shutil

    from ray_tpu_torch.models import training, transformer

    steps = TRAIN_WARMUP + TRAIN_STEPS
    config = {"device": DEVICE, "L": TRAIN_L, "B": TRAIN_B, "steps": steps,
              "dir": str(phase / "a")}
    counts.reset()                   # this path's counts: 0 just before
    t0 = time.perf_counter()
    result = rt_train.TorchTrainer(
        _trainer_loop, train_loop_config=config,
        scaling_config=rt_train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=rt_train.RunConfig(name="trainer",
                                      storage_path=str(phase / "storage")),
    ).fit()
    fit_s = time.perf_counter() - t0
    launches = counts.read()          # ... and read just after
    if result.error is not None:
        fail(f"trainer 17a: fit() failed: {result.error}")
    hist = result.metrics_history
    final = hist[-1]
    step_reports = hist[:-1]
    if len(hist) != final["reports"] or len(step_reports) != steps:
        fail(f"trainer 17a: metrics_history has {len(hist)} entries for "
             f"{final['reports']} reports")
    if any(h["process_group"] for h in step_reports):
        fail("trainer 17a: a process group was formed in one process")
    if not all(h["device"].startswith(DEVICE) for h in step_reports):
        fail(f"trainer 17a: the step ran on {step_reports[0]['device']}")
    n = step_reports[0]["n_layers"]
    want = {"flash_forward": 2 * n, "flash_dq": n, "flash_dkv": n}
    for h in step_reports:
        if h["launches"] != want:
            fail(f"trainer 17a step {h['step']}: launches {h['launches']}, "
                 f"wanted {want}")
    total = {k: want[k] * (steps + 1) for k in want}
    # Each step launches the bias-GELU pair as often as K1 and K2.
    total.update(bias_gelu_forward=total["flash_forward"],
                 bias_gelu_backward=total["flash_dq"])
    if {k: launches[k] for k in total} != total or any(
            launches[k] for k in launches if k not in total):
        fail(f"trainer 17a: launches {launches} in the run, wanted {total}")
    losses = {h["step"]: h["loss"] for h in step_reports}
    _check_step_losses("trainer 17a vs phase 6", losses,
                       dict(enumerate(train["losses"])))
    # The timed steps: from the end of the last warm-up step to the end of
    # the last one, reports and loss reads included.
    wall = step_reports[-1]["t_end"] - step_reports[TRAIN_WARMUP - 1]["t_end"]
    tokens_per_s = TRAIN_B * TRAIN_L * TRAIN_STEPS / wall
    ck = step_reports[-1]
    # The checkpoint restores into a fresh bundle: its next step equals the
    # uninterrupted run's.
    cfg = transformer.gpt2_small(max_seq_len=TRAIN_L, remat=True)
    optimizer = training.adamw(3e-4, weight_decay=0.1)
    bundle = training.make_train_step(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg),
        init_params_fn=lambda seed: transformer.init_params(cfg, seed,
                                                            device=DEVICE),
        optimizer=optimizer, device=DEVICE)
    fresh, fresh_opt = bundle.init(1)           # other weights: overwritten
    t1 = time.perf_counter()
    params, opt, last = _resume(training, rt_train, fresh, fresh_opt,
                                result.checkpoint.path, optimizer)
    restore_ms = (time.perf_counter() - t1) * 1e3
    del fresh, fresh_opt
    count = int(training.adamw_state_tree(opt, params)[0].count)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_L)), device=DEVICE)}
    _, _, m = bundle.step(params, opt, batch)
    resumed = m["loss"].item()
    if last != steps - 1 or count != steps:
        fail(f"trainer 17a: the checkpoint holds step {last} and count "
             f"{count}, wanted {steps - 1} and {steps}")
    _check_step_losses("trainer 17a, the restored bundle's next step",
                       {steps: resumed}, {steps: final["next_loss"]})
    del params, opt, bundle, m
    gc.collect()
    torch.cuda.empty_cache()
    # The manager's copy of the same checkpoint, timed alone.
    mgr = rt_train.CheckpointManager(str(phase / "copy"))
    t2 = time.perf_counter()
    mgr.register(result.checkpoint, {})
    copy_ms = (time.perf_counter() - t2) * 1e3
    shutil.rmtree(phase / "copy")
    shutil.rmtree(phase / "storage")
    shutil.rmtree(phase / "a")
    # One report round's cost: a no-op loop of 1 + REPORT_ROUNDS reports
    # against one of 1 report, each twice.
    walls = {k: [] for k in (1, 1 + REPORT_ROUNDS)}
    for _ in range(2):
        for k in walls:
            walls[k].append(_no_op_trainer_s(rt_train, phase, k))
    round_us = 1e6 * (min(walls[1 + REPORT_ROUNDS]) - min(walls[1])) / REPORT_ROUNDS
    shutil.rmtree(phase / "noop")
    p6 = train
    out = {"fit_s": fit_s, "losses": [losses[s] for s in sorted(losses)],
           "next_loss": final["next_loss"], "resumed_next_loss": resumed,
           "step_ms": [h["step_ms"] for h in step_reports],
           "timed_wall_s": wall, "tokens_per_s": tokens_per_s,
           "step_ms_timed_mean": wall / TRAIN_STEPS * 1e3,
           "phase6_step_ms": p6["step_ms"],
           "phase6_tokens_per_s": p6["tokens_per_s"],
           "report_call_us_median": final["report_call_us"],
           "report_round_us": round_us, "no_op_fit_s": walls,
           "checkpoint_bytes": ck["checkpoint_bytes"],
           "checkpoint_snapshot_ms": ck["snapshot_ms"],
           "checkpoint_write_ms": ck["write_ms"],
           "checkpoint_save_ms": ck["save_ms"],
           "manager_copy_ms": copy_ms, "restore_ms": restore_ms,
           "launches": {k: launches[k] for k in want}}
    log(f"[trainer] 17a TorchTrainer in-process, one GPU worker, no process "
        f"group: {TRAIN_STEPS} timed steps at {out['step_ms_timed_mean']:.1f} "
        f"ms a step, {tokens_per_s:.0f} tokens/s (phase 6 "
        f"{p6['step_ms']:.1f} ms, {p6['tokens_per_s']:.0f} tokens/s); "
        f"losses within {TRAINER_LOSS_TOL} of phase 6's; flash {want} a "
        f"step  [{card}]")
    log(f"[trainer] 17a report(): {final['report_call_us']:.1f} us in the "
        f"loop; one report round {round_us:.1f} us (no-op loops of 1 and "
        f"{1 + REPORT_ROUNDS} reports)")
    log(f"[trainer] 17a checkpoint {ck['checkpoint_bytes']} bytes: snapshot "
        f"{ck['snapshot_ms']:.1f} ms, write {ck['write_ms']:.1f} ms, the "
        f"manager's copy {copy_ms:.1f} ms, restore {restore_ms:.1f} ms; the "
        f"restored bundle's next loss {resumed:.6f} = the uninterrupted "
        f"{final['next_loss']:.6f}  [{card}]")
    return out


def _tune_trainable(config):
    """17c's trial: gpt2_small at full width, B=4 and L=1024, one AdamW step
    on a fixed batch an iteration, reporting its loss."""
    import numpy as np
    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch.models import training, transformer

    t_start = time.perf_counter()
    cfg = transformer.gpt2_small(max_seq_len=config["L"], remat=True)
    bundle = training.make_train_step(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg),
        init_params_fn=lambda seed: transformer.init_params(
            cfg, seed, device=config["device"]),
        optimizer=training.adamw(config["lr"], weight_decay=0.1),
        device=config["device"])
    params, opt = bundle.init(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab_size, (config["B"], config["L"])),
        device=config["device"])}
    for _ in range(config["max_t"]):
        params, opt, m = bundle.step(params, opt, batch)
        tune.report({"loss": m["loss"].item(), "t_start": t_start,
                     "t": time.perf_counter(), "n_layers": cfg.n_layers})


def _asha_replay(records, milestones, max_t, rf):
    """The decisions ASHA's rule gives on ``records`` (trial, t, score) in
    the order the scheduler saw them: stop at ``t >= max_t``; at each rung
    a trial crosses, stop if its score is below the top ``1/rf`` cutoff of
    the scores recorded there so far."""
    rungs, nxt, out = {m: [] for m in milestones}, {}, []
    for trial, t, score in records:
        if t >= max_t:
            out.append("STOP")
            continue
        d, i = "CONTINUE", nxt.get(trial, 0)
        while i < len(milestones) and t >= milestones[i]:
            scores = rungs[milestones[i]]
            scores.append(score)
            k = max(1, int(len(scores) / rf))
            if score < sorted(scores, reverse=True)[k - 1]:
                d = "STOP"
            i += 1
        nxt[trial] = i
        out.append(d)
    return out


def _tune_on_card(torch, np, rt, card, counts):
    """17c: ``Tuner`` over a function trainable, 4 trials on a
    learning-rate grid with ``{"CPU": 1, "GPU": 0.5}`` each, ASHA."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import ASHAScheduler, TrialStatus

    class RecordingASHA(ASHAScheduler):
        """ASHA, recording every result it decides on, in its order."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.record = []

        def on_trial_result(self, trial, result):
            d = super().on_trial_result(trial, result)
            self.record.append((trial.trial_id,
                                int(result["training_iteration"]),
                                self._score(result), d))
            return d

    sched = RecordingASHA(max_t=TUNE_MAX_T, grace_period=TUNE_GRACE,
                          reduction_factor=TUNE_RF)
    counts.reset()                   # this path's counts: 0 just before
    t0 = time.perf_counter()
    grid = tune.Tuner(
        _tune_trainable,
        param_space={"lr": tune.grid_search(list(TUNE_LRS)), "device": DEVICE,
                     "L": TRAIN_L, "B": TUNE_B, "max_t": TUNE_MAX_T},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=sched),
        resources_per_trial={"CPU": 1, "GPU": 0.5},
    ).fit()
    wall = time.perf_counter() - t0
    launches = counts.read()          # ... and read just after
    trials = grid._trials
    ended = (TrialStatus.TERMINATED, TrialStatus.STOPPED)
    if len(trials) != len(TUNE_LRS) or any(
            t.status not in ended or t.error for t in trials):
        fail(f"tune: trials {[(t.config['lr'], t.status, t.error) for t in trials]}")
    iters = sum(len(t.metrics_history) for t in trials)
    n = trials[0].metrics_history[0]["n_layers"]
    want = {"flash_forward": 2 * n * iters, "flash_dq": n * iters,
            "flash_dkv": n * iters}
    if {k: launches[k] for k in want} != want:
        fail(f"tune: launches {launches} over {iters} iterations, wanted "
             f"{want}")
    # At most 2 trials at once: the card's two 0.5 grants.
    spans = [(t.metrics_history[0]["t_start"], t.metrics_history[-1]["t"])
             for t in trials]
    edges = sorted([(a, 1) for a, _ in spans] + [(b, -1) for _, b in spans])
    live = most = 0
    for _, d in edges:
        live += d
        most = max(most, live)
    if most > 2:
        fail(f"tune: {most} trials ran at once on two GPU grants: {spans}")
    # ASHA's stops: at least one at a rung, each as its rule gives on the
    # reported metrics in the order they were seen.
    rec = sched.record
    replay = _asha_replay([r[:3] for r in rec], sched.milestones, TUNE_MAX_T,
                          TUNE_RF)
    if [r[3] for r in rec] != replay:
        fail(f"tune: ASHA's decisions {rec} against its rule {replay}")
    rung_stops = [r for r in rec if r[3] == "STOP" and r[1] < TUNE_MAX_T]
    if not rung_stops:
        fail(f"tune: ASHA stopped no trial at a rung: {rec}")
    best = grid.get_best_result()
    lowest = min(trials, key=lambda t: t.last_result["loss"])
    if best.metrics["loss"] != lowest.last_result["loss"]:
        fail(f"tune: get_best_result() {best.metrics['loss']} is not the "
             f"lowest final loss {lowest.last_result['loss']}")
    by_lr = {t.config["lr"]: {"status": t.status,
                              "iterations": len(t.metrics_history),
                              "losses": [h["loss"] for h in t.metrics_history]}
             for t in trials}
    out = {"wall_s": wall, "iterations": iters, "most_at_once": most,
           "trials": by_lr, "milestones": sched.milestones,
           "rung_stops": [(r[0], r[1]) for r in rung_stops],
           "best_lr": lowest.config["lr"],
           "launches": {k: launches[k] for k in want}}
    log(f"[tune] 17c 4 trials (lr {list(TUNE_LRS)}) x up to {TUNE_MAX_T} "
        f"steps of gpt2_small B={TUNE_B} L={TRAIN_L}, {{CPU: 1, GPU: 0.5}} "
        f"each, ASHA rungs {sched.milestones}: {iters} iterations in "
        f"{wall:.1f} s, at most {most} at once; stopped at a rung "
        f"{len(rung_stops)}, each as ASHA's rule gives; best lr "
        f"{lowest.config['lr']} (final loss "
        f"{lowest.last_result['loss']:.4f}); flash {out['launches']}  "
        f"[{card}]")
    return out


def phase_trainer(torch, np, card, counts, train, cluster_trainer):
    """17a and 17c on the in-process runtime (after phase 13's cluster is
    gone), then 17b's losses held to 17a's."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train as rt_train

    t_phase = time.perf_counter()
    phase = _phase_dir("phase17", fresh=True)
    (phase / "tmp").mkdir()
    old_tmp = tempfile.tempdir
    tempfile.tempdir = str(phase / "tmp")
    rt.init()
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            fail(f"trainer: init() registers {rt.cluster_resources()}, "
                 f"wanted the card as GPU 1")
        st = shutil.disk_usage(phase)
        summary = {"disk_free": st.free}
        summary["a"] = _trainer_in_process(torch, np, rt_train, card, counts,
                                           train, phase)
        summary["c"] = _tune_on_card(torch, np, rt, card, counts)
        summary["spans"] = _phase_spans_shipped("17a, 17c")
    finally:
        rt.shutdown()
        tempfile.tempdir = old_tmp
    shutil.rmtree(phase)
    gc.collect()
    torch.cuda.empty_cache()
    if not cluster_trainer["cut"]:
        a = dict(enumerate(summary["a"]["losses"]))
        for inc in cluster_trainer["losses_by_incarnation"]:
            _check_step_losses("trainer 17b vs 17a",
                               {int(k): v for k, v in inc.items()}, a)
    summary["b"] = cluster_trainer
    summary["launches"] = {k: summary["a"]["launches"][k]
                           + cluster_trainer["launches"][k]
                           + summary["c"]["launches"][k]
                           for k in summary["a"]["launches"]}
    summary["phase_s"] = (time.perf_counter() - t_phase
                          + cluster_trainer["phase_s"])
    log(f"[trainer] 17b's losses within {TRAINER_LOSS_TOL} of 17a's"
        f"{' (cut: not compared)' if cluster_trainer['cut'] else ''}; "
        f"phase 17 took {summary['phase_s']:.1f} s; flash on the trainer "
        f"paths {summary['launches']}")
    return summary


# -- phase 18 ----------------------------------------------------------------
DATA_ROWS, DATA_FILES = 4096, 16       # 18a/18c: 4,096 rows of 1,024 tokens
DATA_BATCH = 16                        # rows a batch (phase 6's B)
PPO_RUNNERS, PPO_ENVS = 2, 2           # 18d: env runners, envs a runner
PPO_FRAGMENT, PPO_MINIBATCH = 64, 64   # steps an env an iteration; rows an update
PPO_ITERS = 3
LEARNER_CARD_TOL = 1e-4                # card vs CPU update, relative to a leaf


def _write_token_files(np, d, tokens, rows_per_file):
    """``tokens`` [rows, L] int32 as parquet files of ``rows_per_file``
    rows, one ``fixed_size_list<int32>[L]`` column ``ids``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    d.mkdir(parents=True, exist_ok=True)
    for i in range(0, len(tokens), rows_per_file):
        part = np.ascontiguousarray(tokens[i:i + rows_per_file])
        col = pa.FixedSizeListArray.from_arrays(pa.array(part.reshape(-1)),
                                                part.shape[1])
        pq.write_table(pa.table({"ids": col}),
                       str(d / f"part-{i // rows_per_file:05d}.parquet"))


def _tokens_from_ids(table):
    """18's ``map_batches``: the ``ids`` list column → a ``tokens`` tensor
    column [rows, L] int32."""
    ids = table.column("ids").combine_chunks()
    return {"tokens": ids.flatten().to_numpy().reshape(-1, ids.type.list_size)}


def _data_corpus(np, vocab):
    """18a's corpus: DATA_ROWS rows of TRAIN_L int32 tokens below the
    vocab, from the script's seed, written as DATA_FILES parquet files."""
    d = _phase_dir("phase18") / "corpus"
    tokens = np.random.default_rng(0).integers(
        0, vocab, (DATA_ROWS, TRAIN_L)).astype(np.int32)
    if not d.exists():
        _write_token_files(np, d, tokens, DATA_ROWS // DATA_FILES)
    return d, tokens


def _row_digests(np, tokens):
    import collections
    import hashlib

    return collections.Counter(
        hashlib.blake2b(np.ascontiguousarray(row, dtype=np.int32).tobytes(),
                        digest_size=16).digest() for row in tokens)


def _device_kw():
    """``iter_torch_batches`` is left to its default device (the card);
    a CPU rehearsal names the host."""
    return {} if DEVICE == "cuda" else {"device": DEVICE}


def _ingest(torch, np, rt_data, files, tokens, remote_args, tag):
    """read_parquet → map_batches (the tokens column) →
    random_shuffle(seed=0) → streaming_split(1, equal=True) →
    iter_torch_batches onto the card; the timed loop keeps every batch on
    the card, then each row's digest is read back."""
    ds = (rt_data.read_parquet(str(files), ray_remote_args=remote_args)
          .map_batches(_tokens_from_ids, batch_format="pyarrow",
                       ray_remote_args=remote_args)
          .random_shuffle(seed=0))
    (split,) = ds.streaming_split(1, equal=True)
    produce = []                      # host numpy batch made: s a batch
    inner = split.iter_batches

    def timed_batches(**kw):
        gen = inner(**kw)
        while True:
            t = time.perf_counter()
            b = next(gen, None)
            produce.append(time.perf_counter() - t)
            if b is None:
                return
            yield b

    split.iter_batches = timed_batches
    got, waits = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = split.iter_torch_batches(batch_size=DATA_BATCH,
                                  dtypes={"tokens": torch.int64},
                                  **_device_kw())
    try:
        while True:
            t = time.perf_counter()
            b = next(it, None)
            if b is None:
                break
            waits.append(time.perf_counter() - t)
            got.append(b["tokens"])
    finally:
        split.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [(tuple(t.shape), str(t.dtype), t.device.type) for t in got
           if (tuple(t.shape), t.dtype, t.device.type)
           != ((DATA_BATCH, TRAIN_L), torch.int64, torch.device(DEVICE).type)]
    if bad or len(got) * DATA_BATCH != DATA_ROWS:
        fail(f"data {tag}: {len(got)} batches, wrong ones {bad[:3]}")
    rows = torch.cat(got).cpu().numpy()
    if _row_digests(np, rows) != _row_digests(np, tokens):
        fail(f"data {tag}: the rows that reached the card are not the "
             f"corpus's multiset")
    pin_copy = [w - p for w, p in zip(waits, produce)]
    nbytes = tokens.nbytes
    out = {"rows": len(rows), "batches": len(got), "wall_s": wall,
           "rows_per_s": len(rows) / wall, "gb_per_s": nbytes / wall / 1e9,
           "bytes": nbytes, "first_wait_ms": waits[0] * 1e3,
           "wait_ms_median": _median(waits) * 1e3,
           "wait_ms_max": max(waits) * 1e3,
           "pin_copy_ms_median": _median(pin_copy) * 1e3,
           "pin_copy_ms_max": max(pin_copy) * 1e3,
           "host_batch_ms_median": _median(produce[:len(waits)]) * 1e3}
    return out


def _data_line(tag, r, card):
    log(f"[data] {tag}: {r['rows']} rows ({r['bytes']} bytes of int32 "
        f"tokens) in {r['wall_s']:.3f} s = {r['rows_per_s']:.0f} rows/s, "
        f"{r['gb_per_s']:.3f} GB/s to the card; next() waits a batch median "
        f"{r['wait_ms_median']:.2f} ms, max {r['wait_ms_max']:.1f} ms (the "
        f"first, through the shuffle's barrier, {r['first_wait_ms']:.1f} "
        f"ms); host batch {r['host_batch_ms_median']:.2f} ms, pin + copy "
        f"{r['pin_copy_ms_median']:.2f} ms a batch (median); the row "
        f"multiset exact  [{card}]")


def phase_data_cluster(torch, np, rt, card, node_b):
    """18c, on phase 13's cluster before its teardown: 18a's pipeline with
    its read and map tasks on node B's CPU workers; this process (node A)
    iterates the split onto the card."""
    from ray_tpu_torch import data as rt_data
    from ray_tpu_torch.models import transformer

    files, tokens = _data_corpus(np, transformer.gpt2_small().vocab_size)
    on_b = {"scheduling_strategy": rt.NodeAffinitySchedulingStrategy(
        node_id=node_b.node_id, soft=False)}
    out = _ingest(torch, np, rt_data, files, tokens, on_b, "18c")
    _data_line("18c read and map tasks on node B, the split onto the card "
               "on node A", out, card)
    return out


def _data_trainer_loop(config):
    """18b's loop, in the trainer's worker: phase 6's step, each batch
    taken from the ``StreamSplitDataIterator`` in the loop's config onto
    the card; a report a step with its loss, time, wait on the iterator
    and K1-K3 launches."""
    import numpy as np
    import torch

    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models import training, transformer

    dev = torch.device(config["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = transformer.gpt2_small(max_seq_len=config["L"], remat=True)
    bundle = training.make_train_step(
        loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg),
        init_params_fn=lambda seed: transformer.init_params(
            cfg, seed, device=config["device"]),
        optimizer=training.adamw(3e-4, weight_decay=0.1),
        device=config["device"])
    params, opt = bundle.init(0)
    want = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (config["B"], config["L"])), device=dev)
    split = config["it"]
    batches = split.iter_torch_batches(batch_size=config["B"],
                                       dtypes={"tokens": torch.int64},
                                       **config["device_kw"])
    try:
        for step in range(config["steps"]):
            t_w = time.perf_counter()
            batch = next(batches)
            wait = time.perf_counter() - t_w
            tok = batch["tokens"]
            placed = {"device": str(tok.device), "dtype": str(tok.dtype),
                      "equal": bool(torch.equal(tok, want))}
            sync()
            t0 = time.perf_counter()
            before = _flash_now()
            params, opt, m = bundle.step(params, opt, batch)
            loss = m["loss"].item()
            t1 = time.perf_counter()
            after = _flash_now()
            rt_train.report({
                "step": step, "loss": loss, "step_ms": (t1 - t0) * 1e3,
                "t_end": t1, "wait_ms": wait * 1e3, "batch": placed,
                "n_layers": cfg.n_layers,
                "launches": {k: after[k] - before[k] for k in after}})
    finally:
        split.finish()


def _ppo_batch(np, spec, n, seed):
    """A PPO minibatch of ``n`` rows from a seed: uint8 pixels, actions,
    their logp, advantages and value targets."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.integers(0, 256, (n, spec.observation_dim)
                                ).astype(np.uint8),
            "actions": rng.integers(0, spec.action_dim, n).astype(np.float32),
            "logp": np.full(n, -np.log(spec.action_dim), np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": rng.standard_normal(n).astype(np.float32)}


def _ppo_learner(torch, np, card):
    """18d's learner leg: the Nature-CNN PPO learner that ``"auto"`` puts
    on the card, timed over PPO_ITERS iterations' minibatches; then one
    update on the card from a CPU learner's parameters against the same
    update on the CPU, TF32 off."""
    from ray_tpu_torch.rllib import PPOConfig, PPOLearner, RLModuleSpec
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    spec = RLModuleSpec(observation_dim=84 * 84 * 4, action_dim=6,
                        discrete=True, conv=True, obs_shape=(84, 84, 4),
                        hidden=(512,))
    c = PPOConfig()
    cfg = {"lr": c.lr, "clip_param": c.clip_param,
           "vf_clip_param": c.vf_clip_param, "vf_loss_coeff": c.vf_loss_coeff,
           "entropy_coeff": c.entropy_coeff, "grad_clip": c.grad_clip}
    learner = PPOLearner(spec, dict(cfg, device="auto"), seed=0)
    if learner.device.type != torch.device(DEVICE).type:
        fail(f"ppo: the auto learner of a {spec} module is on "
             f"{learner.device}")
    n_params = sum(p.numel() for p in tree_leaves(learner.params))
    policy_count = (spec.observation_dim * sum(spec.hidden)
                    + spec.hidden[-1] * spec.action_dim)
    rows = PPO_RUNNERS * PPO_ENVS * PPO_FRAGMENT
    ms, losses = [], []
    for it in range(PPO_ITERS):
        batch = _ppo_batch(np, spec, rows, it)
        for lo in range(0, rows, PPO_MINIBATCH):
            mb = {k: v[lo:lo + PPO_MINIBATCH] for k, v in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(learner.update(mb)["loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(x) for x in losses):
        fail(f"ppo: learner losses {losses}")
    # One update on the card against the CPU's, from the same parameters.
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        host = PPOLearner(spec, dict(cfg, device="cpu"), seed=1)
        card_l = PPOLearner(spec, dict(cfg, device="auto"), seed=2)
        card_l.set_weights(host.get_weights())
        batch = _ppo_batch(np, spec, PPO_MINIBATCH, 100)
        m_host, m_card = host.update(batch), card_l.update(batch)
        worst = 0.0
        for a, b in zip(tree_leaves(card_l.get_weights()),
                        tree_leaves(host.get_weights())):
            worst = max(worst, float(np.abs(a - b).max()
                                     / max(np.abs(b).max(), 1e-30)))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    loss_rel = abs(m_card["loss"] - m_host["loss"]) / abs(m_host["loss"])
    if worst > LEARNER_CARD_TOL or loss_rel > LEARNER_CARD_TOL:
        fail(f"ppo: the card's update against the CPU's: worst leaf "
             f"{worst:.3g} relative, loss {m_card['loss']} vs "
             f"{m_host['loss']} (tolerance {LEARNER_CARD_TOL})")
    out = {"device": str(learner.device), "params": n_params,
           "policy_count": policy_count, "updates": len(ms), "minibatch": PPO_MINIBATCH,
           "update_ms_median": _median(ms), "update_ms_first": ms[0],
           "update_ms_max": max(ms), "losses": losses,
           "card_vs_cpu_worst_leaf_rel": worst,
           "card_vs_cpu_loss_rel": loss_rel,
           "grad_norm_card": m_card["grad_norm"],
           "grad_norm_cpu": m_host["grad_norm"]}
    log(f"[ppo] 18d the Nature-CNN PPO learner ({n_params} parameters; "
        f"{policy_count} by the device policy's count) on "
        f"{learner.device} by the auto policy: {len(ms)} updates of "
        f"{PPO_MINIBATCH} rows, {out['update_ms_median']:.2f} ms an update "
        f"(median; the first {ms[0]:.1f} ms); losses finite. One update on "
        f"the card from a CPU learner's parameters against the CPU's, TF32 "
        f"off: worst leaf {worst:.3g} relative, loss {loss_rel:.3g} relative "
        f"(tolerance {LEARNER_CARD_TOL})  [{card}]")
    return out


def _ppo_run(torch, np, card):
    """18d's PPO run: SyntheticAtariEnv with the Nature-CNN module, env
    runners on the host CPU, the learner on the card by "auto"."""
    from ray_tpu_torch.rllib import PPOConfig, SyntheticAtariEnv

    algo = (PPOConfig().environment(SyntheticAtariEnv)
            .env_runners(num_env_runners=PPO_RUNNERS,
                         num_envs_per_env_runner=PPO_ENVS)
            .training(rollout_fragment_length=PPO_FRAGMENT, num_epochs=1,
                      minibatch_size=PPO_MINIBATCH, seed=0)
            .build())
    try:
        learner = algo.learner_group._local
        if learner.device.type != torch.device(DEVICE).type:
            fail(f"ppo: the PPO learner is on {learner.device}")
        upd, inner = [], algo.learner_group.update

        def timed(mb):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = inner(mb)
            upd.append((time.perf_counter() - t0) * 1e3)
            return m

        algo.learner_group.update = timed
        results = [algo.train() for _ in range(PPO_ITERS)]
    finally:
        algo.stop()
    if not all(math.isfinite(r["loss"]) for r in results):
        fail(f"ppo: losses {[r['loss'] for r in results]}")
    out = {"device": str(learner.device),
           "env_steps_per_s": [r["env_steps_per_sec"] for r in results],
           "timesteps_total": results[-1]["timesteps_total"],
           "losses": [r["loss"] for r in results],
           "update_ms_median": _median(upd), "updates": len(upd),
           "sample_s": [r["time_sample_s"] for r in results]}
    log(f"[ppo] 18d PPO on SyntheticAtariEnv: {PPO_RUNNERS} env runners x "
        f"{PPO_ENVS} envs x {PPO_FRAGMENT} steps, {PPO_ITERS} iterations, "
        f"{out['timesteps_total']} env steps, env steps/s "
        f"{[round(x, 1) for x in out['env_steps_per_s']]}; the learner on "
        f"{learner.device}: {len(upd)} updates of {PPO_MINIBATCH} rows, "
        f"{out['update_ms_median']:.2f} ms an update (median); losses "
        f"finite  [{card}]")
    return out


def phase_data(torch, np, card, counts, train, trainer, cluster_data):
    """18a, 18b and 18d on the in-process runtime (after phase 17), with
    18c's numbers (from phase 13's cluster) beside 18a's."""
    import importlib.util
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rt_data
    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models import transformer

    t_phase = time.perf_counter()
    have = {p: importlib.util.find_spec(p) is not None
            for p in ("pyarrow", "gymnasium", "pandas")}
    log(f"[data] packages: " + ", ".join(
        f"{p} {'imports' if ok else 'is absent'}" for p, ok in have.items()))
    vocab = transformer.gpt2_small().vocab_size
    summary = {"packages": have, "c": cluster_data}
    rt.init()
    try:
        # 18a: the pipeline alone, in this process's runtime.
        files, tokens = _data_corpus(np, vocab)
        summary["a"] = _ingest(torch, np, rt_data, files, tokens, None, "18a")
        _data_line("18a read, map and shuffle tasks in this process's "
                   "runtime, the split onto the card", summary["a"], card)
        c = cluster_data
        log(f"[data] 18c beside 18a: {c['rows_per_s']:.0f} vs "
            f"{summary['a']['rows_per_s']:.0f} rows/s, next() median "
            f"{c['wait_ms_median']:.2f} vs {summary['a']['wait_ms_median']:.2f}"
            f" ms, pin + copy {c['pin_copy_ms_median']:.2f} vs "
            f"{summary['a']['pin_copy_ms_median']:.2f} ms a batch")
        summary["b"] = _data_trainer(torch, np, rt_data, rt_train, card,
                                     counts, train, trainer)
        summary["d"] = {"learner": _ppo_learner(torch, np, card)}
        if have["gymnasium"]:
            summary["d"]["run"] = _ppo_run(torch, np, card)
        else:
            log("[ppo] gymnasium is absent here: 18d's PPO run (env runners "
                "on SyntheticAtariEnv) waits for it; the learner leg ran")
        summary["spans"] = _phase_spans_shipped("18a, 18b, 18d")
    finally:
        rt.shutdown()
    shutil.rmtree(_phase_dir("phase18"))
    gc.collect()
    torch.cuda.empty_cache()
    summary["launches"] = summary["b"]["launches"]
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[data] phase 18 (18a, 18b, 18d) took {summary['phase_s']:.1f} s")
    return summary


def _data_trainer(torch, np, rt_data, rt_train, card, counts, train, trainer):
    """18b: Data → ``TorchTrainer`` → GPT-2 124M: 17a's in-process trainer
    on phase 6's configuration, each step's batch from a
    ``StreamSplitDataIterator`` in ``train_loop_config``; the corpus is
    phase 6's batch 13 times, 16 rows a parquet file."""
    from ray_tpu_torch.models import transformer

    steps = TRAIN_WARMUP + TRAIN_STEPS
    cfg = transformer.gpt2_small(max_seq_len=TRAIN_L)
    batch = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_L)).astype(np.int32)
    files = _phase_dir("phase18") / "trainer"
    _write_token_files(np, files, np.concatenate([batch] * steps), TRAIN_B)
    ds = rt_data.read_parquet(str(files)).map_batches(
        _tokens_from_ids, batch_format="pyarrow")
    (split,) = ds.streaming_split(1, equal=True)
    config = {"device": DEVICE, "L": TRAIN_L, "B": TRAIN_B, "steps": steps,
              "it": split, "device_kw": _device_kw()}
    counts.reset()                   # this path's counts: 0 just before
    t0 = time.perf_counter()
    result = rt_train.TorchTrainer(
        _data_trainer_loop, train_loop_config=config,
        scaling_config=rt_train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=rt_train.RunConfig(
            name="data-trainer", storage_path=str(_phase_dir("phase18") / "storage")),
    ).fit()
    fit_s = time.perf_counter() - t0
    launches = counts.read()          # ... and read just after
    if result.error is not None:
        fail(f"data 18b: fit() failed: {result.error}")
    hist = result.metrics_history
    if len(hist) != steps:
        fail(f"data 18b: {len(hist)} reports for {steps} steps")
    dev_type = torch.device(DEVICE).type
    for h in hist:
        b = h["batch"]
        if (not b["device"].startswith(dev_type) or b["dtype"] != "torch.int64"
                or not b["equal"]):
            fail(f"data 18b step {h['step']}: the batch {b} (wanted phase "
                 f"6's, int64, on the card)")
    n = hist[0]["n_layers"]
    want = {"flash_forward": 2 * n, "flash_dq": n, "flash_dkv": n}
    for h in hist:
        if h["launches"] != want:
            fail(f"data 18b step {h['step']}: launches {h['launches']}, "
                 f"wanted {want}")
    total = {k: want[k] * steps for k in want}
    # Each step launches the bias-GELU pair as often as K1 and K2.
    total.update(bias_gelu_forward=total["flash_forward"],
                 bias_gelu_backward=total["flash_dq"])
    if {k: launches[k] for k in total} != total or any(
            launches[k] for k in launches if k not in total):
        fail(f"data 18b: launches {launches} in the run, wanted {total}")
    losses = [h["loss"] for h in hist]
    if losses != train["losses"]:
        fail(f"data 18b: losses {losses} are not phase 6's "
             f"{train['losses']} bit for bit")
    wall = hist[-1]["t_end"] - hist[TRAIN_WARMUP - 1]["t_end"]
    a = trainer["a"]
    out = {"fit_s": fit_s, "losses": losses,
           "step_ms": [h["step_ms"] for h in hist],
           "wait_ms": [h["wait_ms"] for h in hist],
           "wait_ms_median_timed": _median(
               [h["wait_ms"] for h in hist[TRAIN_WARMUP:]]),
           "timed_wall_s": wall,
           "step_ms_timed_mean": wall / TRAIN_STEPS * 1e3,
           "tokens_per_s": TRAIN_B * TRAIN_L * TRAIN_STEPS / wall,
           "trainer_17a_step_ms": a["step_ms_timed_mean"],
           "trainer_17a_tokens_per_s": a["tokens_per_s"],
           "phase6_step_ms": train["step_ms"],
           "phase6_tokens_per_s": train["tokens_per_s"],
           "launches": {k: launches[k] for k in want}}
    log(f"[data] 18b Data -> TorchTrainer -> gpt2_small: {TRAIN_STEPS} timed "
        f"steps at {out['step_ms_timed_mean']:.1f} ms a step (the iterator's "
        f"wait included), {out['tokens_per_s']:.0f} tokens/s (17a "
        f"{a['step_ms_timed_mean']:.1f} ms, {a['tokens_per_s']:.0f} "
        f"tokens/s; phase 6 {train['step_ms']:.1f} ms, "
        f"{train['tokens_per_s']:.0f} tokens/s); the loop's wait on the "
        f"iterator {out['wait_ms_median_timed']:.2f} ms a step (median); "
        f"every batch phase 6's, int64 on the card before its step; losses "
        f"= phase 6's bit for bit; flash {want} a step  [{card}]")
    return out


# -- phase 19 ----------------------------------------------------------------
LLM_RL_KW = dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=12,
                 d_ff=3072, max_seq_len=1024, vocab_multiple=128)
LLM_RL_ITERS, LLM_RL_ROLLOUTS, LLM_RL_BATCH = 3, 8, 8
LLM_RL_NEW, LLM_RL_LR = 32, 1e-5
RL_T, RL_N, RL_RUNNERS, RL_STEPS = 50, 8, 4, 16


def _lower_half_reward(prompt, completion):
    """19a's reward: the share of completion tokens in the vocab's lower
    half — a signal a random policy varies on, unlike the default reward's
    single target token at this vocab."""
    import numpy as np

    if not len(completion):
        return 0.0
    return float(np.mean(np.asarray(completion) < LLM_RL_KW["vocab_size"] // 2))


def _masked_rel(np, x, ref, mask):
    sel = mask > 0
    return float(np.abs(x[sel] - ref[sel]).max() / np.abs(ref[sel]).max())


def _llm_rl(torch, np, rt, card, counts):
    """19a: LLM-RL at GPT-2 124M widths; see the module docstring."""
    from ray_tpu_torch.rllib.llm_rl import (GenerationActor, LLMRL,
                                            LLMRLConfig, LLMRLLearner,
                                            token_logps)

    rng = np.random.default_rng(19)
    V = LLM_RL_KW["vocab_size"]
    prompts = [rng.integers(1, V, int(n)).tolist()
               for n in rng.integers(32, 129, 2 * LLM_RL_ROLLOUTS)]
    t0 = time.perf_counter()
    algo = LLMRL(LLMRLConfig(
        model_kwargs=dict(LLM_RL_KW, dtype=torch.bfloat16), prompts=prompts,
        reward_fn=_lower_half_reward, num_generators=2,
        rollouts_per_iter=LLM_RL_ROLLOUTS, max_new_tokens=LLM_RL_NEW,
        temperature=1.0, train_batch=LLM_RL_BATCH, updates_per_iter=2,
        lr=LLM_RL_LR, seed=0, learner_device=DEVICE))
    cfg = algo.model_config
    n = cfg.n_layers
    gens = algo.generators
    setup_s = time.perf_counter() - t0
    try:
        if algo.learner.device.type != torch.device(DEVICE).type:
            fail(f"llm-rl: the learner is on {algo.learner.device}")
        st0 = rt.get([g.kv_stats.remote() for g in gens])
        counts.reset()                 # this path's counts: 0 just before
        t_run = time.perf_counter()
        results = []
        for _ in range(LLM_RL_ITERS):
            t_it = time.perf_counter()
            r = algo.train()
            torch.cuda.synchronize()
            r["wall_s"] = time.perf_counter() - t_it
            results.append(r)
        run_s = time.perf_counter() - t_run
        launches = counts.read()       # ... and read just after
        st1 = rt.get([g.kv_stats.remote() for g in gens])

        # (v) exact launches
        d_pref, d_dec, k4 = _k4_by_route(cfg, st0, st1)
        rollouts = LLM_RL_ITERS * LLM_RL_ROLLOUTS
        updates = results[-1]["num_updates"]
        want = {"paged_attention": k4["wgmma"] + k4["split"],
                "paged_attention/wgmma": k4["wgmma"],
                "paged_attention/split": k4["split"],
                "flash_forward": n * (rollouts + updates),
                "flash_dq": n * updates, "flash_dkv": n * updates}
        if ({k: launches[k] for k in want} != want
                or not all(want.values())):
            fail(f"llm-rl: launches {launches}, wanted {want} (prefills "
                 f"{d_pref}, decode steps {d_dec}, {rollouts} behavior "
                 f"forwards, {updates} updates)")
        # (vi) finite rewards and losses
        if not all(math.isfinite(r["reward_mean"]) and math.isfinite(r["loss"])
                   for r in results):
            fail(f"llm-rl: rewards {[r['reward_mean'] for r in results]}, "
                 f"losses {[r['loss'] for r in results]}")

        # (iv) the weight sync drains the pools; then a greedy rollout
        # equals a fresh actor's on the learner's weights
        before = rt.get([g.kv_stats.remote() for g in gens])
        sync_s = algo.sync_weights()
        after = rt.get([g.kv_stats.remote() for g in gens])
        for b, a in zip(before, after):
            if (a["kv_blocks_active"] or a["kv_blocks_cached"]
                    or a["kv_blocks_free"] != a["kv_blocks_total"]):
                fail(f"llm-rl: a generator's pool after the weight sync: {a}")
        weights = algo.learner.get_weights()
        fresh = GenerationActor(cfg, slots=2, params=weights)
        greedy_p = prompts[:2]
        seeds = list(range(len(greedy_p)))
        synced = rt.get(gens[0].rollout.remote(greedy_p, seeds, LLM_RL_NEW,
                                               0.0))
        kern = fresh.rollout(greedy_p, seeds, LLM_RL_NEW, 0.0)
        if not np.array_equal(synced["tokens"], kern["tokens"]):
            fail("llm-rl: a greedy rollout after set_weights differs from a "
                 "fresh GenerationActor's on the learner's weights")

        # (i) the kernel's greedy batch against the plain (gather) path's
        plain = GenerationActor(cfg, slots=2, params=weights,
                                attention_kernel="gather")
        ref = plain.rollout(greedy_p, seeds, LLM_RL_NEW, 0.0)
        ties = []
        for b, p in enumerate(greedy_p):
            lo, hi = len(p), len(p) + LLM_RL_NEW
            ties += _same_greedy(
                torch, plain._engine.params, cfg, list(p),
                ref["tokens"][b, lo:hi].tolist(),
                {"kernel": kern["tokens"][b, lo:hi].tolist()}, "llm-rl",
                bf16=True)
        del plain

        # (ii) behavior log-probs: flash and dense bf16 against f32 dense
        toks = torch.as_tensor(kern["tokens"], device=DEVICE)
        mask = kern["gen_mask"]
        with torch.no_grad():
            lp = {name: token_logps(params, toks, c).cpu().numpy()
                  for name, params, c in (
                      ("flash", fresh._engine.params, cfg),
                      ("dense", fresh._engine.params,
                       cfg.replace(attn_impl="dense")),
                      ("f32", algo.learner.params, cfg.replace(
                          attn_impl="dense", dtype=torch.float32)))}
        lp_err = {k: _masked_rel(np, lp[k], lp["f32"], mask)
                  for k in ("flash", "dense")}
        if lp_err["flash"] > 2 * lp_err["dense"] + BF16_E2E_FLOOR:
            fail(f"llm-rl: behavior log-probs through flash err "
                 f"{lp_err['flash']:.2e} against f32 over twice dense bf16's "
                 f"{lp_err['dense']:.2e} plus {BF16_E2E_FLOOR}")
        # the behavior forward's time (flash, one padded sequence)
        one = toks[:1]
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fresh._token_logps(fresh._engine.params, one)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        del fresh

        # (iii) one learner update: flash and dense bf16 against f32 dense
        batch = algo.buffer.sample(LLM_RL_BATCH)
        batch = {"tokens": batch["tokens"], "gen_mask": batch["gen_mask"],
                 "behavior_logp": batch["behavior_logp"],
                 "advantage": batch["reward"] - float(np.mean(batch["reward"]))}
        lcfg = {"lr": LLM_RL_LR, "clip_param": 0.3, "grad_clip": 1.0,
                "device": DEVICE}
        upd = {}
        for name, c in (("flash", cfg), ("dense", cfg.replace(attn_impl="dense")),
                        ("f32", cfg.replace(attn_impl="dense",
                                            dtype=torch.float32))):
            learner = LLMRLLearner(c, lcfg, seed=1)
            upd[name] = learner.update(batch)
            del learner
            gc.collect()
        # The loss is a sum of advantage-signed terms near 0: its error is
        # taken relative to the advantages' mean size, the terms' scale.
        ref_m = upd["f32"]
        scale = {"loss": max(abs(ref_m["loss"]),
                             float(np.abs(batch["advantage"]).mean())),
                 "grad_norm": abs(ref_m["grad_norm"])}
        upd_err = {k: {m: abs(upd[k][m] - ref_m[m]) / max(scale[m], 1e-30)
                       for m in ("loss", "grad_norm")}
                   for k in ("flash", "dense")}
        for m in ("loss", "grad_norm"):
            if upd_err["flash"][m] > 2 * upd_err["dense"][m] + BF16_E2E_FLOOR:
                fail(f"llm-rl: one update's {m} through flash err "
                     f"{upd_err['flash'][m]:.2e} against f32 over twice dense "
                     f"bf16's {upd_err['dense'][m]:.2e} plus {BF16_E2E_FLOOR}")
    finally:
        algo.stop()
    gc.collect()
    torch.cuda.empty_cache()

    upd_ms = [r["time_update_s"] * 1e3 / max(1, r["num_updates"] - prev)
              for r, prev in zip(results,
                                 [0] + [x["num_updates"] for x in results])]
    out = {"setup_s": setup_s, "run_s": run_s, "launches": launches,
           "prefills": d_pref, "decode_steps": d_dec, "updates": updates,
           "rollouts": rollouts,
           "iterations": [{k: r[k] for k in (
               "reward_mean", "loss", "rollout_tokens", "time_weight_sync_s",
               "time_rollout_s", "time_update_s", "wall_s")} for r in results],
           "rollout_tokens_per_s": [r["rollout_tokens"] / r["time_rollout_s"]
                                    for r in results],
           "update_ms": upd_ms,
           "update_tokens_per_s": [LLM_RL_BATCH * cfg.max_seq_len / (m / 1e3)
                                   for m in upd_ms],
           "behavior_forward_ms": ms, "weight_sync_s": sync_s,
           "greedy_ties": ties, "logp_rel_err": lp_err,
           "update_rel_err": upd_err, "lr": LLM_RL_LR}
    log(f"[rl] 19a LLMRL at GPT-2 124M widths (vocab {V}, L "
        f"{cfg.max_seq_len}, bf16 compute, f32 parameters): 2 generators "
        f"on the card, the learner on {DEVICE}, lr {LLM_RL_LR}; set-up "
        f"{setup_s:.1f} s; {LLM_RL_ITERS} iterations in {run_s:.1f} s  [{card}]")
    for i, (r, tps, um) in enumerate(zip(results, out["rollout_tokens_per_s"],
                                         upd_ms)):
        log(f"[rl] 19a iteration {i + 1}: wall {r['wall_s']:.2f} s, rollouts "
            f"{r['time_rollout_s']:.2f} s ({r['rollout_tokens']} tokens, "
            f"{tps:.1f} tokens/s), updates {r['time_update_s'] * 1e3:.0f} ms "
            f"({um:.1f} ms an update, "
            f"{LLM_RL_BATCH * cfg.max_seq_len / (um / 1e3):.0f} tokens/s), "
            f"weight sync {r['time_weight_sync_s']:.3f} s, reward "
            f"{r['reward_mean']:.4f}, loss {r['loss']:.6f}  [{card}]")
    log(f"[rl] 19a behavior forward (flash, [1, {cfg.max_seq_len}]) "
        f"{_median(ms):.2f} ms median; weight sync learner -> 2 generators "
        f"(reset included) {sync_s:.3f} s; pools drained by it  [{card}]")
    log(f"[rl] 19a launches {launches} = K4 n_layers x (prefills {d_pref} "
        f"wgmma, decode steps {d_dec} split), K1 n_layers x ({rollouts} "
        f"behavior forwards + {updates} updates), K2 = K3 n_layers x "
        f"{updates}")
    log(f"[rl] 19a gates: greedy kernel == plain"
        + (f" up to {len(ties)} near tie(s)" if ties else "")
        + f"; after set_weights == a fresh actor; behavior logp err vs f32 "
        f"flash {lp_err['flash']:.2e} dense {lp_err['dense']:.2e}; update "
        f"loss/grad-norm err vs f32 flash {upd_err['flash']['loss']:.2e}/"
        f"{upd_err['flash']['grad_norm']:.2e} dense "
        f"{upd_err['dense']['loss']:.2e}/{upd_err['dense']['grad_norm']:.2e}")
    return out


def _impala_batch(np, T, N, seed):
    """A synthetic [T, N] IMPALA batch, CartPole-shaped, with autoreset
    steps (valids 0) after terminations."""
    rng = np.random.default_rng(seed)
    term = (rng.random((T, N)) < 0.05).astype(np.float32)
    valids = np.ones((T, N), np.float32)
    valids[1:][term[:-1] > 0] = 0.0
    return {"obs": rng.standard_normal((T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)).astype(np.float32),
            "logp": np.log(rng.uniform(0.2, 0.8, (T, N))).astype(np.float32),
            "rewards": np.ones((T, N), np.float32),
            "terminateds": term, "valids": valids,
            "bootstrap_obs": rng.standard_normal((N, 4)).astype(np.float32)}


def _impala_learners(torch, np, card):
    """19b: IMPALA's and APPO's learner update, card against CPU."""
    from ray_tpu_torch.rllib import (APPOLearner, ImpalaLearner,
                                     RLModuleSpec)
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(64, 64))
    cfg = {"lr": 5e-4, "gamma": 0.99, "vf_loss_coeff": 0.5,
           "entropy_coeff": 0.01, "clip_param": 0.2, "grad_clip": 40.0}
    batch = _impala_batch(np, RL_T, RL_N, 50)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for cls in (ImpalaLearner, APPOLearner):
            host = cls(spec, dict(cfg, device="cpu"), seed=0)
            card_l = cls(spec, dict(cfg, device=DEVICE), seed=1)
            card_l.set_weights(host.get_weights())
            m_host = host.update(batch)
            ms = []
            for i in range(4):        # the compared update, then 3 more
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = card_l.update(batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    m_card, got = m, card_l.get_weights()
            worst = 0.0
            for a, b in zip(tree_leaves(got), tree_leaves(host.get_weights())):
                worst = max(worst, float(np.abs(a - b).max()
                                         / max(np.abs(b).max(), 1e-30)))
            loss_rel = abs(m_card["loss"] - m_host["loss"]) / abs(m_host["loss"])
            if worst > LEARNER_CARD_TOL or loss_rel > LEARNER_CARD_TOL:
                fail(f"rl 19b: {cls.__name__}'s update on the card against "
                     f"the CPU's: worst leaf {worst:.3g}, loss "
                     f"{m_card['loss']} vs {m_host['loss']} (tolerance "
                     f"{LEARNER_CARD_TOL})")
            out[cls.__name__] = {"worst_leaf_rel": worst, "loss_rel": loss_rel,
                                 "update_ms": ms}
            log(f"[rl] 19b {cls.__name__} update on {card_l.device} "
                f"([T={RL_T}, N={RL_N}] CartPole-shaped, autoreset steps): "
                f"worst leaf {worst:.3g}, loss {loss_rel:.3g} relative to "
                f"the CPU's (tolerance {LEARNER_CARD_TOL}, TF32 off); "
                f"{_median(ms[1:]):.2f} ms an update (the first "
                f"{ms[0]:.1f} ms)  [{card}]")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out


def _inference_pool(torch, np, rt, card):
    """19c: an InferencePool serving 4 runners' steps, against
    each runner sampling locally with its own generator."""
    from ray_tpu_torch.rllib import InferencePool, RLModule, RLModuleSpec
    from ray_tpu_torch.rllib.rl_module import tree_map

    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(64, 64))
    module = RLModule(spec)
    params = module.init_params(3, "cpu")
    pool = InferencePool(1, spec, seed=0, num_clients=RL_RUNNERS)
    try:
        pool.set_weights(tree_map(lambda t: t.numpy().copy(), params))
        actor = pool.handle_for(0)

        def gens():
            out = []
            for i in range(RL_RUNNERS):
                g = torch.Generator()
                g.manual_seed(10_000 + 1000 * i)
                out.append(g)
            return out

        remote_g, local_g = gens(), gens()
        rng = np.random.default_rng(7)
        mismatched = 0
        t_pool = t_local = 0.0
        for _ in range(RL_STEPS):
            obs = [rng.standard_normal((RL_N, 4)).astype(np.float32)
                   for _ in range(RL_RUNNERS)]
            noise = [module.draw_noise(RL_N, g).numpy() for g in remote_g]
            t0 = time.perf_counter()
            got = rt.get([actor.infer.remote(o, z, False)
                          for o, z in zip(obs, noise)])
            t_pool += time.perf_counter() - t0
            t0 = time.perf_counter()
            with torch.inference_mode():
                want = [module.sample_action(params, torch.from_numpy(o), g)
                        for o, g in zip(obs, local_g)]
            t_local += time.perf_counter() - t0
            for (a, lp, v), (wa, wlp, wv) in zip(got, want):
                if not (np.array_equal(a, wa.numpy())
                        and np.array_equal(lp, wlp.numpy())
                        and np.array_equal(v, wv.numpy())):
                    mismatched += 1
    finally:
        pool.stop()
    if mismatched:
        fail(f"rl 19c: {mismatched} of {RL_STEPS * RL_RUNNERS} pooled steps "
             f"differ from runner-local sampling")
    out = {"steps": RL_STEPS, "runners": RL_RUNNERS,
           "pool_ms_a_step": t_pool / RL_STEPS * 1e3,
           "local_ms_a_step": t_local / RL_STEPS * 1e3}
    log(f"[rl] 19c InferencePool: {RL_STEPS} steps of {RL_RUNNERS} runners x "
        f"{RL_N} envs; actions, log-probs and values "
        f"bit for bit runner-local; {out['pool_ms_a_step']:.2f} ms a step "
        f"through the pool, {out['local_ms_a_step']:.2f} ms locally (host "
        f"CPU)  [{card}]")
    return out


def phase_rl(torch, np, card, counts):
    """19a, 19b and 19c on the in-process runtime (after phase 18)."""
    import importlib.util

    import ray_tpu_torch as rt

    t_phase = time.perf_counter()
    summary = {}
    rt.init()
    try:
        summary["a"] = _llm_rl(torch, np, rt, card, counts)
        summary["b"] = _impala_learners(torch, np, card)
        summary["c"] = _inference_pool(torch, np, rt, card)
        summary["spans"] = _phase_spans_shipped("19a, 19b, 19c")
    finally:
        rt.shutdown()
    if importlib.util.find_spec("gymnasium") is None:
        log("[rl] gymnasium is absent here: the env loops of IMPALA, APPO, "
            "DQN, SAC, CQL and the multi-agent PPO wait for it; 19a-19c ran")
    gc.collect()
    torch.cuda.empty_cache()
    summary["launches"] = summary["a"]["launches"]
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[rl] phase 19 (19a, 19b, 19c) took {summary['phase_s']:.1f} s")
    return summary


# -- phase 20: cluster operations ---------------------------------------------
JOB_TIMEOUT_S = 600                    # submit -> SUCCEEDED, a cold GPU worker
JOB_RESULT = "JOB_RESULT "             # the job driver's one result line
JOB_SCRIPT = "job_driver.py"
JOB_ENV = {"RAY_TPU_LOCK_ORDER_CHECK_ENABLED": "1",
           "RAY_TPU_LEAK_CHECK_ENABLED": "1"}
JOB_DTYPE = "bfloat16"                 # the job's model: gpt2_small in bf16
AUTOSCALE_PROBE = "autoscale-probe"    # a resource only the launched node has
AUTOSCALE_IDLE_S = 5.0


def _job_driver_source():
    """A submitted job's driver script (written into the run directory; not
    a file of the package). Its argv: GCS address, n_layers, dtype name."""
    return ("import sys\n"
            "import chip_smoke\n"
            "sys.exit(chip_smoke._job_main(sys.argv[1:]))\n")


def _job_main(argv):
    """The job's driver: attach to the cluster, build phase 13's engine
    actor (``num_gpus=1``, seed-0 weights) at ``n_layers`` in ``dtype``,
    serve phase 4's six greedy requests through it, then phase 13's eight
    (their decode rate set beside phase 13's), and print one
    ``JOB_RESULT`` line: the streams, K4's launches by route read in the
    actor's process, this process's lock-order violations, and its leaks
    after ``shutdown()``. This process holds no card."""
    import types

    from ray_tpu_torch.devtools import leakcheck, lockcheck

    before = leakcheck.snapshot()
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models import transformer

    address, n_layers, dtype = argv
    t0 = time.time()
    rt.init(address=address)
    cfg = transformer.gpt2_small(n_layers=int(n_layers),
                                 dtype=getattr(torch, dtype))
    a = rt.remote(num_gpus=1, max_concurrency=8)(_EngineActor).remote(
        cfg, 0, "job-actor")
    info = rt.get(a.info.remote(), timeout=JOB_TIMEOUT_S)
    info["setup_s"]["to_init"] = info["setup_s"].pop("init_at") - t0
    reqs = _pipeline_requests(np)
    st0 = rt.get(a.stats.remote())
    dec0 = rt.get(a.decode_counters.remote())
    rt.get(a.reset_launches.remote())
    no_card = types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None))
    results, wall = _serve(no_card, _ActorStreams(rt, a), reqs, "job")
    dec6 = rt.get(a.decode_counters.remote())
    # Then phase 13's eight requests (the six beside two sampled ones), as
    # phase 13's actor serves them: the decode rate to set beside its own.
    res8, wall8 = _serve(no_card, _ActorStreams(rt, a), _requests(np),
                         "job-8")
    launches = rt.get(a.launches.remote())
    st1 = rt.get(a.stats.remote())
    dec1 = rt.get(a.decode_counters.remote())
    rt.get(a.flush_metrics.remote())
    rt.kill(a)
    rt.shutdown()
    leaks = leakcheck.check(before)
    out = {"pid": os.getpid(), "actor": info,
           "streams": {n: r["tokens"] for n, r in results.items()},
           "launches": {r: launches[f"paged_attention/{r}"]
                        for r in ("wgmma", "split")},
           "prefills": int(st1["prefill_forwards"] - st0["prefill_forwards"]),
           "decode_steps": int(st1["decode_forwards"]
                               - st0["decode_forwards"]),
           "n_layers": cfg.n_layers, "wall_s": wall, "wall8_s": wall8,
           "tokens8": sum(len(r["tokens"]) for r in res8.values()),
           "requests8": len(res8),
           "decode_tokens_per_s": (dec6[0] - dec0[0]) / (dec6[1] - dec0[1]),
           "decode8_tokens_per_s": (dec1[0] - dec6[0]) / (dec1[1] - dec6[1]),
           "lockcheck_installed": lockcheck.installed(),
           "leakcheck_installed": leakcheck.installed(),
           "violations": lockcheck.violations(), "leaks": leaks}
    print(JOB_RESULT + json.dumps(out), flush=True)
    return 0


def _job_result(client, job_id):
    lines = [ln for ln in client.get_job_logs(job_id).splitlines()
             if ln.startswith(JOB_RESULT)]
    return json.loads(lines[-1][len(JOB_RESULT):]) if lines else None


def _wait_job(client, job_id, timeout_s, seen=None):
    """Poll ``job_id`` to a terminal state; ``seen`` gets the seconds at
    which each status was first seen."""
    from ray_tpu_torch.job_submission import JobStatus

    t0 = time.perf_counter()
    while True:
        status = client.get_job_status(job_id)
        if seen is not None:
            seen.setdefault(status, time.perf_counter() - t0)
        if status in JobStatus.TERMINAL:
            return status
        if time.perf_counter() - t0 > timeout_s:
            fail(f"ops: job {job_id} still {status} after {timeout_s} s:\n"
                 f"{client.get_job_logs(job_id)[-3000:]}")
        time.sleep(0.05)


def submit_gpt2_job(rt, client, run_dir, address, n_layers, dtype):
    """Write the job driver into ``run_dir`` and submit it with both runtime
    checkers on; returns (job id, its result line, status timings)."""
    from ray_tpu_torch.job_submission import JobStatus

    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / JOB_SCRIPT).write_text(_job_driver_source())
    t0 = time.perf_counter()
    job = client.submit_job(
        entrypoint=f"{sys.executable} {JOB_SCRIPT} {address} {n_layers} "
                   f"{dtype}",
        runtime_env={"working_dir": str(run_dir),
                     "env_vars": dict(JOB_ENV)})
    seen = {"submitted": time.perf_counter() - t0}
    status = _wait_job(client, job, JOB_TIMEOUT_S, seen)
    result = _job_result(client, job)
    if status != JobStatus.SUCCEEDED or result is None:
        fail(f"ops: the GPT-2 job ended {status}:\n"
             f"{client.get_job_logs(job)[-4000:]}")
    return job, result, seen


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http_get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def _cli(*args):
    """``python -m ray_tpu_torch.scripts <args>`` as a subprocess."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts",
                           *args], capture_output=True, text=True,
                          timeout=120, cwd=str(ROOT))
    if proc.returncode != 0:
        fail(f"ops: ray_tpu_torch.scripts {' '.join(args)} exited "
             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout), time.perf_counter() - t0


def _probe_task():
    import sys as _sys

    return os.getpid(), "torch" in _sys.modules


def phase_cluster_ops(torch, np, rt, card, cluster, node_a, node_b, procs,
                      cluster_summary):
    """Phase 20, inside phase 13's cluster before its teardown: a submitted
    job serves GPT-2 124M on the card (20a), the dashboard (20b), the CLI as
    a subprocess (20c), the autoscaler adding and removing a node (20d)."""
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.job_submission import (_STOP_WAIT_S, JobStatus,
                                              JobSubmissionClient,
                                              group_members)
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.util import flightrec

    out = {}
    t_phase = time.perf_counter()
    _wait_card_free(rt, "ops", "phase 13's actors")
    try:
        import aiohttp  # noqa: F401
        have_aiohttp = True
    except ImportError:
        have_aiohttp = False
    dash = None
    if have_aiohttp:
        from ray_tpu_torch.dashboard import start_dashboard

        dash = start_dashboard(port=_free_port())

    # 20a. The GPT-2 job, then one that fails and one that is stopped.
    client = JobSubmissionClient()
    run_dir = _phase_dir("phase20", fresh=True)
    L = transformer.gpt2_small().n_layers
    job, res, seen = submit_gpt2_job(rt, client, run_dir,
                                     cluster.gcs_address, L, JOB_DTYPE)
    want_streams = cluster_summary["actor"]["greedy_streams"]
    if res["streams"] != want_streams:
        bad = [n for n in want_streams if res["streams"].get(n)
               != want_streams[n]]
        fail(f"ops: the job's greedy streams differ from phase 13's actor's: "
             f"{bad}")
    want = {"wgmma": L * res["prefills"], "split": L * res["decode_steps"]}
    if res["launches"] != want or not all(want.values()):
        fail(f"ops: K4 launches by route in the job's actor "
             f"{res['launches']}, wanted {want} = {L} layers x (prefills "
             f"{res['prefills']}, decode steps {res['decode_steps']})")
    if not (res["lockcheck_installed"] and res["leakcheck_installed"]):
        fail(f"ops: the job's driver ran without its checkers: {res}")
    if res["violations"] or res["leaks"]:
        fail(f"ops: the job's driver: lock-order violations "
             f"{res['violations']}, leaks after shutdown() {res['leaks']}")
    info = res["actor"]
    if (info["engine"] != "PagedLLMEngine" or info["attention_kernel"] != "cuda"
            or torch_device_type(info["device"]) != DEVICE):
        fail(f"ops: the job's engine actor is {info}")
    procs.add(info["pid"])
    _wait_card_free(rt, "ops", "the job's actor")
    p13 = cluster_summary["actor"]
    job_a = {"job_id": job, "status_s": seen, "driver_pid": res["pid"],
             "actor_pid": info["pid"], "setup_s": info["setup_s"],
             "launches": res["launches"], "prefills": res["prefills"],
             "decode_steps": res["decode_steps"], "wall_s": res["wall_s"],
             "decode_tokens_per_s": res["decode_tokens_per_s"],
             "wall8_s": res["wall8_s"],
             "decode8_tokens_per_s": res["decode8_tokens_per_s"]}
    log(f"[ops] 20a job {job}: submit -> RUNNING {seen['RUNNING']:.2f} s -> "
        f"SUCCEEDED {seen['SUCCEEDED']:.2f} s; its driver (pid {res['pid']}, "
        f"lockcheck and leakcheck on) built {info['engine']} gpt2_small in a "
        f"num_gpus=1 actor (worker {info['pid']}; set-up "
        + ", ".join(f"{k} {v:.1f}" for k, v in info["setup_s"].items())
        + f" s) and served phase 4's {len(want_streams)} greedy requests in "
        f"{res['wall_s']:.2f} s: decode {res['decode_tokens_per_s']:.1f} "
        f"tokens/s; then phase 13's 8 requests in {res['wall8_s']:.2f} s: "
        f"decode {res['decode8_tokens_per_s']:.1f} tokens/s (phase 13's "
        f"actor {p13['decode_tokens_per_s']:.1f}, 8 requests); streams "
        f"equal phase 13's; K4 wgmma "
        f"{want['wgmma']} = {L} x {res['prefills']} prefills, split "
        f"{want['split']} = {L} x {res['decode_steps']} decode steps; no "
        f"lock-order violation, no leak after shutdown(); GPU back to 1  "
        f"[{card}]")

    t0 = time.perf_counter()
    failed = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import sys; print('job exits 3'); "
                   f"sys.exit(3)\"")
    if (_wait_job(client, failed, 120) != JobStatus.FAILED
            or client.get_job_info(failed)["returncode"] != 3
            or "job exits 3" not in client.get_job_logs(failed)):
        fail(f"ops: the exit-3 job: {client.get_job_info(failed)}")
    sleeper = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import time; time.sleep(600)\"")
    deadline = time.monotonic() + 60
    while client.get_job_status(sleeper) != JobStatus.RUNNING:
        if time.monotonic() > deadline:
            fail("ops: the sleeping job never ran")
        time.sleep(0.05)
    pgid = get_runtime().gcs.jobs[sleeper].driver_pid
    members = group_members(pgid)
    t_stop = time.monotonic()
    if not client.stop_job(sleeper) or _wait_job(client, sleeper, 60) \
            != JobStatus.STOPPED:
        fail(f"ops: stop_job: {client.get_job_info(sleeper)}")
    while True:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            break
        if time.monotonic() - t_stop > _STOP_WAIT_S + 12:
            fail(f"ops: the stopped job's process group {pgid} is alive: "
                 f"{group_members(pgid)} (before stop_job: {members})")
        time.sleep(0.05)
    gone_s = time.monotonic() - t_stop
    ends = {j: client.get_job_status(j) for j in (job, failed, sleeper)}
    log(f"[ops] 20a a job exiting 3 ended FAILED (returncode 3, its line in "
        f"the log); a sleeping job ended STOPPED under stop_job and its "
        f"process group {pgid} ({', '.join(m['comm'] for m in members)}) "
        f"was gone {gone_s:.2f} s after stop_job"
        + (f" (it outlived SIGTERM: SIGKILL after {_STOP_WAIT_S:.0f} s; "
           f"before stop_job {members})" if gone_s >= _STOP_WAIT_S else "")
        + f"; both in {time.perf_counter() - t0:.2f} s")
    out["jobs"] = {"gpt2": job_a, "ends": ends}

    # 20b. The dashboard.
    if dash is None:
        log("[ops] 20b aiohttp absent: the dashboard waits")
        out["dashboard"] = "aiohttp absent"
    else:
        t0 = time.perf_counter()
        try:
            nodes = json.loads(_http_get(f"{dash.url}/api/nodes"))
            card_nodes = [n for n in nodes if n.get("state") == "ALIVE"
                          and n["resources_total"].get("GPU") == 1.0]
            if (len(card_nodes) != 1 or any(
                    k.startswith("TPU") for n in nodes
                    for k in n["resources_total"])):
                fail(f"ops: /api/nodes {nodes}")
            jobs = {j["job_id"]: j["status"]
                    for j in json.loads(_http_get(f"{dash.url}/api/jobs"))}
            if any(jobs.get(j) != s for j, s in ends.items()):
                fail(f"ops: /api/jobs {jobs}, wanted {ends}")
            stats = json.loads(_http_get(f"{dash.url}/api/node_stats"))
            if len(stats) != 2 or any("error" in n or n.get("workers") is None
                                      for n in stats):
                fail(f"ops: /api/node_stats {stats}")
            text = _http_get(f"{dash.url}/metrics")
            tok = [ln for ln in text.splitlines()
                   if ln.startswith("ray_tpu_serve_tokens_total{")
                   and 'deployment="job-actor"' in ln]
            ttft = [ln for ln in text.splitlines()
                    if ln.startswith("ray_tpu_serve_ttft_s_count{")
                    and 'deployment="job-actor"' in ln
                    and 'phase="total"' in ln]
            n_tok = (sum(len(t) for t in res["streams"].values())
                     + res["tokens8"])
            n_req = len(want_streams) + res["requests8"]
            if (not tok or sum(float(ln.rsplit(" ", 1)[1]) for ln in tok)
                    != n_tok or not ttft or sum(
                    float(ln.rsplit(" ", 1)[1]) for ln in ttft) != n_req):
                fail(f"ops: /metrics: the job actor's series {tok} {ttft}, "
                     f"wanted {n_tok} tokens and {n_req} TTFTs")
        finally:
            dash.stop()
        out["dashboard"] = {"s": time.perf_counter() - t0, "jobs": jobs,
                            "nodes": len(nodes)}
        log(f"[ops] 20b dashboard: /api/nodes shows the card node with GPU 1 "
            f"and no TPU key; /api/jobs lists the three jobs "
            f"({', '.join(sorted(ends.values()))}); /api/node_stats answers "
            f"for both daemons; /metrics holds the job actor's "
            f"ray_tpu_serve_tokens_total ({n_tok}) and ray_tpu_serve_ttft_s "
            f"({n_req}); {time.perf_counter() - t0:.2f} s")

    # 20c. The CLI as a subprocess.
    status, status_s = _cli("status", "--gcs", cluster.gcs_address, "--json")
    alive = [n for n in status["nodes"] if n.get("alive")]
    if (len(alive) != 2 or sorted(n["resources"].get("GPU", 0)
                                  for n in alive) != [0, 1.0]):
        fail(f"ops: status --json nodes {status['nodes']}")
    session = flightrec.session_dir()
    dbg, debug_s = _cli("debug", "--session", session, "--gcs",
                        cluster.gcs_address, "--json")
    by_pid = {p["pid"]: p for p in dbg["processes"]}
    killed = cluster_summary["kill"]["pid"]
    dead = by_pid.get(killed)
    if (dead is None or dead["alive"] or dead["clean_exit"]
            or not any(f":{killed} is DEAD" in d for d in dbg["diagnosis"])):
        fail(f"ops: debug does not name phase 13's SIGKILLed worker "
             f"{killed} as a death: {dead}, {dbg['diagnosis'][:10]}")
    drv = by_pid.get(res["pid"])
    if drv is None or drv["alive"] or not drv["clean_exit"] or any(
            f":{res['pid']} " in d for d in dbg["diagnosis"]):
        fail(f"ops: debug: the job's driver {res['pid']} is {drv}")
    # The job's driver ends its actor with rt.kill, which SIGKILLs the
    # actor's worker (the daemon's kill_actor_worker), as in the JAX
    # package: its ring has no shutdown record, and debug names it DEAD.
    actor = info["pid"]
    actor_ring = by_pid.get(actor)
    if (actor_ring is None or actor_ring["alive"] or actor_ring["clean_exit"]
            or not any(f":{actor} is DEAD" in d for d in dbg["diagnosis"])):
        fail(f"ops: debug: the job's actor worker {actor}, killed by "
             f"rt.kill, is {actor_ring}, {dbg['diagnosis'][:10]}")
    out["cli"] = {"status_s": status_s, "debug_s": debug_s,
                  "rings": len(dbg["processes"]),
                  "deaths": len(dbg["diagnosis"])}
    log(f"[ops] 20c python -m ray_tpu_torch.scripts status --gcs --json: "
        f"both nodes alive, GPU 1 on one ({status_s:.2f} s); debug --session "
        f"--gcs --json over {len(dbg['processes'])} rings names phase 13's "
        f"SIGKILLed worker {killed} DEAD, the job's driver {res['pid']} a "
        f"clean exit, and the job's actor worker {actor}, which rt.kill "
        f"SIGKILLed, DEAD; {len(dbg['diagnosis'])} lines of diagnosis "
        f"({debug_s:.2f} s)")

    # 20d. The autoscaler adds a node for demand nothing can hold.
    out["autoscaler"] = _phase_autoscale(rt, cluster, node_a,
                                         cluster_summary)
    out["s"] = time.perf_counter() - t_phase
    return out


def _phase_autoscale(rt, cluster, node_a, cluster_summary):
    from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalerConfig,
                                          GcsAutoscalerView,
                                          LocalDaemonNodeProvider, NodeType)

    arena = cluster_summary["arena_bytes"]
    if arena != CLUSTER_ARENA:      # the new daemon's arena, cut as phase 13's
        os.environ["RAY_TPU_OBJECT_STORE_MEMORY"] = str(arena)
    provider = LocalDaemonNodeProvider(cluster.gcs_address)
    scaler = Autoscaler(provider, AutoscalerConfig(
        node_types=[NodeType("cpu-probe", {"CPU": 2, AUTOSCALE_PROBE: 1},
                             max_workers=1)],
        idle_timeout_s=AUTOSCALE_IDLE_S, update_interval_s=0.1),
        runtime=GcsAutoscalerView())
    try:
        t0 = time.perf_counter()
        ref = rt.remote(resources={AUTOSCALE_PROBE: 1})(_probe_task).remote()
        while not any(d.get(AUTOSCALE_PROBE) for d in
                      _gcs_call(cluster, "pending_resource_demands")):
            if time.perf_counter() - t0 > 30:
                fail("ops: the probe task never parked as a demand")
            time.sleep(0.05)
        parked = time.perf_counter() - t0
        scaler.start()
        while not provider.non_terminated_nodes():
            if time.perf_counter() - t0 > 60:
                fail("ops: the autoscaler launched no node")
            time.sleep(0.05)
        inst = provider.non_terminated_nodes()[0]
        registered = time.perf_counter() - t0
        pid, has_torch = rt.get(ref, timeout=120)
        result = time.perf_counter() - t0
        if has_torch:
            fail("ops: the probe task's worker imported torch")
        t1 = time.perf_counter()
        while provider.non_terminated_nodes():
            if time.perf_counter() - t1 > 60:
                fail("ops: the idle node was never terminated")
            time.sleep(0.1)
        terminated = time.perf_counter() - t1
        while True:
            nodes = _gcs_call(cluster, "list_nodes")
            gone = [n for n in nodes if n["node_id"] == inst.node_id]
            if gone and not gone[0]["alive"]:
                break
            if time.perf_counter() - t1 > 60:
                fail(f"ops: the terminated node is still alive: {gone}")
            time.sleep(0.1)
        left = time.perf_counter() - t1
    finally:
        scaler.stop()
        provider.shutdown()
        os.environ.pop("RAY_TPU_OBJECT_STORE_MEMORY", None)
    card = [n for n in nodes if n["node_id"] == node_a.node_id]
    if not card or not card[0]["alive"] or card[0]["resources"].get(
            "GPU") != 1.0 or rt.available_resources().get("GPU") != 1.0:
        fail(f"ops: the card node after the autoscaler: {card}")
    log(f"[ops] 20d autoscaler (LocalDaemonNodeProvider, one CPU node type "
        f"with {AUTOSCALE_PROBE}, max_workers 1, idle {AUTOSCALE_IDLE_S:.0f} "
        f"s): the probe task parked as a demand in {parked:.2f} s; a daemon "
        f"launched and registered {registered:.2f} s after the submit, the "
        f"task ran in its worker {pid} (no torch imported) at {result:.2f} "
        f"s; idle -> terminated {terminated:.2f} s, out of the alive set "
        f"{left:.2f} s; the card node untouched, GPU 1 free")
    return {"parked_s": parked, "registered_s": registered,
            "result_s": result, "terminated_s": terminated,
            "left_alive_set_s": left}


# -- phase 21: the static lint and its hot scopes ----------------------------
# The lint's hot-scope files that the serving path runs (the RL scopes run
# in phase 19, under their own gates).
LINT_SERVING_FILES = ("serve/llm.py", "models/generate.py")
LINT_GENERATE_TOKENS = 16


def _lint_report(out, err):
    """(findings by check, ms by phase) from ``lint.main``'s summary line
    ``raylint: clean (N baselined: check=n, ...)`` and ``--profile``'s
    lines ``  <phase> <ms> ms``."""
    import re

    m = re.search(r"raylint: clean \((\d+) baselined: ([^)]*)\)", out)
    if m is None:
        fail(f"lint: no summary line in its output: {out!r}")
    by_check = {}
    for part in m.group(2).split(", "):
        if "=" in part:
            k, v = part.split("=")
            by_check[k] = int(v)
    if sum(by_check.values()) != int(m.group(1)):
        fail(f"lint: findings by check {by_check} do not add up to "
             f"{m.group(1)}")
    ms = {}
    for line in err.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[2] == "ms":
            ms[parts[0]] = float(parts[1])
    if "total" not in ms:
        fail(f"lint: no --profile lines in its output: {err!r}")
    return by_check, ms


def _scope_codes(torchlint):
    """code object -> (file, scope name, qualname) for every function that
    the lint's HOT_SCOPES declares in the serving files."""
    import importlib

    codes = {}
    for path in LINT_SERVING_FILES:
        mod = importlib.import_module(
            "ray_tpu_torch." + path[:-3].replace("/", "."))
        names = torchlint.HOT_SCOPES[path]
        for obj in list(vars(mod).values()):
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if isinstance(obj, type):
                fns = [obj.__dict__.get(n) for n in names]
            else:
                fns = [obj] if getattr(obj, "__name__", None) in names else []
            for fn in fns:
                code = getattr(fn, "__code__", None)
                if code is not None:
                    codes[code] = (path, fn.__name__, fn.__qualname__)
        found = {n for p, n, _ in codes.values() if p == path}
        if set(names) - found:
            fail(f"lint: HOT_SCOPES names {sorted(set(names) - found)} in "
                 f"{path}, which has no such function")
    return codes


class _ScopeEntries:
    """Counts entries into the given code objects through ``sys.monitoring``
    local ``PY_START`` events (set on those code objects alone)."""

    def __init__(self, codes):
        self.codes = codes
        self.entries = {code: 0 for code in codes}
        self._lock = threading.Lock()
        self.tool = None

    def _on_start(self, code, _offset):
        with self._lock:
            self.entries[code] += 1

    def __enter__(self):
        mon = getattr(sys, "monitoring", None)
        if mon is None:
            fail("lint: sys.monitoring needs Python 3.12 or later")
        self.tool = next((i for i in range(6) if mon.get_tool(i) is None),
                         None)
        if self.tool is None:
            fail("lint: no free sys.monitoring tool id")
        mon.use_tool_id(self.tool, "chip_smoke phase 21")
        mon.register_callback(self.tool, mon.events.PY_START, self._on_start)
        for code in self.codes:
            mon.set_local_events(self.tool, code, mon.events.PY_START)
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        for code in self.codes:
            mon.set_local_events(self.tool, code, 0)
        mon.register_callback(self.tool, mon.events.PY_START, None)
        mon.free_tool_id(self.tool)


def phase_lint(torch, np, card, counts):
    """21a: the port's lint in this process, clean against its baseline.
    21b: phase 4's engine and requests and one ``Generator.generate`` under
    the steady-state guard, each declared serving hot scope's entries
    counted: every one must run, K4 on both routes, no violation."""
    import contextlib
    import io

    from ray_tpu_torch.devtools import jitcheck, lint, torchlint
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.generate import Generator
    from ray_tpu_torch.serve.llm import PagedLLMEngine

    t_phase = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = lint.main(["--check-baseline", "--profile"])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"lint: --check-baseline returned {rc}:\n{out.getvalue()}"
             f"{err.getvalue()}")
    by_check, ms = _lint_report(out.getvalue(), err.getvalue())
    summary = {"a": {"rc": rc, "wall_s": wall, "by_check": by_check,
                     "ms": ms, "python": sys.version.split()[0]}}
    log(f"[lint] 21a python -m ray_tpu_torch.devtools.lint --check-baseline "
        f"--profile in this process (Python {summary['a']['python']}): "
        f"clean, {sum(by_check.values())} baselined findings {by_check}; "
        f"{wall:.2f} s wall  [{card}]")
    log("[lint] 21a ms by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(ms.items(), key=lambda kv: -kv[1]))
        + f"  [{card}]")

    codes = _scope_codes(torchlint)
    cfg = transformer.gpt2_small()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device=DEVICE)
    eng = PagedLLMEngine(params, cfg, device=DEVICE)
    del params
    eng.warmup()
    if eng._pg.attention_kernel != "cuda":
        fail(f"lint: engine resolved attention to {eng._pg.attention_kernel!r}")
    gen = Generator(eng.params, cfg, device=DEVICE)
    reqs = _requests(np)
    prompt = next(r["prompt"] for r in reqs if r["name"] == "short")
    jitcheck.install()
    jitcheck.clear_violations()
    try:
        with _ScopeEntries(codes) as scopes:
            counts.reset()
            st0 = eng.stats()
            results, wall = _serve(torch, eng, reqs, "lint")
            launches = counts.read()
            st1 = eng.stats()
            toks = gen.generate(prompt, max_new_tokens=LINT_GENERATE_TOKENS)
            torch.cuda.synchronize()
    finally:
        violations = jitcheck.violations()
        jitcheck.uninstall()
    _check_streams(reqs, results, cfg.vocab_size)
    if len(toks) != LINT_GENERATE_TOKENS or not all(
            0 <= t < cfg.vocab_size for t in toks):
        fail(f"lint: Generator.generate gave {toks}")
    d_pref = int(st1["prefill_forwards"] - st0["prefill_forwards"])
    d_dec = int(st1["decode_forwards"] - st0["decode_forwards"])
    by_route = {r: launches[f"paged_attention/{r}"]
                for r in ("wgmma", "split")}
    if by_route != {"wgmma": cfg.n_layers * d_pref,
                    "split": cfg.n_layers * d_dec} or not all(
                        by_route.values()):
        fail(f"lint: K4 by route {by_route}, wanted wgmma {cfg.n_layers} x "
             f"{d_pref} prefills and split {cfg.n_layers} x {d_dec} decode "
             f"steps, both above 0")
    if violations:
        fail(f"lint: steady-state violations on the card: {violations}")
    entries = {q: scopes.entries[c] for c, (_p, _n, q) in sorted(
        codes.items(), key=lambda kv: kv[1])}
    by_scope = {}
    for code, (path, name, _q) in codes.items():
        key = f"{path}:{name}"
        by_scope[key] = by_scope.get(key, 0) + scopes.entries[code]
    unentered = sorted(k for k, v in by_scope.items() if v == 0)
    if unentered:
        fail(f"lint: declared hot scopes never entered on the card: "
             f"{unentered} (entries {entries})")
    if eng.kv.active_blocks() != 0:
        fail(f"lint: {eng.kv.active_blocks()} blocks still pinned after the "
             f"run")
    eng.close()
    del eng, gen
    gc.collect()
    torch.cuda.empty_cache()
    summary["b"] = {"entries_by_scope": by_scope, "entries": entries,
                    "launches": by_route, "prefill_forwards": d_pref,
                    "decode_forwards": d_dec, "generate_tokens": len(toks),
                    "serve_wall_s": wall, "violations": 0}
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[lint] 21b phase 4's engine, its 8 requests and one "
        f"{LINT_GENERATE_TOKENS}-token Generator.generate under jitcheck: "
        f"hot-scope entries {entries}; K4 wgmma {by_route['wgmma']} = "
        f"{cfg.n_layers} x {d_pref} prefills, split {by_route['split']} = "
        f"{cfg.n_layers} x {d_dec} decode steps; no steady-state "
        f"violation  [{card}]")
    log(f"[lint] phase 21 took {summary['phase_s']:.1f} s")
    return summary


def _leaf_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, f"{prefix}{k}/")
        else:
            yield prefix + k


def main() -> None:
    if not (ROOT / "ray_tpu_torch" / "ops" / "csrc").is_dir():
        fail(f"ray_tpu_torch/ not found beside {Path(__file__).name}: run "
             f"it from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    t_start = time.perf_counter()

    def done(phase):
        log(f"[time] phases to {phase} done in "
            f"{time.perf_counter() - t_start:.1f} s")

    card, kind, count = phase_device(torch)
    logs = phase_build()
    missing = set(logs) - {mod for mod, _ in COUNTERS.values()}
    if missing:
        fail(f"kernel sources without a check here: {sorted(missing)}")
    done(2)
    counts = Counts()
    cases, threshold = phase_kernels(torch, np, card)
    flash_cases = phase_flash_kernels(torch, np, card)
    bias_gelu_cases = phase_bias_gelu(torch, card)
    done(3)
    engine = phase_engine(torch, np, card, counts)
    e2e = phase_end_to_end(torch, np)
    done(5)
    train = phase_train(torch, np, card, counts)
    train_e2e = phase_train_end_to_end(torch, np, counts)
    done(7)
    mesh = phase_mesh(torch, np, card, counts, train)
    done(15)
    slotted, plain, params = phase_slotted(torch, np, card, engine)
    done(8)
    spec = phase_spec(torch, np, card, counts, plain, params)
    del plain, params
    done(9)
    disagg = phase_disagg(torch, np, card, counts, engine)
    done(10)
    runtime = phase_runtime(torch, np, card, kind, count, counts, engine)
    done(11)
    serving = phase_serve(torch, np, card, count, counts, engine, runtime)
    done(12)
    cluster = phase_cluster(torch, np, card, counts, runtime, serving,
                            train, mesh)
    tier = cluster.pop("tier")
    dag = cluster.pop("dag")
    done(16)
    trainer = phase_trainer(torch, np, card, counts, train,
                            cluster.pop("trainer"))
    done(17)
    data = phase_data(torch, np, card, counts, train, trainer,
                      cluster.pop("data"))
    done(18)
    rl = phase_rl(torch, np, card, counts)
    done(19)
    ops = cluster.pop("ops")
    log(f"[time] phase 20 (inside phase 13) took {ops['s']:.1f} s")
    done(20)
    lint_run = phase_lint(torch, np, card, counts)
    done(21)

    def bf16_case(label):
        return next(c for c in cases
                    if c["case"] == label and c["dtype"] == "bfloat16")

    main_case = bf16_case("decode")
    prefill = bf16_case("prefill T=1024 start=0")
    launches = engine["launches"]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "design": {"decode": main_case["design"],
                   "prefill": prefill["design"]},
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:49",
        "launches": launches["paged_attention"],
        "launches_by_route": {"wgmma": launches["paged_attention/wgmma"],
                              "split": launches["paged_attention/split"]},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "timed_case": "decode S=4 T=1 lengths [0,15,16,1000] bf16",
        "prefill_ms": prefill["ms"], "prefill_plain_ms": prefill["plain_ms"],
        "prefill_bound_ms": prefill["bound_ms"],
        "prefill_library_ms": prefill["library_ms"],
        "prefill_timed_case": "prefill S=1 T=1024 start 0 bf16",
        "spec_launches_by_route": {
            r: sum(run["launches"][r] for run in spec["runs"])
            for r in ("split", "wgmma")},
        "disagg_launches_by_route": disagg["launches"],
        "runtime_launches_by_route": runtime["launches"],
        "serve_launches_by_route": {
            r: serving["one_replica"]["launches"][r]
            + serving["two_replicas"]["launches"][r]
            for r in ("wgmma", "split")},
        "cluster_launches_by_route": {
            r: cluster["actor"]["launches"][r]
            + cluster["one_replica"]["launches"][r]
            + cluster["two_replicas"]["launches"][r]
            for r in ("wgmma", "split")},
        "tier_launches_by_route": tier["launches"],
        "dag_launches_by_route": dag["launches"],
        "job_launches_by_route": ops["jobs"]["gpt2"]["launches"],
        "llm_rl_launches": rl["launches"]["paged_attention"],
        "llm_rl_launches_by_route": {
            r: rl["launches"][f"paged_attention/{r}"]
            for r in ("wgmma", "split")},
        "lint_launches_by_route": lint_run["b"]["launches"],
    }]
    for name, (replaces, _) in FLASH.items():
        mine = [c for c in flash_cases if c["kernel"] == name]
        timed = next(c for c in mine if c["case"] == "train")
        kernels.append({
            "name": name, "route": "cuda", "design": timed["route"],
            "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces, "launches": train["launches"][name],
            "mesh_launches": mesh["launches"][name],
            "trainer_launches": trainer["launches"][name],
            "data_trainer_launches": data["launches"][name],
            "llm_rl_launches": rl["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "timed_case": "B=16 L=1024 H=12 D=64 causal bf16",
        })
    xl = next(c for c in bias_gelu_cases if c["case"] == "gpt2-xl")
    for d, key in (("forward", "ms"), ("backward", "backward_ms")):
        pre = "" if d == "forward" else "backward_"
        kernels.append({
            "name": f"bias_gelu_{d}", "route": "cuda",
            "design": "CUDA cores, 16-byte vectors, one wave of row splits",
            "source": "ray_tpu_torch/ops/csrc/bias_gelu.cu",
            "replaces": "the eager bias add, bf16 cast and tanh GELU "
                        "(port only: no TPU kernel)",
            "launches": train["launches"][f"bias_gelu_{d}"],
            "max_abs_err": max(max(c["errs"].values())
                               for c in bias_gelu_cases),
            "ms": xl[key], "plain_ms": xl[f"plain_{pre}ms"],
            "bound_ms": xl[f"{pre}bound_ms"], "bound_by": "bytes",
            "library_ms": xl[f"library_{pre}ms"],
            "timed_case": "[16384, 6400] (GPT-2 XL's MLP) bf16",
        })
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kind": kind, "count": count, "kernels": kernels,
         "cases": cases, "paged_threshold": threshold,
         "flash_cases": flash_cases, "bias_gelu_cases": bias_gelu_cases,
         "engine": engine, "end_to_end": e2e, "train": train,
         "train_end_to_end": train_e2e, "mesh": mesh, "slotted": slotted,
         "spec": spec,
         "disagg": disagg, "runtime": runtime, "serve": serving,
         "cluster": cluster, "tier": tier, "dag": dag, "trainer": trainer,
         "data": data, "rl": rl, "ops": ops, "lint": lint_run},
        indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))


if __name__ == "__main__":
    main()

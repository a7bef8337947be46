#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches an error and goes on):

1. device — the card's name and power limit (``nvidia-smi``), the torch
   device name and count; no CUDA device is a failure;
2. build — every kernel under ``ray_tpu_torch/ops/csrc`` from the checkout's
   sources, one ``nvcc`` per source, all started together; prints the
   ``-Xptxas -v`` lines (registers, shared memory, spills); a spill in a
   tensor-core kernel is a failure;
3. kernels — each kernel's wrapper against its plain PyTorch version at the
   main paths' shapes, in bf16 and f32, with its time, the plain version's
   time, one library call's time (a yardstick only) and the bound: the
   paged-attention kernel at the engine's shapes, the three flash-attention
   kernels at the train step's (B=16, L=1024, H=12, D=64, causal), each
   with its route (bf16 K1 and K3 on the tensor cores, the rest on the
   CUDA cores), TFLOP/s, and times over the bound and the library call;
   there the bf16 tensor-core kernels' errors must stay within twice those
   of torch's SDPA against the same plain versions;
4. engine — ``PagedLLMEngine`` on ``gpt2_small()`` at full width (bf16,
   random weights from a seed) answers 8 requests from concurrent threads,
   with a shared-prefix hit and a copy-on-write tail fork; the kernels'
   launch counts are set to 0 just before and read just after; then a
   short decode window runs under torch.profiler (device busy and idle
   share, time by kernel);
5. end to end — the same greedy requests through the kernel path and
   through the plain (gather) path, at gpt2_small widths with 2 layers in
   f32, must give the same tokens;
6. train — ``bench.py``'s configuration: ``gpt2_small(max_seq_len=1024,
   remat=True)``, 16 × 1024 tokens a step, AdamW(3e-4, weight_decay=0.1),
   3 warm-up and 10 timed steps with the launch counts set to 0 just
   before and read just after (per step: the flash forward 2 × n_layers,
   forward plus the remat recompute, dq and dkv n_layers each); a finite,
   falling loss; tokens/s, step time, peak memory; then one step under
   torch.profiler;
7. train end to end — gpt2_small widths with 2 layers, f32, B=2, L=1024:
   the flash kernels and ``attn_impl="dense"`` give the same loss and
   gradients, then the same losses over 3 AdamW steps; then both in bf16
   compute (where K1 and K3 run on the tensor cores), each held to the f32
   dense run: the flash errors in loss and gradients within twice dense
   bf16's plus one bf16 step.

It prints the kernels line ``{"kernels": [...]}`` and, last, the line
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
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
BF16_E2E_FLOOR = 4e-3                # train e2e bf16: one bf16 step (2^-8) of slack
DEVICE = "cuda"

# Kernel name -> (module of ray_tpu_torch.ops, its launch counter).
COUNTERS = {
    "paged_attention": ("paged_attention", "launches"),
    "flash_forward": ("flash_attention", "forward_launches"),
    "flash_dq": ("flash_attention", "dq_launches"),
    "flash_dkv": ("flash_attention", "dkv_launches"),
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
            if "_mma_kernel" in entry and any(_spill_counts(line)):
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
    a layer's weights pass through the cache between two attention calls)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device=DEVICE)

    def __call__(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for i in range(iters):
            self.flush.zero_()
            starts[i].record()
            fn()
            ends[i].record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


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
            got = pa.paged_attention(*case)
            torch.cuda.synchronize()
            want = pa.paged_attention_reference(*case)
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            if not torch.isfinite(got).all():
                fail(f"paged_attention {label} {dtype}: non-finite output")
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                fail(f"paged_attention {label} {dtype}: max abs err {err} "
                     f"over tolerance {tol}")
            if label == "decode":
                # NaN in the trash block: the kernel never reads a dead page,
                # so the live outputs stay bit for bit what they were.
                nan_case = (case[0], case[1].clone(), case[2].clone()) + \
                    case[3:]
                nan_case[1][0] = float("nan")
                nan_case[2][0] = float("nan")
                if not torch.equal(pa.paged_attention(*nan_case), got):
                    fail(f"paged_attention decode {dtype}: NaN in the trash "
                         f"block reached a live output")
            lib = _library_attention(torch, *case)
            lib_err = (lib.float() - want.float()).abs().max().item()
            ms = timer(lambda: pa.paged_attention(*case))
            plain_ms = timer(lambda: pa.paged_attention_reference(*case))
            lib_ms = timer(lambda: _library_attention(torch, *case))
            bound_ms, bound_by, nbytes, flops = _paged_bound(case, dtype)
            rec = {"case": label, "dtype": dtype, "S": len(lengths), "T": T,
                   "lengths": lengths, "max_abs_err": err, "tol": tol,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_max_abs_err": lib_err, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bytes": nbytes, "flops": flops}
            cases.append(rec)
            log(f"[kernel] paged_attention {label:24s} {dtype:8s} "
                f"err {err:.2e} (tol {tol:g})  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  library {lib_ms:.4f} ms  "
                f"bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
    return cases


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

    # Counts to 0 just before the run, read just after.
    counts.reset()
    st0 = eng.stats()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    st1 = eng.stats()
    if any(t.is_alive() for t in threads):
        fail("engine requests did not finish within 900 s")
    if errors:
        fail(f"engine requests failed: {errors}")

    for r in reqs:
        res = results[r["name"]]
        toks = res["tokens"]
        if len(toks) != r["max_new"]:
            fail(f"request {r['name']}: {len(toks)} tokens, wanted "
                 f"{r['max_new']} (finish {res.get('finish_reason')})")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {r['name']}: token out of [0, {cfg.vocab_size})")
    d_pref = int(st1["prefill_forwards"] - st0["prefill_forwards"])
    d_dec = int(st1["decode_forwards"] - st0["decode_forwards"])
    expected = cfg.n_layers * (d_pref + d_dec)
    if launches["paged_attention"] <= 0 or \
            launches["paged_attention"] != expected:
        fail(f"paged_attention launches {launches['paged_attention']} != "
             f"n_layers x (prefill {d_pref} + decode steps {d_dec}) = "
             f"{expected}")
    hits = st1["kv_hit_tokens"] - st0["kv_hit_tokens"]
    cows = st1["kv_cow_copies"] - st0["kv_cow_copies"]
    if hits < 256 or cows < 1:
        fail(f"prefix paths not exercised: hit tokens {hits}, COW forks "
             f"{cows}")
    if eng.kv.active_blocks() != 0:
        fail(f"{eng.kv.active_blocks()} blocks still pinned after the run")

    n_tok = sum(len(results[r["name"]]["tokens"]) for r in reqs)
    ttfts = sorted(results[r["name"]]["ttft_s"] * 1e3 for r in reqs)
    summary = {
        "requests": len(reqs), "tokens": n_tok, "wall_s": wall,
        "tokens_per_s_wall": n_tok / wall,
        "decode_tokens_per_s": eng.decode_tokens_per_sec(),
        "ttft_ms": {r["name"]: results[r["name"]]["ttft_s"] * 1e3
                    for r in reqs},
        "ttft_ms_median": ttfts[len(ttfts) // 2], "ttft_ms_max": ttfts[-1],
        "prefill_forwards": d_pref, "decode_forwards": d_dec,
        "launches": launches, "kv_hit_tokens": hits, "kv_cow_copies": cows,
        "prompt_lens": {r["name"]: len(r["prompt"]) for r in reqs},
    }
    log(f"[engine] {len(reqs)} requests, {n_tok} tokens in {wall:.2f} s: "
        f"{n_tok / wall:.1f} tokens/s wall, decode "
        f"{eng.decode_tokens_per_sec():.1f} tokens/s  [{card}]")
    log(f"[engine] TTFT median {summary['ttft_ms_median']:.1f} ms, max "
        f"{summary['ttft_ms_max']:.1f} ms  [{card}]")
    log(f"[engine] prefill dispatches {d_pref}, decode steps {d_dec}, "
        f"paged_attention launches {launches['paged_attention']} = "
        f"{cfg.n_layers} x {d_pref + d_dec}; prefix hit tokens {hits:.0f}, "
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
    from ray_tpu_torch.models import generate, transformer
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

    def plain_gap(tokens):
        """Top-2 logit gap of the plain path at the next position."""
        P = 1024
        kp, vp = generate.init_block_pool(cfg, 65, 16, DEVICE)
        table = torch.arange(1, 65, dtype=torch.int32, device=DEVICE)
        padded = torch.zeros((1, P), dtype=torch.long, device=DEVICE)
        padded[0, :len(tokens)] = torch.tensor(tokens)
        logits, _, _ = generate._forward_prefill_paged(
            plain.params, padded, kp, vp, table, 0, len(tokens), cfg, 16,
            kernel="gather")
        top = logits[0, len(tokens) - 1, :cfg.vocab_size].topk(2).values
        return (top[0] - top[1]).item()

    ties = []
    for p in prompts:
        a = kern.generate(p, max_new_tokens=24)
        b = plain.generate(p, max_new_tokens=24)
        if a == b:
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = plain_gap(p + b[:i])
        if gap >= TOP2_TIE:
            fail(f"end to end: prompt of {len(p)} tokens diverges at token "
                 f"{i} (kernel {a[i]}, plain {b[i]}) with a top-2 gap of "
                 f"{gap:.2e} >= {TOP2_TIE}")
        ties.append({"prompt_len": len(p), "position": i, "gap": gap})
        log(f"[e2e] prompt of {len(p)} tokens: first divergence at token {i} "
            f"is a near tie (plain top-2 gap {gap:.2e} < {TOP2_TIE})")
    log(f"[e2e] {len(prompts)} greedy requests, gpt2_small widths x 2 "
        f"layers, f32: kernel path == plain path"
        + (f" up to {len(ties)} near tie(s)" if ties else ""))
    return {"prompts": [len(p) for p in prompts], "ties": ties}


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
    if dtype == "bfloat16" and name in ("flash_forward", "flash_dkv"):
        return "tensor cores (mma.sync)"
    return "CUDA cores"


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
        del qt, kt, vt, lib_out, lib_grads
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
            "paged_attention": 0}
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
        f"{2 * n}, dq {n}, dkv {n} (total {launches})")

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

    # bf16 compute, where the tensor-core K1 and K3 run: the flash kernels
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
        if attn == "flash" and not (ran["flash_forward"] and
                                    ran["flash_dkv"]):
            fail(f"train e2e bf16: the flash kernels did not run ({ran})")
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

    card, kind, count = phase_device(torch)
    logs = phase_build()
    missing = set(logs) - {mod for mod, _ in COUNTERS.values()}
    if missing:
        fail(f"kernel sources without a check here: {sorted(missing)}")
    counts = Counts()
    cases = phase_kernels(torch, np, card)
    flash_cases = phase_flash_kernels(torch, np, card)
    engine = phase_engine(torch, np, card, counts)
    e2e = phase_end_to_end(torch, np)
    train = phase_train(torch, np, card, counts)
    train_e2e = phase_train_end_to_end(torch, np, counts)

    main_case = next(c for c in cases
                     if c["case"] == "decode" and c["dtype"] == "bfloat16")
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:49",
        "launches": engine["launches"]["paged_attention"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "timed_case": "decode S=4 T=1 lengths [0,15,16,1000] bf16",
    }]
    for name, (replaces, _) in FLASH.items():
        mine = [c for c in flash_cases if c["kernel"] == name]
        timed = next(c for c in mine if c["case"] == "train")
        kernels.append({
            "name": name, "route": "cuda", "design": timed["route"],
            "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces, "launches": train["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "timed_case": "B=16 L=1024 H=12 D=64 causal bf16",
        })
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kind": kind, "count": count, "kernels": kernels,
         "cases": cases, "flash_cases": flash_cases,
         "engine": engine, "end_to_end": e2e, "train": train,
         "train_end_to_end": train_e2e}, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))


if __name__ == "__main__":
    main()

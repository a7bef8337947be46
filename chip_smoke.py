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
   versions. Times are
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
   forward plus the remat recompute, dq and dkv n_layers each); a finite,
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
   delivered.

In phases 5, 8, 9 and 10 a greedy stream that departs from its reference must
do so at a near tie: the plain path's top-2 logit gap there under 1e-3.

It prints the kernels line ``{"kernels": [...]}`` and, last, the line
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
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


def _top2_gap(torch, params, cfg, tokens):
    """Top-2 logit gap of the plain (gather) path at the next position."""
    from ray_tpu_torch.models import generate

    P = 1024
    kp, vp = generate.init_block_pool(cfg, 65, 16, DEVICE)
    table = torch.arange(1, 65, dtype=torch.int32, device=DEVICE)
    padded = torch.zeros((1, P), dtype=torch.long, device=DEVICE)
    padded[0, :len(tokens)] = torch.tensor(tokens)
    logits, _, _ = generate._forward_prefill_paged(
        params, padded, kp, vp, table, 0, len(tokens), cfg, 16,
        kernel="gather")
    top = logits[0, len(tokens) - 1, :cfg.vocab_size].topk(2).values
    return (top[0] - top[1]).item()


def _same_greedy(torch, params, cfg, prompt, want, got, tag):
    """Each greedy stream of ``got`` (name -> tokens) equals ``want``, or
    first diverges at a near tie: the plain path's top-2 gap there below
    ``TOP2_TIE``. Returns the ties."""
    ties = []
    for name, toks in got.items():
        if toks == want:
            continue
        i = next((i for i, (x, y) in enumerate(zip(toks, want)) if x != y),
                 min(len(toks), len(want)))
        if i >= min(len(toks), len(want)):
            fail(f"{tag}: {name} gave {len(toks)} tokens, wanted {len(want)}")
        gap = _top2_gap(torch, params, cfg, prompt + want[:i])
        if gap >= TOP2_TIE:
            fail(f"{tag}: prompt of {len(prompt)} tokens, {name} diverges at "
                 f"token {i} ({toks[i]} vs {want[i]}) with a top-2 gap of "
                 f"{gap:.2e} >= {TOP2_TIE}")
        ties.append({"stream": name, "prompt_len": len(prompt),
                     "position": i, "gap": gap})
        log(f"[{tag}] prompt of {len(prompt)} tokens: {name}'s first "
            f"divergence at token {i} is a near tie (plain top-2 gap "
            f"{gap:.2e} < {TOP2_TIE})")
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
            "paged_attention/split": 0}
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
                ran[n] for n in ("flash_forward", "flash_dq", "flash_dkv")):
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
    done(3)
    engine = phase_engine(torch, np, card, counts)
    e2e = phase_end_to_end(torch, np)
    done(5)
    train = phase_train(torch, np, card, counts)
    train_e2e = phase_train_end_to_end(torch, np, counts)
    done(7)
    slotted, plain, params = phase_slotted(torch, np, card, engine)
    done(8)
    spec = phase_spec(torch, np, card, counts, plain, params)
    del plain, params
    done(9)
    disagg = phase_disagg(torch, np, card, counts, engine)
    done(10)

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
         "cases": cases, "paged_threshold": threshold,
         "flash_cases": flash_cases,
         "engine": engine, "end_to_end": e2e, "train": train,
         "train_end_to_end": train_e2e, "slotted": slotted, "spec": spec,
         "disagg": disagg},
        indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))


if __name__ == "__main__":
    main()

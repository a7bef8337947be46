#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches an error and goes on):

1. device — the card's name and power limit (``nvidia-smi``), the torch
   device name and count; no CUDA device is a failure;
2. build — every kernel under ``ray_tpu_torch/ops/csrc`` from the checkout's
   sources, one ``nvcc`` per source, all started together; prints the
   ``-Xptxas -v`` lines (registers, shared memory, spills);
3. kernels — each kernel's wrapper against its plain PyTorch version at the
   main path's shapes, in bf16 and f32, with its time, the plain version's
   time, one library call's time (a yardstick only) and the bound;
4. engine — ``PagedLLMEngine`` on ``gpt2_small()`` at full width (bf16,
   random weights from a seed) answers 8 requests from concurrent threads,
   with a shared-prefix hit and a copy-on-write tail fork; the kernels'
   launch counts are set to 0 just before and read just after; then a
   short decode window runs under torch.profiler (device busy and idle
   share, time by kernel);
5. end to end — the same greedy requests through the kernel path and
   through the plain (gather) path, at gpt2_small widths with 2 layers in
   f32, must give the same tokens.

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
DEVICE = "cuda"


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
    for name, text in logs.items():
        log(f"[build] {name}.cu (sm_90a)")
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry", "stack frame")):
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(logs)} kernel(s) ready in {dt:.1f} s")
    return logs


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


def phase_engine(torch, np, card, kernel_mods):
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
    for mod in kernel_mods.values():
        mod.launches = 0
    st0 = eng.stats()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in kernel_mods.items()}
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
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((e.key, dev, e.count))
    rows.sort(key=lambda r: -r[1])
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


def main() -> None:
    if not (ROOT / "ray_tpu_torch" / "ops" / "csrc").is_dir():
        fail(f"ray_tpu_torch/ not found beside {Path(__file__).name}: run "
             f"it from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    card, kind, count = phase_device(torch)
    logs = phase_build()
    from ray_tpu_torch.ops import paged_attention

    kernel_mods = {"paged_attention": paged_attention}
    missing = set(logs) - set(kernel_mods)
    if missing:
        fail(f"kernel sources without a check here: {sorted(missing)}")
    cases = phase_kernels(torch, np, card)
    engine = phase_engine(torch, np, card, kernel_mods)
    e2e = phase_end_to_end(torch, np)

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
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kind": kind, "count": count, "kernels": kernels,
         "cases": cases,
         "engine": engine, "end_to_end": e2e}, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))


if __name__ == "__main__":
    main()

"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false (the CPU test host). The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so this file imports only torch and numpy
and runs there with:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: 1e-4 in f32 (the kernels sum over up to ~1300 keys in another
order than the plain versions), 1e-2 in bf16 (both round an f32 result to
bf16; one bf16 step is 2^-8 relative; the bf16 flash kernels also round P
and dS to bf16 before their tensor-core products); the flash lse, f32 in
both dtypes, 1e-4. The bf16 tensor-core kernels' errors in o, dq, dk and
dv also stay within twice those of torch's SDPA against the same plain
versions. The tiny train step
through the flash kernels and through dense attention (f32): each gradient leaf 1e-4 relative to its largest entry,
floored at 1e-3 of the model's largest (bk's gradient is 0 in exact
arithmetic: both paths give rounding noise there), the losses of 3 AdamW
steps 1e-4 relative.

The MLP epilogue's kernel pair (``csrc/bias_gelu.cu``) at ragged and full
shapes: ``pre`` bit for bit, ``out`` and ``dpre`` within one bf16 step of
the plain versions (plus 1e-5 of the largest value where gelu' crosses 0),
``db`` the f32 column sums of the kernel's own ``dpre``; ``linear_gelu`` on
bf16 CUDA tensors within bf16 steps of f32 autograd, one launch each way.

The core runtime on the card: ``gpu_resources()`` registers the card; a bf16
CUDA tensor goes through ``put``/``get`` bit for bit below and above the
arena threshold; the paged engine hosted in a ``num_gpus=1`` actor gives the
direct engine's greedy streams on the kernel (2 layers, f32); and warm
engine steps on the card record no steady-state violation.

The multi-process cluster on the card: the paged engine in a worker
process's ``num_gpus=1`` actor gives the in-process engine's greedy streams
(2 layers, f32), and a SIGKILLed GPU worker's card memory and grant come
back.

A submitted job on the card: its driver (both runtime checkers on) serves
the six greedy requests of chip_smoke's phase 4 on a ``num_gpus=1`` engine
actor at 2 layers in f32, equal to the plain path's streams, with K4
launched in the actor, and records no lock-order violation or leak.

The cluster KV tier on the card: the tier's one-op extract (into pinned
host memory) and insert round-trip a bf16 chain bit for bit, and a store
hit at gpt2_small widths with 2 layers (f32) keeps a fresh prefill's
greedy stream.

The compiled DAG on the card: a ``DeviceChannel`` carries bf16 CUDA tensors
from one worker process to another, each landing on the reader's card bit
for bit (a burst through 2 slots, checked by sha256), and a
``backend="device"`` allreduce of CUDA tensors leaves every rank's result
on the card, equal to the torch sum.

Data and RLlib on the card: ``iter_torch_batches`` lands batches on the
card by default (dtype, device, values; through a streaming split too), and
one update of the conv PPO learner, and of the IMPALA and APPO learners, on
the card equals the CPU's within 1e-4 of each leaf's scale, TF32 off. The
LLM-RL learner's update at L=1024 through flash (K1-K3) equals dense
attention's (f32, 1e-4), and a ``GenerationActor`` on K4 gives the gather
path's greedy tokens and behavior log-probs (f32, 1e-4).
"""

import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import training, transformer
from ray_tpu_torch.ops import bias_gelu as bg
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import layers
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.models.generate import Generator
from ray_tpu_torch.serve.llm import LLMEngine, PagedLLMEngine

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(rng, dt, lengths, T, *, H=12, D=64, bt=16, nb_seq=64,
              num_blocks=513):
    S = len(lengths)

    def rnd(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda").to(dt)

    q, kp, vp = rnd(S, T, H, D), rnd(num_blocks, bt, H, D), rnd(
        num_blocks, bt, H, D)
    kp[0] = 1e9          # poisoned trash block
    vp[0] = -1e9
    tables = np.zeros((S, nb_seq), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    nxt = 0
    for s, ln in enumerate(lengths):
        live = min(-(-(ln + T) // bt), nb_seq)
        tables[s, :live] = perm[nxt:nxt + live]
        nxt += live
    return (q, kp, vp, torch.tensor(tables, device="cuda"),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def _paged_cases():
    """(lengths, T, geometry) rows that reach every route and edge of K4:
    the prefill rows (S = 1) at T on both sides of the wgmma threshold, of a
    64-row tile and of a split-kernel block of 8 rows, from contexts 0, 13
    and 256 (256 + 1024 runs past the table's 1024 positions); every block
    size and head_dim; S = 4 slots that mix one live split and many, with
    contexts at a split's boundary (176 keys: 11 pages of 16) and a page's,
    each ±1, and at the capacity − 1."""
    cases = [([start], T, {}) for T in (1, 2, 8, 9, 16, 17, 64, 65, 200, 1024)
             for start in (0, 13, 256)]
    for bt in (8, 16, 32):
        for D in (32, 64, 128):
            geom = dict(bt=bt, D=D, H=4 if D == 128 else 12)
            cap = 64 * bt
            cases += [([0, bt - 1, 5 * bt + 1, cap - 1], 1, geom),
                      ([13], 200, geom)]
    cases += [([0, 15, 16, 1000], 1, {}),                 # engine decode
              ([175, 176, 177, 1023], 1, {}),             # split edge ±1
              ([15, 16, 17, 1022], 2, {}),                # page edge ±1
              ([0, 17, 300], 5, {}),                      # multi-token
              ([5, 63, 64], 3, dict(bt=8, nb_seq=16, D=32)),
              ([100, 7], 2, dict(D=128, H=4))]
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths,T,geom", _paged_cases())
def test_kernel_matches_plain_version(cuda, dtype, lengths, T, geom):
    dt = getattr(torch, dtype)
    ops = _operands(np.random.default_rng(len(lengths) * 100 + T), dt,
                    lengths, T, **geom)
    before = pa.launches
    got = pa.paged_attention(*ops)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    assert got.dtype == dt and got.shape == ops[0].shape
    want = pa.paged_attention_reference(*ops)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dt],
                               rtol=TOL[dt])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths,T", [([0, 15, 16, 1000], 1), ([0], 16),
                                       ([13], 16), ([0], 1024)])
def test_nan_in_dead_pages_never_read(cuda, dtype, lengths, T):
    """NaN in the trash block (the table's dead entries point there): the
    decode and the prefill outputs stay bit for bit what they were."""
    ops = _operands(np.random.default_rng(5), getattr(torch, dtype),
                    lengths, T)
    clean = pa.paged_attention(*ops)
    kp, vp = ops[1].clone(), ops[2].clone()
    kp[0] = float("nan")
    vp[0] = float("nan")
    assert torch.equal(pa.paged_attention(ops[0], kp, vp, *ops[3:]), clean)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths,T", [([0, 15, 16, 1000], 1),
                                       ([175, 1023, 3, 500], 2), ([0], 1024)])
def test_repeat_calls_give_the_same_bits(cuda, dtype, lengths, T):
    """Two calls in a row give the same bits: the split kernel's merge
    counters are back at 0 after each call, and no sum depends on which
    block arrived last."""
    ops = _operands(np.random.default_rng(9), getattr(torch, dtype), lengths,
                    T)
    first = pa.paged_attention(*ops)
    assert torch.equal(pa.paged_attention(*ops), first)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 2, 4, 5, 8, 9, 16, 1024])
def test_route_and_its_counter(cuda, dtype, T):
    """bf16 at T >= WGMMA_MIN_T takes the wgmma kernel, everything else the
    split kernel, and only that route's counter moves."""
    dt = getattr(torch, dtype)
    want = "wgmma" if dt == torch.bfloat16 and T >= pa.WGMMA_MIN_T \
        else "split"
    assert pa.paged_route(T, dt) == want
    if dt == torch.float32 or T == 1:
        assert want == "split"
    if dt == torch.bfloat16 and T >= 16:
        assert want == "wgmma"
    ops = _operands(np.random.default_rng(T), dt, [7], T)
    before = (pa.launches, pa.prefill_launches, pa.decode_launches)
    pa.paged_attention(*ops)
    wg = want == "wgmma"
    assert (pa.launches, pa.prefill_launches, pa.decode_launches) == (
        before[0] + 1, before[1] + wg, before[2] + (not wg))


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    ops = _operands(np.random.default_rng(6), torch.float32, [3], 1,
                    D=16, H=4)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(*ops)
    ops = _operands(np.random.default_rng(6), torch.float32, [3], 1)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(ops[0], ops[1], ops[2], ops[3].long(), ops[4])
    with pytest.raises(ValueError, match="is on"):
        pa.paged_attention(ops[0], ops[1], ops[2], ops[3].cpu(), ops[4])
    with pytest.raises(TypeError, match="wgmma"):
        pa._paged_attention_cuda(*ops, 0.125, route="wgmma")


@pytest.mark.gpu
def test_engine_kernel_path_matches_gather_path(cuda):
    cfg = transformer.tiny(max_seq_len=64, n_heads=2)    # head_dim 32
    params = transformer.init_params(cfg, 0, device="cuda")
    kw = dict(prompt_buckets=(16, 32), chunk=4, slots=2, max_queue=0,
              block_tokens=8, pool_blocks=40)
    kern = PagedLLMEngine(params, cfg, attention_kernel="auto", **kw)
    plain = PagedLLMEngine(params, cfg, attention_kernel="gather", **kw)
    assert kern._pg.attention_kernel == "cuda"
    before = pa.launches
    for prompt in ([7, 3, 11], [2, 4, 6, 8, 10, 12, 14], list(range(20))):
        assert kern.generate(prompt, max_new_tokens=10) == plain.generate(
            prompt, max_new_tokens=10)
    assert pa.launches > before
    assert kern.kv.active_blocks() == plain.kv.active_blocks() == 0


# The speculative verify's shapes: T = k+1 query rows a slot, a slot near
# the table's end whose rows run past NB * bt (1024 here): slot 0 (its rows
# past the table must not read slot 1's entries), a fresh slot, slot 2
# exactly at the edge, slot 3 past it (the tables' last row).
SPEC_LENGTHS = [1022, 3, 1019, 1021]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route", [("float32", "split"),
                                         ("bfloat16", "split"),
                                         ("bfloat16", "wgmma")])
@pytest.mark.parametrize("T", [4, 5, 8])
def test_verify_rows_past_the_table(cuda, dtype, route, T):
    """Query rows at lengths + t >= NB * bt attend the whole table and no
    entry past it, on both routes: outputs match the plain version, and NaN
    in the trash block (the fresh slot's dead entries) reaches no row."""
    dt = getattr(torch, dtype)
    ops = _operands(np.random.default_rng(T), dt, SPEC_LENGTHS, T)
    s = 1.0 / ops[0].shape[-1] ** 0.5
    got = pa._paged_attention_cuda(*ops, s, route=route)
    torch.cuda.synchronize()
    want = pa.paged_attention_reference(*ops)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dt],
                               rtol=TOL[dt])
    kp, vp = ops[1].clone(), ops[2].clone()
    kp[0] = float("nan")
    vp[0] = float("nan")
    assert torch.equal(pa._paged_attention_cuda(ops[0], kp, vp, *ops[3:], s,
                                                route=route), got)


def _spec_models():
    """tiny widths raised to head_dim 64, f32: a target and three drafts
    (the target itself, the target + 0.05 × an independent init, and an
    independent one-layer init)."""
    cfg = transformer.tiny(d_model=128, n_heads=2, max_seq_len=128)
    params = transformer.init_params(cfg, 0, device="cuda")
    other = transformer.init_params(cfg, 1, device="cuda")

    def plus(a, b):
        return {k: plus(v, b[k]) if isinstance(v, dict) else v + 0.05 * b[k]
                for k, v in a.items()}

    near = plus(params, other)
    shallow = cfg.replace(n_layers=1)
    drafts = {"aligned": (params, cfg), "near": (near, cfg),
              "miss": (transformer.init_params(shallow, 2, device="cuda"),
                       shallow)}
    return cfg, params, drafts


SPEC_KW = dict(prompt_buckets=(16, 32, 64), chunk=4, slots=2, max_queue=0,
               block_tokens=16, pool_blocks=40)
SPEC_PROMPTS = [[7, 3, 11], list(range(40, 60)), [5, 9] * 20]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, 4])
def test_spec_engine_kernel_path_matches_gather_path(cuda, k):
    """The spec engine on the card: greedy streams through the kernel (the
    verify at T = k+1) equal the gather path's and the plain engine's, for
    every draft; blocks drain."""
    cfg, params, drafts = _spec_models()
    plain = PagedLLMEngine(params, cfg, attention_kernel="cuda", **SPEC_KW)
    want = [plain.generate(p, max_new_tokens=24) for p in SPEC_PROMPTS]
    for name, (dp, dc) in drafts.items():
        engs = [PagedLLMEngine(params, cfg, attention_kernel=kernel,
                               draft_params=dp, draft_config=dc,
                               spec_tokens=k, **SPEC_KW)
                for kernel in ("cuda", "gather")]
        before = pa.launches
        for e in engs:
            assert [e.generate(p, max_new_tokens=24)
                    for p in SPEC_PROMPTS] == want, name
            assert e.kv.active_blocks() == 0
            assert e.stats()["spec_forwards"] > 0
        assert pa.launches > before


@pytest.mark.gpu
def test_slotted_engine_on_the_card(cuda):
    """The slotted engine on the card: greedy streams equal the paged
    engine's (kernel path) and the Generator's."""
    cfg = transformer.tiny(d_model=128, n_heads=2, max_seq_len=128)
    params = transformer.init_params(cfg, 3, device="cuda")
    kw = dict(prompt_buckets=(16, 32, 64), chunk=4, slots=2, max_queue=0)
    slotted = LLMEngine(params, cfg, **kw)
    paged = PagedLLMEngine(params, cfg, block_tokens=16, pool_blocks=40,
                           **kw)
    oracle = Generator(params, cfg)
    assert slotted.device.type == "cuda" and oracle.device.type == "cuda"
    for p in SPEC_PROMPTS:
        want = oracle.generate(p, max_new_tokens=20)
        assert slotted.generate(p, max_new_tokens=20) == want
        assert paged.generate(p, max_new_tokens=20) == want
    m = slotted.device_metrics()
    assert m["device_ttft_ms"] > 0 and m["device_decode_tokens_per_sec"] > 0


def _flash_operands(seed, dt, B, Lq, Lk, H, D):
    rng = np.random.default_rng(seed)

    def rnd(L):
        return torch.tensor(rng.standard_normal((B, L, H, D)),
                            dtype=torch.float32, device="cuda").to(dt)

    return rnd(Lq), rnd(Lk), rnd(Lk), rnd(Lq)


def _flash_counts():
    return fa.forward_launches, fa.dq_launches, fa.dkv_launches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lq,lk", [(64, 64), (192, 192), (1024, 1024),
                                   (96, 160), (160, 96), (1000, 1000),
                                   (200, 520)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_kernels_match_plain_versions(cuda, dtype, causal, lq, lk, d):
    dt = getattr(torch, dtype)
    B, H = (2, 3) if lq < 1024 else (1, 2)
    q, k, v, g = _flash_operands(lq * 7 + d, dt, B, lq, lk, H, d)
    s = 1.0 / d ** 0.5
    before = _flash_counts()
    o, lse = fa.flash_forward(q, k, v, scale=s, causal=causal)
    torch.cuda.synchronize()
    assert _flash_counts() == (before[0] + 1, before[1], before[2])
    want_o, want_lse = fa.flash_forward_reference(q, k, v, scale=s,
                                                  causal=causal)
    assert o.dtype == dt and o.shape == q.shape and lse.shape == (B, H, lq)
    torch.testing.assert_close(o.float(), want_o.float(), atol=TOL[dt],
                               rtol=TOL[dt])
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    grads = fa.flash_backward(q, k, v, g, o, lse, scale=s, causal=causal)
    torch.cuda.synchronize()
    assert _flash_counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    want = fa.flash_backward_reference(q, k, v, g, o, lse, scale=s,
                                       causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert a.dtype == dt and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=TOL[dt],
                                   rtol=TOL[dt], msg=name)
    # No atomics: a second run gives the same bits.
    again = fa.flash_backward(q, k, v, g, o, lse, scale=s, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
def test_flash_bf16_errors_within_twice_sdpa(cuda):
    """The bf16 tensor-core K1-K3 round P and dS to bf16 before their
    products, as torch's scaled_dot_product_attention does: against the
    same plain versions their max errors in o, dq, dk and dv stay within
    twice SDPA's."""
    import torch.nn.functional as F

    q, k, v, g = _flash_operands(21, torch.bfloat16, 2, 1024, 1024, 4, 64)
    s = 0.125
    o, lse = fa.flash_forward(q, k, v, scale=s, causal=True)
    delta = fa._delta(g, o)
    dq = fa.flash_dq(q, k, v, g, lse, delta, scale=s, causal=True)
    dk, dv = fa.flash_dkv(q, k, v, g, lse, delta, scale=s, causal=True)
    want_o, _ = fa.flash_forward_reference(q, k, v, scale=s, causal=True)
    want_dq = fa.flash_dq_reference(q, k, v, g, lse, delta, scale=s,
                                    causal=True)
    want_dk, want_dv = fa.flash_dkv_reference(q, k, v, g, lse, delta,
                                              scale=s, causal=True)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_dq, lib_dk, lib_dv = torch.autograd.grad(lib_o, (qt, kt, vt),
                                                 g.transpose(1, 2))

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    for name, got, lib, want in (("o", o, lib_o, want_o),
                                 ("dq", dq, lib_dq, want_dq),
                                 ("dk", dk, lib_dk, want_dk),
                                 ("dv", dv, lib_dv, want_dv)):
        lib_err = err(lib.transpose(1, 2), want)
        assert err(got, want) <= 2 * lib_err, (name, err(got, want), lib_err)


@pytest.mark.gpu
def test_flash_autograd_on_strided_operands(cuda):
    """q, k, v as strided views of one [B, L, 3, H, D] tensor and an
    expanded output gradient go through the kernels like contiguous ones."""
    rng = np.random.default_rng(11)
    qkv = torch.tensor(rng.standard_normal((2, 128, 3, 4, 64)),
                       dtype=torch.float32, device="cuda")
    leaf = qkv.clone().requires_grad_(True)
    q, k, v = leaf.unbind(2)
    before = _flash_counts()
    fa.flash_attention(q, k, v, True).sum().backward()
    assert _flash_counts() == tuple(c + 1 for c in before)
    ref = qkv.clone().requires_grad_(True)
    fa._dense_reference(*ref.unbind(2), scale=0.125, causal=True).sum(
    ).backward()
    torch.testing.assert_close(leaf.grad, ref.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_refuses_what_it_cannot_take(cuda):
    q, k, v, g = _flash_operands(0, torch.float32, 1, 64, 64, 2, 16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward(q, k, v, scale=0.25, causal=True)
    q, k, v, g = _flash_operands(0, torch.float32, 1, 64, 64, 2, 64)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_forward(q, k.half(), v, scale=0.125, causal=True)
    with pytest.raises(ValueError, match="on"):
        fa.flash_forward(q, k.cpu(), v, scale=0.125, causal=True)
    o, lse = fa.flash_forward(q, k, v, scale=0.125, causal=True)
    delta = fa._delta(g, o)
    with pytest.raises(ValueError, match="lse and delta"):
        fa.flash_dq(q, k, v, g, lse[:, :1], delta, scale=0.125, causal=True)
    with pytest.raises(ValueError, match="lse and delta"):
        fa.flash_dkv(q, k, v, g, lse, delta.double(), scale=0.125,
                     causal=True)


@pytest.mark.gpu
def test_tiny_train_step_through_flash_kernels_matches_dense(cuda):
    base = transformer.tiny(n_heads=2, max_seq_len=128)     # head_dim 32
    tokens = torch.tensor(np.random.default_rng(12).integers(
        0, base.vocab_size, (2, 128)), device="cuda")
    results = {}
    for attn in ("flash", "dense"):
        cfg = base.replace(attn_impl=attn, remat=True)
        bundle = training.make_train_step(
            loss_fn=lambda p, b, cfg=cfg: transformer.lm_loss(p, b, cfg),
            init_params_fn=lambda seed: transformer.init_params(base, seed),
            optimizer=training.adamw(1e-3, weight_decay=0.1), device="cuda")
        params, opt = bundle.init(0)
        before = _flash_counts()
        transformer.lm_loss(params, {"tokens": tokens}, cfg).backward()
        grads = [p.grad.clone() for p in training._leaves(params)]
        n = base.n_layers if attn == "flash" else 0
        assert _flash_counts() == (before[0] + 2 * n, before[1] + n,
                                   before[2] + n)
        losses = []
        for _ in range(3):
            params, opt, m = bundle.step(params, opt, {"tokens": tokens})
            losses.append(m["loss"].item())
        results[attn] = grads, losses
    (gf, lf), (gd, ld) = results["flash"], results["dense"]
    floor = 1e-3 * max(b.abs().max() for b in gd)
    for a, b in zip(gf, gd):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), floor)
    np.testing.assert_allclose(lf, ld, rtol=1e-4)
    assert lf[-1] < lf[0]


@pytest.mark.gpu
def test_matmul_f32_runs_bf16_with_f32_output(cuda):
    """bf16 operands on the card: one tensor-core GEMM with an unrounded f32
    output (only the sum order differs from the f32 upcast: 1e-4), bf16
    gradients one rounding from the f32 ones (1e-2), and the same product
    with or without a graph to record."""
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.standard_normal((3, 5, 64)), dtype=torch.float32,
                     device="cuda").bfloat16()
    w = torch.tensor(rng.standard_normal((64, 48)), dtype=torch.float32,
                     device="cuda").bfloat16()
    want = torch.matmul(x.float(), w.float())
    got = layers.matmul_f32(x, w)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 48)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = layers.matmul_f32(xg, wg)
    assert torch.equal(y.detach(), got)
    g = torch.tensor(rng.standard_normal((3, 5, 48)), dtype=torch.float32,
                     device="cuda").bfloat16()
    y.to(torch.bfloat16).backward(g)
    xr, wr = x.float().requires_grad_(), w.float().requires_grad_()
    torch.matmul(xr, wr).backward(g.float())
    assert xg.grad.dtype == wg.grad.dtype == torch.bfloat16
    torch.testing.assert_close(xg.grad.float(), xr.grad, atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(wg.grad.float(), wr.grad, atol=1e-2,
                               rtol=1e-2)


# -- the MLP epilogue's kernel pair ---------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", [(1, 8), (7, 40), (1000, 264),
                                       (4099, 3072), (16384, 1000)])
def test_bias_gelu_kernels_match_plain_versions(cuda, rows, cols):
    """pre bit for bit; out and dpre within one bf16 step of the plain
    versions (1e-5 of the largest where gelu' nears 0); db the column sums
    of the kernel's own dpre to f32 rounding; two calls the same bits; one
    launch counted a call."""
    gen = torch.Generator(device="cuda").manual_seed(rows + cols)
    y = torch.randn(rows, cols, generator=gen, device="cuda") * 2
    b = (torch.randn(cols, generator=gen, device="cuda") * 0.5).bfloat16()
    g = (torch.randn(rows, cols, generator=gen, device="cuda")
         * 0.05).bfloat16()
    f0, b0 = bg.bias_gelu_forward_launches, bg.bias_gelu_backward_launches
    pre, out = bg.bias_gelu_forward(y, b)
    dpre, db = bg.bias_gelu_backward(g, pre)
    assert (bg.bias_gelu_forward_launches - f0,
            bg.bias_gelu_backward_launches - b0) == (1, 1)
    want_pre, want_out = bg.bias_gelu_reference(y, b)
    want_dpre, _ = bg.bias_gelu_backward_reference(g, pre)
    assert torch.equal(pre, want_pre)
    for got, want in ((out, want_out), (dpre, want_dpre)):
        got, want = got.float(), want.float()
        lim = 2 ** -7 * want.abs() + 1e-5 * want.abs().max()
        assert ((got - want).abs() <= lim).all()
    col_sums = dpre.float().sum(0)
    torch.testing.assert_close(db, col_sums, rtol=1e-5,
                               atol=1e-5 * col_sums.abs().max().item())
    assert torch.equal(bg.bias_gelu_forward(y, b, keep_pre=False)[1], out)
    assert all(torch.equal(a, c) for a, c in zip(
        bg.bias_gelu_backward(g, pre), (dpre, db)))


@pytest.mark.gpu
def test_bias_gelu_kernels_take_no_rows(cuda):
    """Zero rows: empty outputs and a zero bias gradient, not the unwritten
    partials."""
    y = torch.empty(0, 64, device="cuda")
    b = torch.ones(64, device="cuda").bfloat16()
    pre, out = bg.bias_gelu_forward(y, b)
    dpre, db = bg.bias_gelu_backward(torch.empty_like(pre), pre)
    assert pre.shape == out.shape == dpre.shape == (0, 64)
    assert torch.equal(db, torch.zeros(64, device="cuda"))


@pytest.mark.gpu
def test_linear_gelu_on_the_card(cuda):
    """``linear_gelu`` on bf16 CUDA tensors takes the kernels (one launch
    each way) and stays within bf16 steps of f32 autograd of the same
    expression; an f32 call keeps the eager chain and launches nothing."""
    rng = np.random.default_rng(17)

    def rnd(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32, device="cuda")

    x, w, b = rnd(3, 50, 64), rnd(64, 96, scale=0.2), rnd(96, scale=0.5)
    g = rnd(3, 50, 96)
    xb, wb, bb = (t.bfloat16().requires_grad_(True) for t in (x, w, b))
    f0, b0 = bg.bias_gelu_forward_launches, bg.bias_gelu_backward_launches
    out = layers.linear_gelu(xb, wb, bb)
    out.backward(g.bfloat16())
    assert (bg.bias_gelu_forward_launches - f0,
            bg.bias_gelu_backward_launches - b0) == (1, 1)
    xr, wr, br = (t.bfloat16().float().requires_grad_(True)
                  for t in (x, w, b))
    want = layers.gelu(xr @ wr + br)
    want.backward(g.bfloat16().float())
    for got, ref in ((out, want), (xb.grad, xr.grad), (wb.grad, wr.grad),
                     (bb.grad, br.grad)):
        assert got.dtype == torch.bfloat16
        scale = ref.abs().max().item()
        assert (got.float() - ref.detach()).abs().max().item() \
            <= 2 ** -6 * scale
    with torch.no_grad():
        assert torch.equal(layers.linear_gelu(xb, wb, bb), out.detach())
    f1 = bg.bias_gelu_forward_launches
    layers.linear_gelu(x, w, b)
    assert bg.bias_gelu_forward_launches == f1


# -- prefill/decode disaggregation on the card -----------------------------------
DISAGG_KW = dict(prompt_buckets=(16, 32, 64), chunk=4, slots=2, max_queue=0,
                 block_tokens=16, pool_blocks=40)


def _disagg_model(dtype=torch.float32):
    cfg = transformer.tiny(d_model=128, n_heads=2, max_seq_len=128,
                           dtype=dtype)
    return cfg, transformer.init_params(cfg, 3, device="cuda")


@pytest.mark.gpu
def test_handoff_round_trip_bit_exact_in_bf16(cuda):
    """bf16 blocks gathered from one pool on the card, sent through the
    lane (device to host straight into the slot), received as views of the
    slot and written into another pool: bit for bit, and the write lands in
    the pool tensors themselves."""
    from ray_tpu_torch.models.generate import PagedGenerator
    from ray_tpu_torch.serve.dag_pipeline import KVHandoffLane

    cfg, params = _disagg_model(torch.bfloat16)
    pg = PagedGenerator(params, cfg, slots=2, num_blocks=24, block_tokens=16,
                        device="cuda")
    src_k, src_v, _, _ = pg.init_state()
    dst_k, dst_v, _, _ = pg.init_state()
    g = torch.Generator(device="cuda").manual_seed(5)
    src_k.copy_(torch.randn(src_k.shape, generator=g, device="cuda"))
    src_v.copy_(torch.randn(src_v.shape, generator=g, device="cuda"))
    ids = np.array([3, 17, 9, 1], np.int32)
    k, v = pg.extract_fn(4)(src_k, src_v, ids)
    lane = KVHandoffLane(capacity=1 << 22, slots=2)
    try:
        lane.send({"n": 4}, k, v, timeout=5)
        meta, rk, rv, token = lane.recv(timeout=5)
        assert rk.device.type == "cpu" and rk.dtype == torch.bfloat16
        out_k, out_v = pg.insert_fn(4)(dst_k, dst_v, rk, rv,
                                       np.array([20, 2, 11, 5], np.int32))
        torch.cuda.synchronize()
        del rk, rv
        lane.ack(token)
    finally:
        lane.destroy()
    assert out_k is dst_k and out_v is dst_v
    for s, d in zip(ids.tolist(), (20, 2, 11, 5)):
        assert torch.equal(dst_k[:, d].view(torch.int16),
                           src_k[:, s].view(torch.int16))
        assert torch.equal(dst_v[:, d].view(torch.int16),
                           src_v[:, s].view(torch.int16))


@pytest.mark.gpu
def test_disaggregated_matches_colocated_on_the_kernel(cuda):
    """At 2 layers in f32 the disaggregated engine's greedy streams equal
    the colocated paged engine's on the kernel (decoding after the insert
    reads the blocks the handoff wrote), and both workers launch on the
    device's default stream."""
    from ray_tpu_torch.serve.llm import DisaggregatedLLMEngine

    cfg, params = _disagg_model()
    colo = PagedLLMEngine(params, cfg, name="gpu-colo", **DISAGG_KW)
    eng = DisaggregatedLLMEngine(params, cfg, name="gpu-disagg", **DISAGG_KW)
    streams = {}

    def on_stream(half, fn):
        def wrapped(*a, **k):
            dev = half.device
            on_default = (torch.cuda.current_stream(dev)
                          == torch.cuda.default_stream(dev))
            streams.setdefault(fn.__name__, set()).add(on_default)
            return fn(*a, **k)
        return wrapped

    eng.prefill.prefill_to_blocks = on_stream(eng.prefill,
                                              eng.prefill.prefill_to_blocks)
    eng.decode.admit_prefilled = on_stream(eng.decode,
                                           eng.decode.admit_prefilled)
    try:
        assert eng.device.type == "cuda"
        assert eng.decode._pg.attention_kernel == "cuda"
        before = pa.launches
        for p in SPEC_PROMPTS:
            assert eng.generate(p, max_new_tokens=20) == \
                colo.generate(p, max_new_tokens=20)
        assert pa.launches > before
        assert eng.decode.kv.active_blocks() == 0
        assert eng.prefill.kv.active_blocks() == 0
    finally:
        eng.close()
    assert streams == {"prefill_to_blocks": {True},
                       "admit_prefilled": {True}}


@pytest.mark.gpu
def test_disaggregated_refuses_a_lane_past_free_shm(cuda, monkeypatch):
    """With too little /dev/shm for the lane, building the engine raises
    ENOSPC naming the sizes, before any worker starts."""
    import threading

    from ray_tpu_torch.dag import channel
    from ray_tpu_torch.serve.llm import DisaggregatedLLMEngine

    class TinyShm:  # a 1 MiB filesystem with 64 KiB free
        f_frsize, f_blocks, f_bavail = 4096, 256, 16

    monkeypatch.setattr(channel.os, "statvfs", lambda path: TinyShm)
    cfg, params = _disagg_model()
    with pytest.raises(OSError, match="needs .* bytes of /dev/shm, which "
                                      "has 65536 free of 1048576"):
        DisaggregatedLLMEngine(params, cfg, name="gpu-noshm", **DISAGG_KW)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("gpu-noshm-disagg")]


# -- the core runtime on the card ---------------------------------------------


@pytest.fixture
def runtime(cuda):
    import ray_tpu_torch

    ray_tpu_torch.init()
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.gpu
def test_gpu_resources_on_the_card(runtime):
    from ray_tpu_torch.accelerators import gpu_model, gpu_resources

    n = float(torch.cuda.device_count())
    marker = f"GPU-{gpu_model(torch.cuda.get_device_name(0))}"
    assert gpu_resources() == {"GPU": n, marker: n}
    res = runtime.cluster_resources()
    assert res["GPU"] == n and res[marker] == n and "TPU" not in res


@pytest.mark.gpu
@pytest.mark.parametrize("numel", [1000, 1 << 20])  # 2 KB / 2 MB of bf16
def test_cuda_bf16_tensor_through_put_get_bit_for_bit(runtime, numel):
    from ray_tpu_torch.core.runtime import get_runtime

    g = torch.Generator(device="cuda").manual_seed(numel)
    t = torch.randn(numel // 8, 8, device="cuda", generator=g).to(
        torch.bfloat16)
    ref = runtime.put(t)
    back = runtime.get(ref)
    assert back.device.type == "cpu" and back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.cpu().view(torch.int16))
    entry = get_runtime().store._objects[ref.id]
    assert bool(entry.shm_keys) == (numel * 2 >= 64 * 1024)

    @runtime.remote(num_gpus=1)
    def twice(x):
        return x * 2

    out = runtime.get(twice.remote(t))  # a CUDA result, returned to host
    assert torch.equal(out, (t * 2).cpu())


class _EngineHost:
    def __init__(self, params, cfg, name):
        self.eng = PagedLLMEngine(params, cfg, name=name, **DISAGG_KW)
        self.eng.warmup()

    def generate(self, prompt, n):
        return self.eng.generate(prompt, max_new_tokens=n)

    def kernel(self):
        return self.eng._pg.attention_kernel, self.eng.device.type


@pytest.mark.gpu
def test_engine_actor_on_the_kernel_matches_direct(runtime):
    cfg, params = _disagg_model()
    direct = PagedLLMEngine(params, cfg, name="gpu-direct", **DISAGG_KW)
    want = [direct.generate(p, max_new_tokens=20) for p in SPEC_PROMPTS]
    host = runtime.remote(num_gpus=1, max_concurrency=3)(_EngineHost).remote(
        params, cfg, "gpu-actor")
    assert runtime.get(host.kernel.remote()) == ("cuda", "cuda")
    before = pa.launches
    got = runtime.get([host.generate.remote(p, 20) for p in SPEC_PROMPTS],
                      timeout=300)
    assert got == want
    assert pa.launches > before
    assert runtime.available_resources().get("GPU", 0) == \
        runtime.cluster_resources()["GPU"] - 1


@pytest.mark.gpu
def test_warm_engine_steps_on_the_card_record_no_violation(cuda):
    from ray_tpu_torch.devtools import jitcheck

    was = jitcheck.installed()
    jitcheck.install()
    jitcheck.clear_violations()
    try:
        cfg, params = _disagg_model()
        eng = PagedLLMEngine(params, cfg, name="gpu-steady", **DISAGG_KW)
        eng.warmup()
        for p in SPEC_PROMPTS:
            eng.generate(p, max_new_tokens=20)
        assert jitcheck.violations() == []
        t = torch.ones(3, device="cuda")
        with jitcheck.steady_state():
            jitcheck.device_get(t)
            assert jitcheck.violations() == []
            t.cpu()
        assert len(jitcheck.violations()) == 1
    finally:
        jitcheck.clear_violations()
        if not was:
            jitcheck.uninstall()


# -- the Serve stack on the card ------------------------------------------------


def _serve_streams(handle, prompts, n):
    """Greedy token streams of ``prompts`` through streaming handle calls,
    one thread each; the replica key each landed on."""
    import threading

    outs, keys, errs = [None] * len(prompts), [None] * len(prompts), []

    def client(i):
        try:
            gen = handle.options(stream=True).remote(
                {"prompt_ids": prompts[i], "max_new_tokens": n})
            keys[i] = gen._replica_key
            outs[i] = [item["token"] for item in gen]
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return outs, keys


@pytest.mark.gpu
def test_llm_deployment_on_the_card_counts_k4_by_route(runtime):
    """``serve.run(llm_deployment(...))`` with ``num_gpus=1`` in bf16: the
    replica holds the card, and K4's launches by route are n_layers x its
    engine's prefills (wgmma) and decode steps (split)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_deployment

    cfg, params = _disagg_model(torch.bfloat16)
    lm = llm_deployment(cfg, lambda: params, name="gpu-serve", slots=2,
                        chunk=4, ray_actor_options={"num_gpus": 1})
    try:
        handle = serve.run(lm.bind())
        stats = handle.options(method_name="get_engine_stats")
        st0 = stats.remote().result(timeout_s=300)
        assert runtime.available_resources().get("GPU", 0) == \
            runtime.cluster_resources()["GPU"] - 1
        wgmma0, split0 = pa.prefill_launches, pa.decode_launches
        outs, _ = _serve_streams(handle, SPEC_PROMPTS, 12)
        st1 = stats.remote().result(timeout_s=60)
        assert all(len(o) == 12 and all(0 <= t < cfg.vocab_size for t in o)
                   for o in outs)
        d_pref = st1["prefill_forwards"] - st0["prefill_forwards"]
        d_dec = st1["decode_forwards"] - st0["decode_forwards"]
        assert d_pref > 0 and d_dec > 0
        assert pa.prefill_launches - wgmma0 == cfg.n_layers * d_pref
        assert pa.decode_launches - split0 == cfg.n_layers * d_dec
        assert st1["kv_blocks_active"] == 0
    finally:
        serve.shutdown()


@pytest.mark.gpu
def test_two_half_gpu_replicas_match_the_direct_engine(runtime):
    """Two ``num_gpus=0.5`` replicas on one card, f32: both answer, and
    every greedy stream equals a direct engine's on the kernel."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_deployment

    cfg, params = _disagg_model()
    direct = PagedLLMEngine(params, cfg, name="gpu-serve-direct", slots=2,
                            chunk=4)
    prompts = SPEC_PROMPTS * 3
    want = [direct.generate(p, max_new_tokens=12) for p in SPEC_PROMPTS]
    lm = llm_deployment(cfg, lambda: params, name="gpu-serve-2", slots=2,
                        chunk=4, num_replicas=2,
                        ray_actor_options={"num_gpus": 0.5})
    try:
        handle = serve.run(lm.bind())
        # serve.run returns once both replicas exist; the router takes a
        # replica only once it passes readiness. One request at a time until
        # both have answered, so the burst below meets both.
        seen, deadline = set(), time.monotonic() + 120
        while len(seen) < 2:
            assert time.monotonic() < deadline, seen
            seen.update(_serve_streams(handle, SPEC_PROMPTS[:1], 1)[1])
        outs, keys = _serve_streams(handle, prompts, 12)
        assert outs == want * 3
        assert len(set(keys)) == 2
        assert runtime.available_resources().get("GPU", 0) == \
            runtime.cluster_resources()["GPU"] - 1
    finally:
        serve.shutdown()


@pytest.fixture
def gpu_cluster(cuda):
    import ray_tpu_torch
    from ray_tpu_torch.core.cluster import Cluster

    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 2, "GPU": 1})
    ray_tpu_torch.init(address=cluster.gcs_address)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    cluster.shutdown()


@pytest.mark.gpu
def test_engine_in_a_worker_process_matches_the_in_process_engine(
        gpu_cluster):
    import os

    rt = gpu_cluster

    class Host:  # defined here: workers get it by value
        def __init__(self, seed):
            from ray_tpu_torch.models import transformer as tr
            from ray_tpu_torch.serve.llm import PagedLLMEngine as Engine

            cfg = tr.tiny(d_model=128, n_heads=2, max_seq_len=128)
            self.eng = Engine(tr.init_params(cfg, seed, device="cuda"), cfg,
                              attention_kernel="cuda", name="gpu-worker",
                              **DISAGG_KW)

        def generate(self, prompt, n):
            return self.eng.generate(prompt, max_new_tokens=n)

        def where(self):
            from ray_tpu_torch.ops import paged_attention as kernel

            return (os.getpid(), self.eng.device.type,
                    self.eng._pg.attention_kernel, kernel.launches)

    cfg, params = _disagg_model()
    direct = PagedLLMEngine(params, cfg, attention_kernel="cuda",
                            name="gpu-direct", **DISAGG_KW)
    want = [direct.generate(p, max_new_tokens=20) for p in SPEC_PROMPTS]
    host = rt.remote(num_gpus=1)(Host).remote(3)
    got = rt.get([host.generate.remote(p, 20) for p in SPEC_PROMPTS],
                 timeout=300)
    pid, device, kernel, launches = rt.get(host.where.remote())
    assert got == want
    assert pid != os.getpid() and device == "cuda" and kernel == "cuda"
    assert launches > 0
    assert rt.available_resources().get("GPU", 0) == 0.0


@pytest.mark.gpu
def test_sigkilled_gpu_worker_gives_its_card_back(gpu_cluster):
    import os
    import signal

    rt = gpu_cluster

    class Holder:
        def __init__(self):
            self.buf = torch.empty(1 << 30, dtype=torch.uint8,
                                   device="cuda")

        def pid(self):
            return os.getpid()

    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    a = rt.remote(num_gpus=1)(Holder).remote()
    pid = rt.get(a.pid.remote(), timeout=300)
    assert free0 - torch.cuda.mem_get_info()[0] >= 1 << 30
    b = rt.remote(num_gpus=1)(Holder).remote()
    ready, _ = rt.wait([b.pid.remote()], timeout=2.0)
    assert not ready  # pending: the first holds the card
    os.kill(pid, signal.SIGKILL)
    with pytest.raises(rt.ActorError):
        rt.get(a.pid.remote(), timeout=120)
    assert rt.get(b.pid.remote(), timeout=300) != pid
    rt.kill(b)
    deadline = time.monotonic() + 30
    while free0 - torch.cuda.mem_get_info()[0] > 256 << 20:
        assert time.monotonic() < deadline, "the card's memory did not return"
        time.sleep(0.1)


@pytest.mark.gpu
def test_submitted_job_serves_on_the_kernel(cuda, tmp_path):
    """chip_smoke's phase 20a at 2 layers in f32: a submitted job's driver
    serves phase 4's six greedy requests on a ``num_gpus=1`` engine actor;
    its streams equal the plain path's in this process (``"gather"``, the
    card's plain path), K4 launched in the actor (f32: every call on the
    split route), and the driver, with both
    runtime checkers on, records no lock-order violation and no leak."""
    import os
    import sys

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.job_submission import JobSubmissionClient

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    cluster = Cluster(num_nodes=1, resources_per_node={"CPU": 4, "GPU": 1})
    rt.init(address=cluster.gcs_address)
    try:
        job, res, _seen = cs.submit_gpt2_job(
            rt, JobSubmissionClient(), tmp_path, cluster.gcs_address, 2,
            "float32")
        cfg = transformer.gpt2_small(n_layers=2, dtype=torch.float32)
        plain = PagedLLMEngine(
            transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cuda"),
            cfg, device="cuda", attention_kernel="gather", name="job-plain")
        want, _wall = cs._serve(torch, plain, cs._pipeline_requests(np),
                                "plain")
        assert res["streams"] == {n: r["tokens"] for n, r in want.items()}
        assert res["launches"] == {
            "wgmma": 0, "split": 2 * (res["prefills"] + res["decode_steps"])}
        assert res["launches"]["split"] > 0
        assert res["actor"]["attention_kernel"] == "cuda"
        assert res["actor"]["pid"] != os.getpid()
        assert res["violations"] == [] and res["leaks"] == []
        deadline = time.monotonic() + 60
        while rt.available_resources().get("GPU", 0) != 1.0:
            assert time.monotonic() < deadline
            time.sleep(0.1)
    finally:
        rt.shutdown()
        cluster.shutdown()


# -- the cluster KV tier on the card -------------------------------------------


@pytest.mark.gpu
def test_tier_extract_insert_round_trip_bit_exact_in_bf16(cuda):
    """The tier's one-op extract takes a bf16 chain off the card into pinned
    host memory, and its one-op insert writes it back into other pool
    blocks: bit for bit, into the pool tensors themselves."""
    cfg = transformer.gpt2_small(n_layers=2)
    eng = PagedLLMEngine(transformer.init_params(cfg, 3, device="cuda"),
                         cfg, device="cuda", pool_blocks=129)
    g = torch.Generator(device="cuda").manual_seed(7)
    for pool in (eng._k_pool, eng._v_pool):
        pool.copy_(torch.randn(pool.shape, generator=g, device="cuda"))
    src, dst = [5, 9, 2, 40, 41], [100, 101, 7, 60, 3]
    k, v = eng._tier_extract_blocks(src)
    assert k.device.type == "cpu" and k.is_pinned() and v.is_pinned()
    assert k.dtype == torch.bfloat16 and k.shape[1] == len(src)
    k_pool, v_pool = eng._k_pool, eng._v_pool
    eng._tier_insert_blocks(k, v, dst)
    torch.cuda.synchronize()
    assert eng._k_pool is k_pool and eng._v_pool is v_pool
    for s, d in zip(src, dst):
        assert torch.equal(k_pool[:, d].view(torch.int16),
                           k_pool[:, s].view(torch.int16))
        assert torch.equal(v_pool[:, d].view(torch.int16),
                           v_pool[:, s].view(torch.int16))
    with pytest.raises(ValueError, match="does not fit"):
        eng.kv_import_chain({"k": k.float(), "v": v.float(),
                             "tokens": list(range(80))})


@pytest.mark.gpu
def test_store_hit_keeps_the_fresh_prefill_stream(cuda, monkeypatch):
    """gpt2_small widths at 2 layers (f32) on the kernel: A spills a chain
    to the tier, B hits the store for it and prefills only the suffix, and
    B's greedy stream equals a fresh prefill's on an engine without the
    tier."""
    from ray_tpu_torch.serve import kv_tier

    cfg = transformer.gpt2_small(n_layers=2, dtype=torch.float32)
    params = transformer.init_params(cfg, 11, device="cuda")
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, 300).tolist()
    fresh = PagedLLMEngine(params, cfg, device="cuda", pool_blocks=129)
    fresh.warmup()
    want = fresh.generate(prompt, max_new_tokens=24)
    monkeypatch.setenv("RAY_TPU_KV_TIER_ENABLED", "1")
    kv_tier.reset_local_backend()
    try:
        a = PagedLLMEngine(params, cfg, device="cuda", pool_blocks=129)
        b = PagedLLMEngine(params, cfg, device="cuda", pool_blocks=129)
        a.warmup()
        b.warmup()
        assert a.generate(prompt, max_new_tokens=24) == want
        assert a.stats()["kv_tier_spilled_blocks"] == (300 + 24) // 16
        assert b.generate(prompt, max_new_tokens=24) == want
        assert b.stats()["kv_tier_hits_store"] == (299 // 16) * 16
        a.close()
        b.close()
    finally:
        kv_tier.reset_local_backend()


@pytest.mark.gpu
def test_device_channel_bf16_across_processes_onto_the_card(gpu_cluster):
    import hashlib
    import os

    from ray_tpu_torch.dag import DeviceChannel, InputNode

    rt = gpu_cluster

    def digest(t):
        return hashlib.sha256(t.detach().cpu().contiguous().reshape(-1)
                              .view(torch.uint8).numpy().tobytes()
                              ).hexdigest()

    class Producer:  # defined here: workers get them by value
        def __init__(self, n):
            g = torch.Generator(device="cuda").manual_seed(5)
            self.xs = [torch.randn(n, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(4)]

        def digests(self):
            return [digest(x) for x in self.xs]

        def pick(self, i):
            return self.xs[i % 4]

    class Consumer:
        def check(self, x):
            return (x.is_cuda, str(x.dtype), digest(x), os.getpid())

    n = 3 << 20  # 6 MiB of bf16 a tick
    a = rt.remote(num_gpus=0.5)(Producer).remote(n)
    b = rt.remote(num_gpus=0.5)(Consumer).remote()
    want = rt.get(a.digests.remote(), timeout=300)
    with InputNode() as inp:
        dag = b.check.bind(a.pick.bind(inp))
    compiled = dag.experimental_compile(channel_type="device",
                                        channel_slots=2,
                                        channel_capacity=2 * n + 4096)
    try:
        assert all(isinstance(ch, DeviceChannel)
                   for ch in compiled._channels.values())
        # A burst with 4 ticks in flight (2 x slots: the driver must read
        # its output ring before it writes further).
        got, refs = [], []
        for i in range(12):
            if len(refs) == 4:
                got.append(refs.pop(0).get(timeout=120))
            refs.append(compiled.execute(i))
        got += [r.get(timeout=120) for r in refs]
    finally:
        compiled.teardown()
    for i, (on_card, dtype, d, pid) in enumerate(got):
        assert on_card and dtype == "torch.bfloat16" and pid != os.getpid()
        assert d == want[i % 4], i


@pytest.mark.gpu
def test_device_backend_allreduce_stays_on_the_card(cuda):
    import threading

    from ray_tpu_torch.parallel import collectives as col

    world, results, errors = 4, {}, []

    def member(rank):
        try:
            col.init_collective_group(world, rank, backend="device",
                                      group_name="card")
            x = torch.full((1 << 20,), float(rank + 1), device="cuda",
                           dtype=torch.bfloat16)
            results[rank] = col.allreduce(x, op="sum", group_name="card")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((rank, e))

    threads = [threading.Thread(target=member, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for rank in range(world):
        out = results[rank]
        assert out.is_cuda and out.dtype == torch.bfloat16
        assert torch.equal(out, torch.full_like(out, 10.0))
    col.destroy_collective_group("card")


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """CUDA f32 and bf16 leaves and a world-1 DTensor through save_pytree,
    load_pytree and restore_pytree bit for bit, each restored leaf placed
    as its target (the card; the DTensor's mesh and placements); the
    AsyncCheckpointer's snapshot of CUDA tensors the same."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.parallel.mesh import MeshSpec, compute_mesh, make_mesh

    g = torch.Generator().manual_seed(7)
    f32 = torch.randn(33, 17, generator=g).cuda()
    bf16 = torch.randn(5, 64, generator=g).to("cuda", torch.bfloat16)
    started = not dist.is_initialized()
    mesh = make_mesh(MeshSpec(data=-1))
    try:
        dt = distribute_tensor(torch.randn(8, 4, generator=g).cuda(),
                               compute_mesh(mesh), [Shard(0)])
        tree = {"f32": f32, "bf16": bf16, "dt": dt, "step": 3}
        rt_train.save_pytree(tree, str(tmp_path / "s"))
        back = rt_train.load_pytree(str(tmp_path / "s"))
        assert back["f32"].tobytes() == f32.cpu().numpy().tobytes()
        assert back["bf16"].dtype == torch.bfloat16
        assert torch.equal(back["bf16"], bf16.cpu())
        target = {"f32": torch.zeros_like(f32), "bf16": torch.zeros_like(bf16),
                  "dt": distribute_tensor(torch.zeros(8, 4, device="cuda"),
                                          compute_mesh(mesh), [Shard(0)]),
                  "step": 0}
        got = rt_train.restore_pytree(target, str(tmp_path / "s"))
        assert got["f32"].is_cuda and torch.equal(got["f32"], f32)
        assert got["bf16"].is_cuda and torch.equal(got["bf16"], bf16)
        assert isinstance(got["dt"], DTensor)
        assert got["dt"].placements == dt.placements
        assert torch.equal(got["dt"].full_tensor(), dt.full_tensor())
        assert got["step"] == 3
        snap = f32.cpu()
        ck = rt_train.AsyncCheckpointer()
        ck.save(tree, str(tmp_path / "a"))
        f32.add_(1.0)                      # after the snapshot
        ck.wait()
        again = rt_train.load_pytree(str(tmp_path / "a"))
        assert again["f32"].tobytes() == snap.numpy().tobytes()
        assert torch.equal(again["bf16"], bf16.cpu())
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.gpu
def test_torch_trainer_runs_a_tiny_step_on_the_card(runtime, tmp_path):
    """``TorchTrainer(use_gpu=True)`` on the in-process runtime: one tiny
    train step on the card, its flash launches read in the worker."""
    from ray_tpu_torch import train as rt_train

    def loop(config):
        import torch

        from ray_tpu_torch.models import training, transformer
        from ray_tpu_torch.ops import flash_attention as fa

        cfg = transformer.tiny(n_heads=2, max_seq_len=128, attn_impl="flash",
                               remat=True)
        bundle = training.make_train_step(
            loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg),
            init_params_fn=lambda seed: transformer.init_params(cfg, seed),
            optimizer=training.adamw(1e-3))
        params, opt = bundle.init(0)
        tokens = torch.randint(0, cfg.vocab_size, (2, 128),
                               generator=torch.Generator().manual_seed(0))
        before = (fa.forward_launches, fa.dq_launches, fa.dkv_launches)
        params, opt, m = bundle.step(params, opt, {"tokens": tokens})
        after = (fa.forward_launches, fa.dq_launches, fa.dkv_launches)
        rt_train.report({"loss": m["loss"].item(),
                         "device": str(bundle.device),
                         "launches": [a - b for a, b in zip(after, before)],
                         "n_layers": cfg.n_layers})

    result = rt_train.TorchTrainer(
        loop, scaling_config=rt_train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=rt_train.RunConfig(storage_path=str(tmp_path), name="gpu"),
    ).fit()
    assert result.error is None, result.error
    m = result.metrics
    n = m["n_layers"]
    assert m["device"].startswith("cuda") and np.isfinite(m["loss"])
    assert m["launches"] == [2 * n, n, n]


@pytest.mark.gpu
def test_restored_adamw_resumes_on_the_fused_route(cuda, tmp_path):
    """Params and ``adamw_state_tree`` checkpointed after 2 steps on the
    card, restored into a fresh bundle (the fused AdamW: its step on the
    card): the next step's loss and parameters equal the uninterrupted
    run's."""
    from ray_tpu_torch import train as rt_train

    cfg = transformer.tiny(attn_impl="dense")
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 64)), device="cuda")

    def bundle():
        return training.make_train_step(
            loss_fn=lambda p, b: transformer.lm_loss(p, b, cfg),
            init_params_fn=lambda seed: transformer.init_params(cfg, seed),
            optimizer=training.adamw(1e-3, weight_decay=0.1), device="cuda")

    b = bundle()
    params, opt = b.init(0)
    assert opt.param_groups[0]["fused"]
    for _ in range(2):
        params, opt, _ = b.step(params, opt, {"tokens": tokens})
    d = str(tmp_path / "ck")
    rt_train.save_pytree({"params": params,
                          "opt": training.adamw_state_tree(opt, params)}, d)
    params, opt, m = b.step(params, opt, {"tokens": tokens})

    b2 = bundle()
    fresh, fresh_opt = b2.init(1)                  # other weights: overwritten
    back = rt_train.restore_pytree(
        {"params": fresh, "opt": training.adamw_state_tree(fresh_opt, fresh)}, d)
    p2 = back["params"]
    opt2 = training.load_adamw_state_tree(
        training.adamw(1e-3, weight_decay=0.1).init(p2), p2, back["opt"])
    assert opt2.param_groups[0]["fused"]
    assert all(opt2.state[p]["step"].is_cuda for p in training._leaves(p2))
    p2, opt2, m2 = b2.step(p2, opt2, {"tokens": tokens})
    np.testing.assert_allclose(m2["loss"].item(), m["loss"].item(), rtol=1e-6)
    for a, c in zip(training._leaves(params), training._leaves(p2)):
        torch.testing.assert_close(c, a, rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
def test_iter_torch_batches_lands_on_the_card(runtime):
    """``iter_torch_batches`` with its default device: every column on the
    card, int32 tokens cast to int64 through ``dtypes``, values equal to
    the dataset's; a read-only arrow column is copied (no warning)."""
    import warnings

    from ray_tpu_torch import data as rt_data

    rows = np.random.default_rng(0).integers(0, 50257, (40, 64)).astype(np.int32)
    ds = rt_data.from_numpy({"tokens": rows, "w": np.arange(40, dtype=np.float32)})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        batches = list(ds.iterator().iter_torch_batches(
            batch_size=8, dtypes={"tokens": torch.int64}))
    assert len(batches) == 5
    for i, b in enumerate(batches):
        assert b["tokens"].is_cuda and b["tokens"].dtype == torch.int64
        assert b["w"].is_cuda and b["w"].dtype == torch.float32
        np.testing.assert_array_equal(b["tokens"].cpu().numpy(),
                                      rows[8 * i:8 * (i + 1)])
    (split,) = ds.streaming_split(1, equal=True)
    got = [b["tokens"] for b in split.iter_torch_batches(batch_size=8)]
    split.finish()
    assert all(t.is_cuda for t in got)
    assert sorted(map(tuple, torch.cat(got).cpu().numpy())) == sorted(
        map(tuple, rows))
    with pytest.raises(ValueError, match="pin_memory"):
        next(ds.iterator().iter_torch_batches(batch_size=8, device="cpu",
                                              pin_memory=True))


@pytest.mark.gpu
def test_learner_update_on_the_card_equals_the_cpu(cuda):
    """The conv PPO learner that "auto" puts on the card: one update from
    a CPU learner's parameters equals the same update on the CPU, within
    1e-4 of each leaf's scale, TF32 off."""
    from ray_tpu_torch.rllib import PPOLearner, RLModuleSpec
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    spec = RLModuleSpec(observation_dim=84 * 84 * 4, action_dim=6,
                        conv=True, obs_shape=(84, 84, 4), hidden=(512,))
    cfg = {"lr": 3e-4, "clip_param": 0.2, "vf_clip_param": 10.0,
           "vf_loss_coeff": 0.5, "entropy_coeff": 0.01, "grad_clip": 0.5}
    host = PPOLearner(spec, dict(cfg, device="cpu"), seed=0)
    card = PPOLearner(spec, cfg, seed=1)
    assert card.device.type == "cuda"
    card.set_weights(host.get_weights())
    rng = np.random.default_rng(0)
    n = 64
    batch = {"obs": rng.integers(0, 256, (n, spec.observation_dim)).astype(np.uint8),
             "actions": rng.integers(0, 6, n).astype(np.float32),
             "logp": np.full(n, -np.log(6.0), np.float32),
             "advantages": rng.standard_normal(n).astype(np.float32),
             "value_targets": rng.standard_normal(n).astype(np.float32)}
    mh, mc = host.update(batch), card.update(batch)
    assert abs(mc["loss"] - mh["loss"]) <= 1e-4 * abs(mh["loss"])
    assert abs(mc["grad_norm"] - mh["grad_norm"]) <= 1e-4 * mh["grad_norm"]
    for a, b in zip(tree_leaves(card.get_weights()),
                    tree_leaves(host.get_weights())):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def _impala_batch(T=50, N=8, seed=50):
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


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ImpalaLearner", "APPOLearner"])
def test_impala_learner_update_on_the_card_equals_the_cpu(cuda, name):
    """IMPALA's (V-trace) and APPO's learner: one update on the card from a
    CPU learner's parameters equals the CPU's, within 1e-4 of each leaf's
    scale, TF32 off."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    cls = getattr(rllib, name)
    spec = rllib.RLModuleSpec(observation_dim=4, action_dim=2,
                              hidden=(64, 64))
    cfg = {"lr": 5e-4, "gamma": 0.99, "vf_loss_coeff": 0.5,
           "entropy_coeff": 0.01, "clip_param": 0.2, "grad_clip": 40.0}
    host = cls(spec, dict(cfg, device="cpu"), seed=0)
    card = cls(spec, dict(cfg, device="cuda"), seed=1)
    card.set_weights(host.get_weights())
    batch = _impala_batch()
    mh, mc = host.update(batch), card.update(batch)
    assert abs(mc["loss"] - mh["loss"]) <= 1e-4 * abs(mh["loss"])
    for a, b in zip(tree_leaves(card.get_weights()),
                    tree_leaves(host.get_weights())):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def _llm_cfg(**kw):
    return transformer.tiny(**dict(dict(
        vocab_size=512, d_model=128, n_layers=2, n_heads=2, d_ff=256,
        max_seq_len=1024, vocab_multiple=128, dtype=torch.float32), **kw))


@pytest.mark.gpu
def test_llm_rl_learner_update_flash_equals_dense(cuda):
    """The LLM-RL learner on the card at L=1024 (flash: K1 forward, K2/K3
    backward) against the same update through dense attention, f32: loss
    and grad norm 1e-4 relative; each gradient leaf within 1e-4 of its
    largest entry, floored at 1e-3 of the model's largest (bk's gradient is
    0 in exact arithmetic: both paths give rounding noise there)."""
    from ray_tpu_torch.rllib.llm_rl import LLMRLLearner

    cfg = {"lr": 1e-3, "clip_param": 0.3, "grad_clip": 1.0, "device": "cuda"}
    rng = np.random.default_rng(0)
    B, L = 2, 1024
    mask = np.zeros((B, L), np.float32)
    mask[:, 100:140] = 1.0
    batch = {"tokens": rng.integers(0, 512, (B, L)).astype(np.int32),
             "gen_mask": mask,
             "behavior_logp": (mask * -6.0).astype(np.float32),
             "advantage": np.array([1.0, -1.0], np.float32)}
    out = {}
    for attn in ("flash", "dense"):
        learner = LLMRLLearner(_llm_cfg(attn_impl=attn), cfg, seed=0)
        before = fa.dq_launches
        loss = learner.compute_grads(learner._device_batch(batch))
        grads = [p.grad.clone() for p in learner._leaves]
        norm = learner.apply_grads()
        if attn == "flash":
            assert fa.dq_launches - before == 2
        out[attn] = (loss.item(), norm.item(), grads)
    (lf, nf, gf), (ld, nd, gd) = out["flash"], out["dense"]
    assert abs(lf - ld) <= 1e-4 * abs(ld)
    assert abs(nf - nd) <= 1e-4 * nd
    floor = 1e-3 * max(g.abs().max().item() for g in gd)
    for a, b in zip(gf, gd):
        assert ((a - b).abs().max().item()
                <= 1e-4 * max(b.abs().max().item(), floor))


@pytest.mark.gpu
def test_generation_actor_on_the_kernel_matches_plain(cuda):
    """A ``GenerationActor`` on the paged kernel against one on the gather
    path, same weights, f32: greedy tokens equal, behavior log-probs 1e-4,
    K4 launched."""
    from ray_tpu_torch.rllib.llm_rl import GenerationActor

    cfg = _llm_cfg(n_heads=2, max_seq_len=256)
    params = transformer.init_params(cfg, 0, device="cpu")
    kern = GenerationActor(cfg, params=params, device="cuda",
                           attention_kernel="cuda")
    plain = GenerationActor(cfg, params=params, device="cuda",
                            attention_kernel="gather")
    prompts = [list(range(1, 40)), list(range(7, 12))]
    before = pa.launches
    a = kern.rollout(prompts, [0, 1], 16, 0.0)
    assert pa.launches > before
    b = plain.rollout(prompts, [0, 1], 16, 0.0)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_allclose(a["behavior_logp"], b["behavior_logp"],
                               atol=1e-4, rtol=1e-4)

"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false (the CPU test host). The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so this file imports only torch and numpy
and runs there with:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: 1e-4 in f32 (the kernel sums over up to ~1300 keys in another
order than the plain version), 1e-2 in bf16 (both round an f32 result to
bf16; one bf16 step is 2^-8 relative).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import transformer
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm import PagedLLMEngine

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths,T,geom", [
    ([0, 15, 16, 1000], 1, {}),                       # engine decode
    ([0, 17, 300], 5, {}),                            # multi-token
    ([256], 64, {}),                                  # prefill, prefix hit
    ([0], 1024, {}),                                  # full bucket
    ([5, 63, 64], 3, dict(bt=8, nb_seq=16, D=32)),    # other geometry
    ([100, 7], 2, dict(D=128, H=4)),
])
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
def test_nan_in_dead_pages_never_read(cuda):
    ops = _operands(np.random.default_rng(5), torch.bfloat16,
                    [0, 15, 16, 1000], 1)
    clean = pa.paged_attention(*ops)
    kp, vp = ops[1].clone(), ops[2].clone()
    kp[0] = float("nan")
    vp[0] = float("nan")
    assert torch.equal(pa.paged_attention(ops[0], kp, vp, *ops[3:]), clean)


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

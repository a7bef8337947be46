"""The port's ``ops/layers.py`` against the JAX ops, on the same f32 inputs.

Inputs come from a numpy seed and pass between the packages as numpy
arrays. Tolerance: atol/rtol 1e-6 for the elementwise ops (one or two f32
roundings apart), 1e-5 where a reduction or a transcendental is summed in
another order (layer-norm and rms-norm statistics, logsumexp, rope's
sin/cos of large angles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import layers as jl
from ray_tpu_torch.ops import layers as tl

import torch_threads  # noqa: F401,E402  (one torch thread a test process)

torch.backends.cuda.matmul.allow_tf32 = False


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               atol=tol, rtol=tol)


def test_layer_norm():
    r = _rng(0)
    x = r.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    g = r.standard_normal(64).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    _close(tl.layer_norm(torch.tensor(x), torch.tensor(g), torch.tensor(b)),
           jl.layer_norm(x, g, b), 1e-5)


def test_rms_norm():
    r = _rng(1)
    x = r.standard_normal((4, 32)).astype(np.float32)
    g = r.standard_normal(32).astype(np.float32)
    _close(tl.rms_norm(torch.tensor(x), torch.tensor(g)),
           jl.rms_norm(x, g), 1e-5)


def test_gelu():
    x = _rng(2).standard_normal((7, 33)).astype(np.float32) * 4
    _close(tl.gelu(torch.tensor(x)), jl.gelu(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    r = _rng(3)
    x = r.standard_normal((2, 6, 48)).astype(np.float32)
    w = r.standard_normal((48, 24)).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32) if bias else None
    tb = torch.tensor(b) if bias else None
    _close(tl.linear(torch.tensor(x), torch.tensor(w), tb),
           jl.linear(x, w, b), 1e-5)


def test_linear_bf16_adds_bias_in_f32():
    """bf16 inputs: the product and the bias add stay in f32 and round once
    at the end, so the port and JAX agree to the bf16 rounding of one
    result (the f32 sums differ only in order)."""
    r = _rng(4)
    x = r.standard_normal((4, 32)).astype(np.float32)
    w = r.standard_normal((32, 16)).astype(np.float32)
    b = r.standard_normal(16).astype(np.float32)
    got = tl.linear(torch.tensor(x).bfloat16(), torch.tensor(w).bfloat16(),
                    torch.tensor(b).bfloat16())
    want = jl.linear(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                     jnp.asarray(b, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)


def test_softmax_cross_entropy():
    r = _rng(5)
    logits = r.standard_normal((3, 7, 50)).astype(np.float32) * 2
    labels = r.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -100
    tm, tn = tl.softmax_cross_entropy(torch.tensor(logits),
                                      torch.tensor(labels))
    jm, jn = jl.softmax_cross_entropy(logits, labels)
    _close(tm, jm, 1e-5)
    assert int(tn) == int(jn) == 3 * 7 - 3


@pytest.mark.parametrize("offset", [0, 500])
def test_rope(offset):
    r = _rng(6)
    x = r.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = (np.arange(9)[None, :] + offset + np.array([[0], [3]])).astype(
        np.int32)
    _close(tl.rope(torch.tensor(x), torch.tensor(pos)),
           jl.rope(x, pos), 1e-5)

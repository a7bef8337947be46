"""The MLP up-projection with its epilogue: ``gelu(linear(x, w, b))`` as one
cuBLAS GEMM and one hand-written kernel, forward and backward.

A port-only pair of kernels (``csrc/bias_gelu.cu``; the JAX package leaves
this work to XLA's fusion). Eagerly, ``ops/layers.py``'s ``linear`` adds the
bias to the f32 product in one pass and rounds to bf16 in a second, and its
``gelu`` is nine bf16 kernels; autograd's backward of that chain is about
fifteen more. Here:

- forward: ``y = x @ w`` in f32 (``torch.mm(..., out_dtype=float32)``), then
  ``bias_gelu_forward_kernel`` writes ``pre = bf16(y + f32(b))`` and
  ``out = bf16(gelu(f32(pre)))``, GELU in f32 registers and rounded once;
  without a graph to record, ``pre`` is not written;
- backward: ``bias_gelu_backward_kernel`` writes
  ``dpre = bf16(f32(g) * gelu'(f32(pre)))`` and f32 per-split column sums of
  ``dpre``; their sum over the splits, rounded to the bias's dtype, is
  ``db``; ``dx = dpre @ wᵀ`` and ``dw = xᵀ @ dpre`` in bf16, as
  ``layers._Bf16MatmulF32Out.backward`` computes them.

:func:`takes` is the route: plain (non-DTensor) CUDA tensors, ``x``, ``w``
and ``b`` in bf16, ``w`` [K, F] with F a multiple of 8. Everything else keeps
the eager expression (``layers.linear_gelu``). :func:`bias_gelu_forward` and
:func:`bias_gelu_backward` launch a kernel on CUDA tensors and run the plain
versions :func:`bias_gelu_reference` and :func:`bias_gelu_backward_reference`
(the same expressions in f32 torch ops) on CPU ones.
``bias_gelu_forward_launches`` and ``bias_gelu_backward_launches`` count the
kernels' launches, so a run can show that its path went through them.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.ops import _build

# Kernel launches since import (or since a caller reset them to 0). The
# forward runs on the caller's thread, the backward on autograd's device
# thread, so each count is bumped under a lock.
bias_gelu_forward_launches = 0
bias_gelu_backward_launches = 0
_count_lock = threading.Lock()

_VEC = 8             # columns a thread (csrc ``kVec``): 16 bytes of bf16
_TILE_COLS = 256     # columns a block (csrc ``kTileCols``)
_ROW_THREADS = 8     # rows a block walks at once (csrc ``kRowThreads``)
_MAX_SPLITS = 65535  # the grid's y limit

_fns = {}
_slots: Dict[Tuple[int, int], int] = {}   # (device, backward) -> blocks

_K = math.sqrt(2.0 / math.pi)
_C = 0.044715


def _count(counter: str) -> None:
    with _count_lock:
        globals()[counter] += 1


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load("bias_gelu")
        fn = getattr(lib, f"ray_tpu_torch_bias_gelu_{name}")
        if name == "slots":
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        else:
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _on_card(x) -> bool:
    return x.is_cuda


def takes(x, w, b) -> bool:
    """Whether ``gelu(linear(x, w, b))`` runs on the kernels: plain CUDA
    tensors, all three bf16, ``w`` [K, F] and ``b`` [F] with F % 8 == 0."""
    return (b is not None and _on_card(x)
            and not any(isinstance(t, DTensor) for t in (x, w, b))
            and x.dtype == w.dtype == b.dtype == torch.bfloat16
            and w.dim() == 2 and w.shape[1] % _VEC == 0
            and tuple(b.shape) == (w.shape[1],))


# -- plain versions ----------------------------------------------------------

def _gelu_f32(p):
    return 0.5 * p * (1.0 + torch.tanh(_K * (p + _C * p * p * p)))


def _gelu_grad_f32(p):
    t = torch.tanh(_K * (p + _C * p * p * p))
    return 0.5 * (1.0 + t) + 0.5 * p * (1.0 - t * t) * _K * (
        1.0 + 3.0 * _C * p * p)


def bias_gelu_reference(y, b):
    """Plain version of the forward kernel: ``(pre, out)``, both bf16, from
    the f32 product ``y`` [N, F] and the bias ``b`` [F]."""
    pre = (y.float() + b.float()).to(torch.bfloat16)
    return pre, _gelu_f32(pre.float()).to(torch.bfloat16)


def bias_gelu_backward_reference(g, pre):
    """Plain version of the backward kernel and its reduction: ``(dpre,
    db)``, ``dpre`` bf16 and ``db`` the f32 column sums of the rounded
    ``dpre``."""
    dpre = (g.float() * _gelu_grad_f32(pre.float())).to(torch.bfloat16)
    return dpre, dpre.float().sum(0)


# -- kernel wrappers ---------------------------------------------------------

def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, copied only if it is not."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _splits(device: torch.device, rows: int, cols: int, backward: int) -> int:
    """Row splits of the grid: as many as fill the card once beside the
    column tiles, at least one and no more than the rows take."""
    key = (device.index, backward)
    slots = _slots.get(key)
    if slots is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = _kernel("slots")(backward, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"bias_gelu occupancy query failed: CUDA "
                               f"error {rc}")
        slots = _slots[key] = out.value
    tiles = -(-cols // _TILE_COLS)
    most = max(1, -(-rows // _ROW_THREADS))
    return max(1, min(slots // tiles, most, _MAX_SPLITS))


def _launch(name: str, ptrs, rows: int, cols: int, splits: int, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel(name)(*ptrs, rows, cols, splits, stream)
    if rc != 0:
        raise RuntimeError(f"bias_gelu {name} kernel launch failed: CUDA "
                           f"error {rc}")


def _check(a, a_dtype, b, b_dtype, b_shape_of):
    """Raise unless ``a`` is [N, F] of ``a_dtype`` with F % 8 == 0 and ``b``
    is ``b_dtype`` of the shape ``b_shape_of(a)``, both on one device."""
    if (a.dim() != 2 or a.dtype != a_dtype or a.shape[1] % _VEC
            or b.dtype != b_dtype or tuple(b.shape) != b_shape_of(a)
            or b.device != a.device):
        raise ValueError(
            f"bias_gelu takes [N, F] {a_dtype} (F a multiple of {_VEC}) with "
            f"{b_dtype} {b_shape_of(a)} on one device; got "
            f"{tuple(a.shape)} {a.dtype} on {a.device} and "
            f"{tuple(b.shape)} {b.dtype} on {b.device}")


def _forward_cuda(y, b, keep_pre: bool):
    _check(y, torch.float32, b, torch.bfloat16, lambda a: (a.shape[1],))
    rows, cols = y.shape
    y, b = _operand(y), _operand(b)
    out = torch.empty((rows, cols), dtype=torch.bfloat16, device=y.device)
    pre = torch.empty_like(out) if keep_pre else None
    _launch("forward", (y.data_ptr(), b.data_ptr(),
                        pre.data_ptr() if keep_pre else None,
                        out.data_ptr()),
            rows, cols, _splits(y.device, rows, cols, 0), y.device)
    _count("bias_gelu_forward_launches")
    return pre, out


def _backward_cuda(g, pre):
    _check(pre, torch.bfloat16, g, torch.bfloat16, lambda a: tuple(a.shape))
    rows, cols = pre.shape
    g, pre = _operand(g), _operand(pre)
    splits = _splits(pre.device, rows, cols, 1)
    dpre = torch.empty_like(pre)
    partial = torch.empty((splits, cols), dtype=torch.float32,
                          device=pre.device)
    _launch("backward", (g.data_ptr(), pre.data_ptr(), dpre.data_ptr(),
                         partial.data_ptr()),
            rows, cols, splits, pre.device)
    _count("bias_gelu_backward_launches")
    return dpre, partial.sum(0)


def bias_gelu_forward(y, b, keep_pre: bool = True):
    """``(pre, out)`` from the f32 product ``y`` [N, F] and the bf16 bias:
    the forward kernel on CUDA tensors (``pre`` None unless ``keep_pre``),
    the plain version on CPU ones."""
    if y.is_cuda:
        return _forward_cuda(y, b, keep_pre)
    pre, out = bias_gelu_reference(y, b)
    return (pre if keep_pre else None), out


def bias_gelu_backward(g, pre):
    """``(dpre, db)`` with ``db`` f32: the backward kernel and the sum of its
    partials on CUDA tensors, the plain version on CPU ones."""
    if pre.is_cuda:
        return _backward_cuda(g, pre)
    return bias_gelu_backward_reference(g, pre)


def _product(x2, w):
    """``x2 @ w`` in f32: the card's bf16 GEMM with f32 output; on the CPU,
    which lacks that product, the exact f32 product of the bf16 values."""
    if x2.is_cuda:
        return torch.mm(x2, w, out_dtype=torch.float32)
    return torch.mm(x2.float(), w.float())


class _LinearGelu(torch.autograd.Function):
    """``gelu(linear(x2, w, b))`` for ``x2`` [N, K]: saves ``x2``, ``w`` and
    ``pre``; the bias gradient comes back in ``b``'s dtype."""

    @staticmethod
    def forward(ctx, x2, w, b):
        pre, out = bias_gelu_forward(_product(x2, w), b)
        ctx.save_for_backward(x2, w, pre)
        ctx.b_dtype = b.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x2, w, pre = ctx.saved_tensors
        dpre, db = bias_gelu_backward(g, pre)
        dx = dpre @ w.T if ctx.needs_input_grad[0] else None
        dw = x2.T @ dpre if ctx.needs_input_grad[1] else None
        return dx, dw, db.to(ctx.b_dtype)


def linear_gelu(x, w, b):
    """``gelu(linear(x, w, b))`` for ``x`` [..., K] on the kernels (callers
    route through :func:`takes` first)."""
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        out = _LinearGelu.apply(x2, w, b)
    else:   # no graph to record: no pre, and no Function's host overhead
        out = bias_gelu_forward(_product(x2, w), b, keep_pre=False)[1]
    return out.reshape(*x.shape[:-1], w.shape[-1])

"""Flash attention, forward and backward.

Counterpart of ``ray_tpu/ops/flash_attention.py``. Layout ``[B, L, H, D]``
at the public function, as in JAX. Three hand-written CUDA kernels in
``csrc/flash_attention.cu`` replace the three Pallas kernels:

- ``forward`` (K1, ``_flash_kernel``): the attention output O and the row
  log-sum-exp ``lse`` of the scaled scores, in f32;
- ``dq`` (K2, ``_dq_kernel``): dQ, a q tile sweeping its kv tiles;
- ``dkv`` (K3, ``_dkv_kernel``): dK and dV, a kv tile sweeping its q tiles.

``delta = rowsum(dO * O)`` is a torch reduction outside the kernels, as the
JAX package leaves it to XLA. The operand dtype picks the design: in bf16
all three run on the tensor cores — ``forward`` and ``dq`` on Hopper's
warpgroup MMA (``wgmma``), ``dkv`` on the warp-level ``mma.sync`` — and
round P and dS to bf16 before the products that take them, as SDPA does;
in f32 they run on the CUDA cores in f32 throughout.

:func:`flash_attention` keeps the JAX routing rule: ``bq = min(block_q, L)``
and ``bk = min(block_k, Lk)``; if either length is not a multiple of its
block it takes the dense path and backpropagates through it with autograd.
``block_q``/``block_k`` only decide that route — the CUDA kernels choose
their own tiles and mask a ragged edge themselves. Otherwise it is a
``torch.autograd.Function`` whose forward saves ``(q, k, v, o, lse)`` and
whose backward launches the two backward kernels.

:func:`flash_forward`, :func:`flash_dq` and :func:`flash_dkv` launch one
kernel each on CUDA tensors (or raise) and run the plain versions
:func:`flash_forward_reference`, :func:`flash_dq_reference` and
:func:`flash_dkv_reference` on CPU tensors; :func:`flash_backward` is
delta plus the two backward ones. ``forward_launches``, ``dq_launches`` and
``dkv_launches`` count kernel launches, so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

# Kernel launches since import (or since a caller reset them to 0). Several
# threads launch at once (trials of one process, autograd's device thread),
# so each count is bumped under a lock.
forward_launches = 0
dq_launches = 0
dkv_launches = 0
_count_lock = threading.Lock()


def _count(counter: str) -> None:
    """Add one launch to ``counter`` (one of the three above)."""
    with _count_lock:
        globals()[counter] += 1

_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("flash_attention"),
                     f"ray_tpu_torch_flash_{name}")
        n_ptr = {"forward": 5, "dq": 7, "dkv": 8}[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_void_p]
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


# -- plain versions --------------------------------------------------------

def _causal_mask(lq: int, lk: int, device) -> torch.Tensor:
    """The JAX kernels' top-left mask ``row >= col`` (also for Lq != Lk)."""
    rows = torch.arange(lq, device=device)[:, None]
    cols = torch.arange(lk, device=device)[None, :]
    return rows >= cols


def _scores(q, k, scale, causal):
    """f32 scaled scores [B, H, Lq, Lk], masked to -1e30."""
    s = torch.einsum("blhd,bkhd->bhlk", q.float(), k.float()) * scale
    if causal:
        s = torch.where(_causal_mask(q.shape[1], k.shape[1], q.device), s,
                        torch.full_like(s, _NEG_INF))
    return s


def _dense_reference(q, k, v, *, scale, causal):
    """Dense attention in f32, output in q's dtype — the JAX
    ``_dense_reference`` and the route for ragged lengths."""
    probs = torch.softmax(_scores(q, k, scale, causal), dim=-1)
    return torch.einsum("bhlk,bkhd->blhd", probs, v.float()).to(q.dtype)


def flash_forward_reference(q, k, v, *, scale, causal):
    """Plain version of K1: ``(o, lse)``, o [B, L, H, D] in q's dtype and
    lse [B, H, L] f32, the row log-sum-exp ``m + log(max(l, 1e-30))`` of
    the scaled, masked scores (JAX's ``_finalize``)."""
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_ = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bhlk,bkhd->blhd", p / l_, v.float()).to(q.dtype)
    return o, (m + torch.log(l_))[..., 0]


def _delta(g, o):
    """``rowsum(dO * O)`` in f32, [B, H, L]."""
    return (g.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, g, lse, delta, *, scale, causal):
    """The backward's recomputed ``p = exp(s - lse)`` and
    ``ds = p * (dO·Vᵀ - delta) * scale``, both [B, H, Lq, Lk] f32."""
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    dp = torch.einsum("blhd,bkhd->bhlk", g.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_dq_reference(q, k, v, g, lse, delta, *, scale, causal):
    """Plain version of K2: ``dq = ds·K`` in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, g, lse, delta, scale=scale, causal=causal)
    return torch.einsum("bhlk,bkhd->blhd", ds, k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, g, lse, delta, *, scale, causal):
    """Plain version of K3: ``dk = dsᵀ·Q`` and ``dv = pᵀ·dO``, in k's and
    v's dtypes."""
    p, ds = _probs_and_ds(q, k, v, g, lse, delta, scale=scale, causal=causal)
    dk = torch.einsum("bhlk,blhd->bkhd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhlk,blhd->bkhd", p, g.float()).to(v.dtype)
    return dk, dv


def flash_backward_reference(q, k, v, g, o, lse, *, scale, causal):
    """Plain version of the backward: ``(dq, dk, dv)`` from the forward's
    ``(o, lse)`` and the output gradient ``g`` (JAX ``_flash_backward``)."""
    delta = _delta(g, o)
    dq = flash_dq_reference(q, k, v, g, lse, delta, scale=scale,
                            causal=causal)
    dk, dv = flash_dkv_reference(q, k, v, g, lse, delta, scale=scale,
                                 causal=causal)
    return dq, dk, dv


# -- kernel wrappers -------------------------------------------------------

def _vec(t: torch.Tensor) -> int:
    return 16 // t.element_size()


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: unit stride on D, the other strides a
    whole number of 16-byte loads and the base 16-byte aligned. Anything
    else (an expanded gradient, an odd view) is copied to contiguous."""
    n = _vec(t)
    if (t.stride(-1) == 1 and all(s % n == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check(q, k, v, *rest):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q, k, v must be [B, L, H, D] with k and v alike; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Lq, H, D = q.shape
    if k.shape[0] != B or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch, heads or head_dim")
    if q.dtype not in _DTYPE_CODES or any(
            t.dtype != q.dtype for t in (k, v, *rest)):
        raise TypeError(f"q, k, v (and the gradient) must share one dtype of "
                        f"float32 or bfloat16; got "
                        f"{[t.dtype for t in (q, k, v, *rest)]}")
    for t in (k, v, *rest):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
    for t in rest:
        if t.shape != q.shape:
            raise ValueError(f"gradient {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported by the kernel "
                         f"(supported: {_HEAD_DIMS})")
    if Lq < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")


def _rows(q, *ts):
    """lse and delta as the backward kernels read them: [B, H, Lq] f32,
    contiguous, on q's device."""
    B, Lq, H, _ = q.shape
    for t in ts:
        if (tuple(t.shape) != (B, H, Lq) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"lse and delta must be [B, H, Lq] = "
                             f"{(B, H, Lq)} float32 on {q.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return tuple(t.contiguous() for t in ts)


def _strides(*ts) -> "ctypes.Array":
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(name, ptrs, strides, q, Lk, scale, causal):
    B, Lq, H, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel(name)(*ptrs, ctypes.cast(strides, ctypes.c_void_p),
                           B, H, Lq, Lk, D, float(scale), int(bool(causal)),
                           _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash {name} kernel launch failed: CUDA error "
                           f"{rc}")


def _forward_cuda(q, k, v, scale, causal):
    _check(q, k, v)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    B, Lq, H, D = q.shape
    o = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    _launch("forward", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr()),
            _strides(q, k, v), q, k.shape[1], scale, causal)
    _count("forward_launches")
    return o, lse


def _dq_cuda(q, k, v, g, lse, delta, scale, causal):
    _check(q, k, v, g)
    q, k, v, g = (_kernel_operand(t) for t in (q, k, v, g))
    lse, delta = _rows(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            _strides(q, k, v, g), q, k.shape[1], scale, causal)
    _count("dq_launches")
    return dq


def _dkv_cuda(q, k, v, g, lse, delta, scale, causal):
    _check(q, k, v, g)
    q, k, v, g = (_kernel_operand(t) for t in (q, k, v, g))
    lse, delta = _rows(q, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _launch("dkv", (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr()),
            _strides(q, k, v, g), q, k.shape[1], scale, causal)
    _count("dkv_launches")
    return dk, dv


def _on_device(cuda_fn, plain_fn, q, *args, scale, causal):
    """``cuda_fn`` (a kernel) for CUDA tensors, ``plain_fn`` for CPU ones."""
    if q.device.type == "cuda":
        return cuda_fn(q, *args, scale, causal)
    if q.device.type == "cpu":
        return plain_fn(q, *args, scale=scale, causal=causal)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_forward(q, k, v, *, scale, causal):
    """``(o, lse)``: K1 on CUDA tensors, the plain version on CPU ones."""
    return _on_device(_forward_cuda, flash_forward_reference, q, k, v,
                      scale=scale, causal=causal)


def flash_dq(q, k, v, g, lse, delta, *, scale, causal):
    """dq: K2 on CUDA tensors, the plain version on CPU ones."""
    return _on_device(_dq_cuda, flash_dq_reference, q, k, v, g, lse, delta,
                      scale=scale, causal=causal)


def flash_dkv(q, k, v, g, lse, delta, *, scale, causal):
    """``(dk, dv)``: K3 on CUDA tensors, the plain version on CPU ones."""
    return _on_device(_dkv_cuda, flash_dkv_reference, q, k, v, g, lse, delta,
                      scale=scale, causal=causal)


def flash_backward(q, k, v, g, o, lse, *, scale, causal):
    """``(dq, dk, dv)`` from the forward's ``(o, lse)`` and the output
    gradient ``g``: ``delta`` by torch, then K2 and K3 (on CPU tensors
    their plain versions)."""
    if g.device.type == "cuda":
        g = _kernel_operand(g)          # once for both kernels
    delta = _delta(g, o)
    dq = flash_dq(q, k, v, g, lse, delta, scale=scale, causal=causal)
    return (dq,) + flash_dkv(q, k, v, g, lse, delta, scale=scale,
                             causal=causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_forward(q, k, v, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, g, o, lse, scale=ctx.scale,
                                    causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Multi-head attention, [B, L, H, D] layout; returns [B, L, H, D] in
    q's dtype, differentiable in q, k and v."""
    s = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    bq = min(block_q, q.shape[1])
    bk = min(block_k, k.shape[1])
    if q.shape[1] % bq != 0 or k.shape[1] % bk != 0:
        return _dense_reference(q, k, v, scale=s, causal=causal)
    return _FlashAttention.apply(q, k, v, causal, s)

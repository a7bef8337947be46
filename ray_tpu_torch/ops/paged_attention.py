"""Paged attention over the block-pool KV cache.

Counterpart of ``ray_tpu/ops/paged_attention.py``. The serve engine's
prefill and decode forwards (``models/generate.py``) hold K/V in a SHARED
pool of ``block_tokens``-sized blocks addressed through per-sequence block
tables. Query t of slot s sits at absolute position ``lengths[s] + t`` and
attends positions ``<= lengths[s] + t`` through ``tables[s]``; the T new
tokens' K/V must already be in the pool (the caller writes, then attends).

- :func:`paged_attention` dispatches on the device: CUDA tensors launch the
  hand-written kernel ``csrc/paged_attention.cu`` (the port of the Pallas
  ``_paged_kernel``), CPU tensors run the plain version. There is no other
  route: a CUDA tensor never reaches the plain version through this call.
- :func:`paged_attention_reference` is the plain PyTorch version, line for
  line the JAX ``paged_attention_reference``: it gathers the whole table and
  runs masked dense attention.
- ``launches`` counts kernel launches, so a run can show that its path went
  through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("paged_attention").ray_tpu_torch_paged_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k_pool, v_pool, tables, lengths):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"q must be [S,T,H,D] and k_pool [nb,bt,H,D]; got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    S, T, H, D = q.shape
    nb, bt = k_pool.shape[:2]
    if tuple(k_pool.shape[2:]) != (H, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q's heads "
                         f"{(H, D)}")
    if tables.dim() != 2 or tables.shape[0] != S or tuple(lengths.shape) != (S,):
        raise ValueError(f"tables must be [S, NB] and lengths [S] for S={S}; "
                         f"got {tuple(tables.shape)} and "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and pools must share one dtype of float32 or "
                        f"bfloat16; got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"tables and lengths must be int32; got "
                        f"{tables.dtype} and {lengths.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"loads the pools 16 bytes at a time)")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported by the kernel "
                         f"(supported: {_HEAD_DIMS})")
    if not 1 <= bt <= 32:
        raise ValueError(f"block_tokens {bt} not supported by the kernel "
                         f"(1..32)")
    if nb < 1 or tables.shape[1] < 1:
        raise ValueError("empty pool or table")


def _paged_attention_cuda(q, k_pool, v_pool, tables, lengths, s_val):
    global launches
    _check(q, k_pool, v_pool, tables, lengths)
    S, T, H, D = q.shape
    nb, bt = k_pool.shape[:2]
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                S, T, H, D, bt, tables.shape[1], nb, float(s_val),
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def paged_attention(
    q: torch.Tensor,             # [S, T, H, D]
    k_pool: torch.Tensor,        # [num_blocks, bt, H, D] (one layer's pool)
    v_pool: torch.Tensor,
    tables: torch.Tensor,        # [S, NB] int32 — pool block ids, 0 = trash
    lengths: torch.Tensor,       # [S] int32 — valid context BEFORE the T tokens
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over the block pool; returns [S, T, H, D] in q's dtype.

    CUDA tensors launch the kernel (which raises if it cannot launch); CPU
    tensors run :func:`paged_attention_reference`."""
    s_val = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cuda":
        return _paged_attention_cuda(q, k_pool, v_pool, tables, lengths,
                                     s_val)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                                         scale=s_val)
    raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")


def paged_attention_reference(q, k_pool, v_pool, tables, lengths, *,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Gather-path plain version: materializes [S, NB*bt, H, D] through the
    table and runs masked dense attention — the equivalence target of the
    kernel and the CPU path of :func:`paged_attention`."""
    S, T, H, D = q.shape
    bt = k_pool.shape[1]
    nb_seq = tables.shape[1]
    s_val = scale if scale is not None else 1.0 / D**0.5
    # Out-of-range ids clamp, as the JAX gather clamps them.
    idx = tables.long().clamp(0, k_pool.shape[0] - 1)
    kc = k_pool[idx].reshape(S, nb_seq * bt, H, D)
    vc = v_pool[idx].reshape(S, nb_seq * bt, H, D)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), kc.float()) * s_val
    kv_pos = torch.arange(nb_seq * bt, device=q.device)[None, None, None, :]
    q_pos = (lengths.long().reshape(-1, 1, 1, 1)
             + torch.arange(T, device=q.device)[None, None, :, None])
    scores = torch.where(kv_pos <= q_pos, scores,
                         torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, vc.float())
    return out.to(q.dtype)

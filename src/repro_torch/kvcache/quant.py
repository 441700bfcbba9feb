"""KV quantize / dequantize primitives (symmetric amax scaling).

The port's copy of ``repro/kvcache/quant.py``.  A K/V vector group is
quantized per stored kv head: ``scale = amax / QMAX`` over the head_dim
axis, values stored as ``round(x / scale)`` int8 (half to even, as
``jnp.round``) or ``x / scale`` fp8-e4m3.  Dequant is ``q · scale``; the
attention kernels fold the scales into their products.

Two conversions are spelled out so that they give the reference's bits
on every value, garbage included (a requantize can scale a fresh page's
stale contents up): float -> int8 saturates to [-128, 127] as XLA's
convert does (PyTorch's cast wraps), and float -> fp8 gives NaN above
464 as XLA's does (PyTorch's cast saturates to 448).  Divisions by a
constant divide by a tensor of it: PyTorch's CUDA division by a Python
scalar multiplies by the reciprocal.
"""
from __future__ import annotations

import torch

from repro_torch.kvcache.spec import FP8, QMAX


def qmax_of(dtype: torch.dtype) -> float:
    return QMAX["int8"] if dtype == torch.int8 else QMAX["fp8"]


def to_store(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 -> int8 / fp8 with the reference's conversion semantics
    (int8 truncates toward zero and saturates; fp8 rounds to nearest even
    and overflows to NaN past 464)."""
    if dtype == torch.int8:
        return torch.clamp(x, -128, 127).to(torch.int8)
    nan = torch.copysign(torch.full_like(x, float("nan")), x)
    return torch.where(x.abs() > 464.0, nan, x).to(FP8)


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    return t / torch.full_like(t, c)


def quantize(x: torch.Tensor, store_dtype: torch.dtype, *, axis: int = -1):
    """Quantize ``x`` along ``axis``: ``(q, scale)`` with ``q`` of x's
    shape in ``store_dtype`` and ``scale`` fp32 with ``axis`` reduced.
    Zero vectors get scale 0 and quantize to 0."""
    qmax = qmax_of(store_dtype)
    xf = x.float()
    scale = _div(xf.abs().amax(dim=axis), qmax)
    safe = torch.clamp(scale, min=1e-30)
    scaled = xf / safe.unsqueeze(axis)
    if store_dtype == torch.int8:
        q = to_store(torch.clamp(torch.round(scaled), -qmax, qmax),
                     torch.int8)
    else:
        q = to_store(scaled, FP8)
    return q, scale


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor,
                        store_dtype: torch.dtype, *,
                        axis: int = -1) -> torch.Tensor:
    """Quantize against an externally chosen scale (paged writes: the
    page's running amax scale, which may exceed this vector's own)."""
    qmax = qmax_of(store_dtype)
    safe = torch.clamp(scale, min=1e-30)
    scaled = x.float() / safe.unsqueeze(axis)
    if store_dtype == torch.int8:
        return to_store(torch.clamp(torch.round(scaled), -qmax, qmax),
                        torch.int8)
    return to_store(torch.clamp(scaled, -qmax, qmax), store_dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor, *, axis: int = -1,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.unsqueeze(axis)).to(dtype)


def requant_factor(old_scale: torch.Tensor,
                   new_scale: torch.Tensor) -> torch.Tensor:
    """``old / new`` (0 where the new scale is 0)."""
    return torch.where(new_scale > 0,
                       old_scale / torch.clamp(new_scale, min=1e-30),
                       torch.zeros_like(new_scale))


def rescale(q: torch.Tensor, factor: torch.Tensor, *,
            axis: int = -1) -> torch.Tensor:
    """Stored values times ``factor`` (broadcast with ``axis`` added),
    re-stored in q's type; a factor of 1 changes no bit."""
    v = q.float() * factor.unsqueeze(axis)
    if q.dtype == torch.int8:
        v = torch.round(v)
    return to_store(v, q.dtype)


def requantize(q: torch.Tensor, old_scale: torch.Tensor,
               new_scale: torch.Tensor, *, axis: int = -1) -> torch.Tensor:
    """Re-express stored values under a grown scale (paged running-amax
    writes): ``factor = old / new <= 1`` so int8 never re-clips; pages
    with old scale 0 (fresh or reset) zero out."""
    return rescale(q, requant_factor(old_scale, new_scale), axis=axis)

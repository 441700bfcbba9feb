"""Plain PyTorch versions of the quantized matmuls, and their oracles.

The port's copy of ``repro/kernels/int8_matmul/ref.py`` (row / column
quantization, the W8A8 oracle, int4 packing and the W4A16 oracle) and of
the tile programs of the decode kernels (``_w8a8_decode_emulate``,
``_fp8_decode_emulate`` in ``int8_matmul.py``).  CPU tensors run these in
place of the CUDA kernels (``ops.py``); ``chip_smoke.py`` holds each
kernel against its plain version on the card.

Exactness, as the reference gets it:
* int8 products are summed exactly.  CUDA has no int32 ``torch.matmul``,
  and an fp32 product over a long K is not exact (qwen2's ``down`` has
  K = 8960), so :func:`int8_dot` takes fp32 products over K tiles of at
  most 1024, where every partial sum is an integer below 2**24, and adds
  the tiles in int32.
* Divisions by a constant divide by a tensor of it (:func:`_div`):
  PyTorch's CUDA division by a Python scalar multiplies by the
  reciprocal, which can land one ulp away from the reference's IEEE
  division.
* The decode epilogue with a bias is one fused multiply-add, as XLA
  contracts the reference's ``acc*xs*ws + b``: :func:`fma_f32`.
"""
from __future__ import annotations

from typing import Optional

import torch

#: K tile of the exact int8 product: 1024 * 127**2 < 2**24
INT8_K_TILE = 1024
#: the reference decode kernels' K tile (block_k), the fp8 sums' order
DECODE_K_TILE = 512


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as an IEEE division on every device."""
    return t / torch.full_like(t, c)


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of fp32 tensors rounded once to fp32, as a fused
    multiply-add.  ``a * b`` is exact in fp64; the sum is rounded to odd
    there (two-sum error, then one step towards the exact value when the
    rounded sum's last bit is even), and rounding that to fp32 rounds the
    exact value correctly (53 >= 2 * 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


# ---------------------------------------------------------------------------
# Quantization (the reference's oracles)


def quantize_rowwise(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of (..., K).  ``amax`` (...,
    1) replaces the rows' own absolute maxima (a row split over ranks
    quantizes against the whole row's)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = _div(torch.clamp(amax, min=1e-8), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def quantize_colwise(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of (K, N)."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = _div(torch.clamp(amax, min=1e-8), 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale[0]


def pack_int4(w4: torch.Tensor) -> torch.Tensor:
    """(K, N) int4 values in [-8, 7] -> (K//2, N) packed uint8
    (lo | hi << 4); uint8 marks the leaf as int4-packed."""
    lo = w4[0::2].to(torch.uint8) & 0xF
    hi = w4[1::2].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    k2, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n)


def quantize_int4_colwise(w: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = _div(torch.clamp(amax, min=1e-8), 7.0)
    q = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int8)
    return pack_int4(q), scale[0]


# ---------------------------------------------------------------------------
# Products


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``xq @ wq`` of int8 (M, K) and (K, N)."""
    acc = None
    for k0 in range(0, xq.shape[-1], INT8_K_TILE):
        part = (xq[..., k0:k0 + INT8_K_TILE].float()
                @ wq[k0:k0 + INT8_K_TILE].float()).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def int8_matmul_ref(xq: torch.Tensor, wq: torch.Tensor,
                    x_scale: torch.Tensor, w_scale: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """xq: (M,K) int8; wq: (K,N) int8; x_scale: (M,); w_scale: (N,).  The
    oracle, and the plain version of the tiled kernel (B4)."""
    acc = int8_dot(xq, wq)
    return (acc.float() * x_scale[:, None] * w_scale[None, :]).to(out_dtype)


def int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                    w_scale: torch.Tensor) -> torch.Tensor:
    """Weight-only: x (M,K) × int4-packed (K//2,N) -> (M,N) in x's type."""
    w = unpack_int4(packed).float() * w_scale[None, :]
    return (x.float() @ w).to(x.dtype)


def _epilogue(y: torch.Tensor, w_scale: torch.Tensor,
              bias: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    ws = w_scale.float()[None, :]
    if bias is None:
        return (y * ws).to(out_dtype)
    return fma_f32(y, ws.expand_as(y),
                   bias.float()[None, :].expand_as(y)).to(out_dtype)


def w8a8_decode_ref(x: torch.Tensor, wq: torch.Tensor,
                    w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    out_dtype=None) -> torch.Tensor:
    """The plain version of the W8A8 decode kernel (B5): x (M,K) RAW
    activations quantized per row against max(amax, 1e-8)/127, the exact
    int32 product with wq (K,N) int8, and the epilogue
    ``fma(acc·xs, ws, bias)`` (``(acc·xs)·ws`` without a bias)."""
    xq, xs = quantize_rowwise(x)
    acc = int8_dot(xq, wq).float() * xs[:, None]
    return _epilogue(acc, w_scale, bias, out_dtype or x.dtype)


def fp8_decode_ref(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype=None) -> torch.Tensor:
    """The plain version of the fp8 decode kernel (B6): x (M,K) times the
    upcast e4m3 wq (K,N), fp32 sums over K tiles of 512 in the reference
    kernel's order, then ``fma(acc, ws, bias)`` (``acc·ws`` without)."""
    xf = x.float()
    acc = None
    for k0 in range(0, x.shape[-1], DECODE_K_TILE):
        part = (xf[:, k0:k0 + DECODE_K_TILE]
                @ wq[k0:k0 + DECODE_K_TILE].float())
        acc = part if acc is None else acc + part
    return _epilogue(acc, w_scale, bias, out_dtype or x.dtype)

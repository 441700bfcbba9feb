"""Public ops: quantized matmuls, dispatched on the tensors' device.

CPU tensors take the plain versions (``ref.py``), and so do meta tensors
(a dry-run trace's shapes and dtypes).  CUDA tensors launch the
hand-written kernels or raise; there is no fallback:
  * ``int8_matmul``        -> ``csrc/int8_matmul.cu`` (B4, tiled W8A8)
  * ``w8a8_matmul_decode`` -> ``csrc/w8a8_decode.cu`` (B5, skinny M)
  * ``fp8_matmul_decode``  -> ``csrc/fp8_decode.cu``  (B6, skinny M)
The kernels mask ragged M, N and K themselves, so nothing is padded to
tiles here (the reference pads to its Pallas blocks).  ``launches``,
``decode_launches`` and ``fp8_launches`` count kernel launches (one per
call on a CUDA tensor), so a run can show that its linears went through
the kernels; ``tc_launches`` counts the tiled launches that took B4's
wgmma step (K and N multiples of 16, 16-byte aligned operands; other
shapes take its ragged step), ``decode_tc_launches`` the W8A8 decode
launches that took B5's tensor-core step (N % 16 == 0, K % 32 == 0, K
<= 16,384, 16-byte aligned x / wq / out; bf16 or fp32 x; other shapes
take its ragged step), ``fp8_tc_launches`` the fp8 launches that took
B6's tensor-core step (bf16 x; fp32 x takes the FMA step).
``int4_matmul`` has no kernel in the reference either.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul.ref import (fp8_decode_ref,
                                                 int4_matmul_ref,
                                                 int8_matmul_ref,
                                                 quantize_rowwise,
                                                 w8a8_decode_ref)

#: kernel launches since the last reset (plain integers; reset by callers)
launches = 0            # B4 tiled W8A8
tc_launches = 0         # of those, on the wgmma step
decode_launches = 0     # B5 W8A8 decode
decode_tc_launches = 0  # of those, on the tensor-core step
fp8_launches = 0        # B6 fp8 decode
fp8_tc_launches = 0     # of those, on the tensor-core step

DECODE_M_MAX = 128      # rows the decode kernels take (the dispatch's split)
_TILE_N = 128           # columns per decode block (csrc kBN)
_TC_ROWS = 8            # x rows per tensor-core block (csrc tc_step::kMT)
_TC_STAGE_K = 64        # k-rows per ring stage (csrc tc_step::kKS)
_MAX_CLUSTER = 8        # k-ranges of a tensor-core column tile (a cluster)
W8A8_TC_MAX_RANGE_K = 2048  # B5's longest tensor-core k-range (its blocks
                            # keep 8 rows of x on chip, raw and quantized)
_TARGET_BLOCKS = 264    # two blocks per SM on a 132-SM H100
_TC_TARGET_BLOCKS = 528  # four tensor-core blocks per SM (B6: 28 KB of
                         # ring; B5 at qwen2's shapes: 37 KB with its x)
_MIN_SPLIT_K = 64
_PARTIAL_BYTES = 8 << 20
_X_DTYPES = (torch.float32, torch.bfloat16)

#: per (device, stream): the decode kernels' split-K tile counters, zero
#: between launches (each launch's last block resets the ones it used)
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def decode_split(m: int, k: int, n: int, tc: bool = False,
                 max_range_k: Optional[int] = None) -> tuple[int, int]:
    """(n_split, k_per_split) of a decode launch (B5 or B6): enough K
    ranges that the blocks (column tiles x ranges, and on the tensor-core
    step x blocks of 8 rows) fill the card.  Other step (B5 ragged, B6
    FMA): two blocks an SM, ranges at least 64 deep in multiples of 4, the
    split partials bounded to 8 MB.  Tensor-core step: four blocks an SM,
    ranges in whole 64-row ring stages, at most 8 (one thread block
    cluster), summed on chip; ``max_range_k`` (B5, whose blocks keep their
    slice of x on chip) bounds a range's depth where 8 ranges allow it."""
    blocks = -(-n // _TILE_N) * (-(-m // _TC_ROWS) if tc else 1)
    want = -(-(_TC_TARGET_BLOCKS if tc else _TARGET_BLOCKS) // blocks)
    cap_k = max(1, k // _MIN_SPLIT_K)
    cap = _MAX_CLUSTER if tc else max(1, _PARTIAL_BYTES // (m * n * 4))
    s = max(1, min(want, cap_k, cap))
    if max_range_k:
        s = min(cap, max(s, -(-k // max_range_k)))
    step = _TC_STAGE_K if tc else 4
    kps = -(-k // s)
    kps = -(-kps // step) * step
    return -(-k // kps), kps


def _check(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_tensors(name, tensors, device) -> None:
    for t in tensors:
        _check(name, t.device == device, "all tensors must be on one device")
        _check(name, t.is_contiguous(), "tensors must be contiguous")


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """xq: (M,K) int8; wq: (K,N) int8; x_scale: (M,), w_scale: (N,) fp32
    -> (M,N) ``(acc·xs)·ws`` in ``out_dtype``."""
    if xq.device.type in ("cpu", "meta"):
        return int8_matmul_ref(xq, wq, x_scale, w_scale, out_dtype=out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {xq.device}")
    return _launch_tiled(xq, wq, x_scale, w_scale, out_dtype)


def _launch_tiled(xq, wq, xs, ws, out_dtype):
    global launches, tc_launches
    name = "int8_matmul"
    m, k = xq.shape
    _check(name, wq.ndim == 2 and wq.shape[0] == k, "wq must be (K, N)")
    n = wq.shape[1]
    _check(name, xq.dtype == torch.int8 and wq.dtype == torch.int8,
           f"operands {xq.dtype}/{wq.dtype}, want int8")
    _check(name, xs.dtype == torch.float32 and ws.dtype == torch.float32
           and tuple(xs.shape) == (m,) and tuple(ws.shape) == (n,),
           "scales must be fp32 (M,) and (N,)")
    _check(name, out_dtype in _X_DTYPES, f"out dtype {out_dtype}")
    _check_tensors(name, (xq, wq, xs, ws), xq.device)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    vec = int(k % 4 == 0 and n % 4 == 0 and xq.data_ptr() % 4 == 0
              and wq.data_ptr() % 4 == 0)
    aligned16 = int(all(t.data_ptr() % 16 == 0 for t in (xq, wq, out)))
    fn, err = build.load(name)
    rc = fn(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m, k, n, build.DTYPE_CODES[out_dtype], vec,
            aligned16, build.stream_handle(xq.device))
    build.check_status(name, rc, err)
    launches += 1
    tc_launches += build.tc_step_query(name)(k, n, aligned16)
    return out


def int8_matmul_dynamic(x: torch.Tensor, wq: torch.Tensor,
                        w_scale: torch.Tensor) -> torch.Tensor:
    """Quantize activations per row on the fly, then :func:`int8_matmul`
    (the W8A8 path at M > 128): (..., K) -> (..., N) in x's type."""
    shp = x.shape
    xq, xs = quantize_rowwise(x.reshape(-1, shp[-1]))
    y = int8_matmul(xq, wq, xs, w_scale, out_dtype=x.dtype)
    return y.reshape(*shp[:-1], wq.shape[1])


def w8a8_matmul_decode(x2: torch.Tensor, wq: torch.Tensor,
                       w_scale: torch.Tensor, *,
                       bias: Optional[torch.Tensor] = None,
                       out_dtype=None) -> torch.Tensor:
    """Skinny W8A8: x2 (M,K) RAW activations (M <= 128 on CUDA), wq (K,N)
    int8, w_scale (N,) fp32, bias (N,) or None -> (M,N).  The kernel
    quantizes x per row itself and folds the bias into its epilogue."""
    out_dtype = out_dtype or x2.dtype
    if x2.device.type in ("cpu", "meta"):
        return w8a8_decode_ref(x2, wq, w_scale, bias, out_dtype)
    if x2.device.type != "cuda":
        raise ValueError(f"w8a8_matmul_decode: unsupported device "
                         f"{x2.device}")
    return _launch_decode("w8a8_decode", x2, wq, w_scale, bias, out_dtype)


def fp8_matmul_decode(x2: torch.Tensor, wq: torch.Tensor,
                      w_scale: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype=None) -> torch.Tensor:
    """Skinny weight-only fp8: x2 (M,K) (M <= 128 on CUDA), wq (K,N)
    float8_e4m3fn, w_scale (N,) fp32, bias (N,) or None -> (M,N)."""
    out_dtype = out_dtype or x2.dtype
    if x2.device.type in ("cpu", "meta"):
        return fp8_decode_ref(x2, wq, w_scale, bias, out_dtype)
    if x2.device.type != "cuda":
        raise ValueError(f"fp8_matmul_decode: unsupported device "
                         f"{x2.device}")
    return _launch_decode("fp8_decode", x2, wq, w_scale, bias, out_dtype)


def _counters(device: torch.device, tiles: int) -> torch.Tensor:
    key = (device.index, build.stream_handle(device))
    c = _COUNTERS.get(key)
    if c is None or c.numel() < tiles:
        c = torch.zeros(max(tiles, 128), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def _launch_decode(name, x2, wq, ws, bias, out_dtype):
    global decode_launches, decode_tc_launches, fp8_launches, fp8_tc_launches
    int8 = name == "w8a8_decode"
    want_w = torch.int8 if int8 else torch.float8_e4m3fn
    _check(name, x2.ndim == 2 and wq.ndim == 2 and wq.shape[0] == x2.shape[1],
           "x2 must be (M, K) and wq (K, N)")
    m, k = x2.shape
    n = wq.shape[1]
    _check(name, 0 < m <= DECODE_M_MAX, f"M = {m} rows, want 1..128")
    _check(name, x2.dtype in _X_DTYPES, f"x dtype {x2.dtype}")
    _check(name, wq.dtype == want_w, f"wq dtype {wq.dtype}, want {want_w}")
    _check(name, out_dtype in _X_DTYPES, f"out dtype {out_dtype}")
    _check(name, ws.dtype == torch.float32 and tuple(ws.shape) == (n,),
           "w_scale must be fp32 (N,)")
    tensors = [x2, wq, ws]
    if bias is not None:
        _check(name, bias.dtype in _X_DTYPES and tuple(bias.shape) == (n,),
               "bias must be fp32 or bf16 (N,)")
        tensors.append(bias)
    _check_tensors(name, tensors, x2.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    aligned16 = int(all(t.data_ptr() % 16 == 0 for t in (x2, wq, out)))
    tc = build.tc_step_query(name)(build.DTYPE_CODES[x2.dtype], k, n,
                                   aligned16)
    n_split, kps = decode_split(
        m, k, n, tc=bool(tc),
        max_range_k=W8A8_TC_MAX_RANGE_K if int8 and tc else None)
    partial = counters = None
    if n_split > 1 and not tc:
        partial = torch.empty((n_split, m, n), device=x2.device,
                              dtype=torch.int32 if int8 else torch.float32)
        counters = _counters(x2.device, -(-n // _TILE_N))
    vec = int(n % 4 == 0 and wq.data_ptr() % 4 == 0)
    fn, err = build.load(name)
    args = [x2.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if counters is None else counters.data_ptr(),
            m, k, n, n_split, kps, build.DTYPE_CODES[x2.dtype],
            build.DTYPE_CODES[out_dtype],
            build.DTYPE_CODES[bias.dtype] if bias is not None else 0, vec]
    if int8:
        args.append(int((k * x2.element_size()) % 16 == 0
                        and x2.data_ptr() % 16 == 0))
    args.append(aligned16)
    rc = fn(*args, build.stream_handle(x2.device))
    build.check_status(name, rc, err)
    if int8:
        decode_launches += 1
        decode_tc_launches += tc
    else:
        fp8_launches += 1
        fp8_tc_launches += tc
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """Weight-only int4 (W4A16), plain torch on every device, as the
    reference leaves it to XLA."""
    shp = x.shape
    y = int4_matmul_ref(x.reshape(-1, shp[-1]), packed, w_scale)
    return y.reshape(*shp[:-1], packed.shape[1])

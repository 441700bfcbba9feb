"""Public op: RMSNorm over the last axis, dispatched on the tensors'
device.

CPU tensors take the plain version (``ref.py``), and so do meta tensors
(a dry-run trace's shapes and dtypes).  CUDA tensors launch the
hand-written kernel (``csrc/rmsnorm.cu``) or raise; there is no fallback.
``launches`` counts kernel launches (one per call on a CUDA tensor);
``warp_launches`` counts those that took the warp step (one warp a row
held in registers: d <= 2,048, a whole number of 16-byte vectors, x, y
and the scale 16-byte aligned); other rows take the long-row step.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

#: kernel launches since the last reset (plain integers; reset by callers)
launches = 0
warp_launches = 0       # of those, on the warp step

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_D = 8192                    # the reference kernel's stated row limit


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) bf16 / fp32; scale: (d,) bf16 / fp32 -> (..., d) in
    x's dtype."""
    if x.device.type in ("cpu", "meta"):
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    return _launch(x, scale, eps)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rmsnorm: {msg}")


def _launch(x, scale, eps):
    global launches, warp_launches
    d = x.shape[-1]
    _check(scale.device == x.device, "x and scale must be on one device")
    _check(x.is_contiguous() and scale.is_contiguous(),
           "tensors must be contiguous")
    _check(x.dtype in _DTYPES and scale.dtype in _DTYPES,
           f"dtypes {x.dtype}/{scale.dtype}")
    _check(tuple(scale.shape) == (d,), f"scale shape {tuple(scale.shape)}")
    _check(0 < d <= _MAX_D, f"row length {d}")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    aligned16 = int(all(t.data_ptr() % 16 == 0 for t in (x, scale, out)))
    fn, err = build.load("rmsnorm")
    rc = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
            float(eps), build.DTYPE_CODES[x.dtype],
            build.DTYPE_CODES[scale.dtype], aligned16,
            build.stream_handle(x.device))
    build.check_status("rmsnorm", rc, err)
    launches += 1
    warp_launches += build.tc_step_query("rmsnorm")(
        build.DTYPE_CODES[x.dtype], d, aligned16)
    return out

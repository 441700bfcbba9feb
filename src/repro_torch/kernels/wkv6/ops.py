"""Public op: the RWKV-6 WKV recurrence, dispatched on the tensors' device.

CPU tensors take the plain chunked version (``ref.py``) on fp32 copies,
as the reference's op does, and so do meta tensors (a dry-run trace's
shapes and dtypes).  CUDA tensors launch the hand-written kernel
(``csrc/wkv6.cu``: a chunk-parallel increment pass, a carry pass along
the chunks, a chunk-parallel output pass) or raise; there is no
fallback.  ``launches`` counts calls that launched the kernel on a CUDA
tensor (one a call, whatever the passes).  Any sequence length is taken:
the kernel masks the tail chunk as the plain version pads it.  The state
entering every 64-token chunk goes through a workspace, (B, H,
ceil(S / 64), 64, 64) fp32 and the chunks' decays (B, H, ceil(S / 64),
64), allocated here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wkv6.ref import DEFAULT_CHUNK, wkv6_chunked_ref

#: kernel launches since the last reset (plain integer; reset by callers)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)     # r / k / v
_HEAD_DIM = 64                                # csrc/wkv6.cu kD


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,logw: (B,S,H,D); u: (H,D); s0: (B,H,D,D) fp32 state ->
    (o (B,S,H,D) fp32, s_final (B,H,D,D) fp32).  On the card r / k / v
    are bf16 or fp32 (read as they are: the upcast is exact), logw, u and
    s0 fp32, D 64."""
    if r.device.type in ("cpu", "meta"):
        return wkv6_chunked_ref(r.float(), k.float(), v.float(),
                                logw.float(), u.float(), s0.float(),
                                chunk=DEFAULT_CHUNK)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    return _launch(r, k, v, logw, u, s0)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wkv6: {msg}")


def _launch(r, k, v, logw, u, s0):
    global launches
    b, s, h, d = r.shape
    for x in (r, k, v, logw, u, s0):
        _check(x.device == r.device, "all tensors must be on one device")
        _check(x.is_contiguous(), "tensors must be contiguous")
    _check(r.dtype in _DTYPES and k.dtype == r.dtype and v.dtype == r.dtype,
           f"r/k/v dtypes {r.dtype}/{k.dtype}/{v.dtype}")
    _check(logw.dtype == torch.float32 and u.dtype == torch.float32
           and s0.dtype == torch.float32, "logw, u and s0 must be fp32")
    _check(k.shape == r.shape and v.shape == r.shape
           and logw.shape == r.shape, "r/k/v/logw shapes differ")
    _check(d == _HEAD_DIM, f"head dim {d} (the kernel takes {_HEAD_DIM})")
    _check(tuple(u.shape) == (h, d), f"u shape {tuple(u.shape)}")
    _check(tuple(s0.shape) == (b, h, d, d), f"s0 shape {tuple(s0.shape)}")
    o = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_final = torch.empty_like(s0)
    if b == 0 or h == 0:
        return o, s_final
    _check(s > 0, "empty sequence")
    _check(all(x.data_ptr() % 16 == 0 for x in (r, k, v, logw)),
           "r, k, v and logw must be 16-byte aligned (the kernel reads "
           "token rows 16 bytes at a time)")
    ws = torch.empty(b * h * -(-s // DEFAULT_CHUNK) * (d * d + d),
                     dtype=torch.float32, device=r.device)
    fn, err = build.load("wkv6")
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_final.data_ptr(),
            ws.data_ptr(), b, s, h, d, build.DTYPE_CODES[r.dtype],
            build.stream_handle(r.device))
    build.check_status("wkv6", rc, err)
    launches += 1
    return o, s_final

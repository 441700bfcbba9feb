"""Public op: flash attention, dispatched on the tensors' device.

CPU tensors take the plain version (``ref.py``), and so do meta tensors
(no values and no kernel: the plain version gives the result's shape
and dtype to a dry-run trace).  CUDA tensors launch the
hand-written kernel (``csrc/flash_attention.cu``) or raise; there is no
fallback.  ``launches`` counts kernel launches (one per call on a CUDA
tensor); ``tc_launches`` counts those that took the kernel's tensor-core
tile step (bf16; fp32 takes the FMA step).  Unlike the TPU kernel, any S and T are taken: the kernel masks
the ragged edge itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: kernel launches since the last reset (plain integer; reset by callers)
launches = 0
#: of those, launches that took the tensor-core tile step
tc_launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 64, 128)      # the port's configs (held by chip_smoke.py)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,KH,D) -> (B,S,H,D) in q's dtype."""
    if q.device.type in ("cpu", "meta"):
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, window)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _launch(q, k, v, causal, window):
    global launches, tc_launches
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    for x in (q, k, v):
        _check(x.device == q.device, "all tensors must be on one device")
        _check(x.is_contiguous(), "tensors must be contiguous")
        _check(x.dtype == q.dtype and x.dtype in _DTYPES,
               f"dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    _check(tuple(k.shape) == (b, t, kh, d) and v.shape == k.shape,
           f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)}")
    _check(d in _HEAD_DIMS, f"head dim {d}")
    _check(kh > 0 and h % kh == 0, f"{h} heads over {kh} kv heads")
    _check(window is None or window > 0, f"window {window}")
    out = torch.empty_like(q)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    dt = build.DTYPE_CODES[q.dtype]
    tc = build.tc_step_query("flash_attention")(dt)
    if tc:
        _check(all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
               "bf16 tensors must be 16-byte aligned (asynchronous copies)")
    fn, err = build.load("flash_attention")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kh, d, int(causal), window or 0, 1.0 / (d ** 0.5),
            dt, build.stream_handle(q.device))
    build.check_status("flash_attention", rc, err)
    launches += 1
    tc_launches += tc
    return out

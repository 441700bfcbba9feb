"""Public op: paged decode attention, dispatched on the tensors' device.

CPU tensors take the plain version (``ref.py``).  CUDA tensors launch the
hand-written kernel (``csrc/paged_attention.cu``) or raise; there is no
fallback.  ``launches`` counts kernel launches (one per call on a CUDA
tensor), so a run can show that its decode steps went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

#: kernel launches since the last reset (plain integer; reset by callers)
launches = 0

_Q_DTYPES = (torch.float32, torch.bfloat16)
_KV_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn)
_HEAD_DIMS = (16, 64, 128)      # the port's configs (held by chip_smoke.py)
_MAX_GROUP = 8                 # query heads per kv head (csrc kMaxG)
_TARGET_BLOCKS = 264           # two blocks per SM on a 132-SM H100
_MIN_SPLIT_TOKENS = 64


def split_plan(n_slots: int, kv_heads: int, horizon: int) -> tuple[int, int]:
    """(n_split, tokens_per_split): cut each slot's token horizon into
    ranges so that slots x kv heads x splits fills the card, with ranges of
    at least 64 tokens in multiples of 16 (4 warps x 4 tokens)."""
    want = -(-_TARGET_BLOCKS // max(n_slots * kv_heads, 1))
    n_split = max(1, min(want, -(-horizon // _MIN_SPLIT_TOKENS)))
    tps = -(-horizon // n_split)
    tps = -(-tps // 16) * 16
    return -(-horizon // tps), tps


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (S,H,D); k_pages/v_pages: (N,page,KH,D); block_table: (S,P)
    int32; lengths: (S,) int32; k_scales/v_scales: (N,KH) fp32 for int8 /
    fp8 pools -> (S,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table, lengths,
                                   k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, block_table, lengths, k_scales,
                   v_scales)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def _launch(q, k_pages, v_pages, block_table, lengths, k_scales, v_scales):
    global launches
    s_n, h, d = q.shape
    n_pages, page, kh, d_kv = k_pages.shape
    p_n = block_table.shape[1]
    quantized = k_pages.dtype in (torch.int8, torch.float8_e4m3fn)
    tensors = [q, k_pages, v_pages, block_table, lengths]
    if quantized:
        _check(k_scales is not None and v_scales is not None,
               "int8/fp8 pools need k_scales and v_scales")
        _check(k_scales.dtype == torch.float32
               and v_scales.dtype == torch.float32, "scales must be fp32")
        _check(tuple(k_scales.shape) == (n_pages, kh)
               and tuple(v_scales.shape) == (n_pages, kh),
               f"scales must be {(n_pages, kh)}")
        tensors += [k_scales, v_scales]
    else:
        _check(k_scales is None and v_scales is None,
               "scales are only taken with int8/fp8 pools")
    for t in tensors:
        _check(t.device == q.device, "all tensors must be on one device")
        _check(t.is_contiguous(), "tensors must be contiguous")
    _check(q.dtype in _Q_DTYPES, f"q dtype {q.dtype}")
    _check(k_pages.dtype in _KV_DTYPES and v_pages.dtype == k_pages.dtype,
           f"pool dtype {k_pages.dtype}/{v_pages.dtype}")
    _check(v_pages.shape == k_pages.shape, "k/v pools differ in shape")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
           "q and pools must be 16-byte aligned (vector loads)")
    _check(d == d_kv and d in _HEAD_DIMS, f"head dim {d} (pools {d_kv})")
    _check(h % kh == 0 and h // kh <= _MAX_GROUP,
           f"{h} heads over {kh} kv heads")
    _check(block_table.dtype == torch.int32
           and tuple(block_table.shape) == (s_n, p_n), "block_table")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (s_n,),
           "lengths")
    fn, err = build.load("paged_attention")
    n_split, tps = split_plan(s_n, kh, p_n * page)
    g = h // kh
    out = torch.empty_like(q)
    part_m = torch.empty((s_n, kh, n_split, g), device=q.device,
                         dtype=torch.float32)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((s_n, kh, n_split, g, d), device=q.device,
                           dtype=torch.float32)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), s_n, h, kh, d, page, p_n, n_split, tps,
            1.0 / (d ** 0.5), build.DTYPE_CODES[q.dtype],
            build.DTYPE_CODES[k_pages.dtype], build.stream_handle(q.device))
    build.check_status("paged_attention", rc, err)
    launches += 1
    return out

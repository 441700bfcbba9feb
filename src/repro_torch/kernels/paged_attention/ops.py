"""Public ops: paged decode attention and multi-query prefix-extend
attention, dispatched on the tensors' device.

CPU tensors take the plain versions (``ref.py``), and so do meta tensors
(a dry-run trace's shapes and dtypes).  CUDA tensors launch the
hand-written kernels (``csrc/paged_attention.cu``,
``csrc/paged_prefix_extend.cu``) or raise; there is no fallback.
``launches`` and ``extend_launches`` count kernel launches (one per call on
a CUDA tensor), so a run can show that its decode steps and its chunked
prefill continuations went through the kernels; ``tc_launches`` and
``extend_tc_launches`` count the launches that took a kernel's
tensor-core step (bf16 q over bf16 / int8 / fp8 pools, and for prefix
extend a bf16 chunk; other dtypes take the FMA step).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_prefix_extend_ref)

#: kernel launches since the last reset (plain integers; reset by callers)
launches = 0            # paged decode
tc_launches = 0         # of those, on the tensor-core step
extend_launches = 0     # prefix extend
extend_tc_launches = 0  # of those, on the tensor-core tile step

_Q_DTYPES = (torch.float32, torch.bfloat16)
_KV_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn)
_HEAD_DIMS = (16, 64, 128)      # the port's configs (held by chip_smoke.py)
_TARGET_BLOCKS = 132           # one block per SM on a 132-SM H100
_MAX_SPLIT = 8                 # splits of a cluster (csrc: at most 8)
_TILE = 64                     # tokens per key tile (csrc tc::kBK)
_ROW_GROUP = {True: 16, False: 8}   # query heads per block, by step


def split_plan(n_slots: int, kv_heads: int, horizon: int,
               row_groups: int = 1) -> tuple[int, int]:
    """(n_split, tokens_per_split): cut each slot's token horizon into at
    most 8 ranges (a thread block cluster) so that slots x kv heads x row
    groups x splits fills the card once, with ranges in whole 64-token
    tiles."""
    want = -(-_TARGET_BLOCKS // max(n_slots * kv_heads * row_groups, 1))
    n_split = max(1, min(want, _MAX_SPLIT, -(-horizon // _TILE)))
    tps = -(-horizon // n_split)
    tps = -(-tps // _TILE) * _TILE
    return -(-horizon // tps), tps


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (S,H,D); k_pages/v_pages: (N,page,KH,D); block_table: (S,P)
    int32; lengths: (S,) int32; k_scales/v_scales: (N,KH) fp32 for int8 /
    fp8 pools -> (S,H,D) in q's dtype."""
    if q.device.type in ("cpu", "meta"):
        return paged_attention_ref(q, k_pages, v_pages, block_table, lengths,
                                   k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, block_table, lengths, k_scales,
                   v_scales)


def _checker(name: str):
    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"{name}: {msg}")
    return check


def _check_pools(check, k_pages, v_pages, k_scales, v_scales) -> bool:
    """Pool dtype, shape and scale checks shared by both kernels; returns
    whether the pools are quantized."""
    n_pages, _, kh, _ = k_pages.shape
    quantized = k_pages.dtype in (torch.int8, torch.float8_e4m3fn)
    if quantized:
        check(k_scales is not None and v_scales is not None,
              "int8/fp8 pools need k_scales and v_scales")
        check(k_scales.dtype == torch.float32
              and v_scales.dtype == torch.float32, "scales must be fp32")
        check(tuple(k_scales.shape) == (n_pages, kh)
              and tuple(v_scales.shape) == (n_pages, kh),
              f"scales must be {(n_pages, kh)}")
    else:
        check(k_scales is None and v_scales is None,
              "scales are only taken with int8/fp8 pools")
    check(k_pages.dtype in _KV_DTYPES and v_pages.dtype == k_pages.dtype,
          f"pool dtype {k_pages.dtype}/{v_pages.dtype}")
    check(v_pages.shape == k_pages.shape, "k/v pools differ in shape")
    return quantized


def _check_tensors(check, tensors, device) -> None:
    for t in tensors:
        check(t.device == device, "all tensors must be on one device")
        check(t.is_contiguous(), "tensors must be contiguous")


def _launch(q, k_pages, v_pages, block_table, lengths, k_scales, v_scales):
    global launches, tc_launches
    check = _checker("paged_attention")
    s_n, h, d = q.shape
    n_pages, page, kh, d_kv = k_pages.shape
    p_n = block_table.shape[1]
    quantized = _check_pools(check, k_pages, v_pages, k_scales, v_scales)
    tensors = [q, k_pages, v_pages, block_table, lengths]
    if quantized:
        tensors += [k_scales, v_scales]
    _check_tensors(check, tensors, q.device)
    check(q.dtype in _Q_DTYPES, f"q dtype {q.dtype}")
    check(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
          "q and pools must be 16-byte aligned (vector loads and "
          "asynchronous copies)")
    check(d == d_kv and d in _HEAD_DIMS, f"head dim {d} (pools {d_kv})")
    check(h % kh == 0, f"{h} heads over {kh} kv heads")
    check(block_table.dtype == torch.int32
          and tuple(block_table.shape) == (s_n, p_n), "block_table")
    check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (s_n,),
          "lengths")
    dts = [build.DTYPE_CODES[t.dtype] for t in (q, k_pages)]
    tc = build.tc_step_query("paged_attention")(*dts)
    fn, err = build.load("paged_attention")
    rows = _ROW_GROUP[bool(tc)]
    groups = -(-(h // kh) // rows)
    n_split, tps = split_plan(s_n, kh, p_n * page, groups)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            out.data_ptr(), s_n, h, kh, d, page, p_n, n_split, tps,
            1.0 / (d ** 0.5), *dts, build.stream_handle(q.device))
    build.check_status("paged_attention", rc, err)
    launches += 1
    tc_launches += tc
    return out


def paged_prefix_extend_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  block_table: torch.Tensor,
                                  prefix_lens: torch.Tensor,
                                  chunk_k: torch.Tensor,
                                  chunk_v: torch.Tensor,
                                  widths: torch.Tensor,
                                  k_scales: Optional[torch.Tensor] = None,
                                  v_scales: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """q: (S,W,H,D) queries at logical positions ``prefix_lens[s] +
    [0, W)``; k_pages/v_pages: (N,page,KH,D); block_table: (S,P) int32;
    prefix_lens, widths: (S,) int32; chunk_k/chunk_v: (S,W,KH,D) fresh K/V
    attended causally up to ``widths[s]``; k_scales/v_scales: (N,KH) fp32
    for int8 / fp8 pools -> (S,W,H,D) in q's dtype.  q and the chunk are
    each fp32 or bf16."""
    if q.device.type in ("cpu", "meta"):
        return paged_prefix_extend_ref(q, k_pages, v_pages, block_table,
                                       prefix_lens, chunk_k, chunk_v, widths,
                                       k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_prefix_extend_attention: unsupported device {q.device}")
    return _launch_extend(q, k_pages, v_pages, block_table, prefix_lens,
                          chunk_k, chunk_v, widths, k_scales, v_scales)


def _launch_extend(q, k_pages, v_pages, block_table, prefix_lens, chunk_k,
                   chunk_v, widths, k_scales, v_scales):
    global extend_launches, extend_tc_launches
    check = _checker("paged_prefix_extend_attention")
    s_n, w_n, h, d = q.shape
    _, page, kh, d_kv = k_pages.shape
    p_n = block_table.shape[1]
    quantized = _check_pools(check, k_pages, v_pages, k_scales, v_scales)
    tensors = [q, k_pages, v_pages, block_table, prefix_lens, chunk_k,
               chunk_v, widths]
    if quantized:
        tensors += [k_scales, v_scales]
    _check_tensors(check, tensors, q.device)
    check(q.dtype in _Q_DTYPES, f"q dtype {q.dtype}")
    check(chunk_k.dtype in _Q_DTYPES and chunk_v.dtype == chunk_k.dtype,
          f"chunk dtype {chunk_k.dtype}/{chunk_v.dtype}")
    check(tuple(chunk_k.shape) == (s_n, w_n, kh, d)
          and chunk_v.shape == chunk_k.shape,
          f"chunk shapes {tuple(chunk_k.shape)}/{tuple(chunk_v.shape)}")
    check(d == d_kv and d in _HEAD_DIMS, f"head dim {d} (pools {d_kv})")
    check(h % kh == 0, f"{h} heads over {kh} kv heads")
    check(block_table.dtype == torch.int32
          and tuple(block_table.shape) == (s_n, p_n), "block_table")
    for name, t in (("prefix_lens", prefix_lens), ("widths", widths)):
        check(t.dtype == torch.int32 and tuple(t.shape) == (s_n,), name)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dts = [build.DTYPE_CODES[t.dtype] for t in (q, chunk_k, k_pages)]
    tc = build.tc_step_query("paged_prefix_extend")(*dts)
    if tc:
        check(all(t.data_ptr() % 16 == 0
                  for t in (q, k_pages, v_pages, chunk_k, chunk_v)),
              "q, pools and chunk must be 16-byte aligned (asynchronous "
              "copies)")
    fn, err = build.load("paged_prefix_extend")
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), prefix_lens.data_ptr(),
            chunk_k.data_ptr(), chunk_v.data_ptr(), widths.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            out.data_ptr(), s_n, w_n, h, kh, d, page, p_n, 1.0 / (d ** 0.5),
            *dts, build.stream_handle(q.device))
    build.check_status("paged_prefix_extend", rc, err)
    extend_launches += 1
    extend_tc_launches += tc
    return out

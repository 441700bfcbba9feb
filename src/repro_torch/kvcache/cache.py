"""KV-cache allocation, writes and views (bf16 pools).

The port's copy of the bf16 path of ``repro/kvcache/cache.py``:

Contiguous node:  {"k": (B,S,KH,D), "v": (B,S,KH,D)}
Paged node:       {"k_pages"/"v_pages": (N,page,KH,D),
                   "block_table": (n_slots, pages_per_slot) int32}

Page 0 is the null page (serve/paged.py): free slots' writes and padding
rows are routed there and reads are masked by per-slot lengths.

The reference returns new arrays (its cache is donated to each jitted
dispatch); here every write updates the cache tensors IN PLACE with
``index_put_`` / slice assignment and returns the same dict, so the page
pools are never double-resident.  Quantized writes (int8 / fp8 with
per-page scales) arrive in a later slice: the allocators refuse them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kvcache.spec import CacheSpec


def _refuse_quantized(spec: CacheSpec) -> None:
    if spec.quantized:
        raise NotImplementedError(
            f"kv cache dtype {spec.dtype!r}: quantized KV writes are not "
            "ported yet (bf16 pools only)")


# ---------------------------------------------------------------------------
# Allocation


def alloc_contiguous(spec: CacheSpec, a: AttentionConfig, batch: int,
                     max_len: int, device=None) -> dict:
    _refuse_quantized(spec)
    kvh = spec.stored_kv_heads(a)
    shape = (batch, max_len, kvh, a.head_dim)
    return {"k": torch.zeros(shape, dtype=spec.store_dtype, device=device),
            "v": torch.zeros(shape, dtype=spec.store_dtype, device=device)}


def alloc_paged(spec: CacheSpec, a: AttentionConfig, n_slots: int,
                n_pages: int, pages_per_slot: int, device=None,
                block_table: Optional[torch.Tensor] = None) -> dict:
    """Page pools shared by all slots + the per-slot block table.  Pass
    ``block_table`` to share one table tensor between layers (every layer
    maps a slot to the same pages; the reference keeps one copy per
    layer)."""
    _refuse_quantized(spec)
    kvh = spec.stored_kv_heads(a)
    shape = (n_pages, spec.page_size, kvh, a.head_dim)
    if block_table is None:
        block_table = torch.zeros((n_slots, pages_per_slot),
                                  dtype=torch.int32, device=device)
    return {"k_pages": torch.zeros(shape, dtype=spec.store_dtype,
                                   device=device),
            "v_pages": torch.zeros(shape, dtype=spec.store_dtype,
                                   device=device),
            "block_table": block_table}


# ---------------------------------------------------------------------------
# Contiguous writes


def prefill_write(cache: dict, updates: dict) -> dict:
    """Slab-write full-sequence values at position 0 (in place)."""
    for name, new in updates.items():
        cache[name][:, :new.shape[1]] = new.to(cache[name].dtype)
    return cache


# ---------------------------------------------------------------------------
# Paged writes


def paged_views(cache: dict):
    """(k_pages, v_pages, k_scales, v_scales, block_table) — scales are
    None for bf16 pools."""
    return (cache["k_pages"], cache["v_pages"], cache.get("k_scales"),
            cache.get("v_scales"), cache["block_table"])


def paged_write_batch(cache: dict, positions: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Write one token per slot (in place): k_new/v_new (S, KH, D) land at
    logical position ``positions[s]`` of each slot's pages.  Unallocated
    block-table rows resolve to the null page."""
    kp, vp, _, _, bt = paged_views(cache)
    page = kp.shape[1]
    s_n = positions.shape[0]
    positions = positions.long()
    # pad-safe: clamp the logical page (the reference clamps explicitly;
    # torch would raise on an out-of-range index instead)
    lpage = torch.clamp(positions // page, max=bt.shape[1] - 1)
    pidx = bt[torch.arange(s_n, device=bt.device), lpage].long()   # (S,)
    off = positions % page
    # duplicate (pidx, off) targets only ever alias the null page (free
    # slots); which garbage write wins there is arbitrary on CUDA and is
    # masked by every slot's length
    kp.index_put_((pidx, off), k_new.to(kp.dtype))
    vp.index_put_((pidx, off), v_new.to(vp.dtype))
    return cache


def paged_scatter_prefill(cache: dict, slot_ids: torch.Tensor,
                          lengths: torch.Tensor, k_rows: torch.Tensor,
                          v_rows: torch.Tensor,
                          starts: Optional[torch.Tensor] = None) -> dict:
    """Scatter a batched prefill's contiguous K/V into pages (in place).

    k_rows/v_rows: (B, T, KVH, D) — row b's tokens [0, lengths[b]) go to
    slot ``slot_ids[b]``'s pages at logical positions ``starts[b] +
    [0, lengths[b])`` (``starts`` defaults to 0: whole-prompt admission;
    chunked prefill passes each chunk's page-aligned start); padding
    tokens and rows with length 0 are routed to the null page.  One
    scatter per array."""
    kp, vp, _, _, bt = paged_views(cache)
    t = k_rows.shape[1]
    page = kp.shape[1]
    tpos = torch.arange(t, device=kp.device)[None, :]               # (1,T)
    valid = tpos < lengths[:, None].long()                          # (B,T)
    apos = tpos if starts is None else starts[:, None].long() + tpos
    lpage = torch.clamp(apos // page, max=bt.shape[1] - 1)          # pad-safe
    pidx = bt[slot_ids[:, None].long(), lpage].long()
    pidx = torch.where(valid, pidx, 0)
    off = torch.where(valid, apos % page, 0)
    # padding rows all alias (null page, offset 0): the winner among the
    # duplicates is arbitrary on CUDA and never read
    kp.index_put_((pidx, off), k_rows.to(kp.dtype))
    vp.index_put_((pidx, off), v_rows.to(vp.dtype))
    return cache

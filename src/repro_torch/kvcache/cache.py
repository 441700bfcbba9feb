"""KV-cache allocation, writes and views.

The port's copy of ``repro/kvcache/cache.py``:

Contiguous node:  {"k": (B,S,KH,D), "v": (B,S,KH,D)
                   [, "k_scale"/"v_scale": (B,S,KH) fp32]}
                  (the eager ``Engine``'s cache, a draft LM's, and the
                  bf16 staging caches of admission and speculative
                  verify)
Paged node:       {"k_pages"/"v_pages": (N,page,KH,D),
                   [, "k_scales"/"v_scales": (N,KH) fp32]
                   "block_table": (n_slots, pages_per_slot) int32}

Quantized scales are fp32 amax scales: per (batch, position, kv head)
for contiguous caches, each position quantized once with its own, and per
(page, kv head) for paged pools.  A
page's scale is a *running* maximum: a decode write that raises it
requantizes the page (``quant.requantize``; factor <= 1, so int8 never
re-clips), and a write at offset 0 resets it, so a reused page sheds its
previous occupant's scale on the device.  Prefill scatters reset every
page they touch to exactly their own amax (reset, then scatter-max), which
is why chunk starts must be page-aligned.  Page 0 is the null page
(serve/paged.py): free slots' writes and padding rows are routed there
and reads are masked by per-slot lengths.

The reference returns new arrays (its cache is donated to each jitted
dispatch); here every write updates the cache tensors IN PLACE with
``index_put_`` / ``scatter_reduce_`` and returns the same dict, so the page
pools are never double-resident.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kvcache.quant import (_div, qmax_of, quantize,
                                       quantize_with_scale, requant_factor,
                                       rescale)
from repro_torch.kvcache.spec import CacheSpec


# ---------------------------------------------------------------------------
# Allocation


def alloc_contiguous(spec: CacheSpec, a: AttentionConfig, batch: int,
                     max_len: int, device=None) -> dict:
    kvh = spec.stored_kv_heads(a)
    shape = (batch, max_len, kvh, a.head_dim)
    c = {"k": torch.zeros(shape, dtype=spec.store_dtype, device=device),
         "v": torch.zeros(shape, dtype=spec.store_dtype, device=device)}
    if spec.quantized:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                  device=device)
    return c


def alloc_paged(spec: CacheSpec, a: AttentionConfig, n_slots: int,
                n_pages: int, pages_per_slot: int, device=None,
                block_table: Optional[torch.Tensor] = None) -> dict:
    """Page pools shared by all slots + the per-slot block table.  Pass
    ``block_table`` to share one table tensor between layers (every layer
    maps a slot to the same pages; the reference keeps one copy per
    layer)."""
    kvh = spec.stored_kv_heads(a)
    shape = (n_pages, spec.page_size, kvh, a.head_dim)
    if block_table is None:
        block_table = torch.zeros((n_slots, pages_per_slot),
                                  dtype=torch.int32, device=device)
    c = {"k_pages": torch.zeros(shape, dtype=spec.store_dtype,
                                device=device),
         "v_pages": torch.zeros(shape, dtype=spec.store_dtype,
                                device=device),
         "block_table": block_table}
    if spec.quantized:
        c["k_scales"] = torch.zeros((n_pages, kvh), dtype=torch.float32,
                                    device=device)
        c["v_scales"] = torch.zeros((n_pages, kvh), dtype=torch.float32,
                                    device=device)
    return c


# ---------------------------------------------------------------------------
# Contiguous writes


def prefill_write(cache: dict, updates: dict) -> dict:
    """Slab-write full-sequence values at position 0 (in place).  A name
    with a ``<name>_scale`` sibling in the cache is quantized on the way
    in, each position with its own amax scale."""
    for name, new in updates.items():
        s = new.shape[1]
        sk = name + "_scale"
        if sk in cache:
            q, scale = quantize(new, cache[name].dtype)
            cache[name][:, :s] = q
            cache[sk][:, :s] = scale
        else:
            cache[name][:, :s] = new.to(cache[name].dtype)
    return cache


def decode_write(cache: dict, updates: dict, pos: torch.Tensor) -> dict:
    """One-token write (in place) at per-row positions ``pos`` (B,):
    ``updates`` maps "k" / "v" to (B, 1, KH, D), quantized with their
    own amax scales into an int8 / fp8 cache.  A position past the slab
    is clamped to its last row, as the reference's
    ``dynamic_update_slice`` clamps (a draft LM's lock-step steps past
    the end only ever write there)."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    for name, new in updates.items():
        tgt = cache[name]
        p = torch.clamp(pos.long(), 0, tgt.shape[1] - 1)
        sk = name + "_scale"
        if sk in cache:
            q, scale = quantize(new[:, 0], tgt.dtype)
            tgt[rows, p] = q
            cache[sk][rows, p] = scale
        else:
            tgt[rows, p] = new[:, 0].to(tgt.dtype)
    return cache


def kv_views(cache: dict):
    """(k, v, k_scale, v_scale) of a contiguous node; the scales are None
    for bf16 / float32 caches.  Attention folds them into its products
    (no dequantized copy of the cache is materialized)."""
    return cache["k"], cache["v"], cache.get("k_scale"), cache.get("v_scale")


# ---------------------------------------------------------------------------
# Paged writes


def paged_views(cache: dict):
    """(k_pages, v_pages, k_scales, v_scales, block_table) — scales are
    None for bf16 pools."""
    return (cache["k_pages"], cache["v_pages"], cache.get("k_scales"),
            cache.get("v_scales"), cache["block_table"])


def _quant_token_write(pools, scales, pidx, off, new) -> None:
    """Append one quantized token per slot at (pidx, off) to the K and V
    pools, in place, growing each page's running amax scale (resetting it
    at offset 0) and requantizing the page when it grows.  pools / scales:
    the (K, V) pairs of (N,page,KH,D) / (N,KH); new: (2,S,KH,D), K then V.

    The reference branches with ``lax.cond``, per pool, on whether any
    real page's scale grew (fresh pages, pages with scale 0 and the null
    page do not count) and then requantizes every written page by
    ``old / new``.  A branch here would read the device from the host, so
    both branches are one computation: every written page is rewritten,
    by that factor when a page of its pool grew and by 1 (which changes no
    bit) when none did.  K and V go through one chain of ops on stacked
    tensors: a decode step is host-bound, so what costs is the number of
    launches, not the bytes."""
    s_n = pidx.shape[0]
    dtype = pools[0].dtype
    amax_q = _div(new.float().abs().amax(dim=-1), qmax_of(dtype))  # (2,S,KH)
    old = torch.stack([sc[pidx] for sc in scales])                 # (2,S,KH)
    fresh = (off == 0)[:, None]                                    # (S,1)
    ns = torch.where(fresh, amax_q, torch.maximum(old, amax_q))
    tok = quantize_with_scale(new, ns, dtype)                      # (2,S,KH,D)
    grew = ((ns > old) & (old > 0) & ~fresh
            & (pidx != 0)[:, None]).flatten(1).any(dim=1)         # (2,)
    factor = torch.where(grew[:, None, None], requant_factor(old, ns),
                         torch.ones_like(old))
    pg = rescale(torch.stack([p[pidx] for p in pools]),
                 factor[:, :, None])                          # (2,S,page,KH,D)
    pg[:, torch.arange(s_n, device=pg.device), off] = tok
    # duplicate pidx entries only ever alias the null page (free slots);
    # whichever garbage write wins there is masked away
    for pool, sc, p_new, s_new in zip(pools, scales, pg, ns):
        pool[pidx] = p_new
        sc[pidx] = s_new


def paged_write_batch(cache: dict, positions: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> dict:
    """Write one token per slot (in place): k_new/v_new (S, KH, D) land at
    logical position ``positions[s]`` of each slot's pages.  Unallocated
    block-table rows resolve to the null page.  ``mask`` (S,) bool
    reroutes masked-out slots' writes to the null page: the speculative
    commit replays only accepted tokens this way, so a rejected draft
    never touches a live page or grows a page's scale."""
    kp, vp, ks, vs, bt = paged_views(cache)
    page = kp.shape[1]
    s_n = positions.shape[0]
    positions = positions.long()
    # pad-safe: clamp the logical page (the reference clamps explicitly;
    # torch would raise on an out-of-range index instead)
    lpage = torch.clamp(positions // page, max=bt.shape[1] - 1)
    pidx = bt[torch.arange(s_n, device=bt.device), lpage].long()   # (S,)
    off = positions % page
    if mask is not None:
        pidx = torch.where(mask, pidx, 0)
        off = torch.where(mask, off, 0)
    if ks is not None:
        _quant_token_write((kp, vp), (ks, vs), pidx, off,
                           torch.stack([k_new, v_new]))
        return cache
    # duplicate (pidx, off) targets only ever alias the null page (free
    # slots); which garbage write wins there is arbitrary on CUDA and is
    # masked by every slot's length
    kp.index_put_((pidx, off), k_new.to(kp.dtype))
    vp.index_put_((pidx, off), v_new.to(vp.dtype))
    return cache


def _quant_scatter(pages, scales, pidx, off, rows, amax) -> None:
    """Scatter a prefill's rows into pages with fresh per-page scales, in
    place.  pidx/off: (B,T); rows: (B,T,KH,D); amax: (B,T,KH), zero at
    padding positions.  Reset-then-max: every touched page gets exactly
    this scatter's amax (a released slot's stale scale does not linger)."""
    flat = pidx.reshape(-1)
    src = _div(amax, qmax_of(pages.dtype)).reshape(flat.shape[0], -1)
    scales[flat] = 0.0
    scales.scatter_reduce_(0, flat[:, None].expand_as(src), src, "amax")
    q = quantize_with_scale(rows, scales[pidx], pages.dtype)
    pages[pidx, off] = q


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
    scatter per array.  Quantized pools reset every touched page's scale
    to this scatter's amax, so non-zero ``starts`` must be page-aligned
    (the scheduler's chunks are)."""
    kp, vp, ks, vs, bt = paged_views(cache)
    t = k_rows.shape[1]
    page = kp.shape[1]
    tpos = torch.arange(t, device=kp.device)[None, :]               # (1,T)
    valid = tpos < lengths[:, None].long()                          # (B,T)
    apos = tpos if starts is None else starts[:, None].long() + tpos
    lpage = torch.clamp(apos // page, max=bt.shape[1] - 1)          # pad-safe
    pidx = bt[slot_ids[:, None].long(), lpage].long()
    pidx = torch.where(valid, pidx, 0)
    off = torch.where(valid, apos % page, 0)
    if ks is not None:
        vm = valid[..., None].float()                               # (B,T,1)
        for pool, sc, rows in ((kp, ks, k_rows), (vp, vs, v_rows)):
            amax = rows.float().abs().amax(dim=-1) * vm
            _quant_scatter(pool, sc, pidx, off, rows, amax)
        return cache
    # padding rows all alias (null page, offset 0): the winner among the
    # duplicates is arbitrary on CUDA and never read
    kp.index_put_((pidx, off), k_rows.to(kp.dtype))
    vp.index_put_((pidx, off), v_rows.to(vp.dtype))
    return cache


# ---------------------------------------------------------------------------
# Accounting


def pool_bytes(cache) -> int:
    """Bytes of KV storage (pages and scales) in a cache (a node, or the
    model's list of groups); block tables excluded (bookkeeping)."""
    if isinstance(cache, (list, tuple)):
        return sum(pool_bytes(c) for c in cache)
    if isinstance(cache, dict):
        return sum(pool_bytes(v) for k, v in cache.items()
                   if k != "block_table")
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return 0

"""Paged KV cache host bookkeeping and the engine-facing cache walkers.

The port's copy of ``repro/serve/paged.py``: a per-slot block table of
large pages (256 tokens by default) over shared page pools, with page 0
the NULL page — free slots' block-table rows point at it and masked
writes (padding tokens, retired slots) land there, so device code needs
no branch for "no page allocated here".  This module owns the HOST side
(the refcounted allocator) and the walkers that apply ``repro_torch.
kvcache`` device writes to a whole model's cache; the pools themselves
are updated in place.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.kvcache import paged_scatter_prefill, paged_write_batch

PAGE = 256


class OutOfPagesError(RuntimeError):
    """Raised when an allocation cannot be satisfied by the free list."""


class PageAllocator:
    """Host-side page accounting: refcounted pages + a host block table.

    Device arrays (the page pools, the device block table inside the
    engine cache) are owned elsewhere; this class only decides WHICH
    physical pages a slot owns.  Page 0 is reserved as the null page.

    Pages carry a reference count so one physical page can back several
    block-table rows at once: full pages are immutable (writes only ever
    land past a slot's length), so a shared prompt prefix can be mapped
    into every slot that carries it (``assign`` with ``shared``), and the
    scheduler's prefix cache can keep pages alive after their slot
    retires (``ref``).  A page returns to the free list exactly when its
    last reference drops (``unref``).
    """

    def __init__(self, n_pages: int, max_pages_per_slot: int, n_slots: int):
        self.n_pages = n_pages
        self.max_pages_per_slot = max_pages_per_slot
        self.free: List[int] = list(range(n_pages - 1, 0, -1))
        self.table = np.zeros((n_slots, max_pages_per_slot), np.int32)
        self.refs = np.zeros((n_pages,), np.int32)
        self._owned: Dict[int, List[int]] = {}
        # optional chaos harness (repro_torch.resil.inject.FaultInjector):
        # when set AND enabled, _take consults it for spurious page faults
        # and forced pool shrinkage; None is the untouched allocation path
        self.injector = None

    def pages_needed(self, seq_len: int, page_size: int = PAGE) -> int:
        return (seq_len + page_size - 1) // page_size

    def occupancy(self, top: int = 3) -> dict:
        """Point-in-time pool snapshot for post-mortems: free/total
        pages (null page excluded), pages pinned beyond slot ownership
        (prefix-cache references), and the largest slot holders."""
        holders = sorted(((s, len(p)) for s, p in self._owned.items() if p),
                         key=lambda x: -x[1])[:top]
        slot_pages = sum(len(p) for p in self._owned.values())
        referenced = int((self.refs > 0).sum())
        used = self.n_pages - 1 - len(self.free)
        return {"free": len(self.free), "total": self.n_pages - 1,
                "used": used, "slot_pages": slot_pages,
                "cache_only_pages": used - len(
                    {p for ps in self._owned.values() for p in ps}),
                "referenced": referenced,
                "top_holders": holders}

    def occupancy_summary(self, top: int = 3) -> str:
        """One-line occupancy rendering appended to every
        OutOfPagesError message (post-mortem debuggability)."""
        o = self.occupancy(top)
        holders = ", ".join(f"slot {s}: {n}p" for s, n in o["top_holders"]) \
            or "none"
        return (f"pool {o['used']}/{o['total']} pages used "
                f"({o['free']} free, {o['cache_only_pages']} cache-held), "
                f"top holders: {holders}")

    def _take(self, need: int) -> List[int]:
        avail = len(self.free)
        inj = self.injector
        if inj is not None and inj.enabled:
            inj.page_fault_check(self)     # may raise InjectedPageFault
            avail = max(avail - inj.reserved_pages(), 0)
        if need > avail:
            raise OutOfPagesError(
                f"need {need} pages, {avail} free; "
                f"{self.occupancy_summary()}")
        return [self.free.pop() for _ in range(need)]

    def alloc(self, slot: int, need: int) -> List[int]:
        """Reserve ``need`` fresh pages for ``slot``.  Atomic: on failure
        the free list is left exactly as it was and OutOfPagesError
        raised."""
        return self.assign(slot, (), need)

    def assign(self, slot: int, shared, need: int) -> List[int]:
        """Give ``slot`` the already-allocated pages ``shared`` (each
        gains a reference — the prefix-cache hit path) followed by
        ``need`` fresh pages.  Atomic like :meth:`alloc`."""
        if self._owned.get(slot):
            raise OutOfPagesError(f"slot {slot} already holds pages")
        total = len(shared) + need
        if total > self.max_pages_per_slot:
            raise OutOfPagesError(
                f"need {total} pages > {self.max_pages_per_slot} per slot; "
                f"{self.occupancy_summary()}")
        fresh = self._take(need)
        for p in shared:
            self.refs[p] += 1
        for p in fresh:
            self.refs[p] = 1
        pages = list(shared) + fresh
        self.table[slot, :] = 0
        self.table[slot, :total] = pages
        self._owned[slot] = pages
        return pages

    def extend(self, slot: int, extra: int) -> List[int]:
        """Lazily grow ``slot``'s allocation by ``extra`` fresh pages
        (appended to its block-table row).  Atomic."""
        owned = self._owned.get(slot)
        if owned is None:
            raise OutOfPagesError(f"slot {slot} owns no pages")
        n0 = len(owned)
        if n0 + extra > self.max_pages_per_slot:
            raise OutOfPagesError(
                f"{n0}+{extra} pages > {self.max_pages_per_slot} per slot; "
                f"{self.occupancy_summary()}")
        fresh = self._take(extra)
        for p in fresh:
            self.refs[p] = 1
        self.table[slot, n0:n0 + extra] = fresh
        owned.extend(fresh)
        return fresh

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, ()))

    def ref(self, page: int) -> None:
        """Take an extra reference on an allocated page (prefix cache)."""
        if self.refs[page] <= 0:
            raise ValueError(f"ref on unallocated page {page}")
        self.refs[page] += 1

    def unref(self, page: int) -> None:
        """Drop a reference; the page frees when the count hits zero."""
        if self.refs[page] <= 0:
            raise ValueError(f"double free of page {page}")
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self.free.append(page)

    def cow(self, slot: int, index: int) -> int:
        """Copy-on-write: replace the SHARED page at ``slot``'s block-
        table position ``index`` with a fresh exclusive page (the caller
        copies the device contents).  The old page keeps its other
        references (prefix cache / other rows); this row's reference
        moves to the fresh page.  Atomic: on OutOfPagesError nothing
        changed.  Returns the fresh physical page id."""
        owned = self._owned.get(slot)
        if owned is None or index >= len(owned):
            raise ValueError(f"slot {slot} owns no page at index {index}")
        old = owned[index]
        if self.refs[old] <= 1:
            raise ValueError(f"cow of exclusive page {old} (refs <= 1)")
        (fresh,) = self._take(1)
        self.refs[fresh] = 1
        owned[index] = fresh
        self.table[slot, index] = fresh
        self.unref(old)
        return fresh

    def release(self, slot: int) -> None:
        for p in self._owned.pop(slot, ()):
            self.unref(p)
        self.table[slot, :] = 0


# ---------------------------------------------------------------------------
# Engine-facing cache walkers (device writes themselves: repro_torch.kvcache)


def _attn_nodes(cache):
    """Every paged / contiguous attention node of a model cache (a list of
    groups of ``{"blk<i>": {"kv": node}}``), in layer order."""
    return [blk["kv"] for group in cache for blk in group.values()]


def scatter_prefill_cache(paged_cache, contig_cache, slot_ids, lengths,
                          starts=None):
    """Scatter a whole model's batched-prefill cache into the paged cache,
    layer by layer (in place): every paged node receives the matching
    contiguous node's rows via ``kvcache.paged_scatter_prefill``, offset
    by ``starts`` (B,) when given (page-aligned chunk starts).  The
    staging cache is bf16 whatever the pools hold: int8 / fp8 pools are
    quantized once, here, with each touched page's exact amax scale."""
    for node, contig in zip(_attn_nodes(paged_cache),
                            _attn_nodes(contig_cache)):
        paged_scatter_prefill(node, slot_ids, lengths, contig["k"],
                              contig["v"], starts)
    return paged_cache


def commit_spec_cache(paged_cache, stage_cache, lengths, n_write):
    """Commit a speculative verify round's ACCEPTED tokens into the paged
    cache, in place (write-after-accept; ``repro_torch.spec``).

    ``stage_cache`` is the bf16 staging cache ``LM.verify_paged`` filled
    (per attention node ``{"k"/"v": (S, W, KH, D)}``) and ``n_write`` (S,)
    how many leading chunk tokens each slot accepted.  The writes replay
    the decode path: W per-token ``kvcache.paged_write_batch`` calls per
    layer in chunk order, masked to ``i < n_write[s]`` (masked writes
    land in the null page), so the pools, int8 / fp8 page scales and
    their requantizations included, evolve just as W decode steps would
    have moved them.  Rejected draft K/V is never written: rolling back
    is a host-side length truncation."""
    for node, stage in zip(_attn_nodes(paged_cache),
                           _attn_nodes(stage_cache)):
        k_rows, v_rows = stage["k"], stage["v"]
        for i in range(k_rows.shape[1]):
            paged_write_batch(node, lengths + i, k_rows[:, i], v_rows[:, i],
                              mask=i < n_write)
    return paged_cache


def set_block_table_rows(cache, slots, rows):
    """Push host block-table rows into the device block table(s), in
    place.  slots: (n,) slot indices; rows: (n, pages_per_slot) int32.
    Layers that share one table tensor are written once."""
    seen = set()
    for node in _attn_nodes(cache):
        bt = node["block_table"]
        if id(bt) in seen:
            continue
        seen.add(id(bt))
        idx = torch.as_tensor(np.asarray(slots), dtype=torch.long,
                              device=bt.device)
        bt[idx] = torch.as_tensor(np.asarray(rows, np.int32),
                                  device=bt.device)
    return cache

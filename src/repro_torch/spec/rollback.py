"""Paged-cache rollback invariants for speculative decoding (the port of
``repro/spec/rollback.py``).

The spec engine writes after it accepts (``repro_torch.spec.engine``): a
verify round holds the draft chunk's K/V in a bf16 staging cache and
commits only the accepted prefix, replaying the decode path's per-token
writes.  Rejected drafts therefore never touch a live page: no quantized
page scale is grown by a rejected tail, and rolling back is a host-side
length truncation (:func:`rollback_length`).  Positions past the
truncated length hold stale bytes only on the null page (masked writes)
or nothing at all; the next committed write at a page's offset 0 resets
its running amax scale exactly as plain decode does.

What still needs guarding is sharing: a page mapped by several
block-table rows, or held alive by the prefix cache, must never receive
a speculative commit, since other readers see its bytes.  In the current
admission flow shared pages are always full prompt pages below a slot's
length, so the write span past ``lengths`` never overlaps one; but
:func:`ensure_exclusive_tail` enforces it with copy-on-write, which also
covers flows that would share decode-tail pages (beam / n-best).
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.serve.paged import (PageAllocator, _attn_nodes,
                                     set_block_table_rows)

#: the per-page tensors of a paged node: pools (N,page,KH,D), scales (N,KH)
_PAGE_TENSORS = ("k_pages", "v_pages", "k_scales", "v_scales")


def span_pages(start: int, end: int, page_size: int) -> List[int]:
    """Logical page indices a write span [start, end) touches."""
    if end <= start:
        return []
    return list(range(start // page_size, (end - 1) // page_size + 1))


def copy_page_device(cache, src: int, dst: int):
    """Copy one physical page's K/V contents AND its quantized scales from
    ``src`` to ``dst`` in every layer's pools, in place: the device half
    of a copy-on-write."""
    for node in _attn_nodes(cache):
        for name in _PAGE_TENSORS:
            if name in node:
                node[name][dst] = node[name][src]
    return cache


def ensure_exclusive_tail(cache, alloc: PageAllocator, slot: int,
                          start: int, end: int, page_size: int):
    """Make every page in the speculative write span [start, end) of
    ``slot`` exclusively owned (refcount 1) before a verify round: a
    shared page, mapped by another row or held by the prefix cache, is
    copy-on-written (fresh page, device copy of contents and scales,
    block-table row updated on the host and the device).  Returns the
    cache; a no-op when the tail is already exclusive."""
    touched = False
    for li in span_pages(start, end, page_size):
        if li >= alloc.max_pages_per_slot:
            break
        owned = alloc.owned(slot)
        if li >= len(owned):
            break                          # lazy growth allocates later
        p = int(alloc.table[slot, li])
        if p != 0 and alloc.refs[p] > 1:
            fresh = alloc.cow(slot, li)
            cache = copy_page_device(cache, p, fresh)
            touched = True
    if touched:
        cache = set_block_table_rows(cache, np.asarray([slot]),
                                     alloc.table[[slot]])
    return cache


def rollback_length(alloc: PageAllocator, slot: int, old_len: int,
                    new_len: int, page_size: int) -> List[int]:
    """Roll a slot back from ``old_len`` to ``new_len`` cached tokens
    after a rejected speculative tail.  Under write-after-accept this is
    bookkeeping only: no page frees (the slot keeps its lazily grown
    pages for the next round) and no device work.  Asserts that the
    rejected span's pages are exclusively owned (a shared page there
    would mean :func:`ensure_exclusive_tail` was skipped).  Returns the
    rejected span's physical pages."""
    assert 0 <= new_len <= old_len, (new_len, old_len)
    pages = []
    owned = alloc.owned(slot)
    for li in span_pages(new_len, old_len, page_size):
        if li >= len(owned):
            break
        p = int(owned[li])
        assert alloc.refs[p] == 1, \
            f"rollback into shared page {p} (refs={alloc.refs[p]})"
        pages.append(p)
    return pages

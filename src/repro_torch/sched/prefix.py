"""Hash-chain prefix cache over the paged KV pools.

The port's copy of ``repro/sched/prefix.py`` (pure host code: numpy and
hashlib).  Full KV pages are immutable — writes only ever land past a slot's
length — so a page holding a complete, position-aligned run of prompt
tokens can back ANY later request whose prompt starts with the same
tokens: admission maps the shared physical pages into the new slot's
block-table row (``PageAllocator.assign``) and prefill starts after
them.

The cache is keyed by a rolling blake2b chain over page-sized token
runs: page i's digest hashes (digest of pages [0, i), tokens of page i),
so a node is only reachable through its exact full prefix — lookups walk
the chain until the first miss, which IS the longest cached prefix.
Nodes hold their own allocator reference, keeping pages alive after the
originating slot retires; eviction (oldest-touched leaves first) drops
that reference, and the physical page returns to the free list when the
last slot sharing it releases.

A lookup is capped at ``len(prompt) - 1`` tokens so at least one suffix
token always runs through prefill — the last-token logits are where the
first sampled token comes from.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np


class PrefixCache:
    """Refcount-backed longest-prefix page cache (host-side index)."""

    def __init__(self, allocator, page_size: int):
        self.alloc = allocator
        self.page = page_size
        # digest -> {page, parent digest, live child count, lru tick}
        self.nodes: Dict[bytes, dict] = {}
        self._tick = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted = 0
        self.evicted = 0

    # ------------------------------------------------------------------
    def _chain(self, tokens) -> List[bytes]:
        """Chain digests of each FULL page-sized run of ``tokens``."""
        tokens = np.asarray(tokens, np.int32)
        out: List[bytes] = []
        prev = b"\x00"
        for i in range(len(tokens) // self.page):
            h = hashlib.blake2b(prev, digest_size=16)
            h.update(tokens[i * self.page:(i + 1) * self.page].tobytes())
            out.append(h.digest())
            prev = out[-1]
        return out

    # ------------------------------------------------------------------
    def chain_digests(self, tokens) -> List[bytes]:
        """The digest chain :meth:`lookup` walks for ``tokens`` (capped
        one token short — see module docstring).  Hashing is O(len), so
        the scheduler precomputes this once per queued request and
        passes it back through ``lookup(chain=...)`` on every
        page-availability probe."""
        return self._chain(tokens[:max(len(tokens) - 1, 0)])

    def lookup(self, tokens, *, count: bool = True,
               chain: Optional[List[bytes]] = None) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``: (n_tokens, page ids).
        Touches the hit nodes' LRU ticks; capped one token short of the
        full prompt (see module docstring).  ``count=False`` skips the
        hit/lookup telemetry — the scheduler re-looks-up after an
        eviction pass and must not double-count one admission."""
        self._tick += 1
        if count:
            self.lookups += 1
        if chain is None:
            chain = self.chain_digests(tokens)
        pages: List[int] = []
        for d in chain:
            node = self.nodes.get(d)
            if node is None:
                break
            node["tick"] = self._tick
            pages.append(node["page"])
        if pages and count:
            self.hits += 1
            self.hit_tokens += len(pages) * self.page
        return len(pages) * self.page, pages

    def insert(self, tokens, pages: List[int]) -> None:
        """Register ``tokens``' full pages at physical ids ``pages`` (the
        owning slot's leading block-table entries, in order).  Each newly
        registered page gains a cache-held allocator reference; digests
        already present keep their existing physical page (first writer
        wins — the bytes are identical by construction)."""
        self._tick += 1
        parent: Optional[bytes] = None
        for i, d in enumerate(self._chain(tokens)):
            if i >= len(pages):
                break
            if d not in self.nodes:
                self.alloc.ref(pages[i])
                self.nodes[d] = {"page": pages[i], "parent": parent,
                                 "kids": 0, "tick": self._tick}
                if parent is not None and parent in self.nodes:
                    self.nodes[parent]["kids"] += 1
                self.inserted += 1
            parent = d

    # ------------------------------------------------------------------
    def count_lookup(self, hit_tokens: int) -> None:
        """Record one admission's lookup outcome.  The scheduler probes
        with ``count=False`` (possibly several times across ticks while
        pages are short) and reports the admission's final outcome
        exactly once, so hit-rate telemetry is per admission, not per
        probe."""
        self.lookups += 1
        if hit_tokens:
            self.hits += 1
            self.hit_tokens += hit_tokens

    # ------------------------------------------------------------------
    def evict_pages(self, need: int) -> int:
        """Drop oldest-touched leaf nodes until ``need`` pages have
        returned to the allocator's free list.  Only leaves whose page
        the cache alone references are candidates: evicting a node whose
        page is still mapped by a running slot frees nothing now and
        would destroy the warm index as a side effect (slots map
        contiguous chain prefixes, so a mapped leaf implies its whole
        chain is mapped).  Returns the number of pages freed."""
        freed = 0
        while freed < need and self.nodes:
            leaf = min((d for d, nd in self.nodes.items()
                        if nd["kids"] == 0
                        and self.alloc.refs[nd["page"]] == 1),
                       key=lambda d: self.nodes[d]["tick"], default=None)
            if leaf is None:        # every remaining leaf is still mapped
                break
            nd = self.nodes.pop(leaf)
            if nd["parent"] in self.nodes:
                self.nodes[nd["parent"]]["kids"] -= 1
            self.alloc.unref(nd["page"])    # cache-only ref: frees now
            freed += 1
            self.evicted += 1
        return freed

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": round(self.hits / self.lookups, 4)
            if self.lookups else 0.0,
            "hit_tokens": self.hit_tokens,
            "cached_pages": len(self.nodes),
            "inserted": self.inserted,
            "evicted": self.evicted,
        }

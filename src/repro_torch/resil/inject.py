"""Deterministic, seeded fault injection for the serving stack (the
port's copy of ``repro/resil/inject.py``).

A :class:`FaultInjector` is consulted at host decision points the
engines already pass through — allocator ``_take`` calls, the host side
of every dispatch, the drafter's ``propose_batch`` boundary — and (with
its seeded RNG) decides whether to perturb them:

* **page pressure** — a standing pool reservation (``shrink_pages``
  pages hidden from the free list: forced shrinkage) and spurious
  :class:`~repro_torch.resil.errors.InjectedPageFault` raises with
  probability ``oom_p`` per allocation;
* **dispatch faults** — :class:`~repro_torch.resil.errors.InjectedFault`
  raised with probability ``fault_p`` BEFORE a dispatch launches (the
  host boundary, so engine state is still consistent and recovery is a
  clean preempt-and-requeue);
* **latency spikes** — a host-side ``time.sleep(spike_s)`` with
  probability ``spike_p`` per dispatch;
* **degenerate proposals** — with probability ``draft_p`` per slot a
  spec drafter's proposal is replaced by a constant garbage draft, which
  exact verify/accept must reject without corrupting the stream.

Faults-off is free by construction: a disabled injector (all knobs zero)
is never consulted past one ``enabled`` check and draws nothing from its
RNG, so sync counts and token streams are identical with the harness
absent or disabled.  All randomness comes from ONE ``numpy`` generator
seeded at construction, drawn in the reference's order, so for a fixed
seed and call sequence the fault schedule is the reference's.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from repro_torch.resil.errors import InjectedFault, InjectedPageFault

#: Injected-fault kinds, as counted by ``FaultInjector.counts`` and the
#: ``resil_injected_faults_total{kind=}`` metric family.
FAULT_KINDS = ("page_oom", "dispatch", "latency", "draft")


class FaultInjector:
    """Seeded chaos harness (see module docstring).

    ``spec`` strings (``--chaos``) are comma-separated ``key=value``
    pairs over the constructor knobs, e.g.
    ``"seed=0,oom=0.05,fault=0.1,spike=0.05,spike_s=0.02,draft=0.3,shrink=4"``.
    """

    def __init__(self, seed: int = 0, *, oom_p: float = 0.0,
                 fault_p: float = 0.0, spike_p: float = 0.0,
                 spike_s: float = 0.01, draft_p: float = 0.0,
                 shrink_pages: int = 0):
        self.seed = int(seed)
        self.oom_p = float(oom_p)
        self.fault_p = float(fault_p)
        self.spike_p = float(spike_p)
        self.spike_s = float(spike_s)
        self.draft_p = float(draft_p)
        self.shrink_pages = int(shrink_pages)
        self.rng = np.random.default_rng(self.seed)
        self.counts: Dict[str, int] = {k: 0 for k in FAULT_KINDS}

    # ------------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return (self.oom_p > 0 or self.fault_p > 0 or self.spike_p > 0
                or self.draft_p > 0 or self.shrink_pages > 0)

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> Optional["FaultInjector"]:
        """Parse a ``--chaos`` spec string; None/"" -> no injector."""
        if not spec:
            return None
        keys = {"seed": int, "oom": float, "fault": float, "spike": float,
                "spike_s": float, "draft": float, "shrink": int}
        arg_of = {"oom": "oom_p", "fault": "fault_p", "spike": "spike_p",
                  "draft": "draft_p", "shrink": "shrink_pages"}
        kw = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            if k not in keys:
                raise ValueError(
                    f"unknown chaos knob {k!r} (expected one of "
                    f"{sorted(keys)})")
            kw[arg_of.get(k, k)] = keys[k](v)
        seed = kw.pop("seed", 0)
        return cls(seed, **kw)

    def describe(self) -> dict:
        return {"seed": self.seed, "oom_p": self.oom_p,
                "fault_p": self.fault_p, "spike_p": self.spike_p,
                "spike_s": self.spike_s, "draft_p": self.draft_p,
                "shrink_pages": self.shrink_pages,
                "counts": dict(self.counts)}

    # ------------------------------------------------------------------
    # hook points

    def reserved_pages(self) -> int:
        """Pages hidden from the allocator's free list (forced pool
        shrinkage)."""
        return self.shrink_pages

    def page_fault_check(self, alloc) -> None:
        """Allocator ``_take`` hook: raise a spurious page fault with
        probability ``oom_p`` (rides the caller's evict/retry path)."""
        if self.oom_p > 0 and self.rng.random() < self.oom_p:
            self.counts["page_oom"] += 1
            raise InjectedPageFault(
                f"injected page fault; {alloc.occupancy_summary()}")

    def pre_dispatch(self, kind: str) -> None:
        """Engine dispatch-boundary hook, called on the host immediately
        before a dispatch: may sleep (latency spike) and/or raise an
        :class:`InjectedFault` (transient dispatch failure).  Raising
        happens BEFORE any engine state or device work for the dispatch,
        so recovery sees a consistent engine."""
        if self.spike_p > 0 and self.rng.random() < self.spike_p:
            self.counts["latency"] += 1
            time.sleep(self.spike_s)
        if self.fault_p > 0 and self.rng.random() < self.fault_p:
            self.counts["dispatch"] += 1
            raise InjectedFault(f"injected {kind} fault", kind=kind)

    def mangle_proposals(self, proposals: dict, k_max: int) -> dict:
        """Drafter hook: with probability ``draft_p`` per slot, replace
        its proposal with a degenerate constant draft (token 0 repeated
        ``k_max`` times).  Exact verify/accept must reject these without
        perturbing the emitted stream — greedy output stays identical to
        the fault-free run."""
        if self.draft_p <= 0:
            return proposals
        out = dict(proposals)
        for slot in sorted(out):
            if out[slot] is not None and self.rng.random() < self.draft_p:
                self.counts["draft"] += 1
                out[slot] = np.zeros((k_max,), np.int32)
        return out

    def register_metrics(self, metrics) -> None:
        """fn-backed ``resil_injected_faults_total{kind=}`` bridges over
        ``counts`` (the injector stays the writer)."""
        for k in FAULT_KINDS:
            metrics.counter("resil_injected_faults_total",
                            "faults injected by the chaos harness",
                            fn=lambda k=k: self.counts[k], kind=k)

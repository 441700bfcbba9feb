"""Graceful-degradation ladder: monotone service-quality rungs with
hysteresis, driven by pressure signals already in the engine's
:class:`~repro_torch.obs.metrics.MetricsRegistry` (the port's copy of
``repro/resil/degrade.py``).

Under overload the ladder steps through the tuner's serving arms in a
fixed cheap-to-cheapest order, without waiting for a search, and steps
back up when pressure clears.

Rungs (monotone; each includes the ones below it):

====  ============  ====================================================
rung  name          action for new work
====  ============  ====================================================
0     ``full``      normal service
1     ``spec_off``  speculative decoding gated off (draft_k -> 0):
                    verify rounds stop gambling decode budget on drafts
2     ``chunk``     prefill chunk halved (page-aligned): shorter prefill
                    dispatches interleave more decode under pressure
3     ``kv_int8``   advisory KV-dtype hint: pools are allocated per
                    engine, so the hint is surfaced (gauge + serve log)
                    for the relauncher rather than applied in place
4     ``shed``      policy-aware admission rejection with retry-after:
                    the queue is trimmed to the policy's best-ranked
                    survivors, the rest retire with outcome ``shed``
====  ============  ====================================================

Pressure is a max over three normalized signals read from a registry
snapshot (no device reads — the gauges are fn-backed host state): page
occupancy (gated on a non-empty queue: a full pool with nobody waiting
is healthy), queue depth relative to slot count, and the recent
TTFT-SLO miss fraction (bucket-interpolated from the ``serve_ttft_
seconds`` histogram delta since the previous update).  Hysteresis is
asymmetric — escalate after ``dwell_ticks`` consecutive high-pressure
updates, de-escalate only after ``cool_ticks`` calm ones — so the ladder
reacts fast and relaxes slowly instead of oscillating.

The reference also prices each rung with its cost model
(``priced()``); that model's peaks are a TPU's, so :meth:`priced`
raises until the cost model has an H100 tier (ROADMAP A5).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.obs.metrics import histogram_fraction_le

RUNG_NAMES = ("full", "spec_off", "chunk", "kv_int8", "shed")
SPEC_OFF, CHUNK_SHRINK, KV_INT8, SHED = 1, 2, 3, 4


class DegradationLadder:
    """Monotone degradation ladder with hysteresis (module docstring)."""

    def __init__(self, metrics, *, n_slots: int = 4,
                 slo_ttft: Optional[float] = None, high: float = 0.85,
                 low: float = 0.5, dwell_ticks: int = 2,
                 cool_ticks: int = 25):
        self.metrics = metrics
        self.n_slots = max(int(n_slots), 1)
        self.slo_ttft = slo_ttft
        self.high = float(high)
        self.low = float(low)
        self.dwell_ticks = int(dwell_ticks)
        self.cool_ticks = int(cool_ticks)
        self.rung = 0
        self.transitions = 0
        self.last_pressure = 0.0
        self._hot = 0
        self._cool = 0
        self._last_snap: Optional[dict] = None
        metrics.gauge("resil_degrade_rung",
                      "active degradation rung (0 = full service)",
                      fn=lambda: self.rung)
        metrics.gauge("resil_pressure",
                      "last computed overload pressure (0..1)",
                      fn=lambda: self.last_pressure)
        metrics.counter("resil_degrade_transitions_total",
                        "ladder rung changes (both directions)",
                        fn=lambda: self.transitions)

    # ------------------------------------------------------------------
    # pressure signal

    def pressure(self) -> float:
        snap = self.metrics.snapshot()
        g = snap["gauges"]
        depth = g.get("serve_queue_depth", 0.0)
        p = min(depth / (2.0 * self.n_slots), 1.0)
        if self.slo_ttft is not None:
            h = snap["histograms"].get("serve_ttft_seconds")
            prev = (self._last_snap or {}).get("histograms", {}) \
                .get("serve_ttft_seconds")
            if h is not None:
                d = h if prev is None else {
                    "buckets": [a - b for a, b in zip(h["buckets"],
                                                      prev["buckets"])],
                    "count": h["count"] - prev["count"]}
                if d["count"] > 0:
                    miss = 1.0 - histogram_fraction_le(d, self.slo_ttft)
                    p = max(p, miss)
        if depth > 0:
            total = g.get("serve_pages_total", 0.0)
            free = g.get("serve_pages_free", 0.0)
            if total > 1:
                occ = 1.0 - free / (total - 1)     # excl. null page
                # occupancy only counts as overload past 60% full AND
                # with work actually waiting on pages
                p = max(p, (occ - 0.6) / 0.4)
        self._last_snap = snap
        return max(min(p, 1.0), 0.0)

    # ------------------------------------------------------------------
    # hysteresis stepping

    def update(self) -> int:
        """One scheduler-tick update: escalate one rung after
        ``dwell_ticks`` consecutive pressure >= high, de-escalate one
        rung after ``cool_ticks`` consecutive pressure <= low; the band
        between holds the current rung."""
        p = self.last_pressure = self.pressure()
        if p >= self.high:
            self._cool = 0
            self._hot += 1
            if self.rung < SHED and self._hot >= self.dwell_ticks:
                self.rung += 1
                self.transitions += 1
                self._hot = 0
        elif p <= self.low:
            self._hot = 0
            self._cool += 1
            if self.rung > 0 and self._cool >= self.cool_ticks:
                self.rung -= 1
                self.transitions += 1
                self._cool = 0
        else:
            self._hot = self._cool = 0
        return self.rung

    # ------------------------------------------------------------------
    # rung surface consumed by the engines

    @property
    def name(self) -> str:
        return RUNG_NAMES[self.rung]

    @property
    def spec_off(self) -> bool:
        return self.rung >= SPEC_OFF

    def draft_k_cap(self, k_max: int) -> int:
        return 0 if self.rung >= SPEC_OFF else k_max

    def chunk_for(self, base_chunk: int, page_size: int) -> int:
        """Effective prefill chunk at the current rung: halved but kept
        a positive page-aligned multiple."""
        if self.rung < CHUNK_SHRINK:
            return base_chunk
        half = (base_chunk // 2) // page_size * page_size
        return max(half, page_size)

    @property
    def kv_dtype_hint(self) -> Optional[str]:
        return "int8" if self.rung >= KV_INT8 else None

    @property
    def shed(self) -> bool:
        return self.rung >= SHED

    # ------------------------------------------------------------------
    def priced(self, cfg, tier: str = "h100", **kw) -> List[dict]:
        """The reference's cost-model pricing of every rung's arm."""
        raise NotImplementedError(
            "DegradationLadder.priced needs the cost model's H100 tier "
            "(ROADMAP A5); the reference prices rungs with TPU peaks")

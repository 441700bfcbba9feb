"""Per-dispatch wall-clock profiling (the port of ``repro/obs/profile.py``).

Attributes measured wall-clock to every engine dispatch kind — ``admit``
(batched prefill), ``prefill_chunk`` (scheduler continuation chunk),
``decode_block`` (fused multi-token decode), ``spec_round`` (draft
verify) and ``draft_propose`` — labeled by the live config arm (KV
dtype, weight quant + matmul impl, pow2 chunk/width bucket, draft_k,
mesh shape).

Sync-free by construction: ``record()`` consumes only the two host
``time.perf_counter()`` stamps the engines already take around each
dispatch (before it is enqueued, after the host read that ends it), plus
host numbers the engine already holds.  So ``dur_s`` covers the dispatch
and the block-boundary sync the engine pays anyway, and ``sync_count``
and the greedy token streams are the same with profiling on and off
(``tests/test_torch_profile.py``).

Attainment: the reference lowers the engine's compiled program and reads
XLA's cost analysis.  The port has no compiled program, so each sample's
FLOPs and HBM bytes are the cost model's own counts for that dispatch
(:func:`repro_torch.core.costmodel.dispatch_work`, the terms
``dispatch_estimate`` prices), over the tier's peaks at the config's
rate.  At one chip a sample's attainment is therefore the analytic
roofline time over the measured time: the inverse of its drift ratio.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

from repro_torch.core.costmodel import _peak_flops, dispatch_work

__all__ = ["DispatchProfiler", "ProfileSample", "DISPATCH_KINDS"]

DISPATCH_KINDS = ("admit", "prefill_chunk", "decode_block", "spec_round",
                  "draft_propose")


@dataclasses.dataclass
class ProfileSample:
    """One measured dispatch.  ``dur_s`` covers device dispatch + the
    block-boundary host sync the engine pays anyway."""
    kind: str                  # one of DISPATCH_KINDS
    arm: str                   # config-arm label incl. pow2 bucket
    dur_s: float
    tokens: int = 0            # real (unpadded) tokens processed
    rows: int = 0              # batch rows in the dispatch
    steps: int = 1             # decode steps in the dispatch (decode_block)
    bucket: int = 0            # pow2 pad bucket (plen/chunk/width/block)
    ctx: int = 0               # live context length (host lengths max)


class DispatchProfiler:
    """Per-dispatch wall-clock attribution.  Disabled by default: every
    method is a no-op until constructed with ``enabled=True`` (as
    :class:`repro_torch.obs.trace.Tracer`)."""

    def __init__(self, enabled: bool = False, *, tier=None):
        self.enabled = bool(enabled)
        self.samples: List[ProfileSample] = []
        self.arm = ""                       # bound config-arm label
        self.tier = tier                    # HwTier for attainment math
        self.cfg = None                     # bound config (work counts)
        self.layout = "contiguous"          # bound KV layout

    # ------------------------------------------------------------------
    # binding + hot-path record (host-only, zero syncs)

    def bind(self, cfg, *, model_parallel: int = 1,
             layout: str = "contiguous"):
        """Derive the config-arm label from the live ModelConfig, and keep
        the config and the engine's KV layout for the work counts."""
        if not self.enabled:
            return self
        self.arm = (f"kv={cfg.kv_cache_dtype},"
                    f"q={cfg.quant}:{cfg.quant_matmul_impl},"
                    f"k={cfg.spec_draft_k},mp={int(model_parallel)}")
        self.cfg = cfg
        self.layout = layout
        return self

    def record(self, kind: str, t0: float, t1: float, *, tokens: int = 0,
               rows: int = 0, steps: int = 1, bucket: int = 0,
               ctx: int = 0):
        """Store one sample from timestamps the engine already took; every
        other argument is a host number the engine already holds."""
        if not self.enabled:
            return
        self.samples.append(ProfileSample(
            kind=kind, arm=f"{self.arm},b={int(bucket)}", dur_s=t1 - t0,
            tokens=int(tokens), rows=int(rows), steps=int(steps),
            bucket=int(bucket), ctx=int(ctx)))

    # ------------------------------------------------------------------
    # aggregation

    def summary(self, tier=None) -> Dict[str, dict]:
        """Per-(kind × arm) aggregates: sample count, total measured
        seconds, tokens, the cost model's FLOPs / HBM bytes and roofline
        attainment against the tier's peaks (``draft_propose`` has no work
        of its own, so no attainment)."""
        tier = tier or self.tier
        agg: Dict[tuple, dict] = {}
        for s in self.samples:
            a = agg.setdefault((s.kind, s.arm), {
                "kind": s.kind, "arm": s.arm, "count": 0, "seconds": 0.0,
                "tokens": 0, "rows": 0, "flops": 0.0, "hbm_bytes": 0.0})
            a["count"] += 1
            a["seconds"] += s.dur_s
            a["tokens"] += s.tokens
            a["rows"] += s.rows
            work = None if self.cfg is None else dispatch_work(
                self.cfg, kind=s.kind, tokens=s.tokens, rows=s.rows,
                steps=s.steps, bucket=s.bucket, ctx=s.ctx,
                layout=self.layout)
            if work is not None:
                a["flops"] += work[0]
                a["hbm_bytes"] += work[1]
        out = {}
        for (kind, arm), a in agg.items():
            if a["seconds"] > 0 and (a["flops"] or a["hbm_bytes"]):
                a["achieved_flops_per_s"] = a["flops"] / a["seconds"]
                a["achieved_hbm_bytes_per_s"] = a["hbm_bytes"] / a["seconds"]
                if tier is not None:
                    chips = tier.chips
                    peak_f = chips * _peak_flops(self.cfg, tier)
                    peak_b = chips * tier.hbm_bw
                    a["attainment"] = max(
                        a["achieved_flops_per_s"] / peak_f,
                        a["achieved_hbm_bytes_per_s"] / peak_b)
            out[f"{kind}|{arm}"] = a
        return out

    # ------------------------------------------------------------------
    # export

    def export_gauges(self, registry, tier=None):
        """Fold the per-(kind × arm) aggregates into a MetricsRegistry.
        Called at artifact-write time (never on the hot path).  No-op when
        profiling is disabled, so the default metric schema is untouched."""
        if not self.enabled:
            return
        g_sec = registry.gauge(
            "profile_dispatch_seconds_total",
            "measured dispatch+sync wall-clock by kind and config arm")
        g_cnt = registry.gauge(
            "profile_dispatch_count", "profiled dispatches by kind and arm")
        g_att = registry.gauge(
            "profile_roofline_attainment",
            "analytic work rate over HwTier peak (max of FLOP/s and HBM "
            "B/s fractions)")
        for a in self.summary(tier).values():
            lbl = dict(kind=a["kind"], arm=a["arm"])
            g_sec.set(a["seconds"], **lbl)
            g_cnt.set(a["count"], **lbl)
            if "attainment" in a:
                g_att.set(a["attainment"], **lbl)

    def to_json(self) -> dict:
        return {"arm": self.arm,
                "samples": [dataclasses.asdict(s) for s in self.samples]}

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, default=str)

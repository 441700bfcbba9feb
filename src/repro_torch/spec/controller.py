"""Adaptive draft-length controller (the port of ``repro/spec/controller.py``).

Each slot keeps an exponential moving average of its measured draft
acceptance rate, and before every verify round the controller picks the
draft length ``k`` that maximizes the cost model's predicted speculative
speedup at that rate (``core.costmodel.spec_speedup``).  A slot whose
drafts stop landing walks itself down to ``k = 0`` (speculation off: a
verify round costs draft work plus a wider verify, so at low acceptance
plain decode wins) and back up when the workload turns repetitive again.
With quantized target weights the n-gram arm's draft cost is rescaled by
the cost model's quantized-decode ratio (``quant_decode_scale``) on the
engine's tier and KV layout.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.costmodel import (SPEC_DRAFT_COST, TIERS,
                                        quant_decode_scale, spec_speedup)


class AdaptiveDraftController:
    """Per-slot EMA acceptance tracking + modeled-speedup k selection."""

    def __init__(self, n_slots: int, k_max: int, *, arm: str = "ngram",
                 adaptive: bool = True, a0: float = 0.5, beta: float = 0.3,
                 cfg=None, tier="h100-1", layout: str = "contiguous"):
        self.n_slots = n_slots
        self.k_max = k_max
        self.adaptive = adaptive
        self.a0 = a0                      # optimistic prior: explore first
        self.beta = beta
        self.draft_cost = SPEC_DRAFT_COST.get(arm, 0.05)
        # Draft costs are fractions of a TARGET decode step.  When the
        # target streams quantized weights, its step shrinks, but a
        # host-side n-gram lookup's absolute cost does not — rescale so
        # the k argmax still trades real quantities.  The draft-LM arm is
        # quantized alongside the target (launch/serve.py), so its
        # relative cost is unchanged.
        if cfg is not None and arm == "ngram":
            tier = TIERS[tier] if isinstance(tier, str) else tier
            self.draft_cost /= max(quant_decode_scale(cfg, tier,
                                                      layout=layout), 1e-3)
        self.ema = np.full((n_slots,), a0, np.float64)
        self.rounds = np.zeros((n_slots,), np.int64)

    def reset(self, slot: int) -> None:
        self.ema[slot] = self.a0
        self.rounds[slot] = 0

    def update(self, slot: int, proposed: int, accepted: int) -> None:
        """Fold one verify round's outcome into the slot's EMA."""
        if proposed <= 0:
            return
        rate = min(accepted / proposed, 1.0)
        self.ema[slot] = (1 - self.beta) * self.ema[slot] + self.beta * rate
        self.rounds[slot] += 1

    def k_for(self, slot: int) -> int:
        """Draft length for the next round: argmax_k of the modeled
        speedup at the slot's current acceptance estimate (0 disables
        speculation for the slot)."""
        if not self.adaptive:
            return self.k_max
        a = float(self.ema[slot])
        best_k, best_s = 0, 1.0
        for k in range(1, self.k_max + 1):
            s = spec_speedup(a, k, draft_cost=self.draft_cost)
            if s > best_s:
                best_k, best_s = k, s
        return best_k

    def stats(self) -> dict:
        return {"ema_acceptance": [round(float(a), 3) for a in self.ema],
                "k_next": [self.k_for(s) for s in range(self.n_slots)]}

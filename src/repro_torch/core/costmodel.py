"""Speculative-decoding terms of the cost model.

A copy of the four spec entries of ``repro/core/costmodel.py``: the cost
of proposing one draft token and of widening the verify by one query, in
units of a target decode step, and the expected haul and modeled speedup
of a k-token round.  The adaptive draft controller (``repro_torch.spec``)
picks each slot's k with them.  None of the module's hardware tiers is
copied: the H100 tier of the cost model, and with it the pricing of
quantized weights, comes with ROADMAP A5.
"""
from __future__ import annotations

# Cost of proposing ONE draft token, as a fraction of a target decode
# step: ngram lookup is host-side (~free); a small draft LM costs a
# shrunken forward pass.
SPEC_DRAFT_COST = {"none": 0.0, "ngram": 0.02, "draft": 0.15}
# Marginal cost of verifying one extra query position in the fused
# multi-query verify dispatch: decode is bound by memory traffic (weights
# and KV reads amortize over the K queries), so the verify step is nearly
# flat in K.
SPEC_VERIFY_OVERHEAD = 0.03


def spec_tokens_per_step(accept_rate: float, k: int) -> float:
    """Expected tokens emitted per verify round with ``k`` draft tokens
    at per-token acceptance ``accept_rate`` (independence assumption):
    1 + a + a^2 + ... + a^k = (1 - a^(k+1)) / (1 - a).  The "+1" is the
    correction/bonus token the target model always contributes."""
    a = min(max(accept_rate, 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def spec_speedup(accept_rate: float, k: int, *,
                 draft_cost: float = 0.05,
                 verify_overhead: float = SPEC_VERIFY_OVERHEAD) -> float:
    """Modeled decode speedup of k-token speculation over plain decode:
    expected tokens per round divided by the round's cost in decode-step
    units (1 verify + k draft proposals + the multi-query widening).
    ``k = 0`` is exactly 1.0 (plain decode)."""
    if k <= 0:
        return 1.0
    e = spec_tokens_per_step(accept_rate, k)
    return e / (1.0 + verify_overhead * k + draft_cost * k)

"""Speculative-decoding engine layered on the scheduler (the port of
``repro/spec/engine.py``).

``SpecEngine`` keeps every scheduler behaviour (policy-ordered admission,
prefix caching, chunked prefill, lazy growth, preemption) and replaces the
plain fused decode dispatch with DRAFT -> VERIFY -> COMMIT rounds:

1. **Draft** — a proposer (``repro_torch.spec.drafter``: model-free
   n-gram prompt lookup, or a small draft LM sharing the vocabulary)
   suggests up to ``k`` next tokens per active slot; the adaptive
   controller (``repro_torch.spec.controller``) picks each slot's ``k``
   from its measured acceptance EMA through the cost model's speedup.
2. **Verify** — one forward scores every slot's chunk (last accepted
   token + drafts) with multi-query paged attention (``LM.verify_paged``
   -> the prefix-extend kernel at W = k + 1): K + 1 query positions
   against the paged prefix plus the chunk itself, the chunk's K/V held
   in a bf16 staging cache; the pages are NOT written.
3. **Accept** — exact acceptance on the device (:func:`spec_accept`):
   greedy rows accept a draft iff it equals the target argmax; sampled
   rows accept with probability p(d) against the deterministic proposal
   and otherwise draw from the renormalized residual, so the emitted
   stream is distributed exactly as plain sampling and greedy output is
   token-identical to plain decode.
4. **Commit / roll back** — only the accepted prefix is written into the
   pages, replaying the decode path's per-token writes
   (``serve.paged.commit_spec_cache``); rejection is a host-side length
   truncation (``repro_torch.spec.rollback``).  Shared or prefix-cache
   pages are copy-on-written before a round writes.

Every verify round costs one host sync and emits 1..k+1 tokens per slot.
A round where no slot has drafts, or where an EDF deadline is too close
to gamble decode budget on rejected drafts (``spec_slack_s``), falls back
to the base fused ``decode_block`` dispatch, and so does every round
while the degradation ladder sits at or past its ``spec_off`` rung.  A
chaos injector may fail a round at its boundary (before any draft state)
and mangle proposals into garbage drafts, which exact acceptance
rejects.  The reference's sampled rows draw from JAX's threefry
stream, which torch cannot reproduce, so sampled rows here draw from the
engine's ``torch.Generator`` and agree with the reference as a
distribution.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.trace import PID_ENGINE
from repro_torch.sched.policy import EDF
from repro_torch.sched.scheduler import SchedEngine
from repro_torch.serve.engine import (_gumbel_argmax, _pow2_bucket,
                                      _scale_snapshot)
from repro_torch.serve.paged import commit_spec_cache
from repro_torch.sharding.tp import shard_model
from repro_torch.spec.controller import AdaptiveDraftController
from repro_torch.spec.drafter import DraftLMDrafter, NgramDrafter
from repro_torch.spec.rollback import ensure_exclusive_tail


def spec_accept(logits, fed, widths, active, temps, remaining, lengths,
                eos: int, max_len: int,
                gen: Optional[torch.Generator] = None):
    """Exact acceptance for one speculative verify round (device math).

    logits: (S, W, V) target logits — position ``j`` predicts the token
    AFTER ``fed[:, j]``; ``fed[:, 0]`` is the last accepted token and
    ``fed[:, 1:]`` the (deterministic) draft proposals, real up to
    ``widths[s] - 1`` drafts.  Greedy rows (temps <= 0) accept draft
    ``d_j`` iff it equals ``argmax(logits[:, j-1])``; sampled rows run
    exact rejection sampling against the deterministic proposal — accept
    with probability ``p_{j-1}(d_j)``, else emit a sample of the
    renormalized residual (p with ``d_j`` zeroed) — so the emitted stream
    is distributed exactly as target-model sampling (Leviathan et al.,
    2023, for a point-mass draft).  The round's last token (correction or
    bonus) always comes from the target model.  ``gen`` draws the sampled
    rows' noise; ``None`` means every row is greedy.

    Emission is then capped exactly as the decode loop caps it: at the
    first EOS, at the end of the remaining budget, and at ``max_len - 1``.
    Returns ``(y, n_emit, n_match)``: emitted tokens (S, W) (garbage past
    ``n_emit``), tokens emitted per slot (0 for inactive slots), and the
    accepted-draft count before the caps (the controller's signal)."""
    s_n, w, v = logits.shape
    dev = logits.device
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)        # (S,W)
    d = fed[:, 1:].to(torch.int32)                               # (S,W-1)
    real = torch.arange(1, w, device=dev)[None, :] < widths[:, None]
    acc = d == greedy[:, :-1]
    y = greedy
    if gen is not None:
        sampled = temps > 0
        temps_c = torch.clamp(temps, min=1e-6)[:, None, None]
        probs = torch.softmax(logits / temps_c, dim=-1)          # (S,W,V)
        p_d = torch.gather(probs[:, :-1], -1, d[..., None].long())[..., 0]
        u = torch.rand(d.shape, generator=gen, device=dev)
        acc = torch.where(sampled[:, None], u < p_d, acc)
        res = probs[:, :-1].scatter(-1, d[..., None].long(), 0.0)
        res = res / torch.clamp(res.sum(-1, keepdim=True), min=1e-30)
        res_tok = _gumbel_argmax(torch.log(torch.clamp(res, min=1e-30)), gen)
        fresh_tok = _gumbel_argmax(logits / temps_c, gen)        # (S,W)
        cor = torch.where(real, res_tok, fresh_tok[:, :-1])
        samp = torch.cat([torch.where(acc & real, d, cor),
                          fresh_tok[:, -1:]], dim=1)
        y = torch.where(sampled[:, None], samp, greedy)
    acc = acc & real
    n_match = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    # caps, as the reference's scan over the W columns: column j is
    # emitted while j <= n_match and no earlier column stopped; a column
    # stops the slot on EOS, an exhausted budget or max_len - 1
    j = torch.arange(w, device=dev)[None, :]
    stop = ((y == eos) | (remaining[:, None] - (j + 1) <= 0)
            | (lengths[:, None] + j + 1 >= max_len - 1))
    first_stop = torch.where(stop.any(dim=1),
                             torch.argmax(stop.to(torch.int32), dim=1),
                             torch.full_like(n_match, w - 1))
    n_emit = torch.minimum(n_match + 1, first_stop + 1) * active
    return (y.to(torch.int32), n_emit.to(torch.int32),
            n_match.to(torch.int32))


@dataclasses.dataclass
class SpecStats:
    verify_steps: int = 0           # draft->verify->commit rounds
    slot_steps: int = 0             # (active slot, round) pairs verified
    drafts_proposed: int = 0
    drafts_accepted: int = 0        # capped at what was actually emitted
    spec_tokens: int = 0            # tokens emitted by verify rounds
    fallback_steps: int = 0         # plain decode blocks (no drafts)
    skipped_urgent: int = 0         # rounds gated off by EDF urgency
    cow_pages: int = 0              # shared tail pages copy-on-written


class SpecEngine(SchedEngine):
    """Scheduler + speculative decoding (see the module docstring).

    ``spec``: "ngram" (default) | "draft" (``--spec none`` serves through
    the plain ``SchedEngine``).  ``draft_lm`` / ``draft_params`` supply the
    draft model of the "draft" arm (see
    ``repro_torch.spec.drafter.draft_config_of``; the target model itself
    gives self-speculation, an oracle).  ``spec_slack_s`` turns
    speculation off for a tick whenever a queued request's EDF deadline is
    closer than the slack: rejected drafts would waste decode budget the
    urgent request needs.  ``tier`` is the cost model's hardware tier, for
    the policy and the controller's quantized n-gram rescale."""

    def __init__(self, lm, params, *, spec: str = "ngram", draft_k: int = 4,
                 draft_lm=None, draft_params=None, adaptive: bool = True,
                 spec_slack_s: Optional[float] = None, tier="h100-1", **kw):
        if spec not in ("ngram", "draft"):
            raise ValueError(f"unknown spec arm {spec!r}")
        super().__init__(lm, params, tier=tier, **kw)
        self.clock_decides = self.clock_decides or spec_slack_s is not None
        self.spec_arm = spec
        self.k_max = int(draft_k)
        self.w_max = self.k_max + 1
        # a verify round writes up to w_max accepted tokens past a length
        self.decode_horizon = max(self.decode_block, self.w_max)
        if spec == "ngram":
            self.drafter = NgramDrafter(k_max=self.k_max)
        else:
            if draft_lm is None or draft_params is None:
                raise ValueError("spec='draft' needs draft_lm/draft_params")
            if self.mesh is not None:
                # the draft LM serves on the same mesh, its weights split
                # as the target's (a replicated draft would repeat the
                # same work on every rank)
                draft_lm, draft_params = shard_model(draft_lm, draft_params,
                                                     self.mesh)
            self.drafter = DraftLMDrafter(
                draft_lm, draft_params, n_slots=self.n_slots,
                max_len=self.max_len + 2 * self.w_max, k_max=self.k_max)
        # the verify chunk's bf16 K/V staging cache, rewritten every round
        self.stage = self.lm.init_cache(self.n_slots, self.w_max,
                                        kv_dtype="bfloat16")
        self.controller = AdaptiveDraftController(
            self.n_slots, k_max=self.k_max, arm=spec, adaptive=adaptive,
            cfg=lm.cfg, tier=tier, layout=self.kv_layout)
        self.spec_slack_s = spec_slack_s
        self.spec_stats = SpecStats()
        # fn-backed registry bridges (SpecStats stays the writer)
        m = self.metrics
        for f in dataclasses.fields(SpecStats):
            m.counter(f"spec_{f.name}_total", f.name.replace("_", " "),
                      fn=lambda f=f.name: getattr(self.spec_stats, f))
        m.gauge("spec_arm_info", "1, labelled with the speculation arm",
                fn=lambda: 1.0, arm=self.spec_arm)

    # ------------------------------------------------------------------
    # device program

    @torch.no_grad()
    def _verify_impl(self, fed, lengths, widths, active, remaining, temps,
                     gen, max_pages: int):
        """One verify round: score every slot's chunk, accept on the
        device, then commit ONLY the accepted prefix (in place), so the
        page pools and their scales move exactly as ``n_emit`` decode
        steps would have moved them.  ``max_pages`` narrows the prefix-
        extend kernel's block table to the deepest prefix.  The last item
        counts the quantized page-scale entries of real pages the commit
        changed (as ``_decode_impl`` does)."""
        logits, stage = self.lm.verify_paged(self.params, fed, self.cache,
                                             self.stage, lengths, widths,
                                             max_pages=max_pages)
        y, n_emit, n_match = spec_accept(logits, fed, widths, active, temps,
                                         remaining, lengths, self.eos,
                                         self.max_len, gen)
        scales0 = _scale_snapshot(self.cache)
        commit_spec_cache(self.cache, stage, lengths, n_emit)
        new_lengths = lengths + n_emit
        new_remaining = remaining - n_emit
        idx = torch.clamp(n_emit - 1, min=0).long()
        last = torch.gather(y, 1, idx[:, None])[:, 0]
        last = torch.where(n_emit > 0, last, fed[:, 0].to(torch.int32))
        done = (last == self.eos) | (new_remaining <= 0) \
            | (new_lengths >= self.max_len - 1)
        new_active = active & ~done
        nrq = torch.zeros((1,), dtype=torch.int32, device=fed.device)
        if scales0 is not None:
            nrq[0] = self._global_count(
                (_scale_snapshot(self.cache) != scales0).sum())
        return y, n_emit, n_match, last, new_lengths, new_active, \
            new_remaining, nrq

    # ------------------------------------------------------------------
    # host loop

    def _spec_allowed(self) -> bool:
        """EDF urgency gate: don't gamble the decode budget on drafts
        while a queued request's deadline is within ``spec_slack_s`` of
        the tick's latest clock reading."""
        if self.spec_slack_s is None or not isinstance(self.policy, EDF):
            return True
        return all(self.policy.deadline(r) - self._now >= self.spec_slack_s
                   for r in self.queue)

    def _dispatch_decode(self, emitted: list) -> None:
        if self.ladder is not None and self.ladder.spec_off:
            # degradation rung >= spec_off: stop gambling decode budget
            # on drafts; plain fused decode gives the same greedy stream
            self.spec_stats.fallback_steps += 1
            return super()._dispatch_decode(emitted)
        if not self._spec_allowed():
            self.spec_stats.skipped_urgent += 1
            self.spec_stats.fallback_steps += 1
            return super()._dispatch_decode(emitted)
        return self._spec_round(emitted)

    def _spec_round(self, emitted: list) -> None:
        # chaos hook BEFORE any draft / verify state is built: a raise
        # here preempts cleanly (the decode hook's contract)
        self._maybe_inject("spec_round")
        reqs = list(self.active.items())
        # --- draft ----------------------------------------------------
        batch = []
        for slot, req in reqs:
            room = min(int(self.remaining[slot]) - 1,
                       self.max_len - 2 - int(self.lengths[slot]))
            k = min(self.controller.k_for(slot), max(room, 0))
            hist = np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(req.out_tokens, np.int32)])
            batch.append((slot, req.rid, hist, k))
        t_round0 = t0 = time.perf_counter()   # spec_round span covers
        proposals = self.drafter.propose_batch(batch, self.k_max)
        if self.injector is not None and self.injector.enabled:
            # degenerate-proposal injection: exact verify / accept must
            # reject garbage drafts without perturbing the greedy stream
            proposals = self.injector.mangle_proposals(proposals,
                                                       self.k_max)
        # drafting is decode-phase work (the draft-LM arm is a real
        # dispatch + sync): charge it to decode
        t_draft1 = time.perf_counter()
        self.t_decode_s += t_draft1 - t0
        fed = np.zeros((self.n_slots, self.w_max), np.int32)
        widths = np.zeros((self.n_slots,), np.int32)
        ndraft = np.zeros((self.n_slots,), np.int32)
        active_mask = np.zeros((self.n_slots,), bool)
        for slot, _req in reqs:
            drafts = proposals.get(slot)
            nd = 0 if drafts is None else len(drafts)
            fed[slot, 0] = self.last_tok[slot]
            if nd:
                fed[slot, 1:1 + nd] = drafts
            widths[slot] = 1 + nd
            ndraft[slot] = nd
            active_mask[slot] = True
        prof = self.profiler
        if prof.enabled:
            prof.record("draft_propose", t0, t_draft1,
                        tokens=int(ndraft.sum()), rows=len(reqs),
                        bucket=self.k_max, ctx=int(self.lengths.max()))
        if ndraft.sum() == 0:            # nothing to verify: plain decode
            self.spec_stats.fallback_steps += 1
            return super()._dispatch_decode(emitted)
        # --- shared-tail guard (copy-on-write; normally a no-op) ------
        for slot, _req in reqs:
            start = int(self.lengths[slot])
            row_before = self.alloc.table[slot].copy()
            self.cache = ensure_exclusive_tail(
                self.cache, self.alloc, slot, start,
                min(start + int(widths[slot]), self.max_len),
                self.page_size)
            self.spec_stats.cow_pages += int(
                np.sum(row_before != self.alloc.table[slot]))
        # --- verify + commit (one dispatch, one sync) -----------------
        # block table narrowed to the deepest prefix (pow2-bucketed), not
        # the slot horizon: the chunk's K/V is staged, never paged, so
        # only positions < lengths[s] are read from the pools
        mp = min(_pow2_bucket(-(-int(self.lengths.max()) // self.page_size),
                              lo=1), self.alloc.max_pages_per_slot)
        dev = self.device
        state = torch.as_tensor(np.stack([self.lengths, widths,
                                          active_mask.astype(np.int32),
                                          self.remaining]), device=dev)
        t0 = time.perf_counter()
        out = self._verify_impl(torch.as_tensor(fed, device=dev).long(),
                                state[0], state[1], state[2].bool(),
                                state[3],
                                torch.as_tensor(self.temps, device=dev),
                                self._gen_if(self.temps), mp)
        # ONE device->host copy for the round
        host = torch.cat([t.reshape(-1).to(torch.int32)
                          for t in out]).cpu().numpy()
        self.sync_count += 1
        t1 = time.perf_counter()
        now = self._now = self._clock()
        self.t_decode_s += t1 - t0
        s_n, w = self.n_slots, self.w_max
        y = host[:s_n * w].reshape(s_n, w)
        n_emit, n_match, last, lengths, active, remaining = (
            host[s_n * w + i * s_n:s_n * w + (i + 1) * s_n].copy()
            for i in range(6))
        nrq = int(host[-1])
        if prof.enabled:
            prof.record("spec_round", t0, t1, tokens=int(n_emit.sum()),
                        rows=len(reqs), bucket=self.w_max,
                        ctx=int(self.lengths.max()))
        self.spec_stats.verify_steps += 1
        self._c_requant.inc(nrq)
        self._c_tokens.inc(int(n_emit.sum()))
        self.lengths, self.last_tok, self.remaining = (lengths, last,
                                                       remaining)
        tr = self.tracer
        if tr.enabled:
            tr.complete("spec_round", 0, t_round0, t1, pid=PID_ENGINE,
                        args={"rows": len(reqs),
                              "proposed": int(ndraft.sum()),
                              "tokens": int(n_emit.sum())})
        for slot, req in reqs:
            ne = int(n_emit[slot])
            for t in y[slot, :ne]:
                req.out_tokens.append(int(t))
                emitted.append((req.rid, int(t)))
            req.pos += ne
            self.controller.update(slot, int(ndraft[slot]),
                                   int(n_match[slot]))
            self.spec_stats.slot_steps += 1
            self.spec_stats.drafts_proposed += int(ndraft[slot])
            acc = min(int(n_match[slot]), max(ne - 1, 0))
            self.spec_stats.drafts_accepted += acc
            self.spec_stats.spec_tokens += ne
            if tr.enabled:
                tr.complete("spec_round", req.rid, t_round0, t1,
                            args={"proposed": int(ndraft[slot]),
                                  "accepted": acc, "tokens": ne})
        for slot, _req in reqs:
            if not active[slot]:
                self._retire(slot, now)

    def _retire(self, slot: int, now: float):
        self.controller.reset(slot)
        super()._retire(slot, now)

    def _cancel_slot(self, slot: int, now: float, outcome: str):
        self.controller.reset(slot)
        super()._cancel_slot(slot, now, outcome)

    # ------------------------------------------------------------------
    def telemetry(self, since=None) -> dict:
        out = super().telemetry(since)
        snap = (self.metrics.snapshot() if since is None
                else self.metrics.delta(since))
        c = snap["counters"]
        st = {f.name: int(c.get(f"spec_{f.name}_total", 0))
              for f in dataclasses.fields(SpecStats)}
        st["arm"] = self.spec_arm
        st["k_max"] = self.k_max
        st["acceptance_rate"] = (
            round(st["drafts_accepted"] / st["drafts_proposed"], 4)
            if st["drafts_proposed"] else None)
        # per SLOT-step means: the decode loop emits exactly 1 token per
        # active slot per step, so tokens_per_step > 1 is the decode-step
        # reduction speculation bought
        st["accepted_per_step"] = (
            round(st["drafts_accepted"] / st["slot_steps"], 3)
            if st["slot_steps"] else None)
        st["tokens_per_step"] = (
            round(st["spec_tokens"] / st["slot_steps"], 3)
            if st["slot_steps"] else None)
        st["controller"] = self.controller.stats()
        out["spec"] = st
        return out

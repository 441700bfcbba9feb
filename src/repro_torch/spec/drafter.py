"""Draft proposers for speculative decoding (the port of
``repro/spec/drafter.py``).

Two arms, one host-facing interface (``propose_batch``):

* ``NgramDrafter`` — model-free prompt-lookup decoding: propose the
  continuation of the most recent earlier occurrence of the slot's
  trailing n-gram in its own history (prompt + generated so far).  No
  extra products and no second checkpoint; acceptance is high exactly on
  repetitive text (retrieval prompts, code, greedy loops).
* ``DraftLMDrafter`` — a small draft LM sharing the target's vocabulary.
  It drafts greedily (a deterministic proposal, which the verifier's
  exact rejection rule assumes) over its own contiguous bf16 cache,
  teacher-forced on the confirmed stream only: every round it first
  catches up on the tokens the target accepted since the last round,
  one decode step a token, then runs ``k`` free steps, for every active
  slot at once with one host read at the end.  Its per-slot position
  advances over confirmed tokens only, so the draft cache rolls back for
  free: stale draft entries lie past the position and are overwritten
  when the real tokens are fed.

Proposals are host-side numpy so the engine can size the verify chunk
before dispatch; both drafters are deterministic given their inputs.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.serve.engine import _pow2_bucket


class NgramDrafter:
    """Prompt-lookup drafting: match the trailing ``n``-gram (longest of
    ``n_max .. n_min`` that matches) against the history and propose the
    ``k`` tokens that followed its most recent earlier occurrence."""

    name = "ngram"

    def __init__(self, k_max: int = 4, n_max: int = 3, n_min: int = 1):
        self.k_max = k_max
        self.n_max = n_max
        self.n_min = n_min

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        """history: (L,) int32 — prompt + tokens emitted so far.  Returns
        up to ``k`` draft tokens (possibly none: no n-gram match)."""
        h = np.asarray(history, np.int32)
        k = min(k, self.k_max)
        if k <= 0 or len(h) < self.n_min + 1:
            return np.zeros((0,), np.int32)
        best = np.zeros((0,), np.int32)
        for n in range(min(self.n_max, len(h) - 1), self.n_min - 1, -1):
            tail = h[-n:]
            # start positions of earlier occurrences (the trailing
            # occurrence itself is excluded: i + n < len)
            wins = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
            hits = np.flatnonzero((wins == tail).all(axis=1))
            # most recent match first, but prefer one with a FULL k-token
            # continuation (the most recent match is often the trailing
            # repetition itself, cut short by the end of the history)
            for i in hits[::-1]:
                cont = h[i + n:i + n + k]
                if len(cont) == k:
                    return cont.astype(np.int32)
                if len(cont) > len(best):
                    best = cont.astype(np.int32)
            if len(best):
                return best
        return best

    def propose_batch(self, batch: List[tuple], k_pad: int
                      ) -> Dict[int, np.ndarray]:
        """batch: [(slot, rid, history, k), ...] -> {slot: drafts}."""
        return {slot: self.propose(hist, min(k, k_pad))
                for slot, _rid, hist, k in batch}


class DraftLMDrafter:
    """Small-LM drafting (see the module docstring).  ``lm`` / ``params``
    is any ``repro_torch.models.model.LM`` sharing the target's vocabulary:
    the shrunk config from :func:`draft_config_of`, or the target itself
    (self-speculation: acceptance 1.0, an oracle of the plumbing).  Its
    cache is a contiguous bf16 one (``LM.init_cache``), decoded by the
    plain contiguous attention."""

    name = "draft"

    def __init__(self, lm, params, *, n_slots: int, max_len: int,
                 k_max: int = 4):
        self.lm = lm
        self.params = lm.prepare(params) if "head_f32" not in params \
            else params
        self.n_slots = n_slots
        self.max_len = max_len
        self.k_max = k_max
        self.cache = lm.init_cache(n_slots, max_len, kv_dtype="bfloat16")
        self.pos = np.zeros((n_slots,), np.int32)   # confirmed tokens cached
        self.rid = np.full((n_slots,), -1, np.int64)
        self.syncs = 0
        self.steps = 0                              # decode steps run

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _drive(self, feed, feed_len, pos0, steps: int) -> torch.Tensor:
        """``steps`` decode steps of every slot, with no host read: step i
        feeds ``feed[:, i]`` while ``i < feed_len[s]`` (teacher-forced
        catch-up on confirmed tokens), then the model's own greedy pick
        (free-running draft).  Returns the (steps, S) greedy outputs; slot
        s's drafts are rows ``feed_len[s]-1 ..``."""
        p_n = feed.shape[1]
        pos = pos0
        cur = torch.zeros_like(pos0)
        outs = torch.empty((steps, feed.shape[0]), dtype=torch.int32,
                           device=feed.device)
        for i in range(steps):
            tok = torch.where(i < feed_len, feed[:, min(i, p_n - 1)], cur)
            logits, self.cache = self.lm.decode_step(self.params, tok,
                                                     self.cache, pos)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            outs[i] = cur
            pos = pos + 1
        self.steps += steps
        return outs

    def propose_batch(self, batch: List[tuple], k_pad: int
                      ) -> Dict[int, np.ndarray]:
        """batch: [(slot, rid, history, k), ...] -> {slot: drafts}.  One
        pass over the steps for the whole batch and one host read."""
        work: List[Tuple[int, int, np.ndarray]] = []
        for slot, rid, hist, k in batch:
            if self.rid[slot] != rid:            # new / readmitted request
                self.rid[slot] = rid
                self.pos[slot] = 0
            pending = np.asarray(hist[self.pos[slot]:], np.int32)
            work.append((slot, min(k, k_pad), pending))
        if not any(k > 0 for _, k, _ in work):
            return {slot: np.zeros((0,), np.int32) for slot, _, _ in work}
        # every slot with pending tokens is fed (and its pos advanced)
        # even when its k is 0 this round, so a k = 0 slot's backlog does
        # not grow round after round.  The step count is the reference's
        # (its scan length, pow2-bucketed so that it recompiles rarely)
        p_n = max(max((len(p) for _, _, p in work), default=1), 1)
        p_n = _pow2_bucket(p_n, lo=4)
        feed = np.zeros((self.n_slots, p_n), np.int32)
        feed_len = np.zeros((self.n_slots,), np.int32)
        for slot, _k, pending in work:
            if len(pending) + self.pos[slot] + k_pad >= self.max_len:
                continue                         # no room: propose nothing
            feed[slot, :len(pending)] = pending
            feed_len[slot] = len(pending)
        dev = self.lm.device
        outs = self._drive(torch.as_tensor(feed, device=dev).long(),
                           torch.as_tensor(feed_len, device=dev),
                           torch.as_tensor(self.pos, device=dev).long(),
                           int(p_n + k_pad - 1))
        outs = outs.cpu().numpy()                # <- sync (1 per round)
        self.syncs += 1
        drafts: Dict[int, np.ndarray] = {}
        for slot, k, pending in work:
            fl = int(feed_len[slot])
            if fl > 0:
                self.pos[slot] += fl             # confirmed only: draft
            if fl == 0 or k <= 0:                # writes roll back for free
                drafts[slot] = np.zeros((0,), np.int32)
                continue
            drafts[slot] = outs[fl - 1:fl - 1 + k, slot].astype(np.int32)
        return drafts


def draft_config_of(cfg, *, shrink: int = 4):
    """A tiny draft-model config sharing ``cfg``'s vocabulary: one block
    group, ``d_model / shrink`` width, a bf16 KV cache.  Random weights
    (no second checkpoint): its drafts are only as good as its training,
    but the verify is exact regardless.  The reference also sets
    ``decode_attn_impl="eager"``; the port's config has no such field, as
    the cache's layout picks the attention (``LM.init_cache`` gives the
    drafter a contiguous cache, hence the contiguous decode)."""
    a = cfg.attention
    d_model = max(32, cfg.d_model // shrink)
    heads = max(1, a.num_heads // shrink)
    head_dim = max(8, d_model // max(heads, 1))
    return cfg.with_(
        name=cfg.name + "-draft",
        num_layers=len(cfg.block_pattern),
        d_model=d_model,
        d_ff=max(64, cfg.d_ff // shrink),
        attention=a.__class__(**{**a.__dict__, "num_heads": heads,
                                 "num_kv_heads": max(1, min(
                                     a.num_kv_heads, heads)),
                                 "head_dim": head_dim}),
        kv_cache_dtype="bfloat16",
    )

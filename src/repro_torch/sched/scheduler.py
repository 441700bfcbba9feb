"""SLO-aware continuous-batching scheduler over ``PagedEngine``.

The port of ``repro/sched/scheduler.py``'s ``SchedEngine``.  It keeps the
base engine's device programs (batched staging admission, fused
``decode_block`` decode loop) and replaces the host-side scheduling
around them:

* **Policy-ordered admission** — the queue is ranked by a pluggable
  :mod:`repro_torch.sched.policy` (FCFS / deadline-EDF) instead of strict
  arrival order, removing the base engine's head-of-line blocking.
* **Prefix caching** — admission looks up the longest cached prompt
  prefix (:mod:`repro_torch.sched.prefix`) and maps the shared physical
  pages into the slot's block-table row; prefill runs only on the suffix.
* **Chunked prefill** — prompts are prefilled ``prefill_chunk`` tokens
  per tick (page-aligned chunks), interleaved with the running slots'
  decode blocks, so one long prompt no longer stalls everyone's TPOT.
  A fresh chunk (progress 0) reuses the staging-prefill admission program
  (flash kernel); continuation chunks run ``LM.prefill_paged`` straight
  against the paged cache (prefix-extend kernel) — the same computation a
  prefix-cache warm start runs, which is why warm and cold admissions are
  token-identical.
* **Lazy page growth** — slots hold pages for what they have actually
  written plus one decode block, not the full ``prompt + max_new``
  horizon; pages are extended on demand.
* **Preemption with recompute-on-readmit** — when growth runs dry the
  policy picks a victim: its pages are released, the request re-queues,
  and readmission recomputes its KV (prompt + generated-so-far) before
  decoding resumes exactly where it left off.
* **Request-level isolation & recovery** (``repro_torch.resil``; armed by
  any of ``injector=`` / ``ladder=`` / ``max_request_s=``) — transient
  dispatch failures preempt-and-requeue the affected slots with bounded
  exponential backoff instead of crashing the engine; per-request
  wall-clock deadlines cancel and free pages; the shed rung rejects
  excess admissions with a policy-priced retry-after.  Every request
  retires with exactly one outcome (``ok | shed | timed_out | failed``).
  The tick catches exactly the reference's two classes,
  ``TransientDispatchError`` and ``OutOfPagesError``: a kernel fault on
  the card propagates.  With none of the three knobs set, ``step()`` is
  the plain tick verbatim: same dispatches, same sync counts, same
  tokens.

Telemetry (``stats``/``telemetry()``): admitted / preempted counts,
prefill tokens actually computed vs. served from the prefix cache, and
the per-request timestamps (``t_submit/t_admit/t_first/t_done``) that
give queue-wait and SLO-attainment figures.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs.trace import PID_ENGINE
from repro_torch.resil.degrade import DegradationLadder
from repro_torch.resil.errors import InjectedPageFault, TransientDispatchError
from repro_torch.sched.policy import COST_MODEL_TODO, Policy, make_policy
from repro_torch.sched.prefix import PrefixCache
from repro_torch.serve.engine import (PagedEngine, Request, _pow2_bucket,
                                      _sample_batch)
from repro_torch.serve.paged import OutOfPagesError, set_block_table_rows


@dataclasses.dataclass
class SchedStats:
    admitted: int = 0
    preemptions: int = 0
    chunks: int = 0                 # prefill dispatches
    prefill_tokens: int = 0         # tokens actually run through prefill
    prefix_hit_tokens: int = 0      # tokens served from the prefix cache
    slo_rejected: int = 0           # admission-time SLO-infeasible drops


class SchedEngine(PagedEngine):
    """Scheduler-driven paged engine (see module docstring)."""

    def __init__(self, lm, params, *, policy="fcfs",
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 slo_ttft: Optional[float] = None,
                 slo_tpot: Optional[float] = None,
                 admission_control: bool = False,
                 ladder=None, max_request_s: Optional[float] = None,
                 max_retries: int = 3, backoff_s: float = 0.05,
                 backoff_max_s: float = 1.0, **kw):
        if admission_control:
            raise NotImplementedError(f"admission_control {COST_MODEL_TODO}")
        super().__init__(lm, params, **kw)
        if prefill_chunk is None:
            prefill_chunk = 8 * self.page_size
        # page-aligned chunks are what keep quantized chunk scatters
        # right: a scatter resets every page it touches to its own amax,
        # so a chunk that started mid-page would overwrite the scale that
        # the previous chunk's rows on that page were quantized against
        if prefill_chunk % self.page_size or prefill_chunk <= 0:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be a positive multiple "
                f"of page_size={self.page_size} (page-aligned chunks keep "
                "quantized page scales single-writer)")
        self.prefill_chunk = prefill_chunk
        # tokens past each slot's length that the next decode dispatch may
        # write (SpecEngine widens it to a verify round's chunk)
        self.decode_horizon = self.decode_block
        self.policy: Policy = (policy if isinstance(policy, Policy)
                               else make_policy(policy, slo_ttft=slo_ttft))
        self.prefix = (PrefixCache(self.alloc, self.page_size)
                       if prefix_cache else None)
        self.slo_ttft = slo_ttft
        self.slo_tpot = slo_tpot
        self.stats = SchedStats()
        # fn-backed registry bridges: SchedStats / PrefixCache stay the
        # writers; the registry reads them at snapshot time, which gives
        # telemetry() its per-drive deltas
        m = self.metrics
        for f, h in (("admitted", "slot grants (readmits count again)"),
                     ("preemptions", "policy-chosen page-pressure victims"),
                     ("chunks", "prefill chunk dispatches"),
                     ("prefill_tokens", "prompt tokens actually computed"),
                     ("prefix_hit_tokens", "prompt tokens served from the "
                      "prefix cache"),
                     ("slo_rejected", "admission-time SLO-infeasible "
                      "drops")):
            m.counter(f"sched_{f}_total", h,
                      fn=lambda f=f: getattr(self.stats, f))
        m.gauge("sched_policy_info", "1, labelled with the active policy",
                fn=lambda: 1.0, policy=self.policy.name)
        if self.prefix is not None:
            for f in ("lookups", "hits", "hit_tokens", "inserted",
                      "evicted"):
                m.counter(f"prefix_{f}_total", f"prefix cache {f}",
                          fn=lambda f=f: getattr(self.prefix, f))
            m.gauge("prefix_cached_pages", "pages pinned by the prefix "
                    "cache", fn=lambda: len(self.prefix.nodes))
        # --- resilience wiring (repro_torch.resil) ---------------------
        # ladder accepts True (build one from the engine's own knobs), a
        # built DegradationLadder, or None.  ``resilient`` gates the
        # recovery tick: with every knob off the engine runs the plain
        # tick verbatim (sync- and token-identical)
        if ladder is True:
            ladder = DegradationLadder(self.metrics, n_slots=self.n_slots,
                                       slo_ttft=slo_ttft)
        self.ladder = ladder
        self.max_request_s = max_request_s
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.resilient = ((self.injector is not None
                           and self.injector.enabled)
                          or ladder is not None or max_request_s is not None)
        if self.resilient:
            self._c_recovered = m.counter(
                "resil_recovered_total",
                "transient faults recovered by preempt-and-requeue")
            self._c_timeouts = m.counter(
                "resil_timeouts_total",
                "requests cancelled at their wall-clock deadline")
            self._c_shed = m.counter(
                "resil_shed_total", "admissions rejected by the shed rung")
            self._c_failed = m.counter(
                "resil_failed_total",
                "requests retired as failed (retries exhausted / no fit)")
        self._prefilling: Dict[int, Request] = {}    # slot -> mid-prompt req
        # rid -> (len(toks), digest chain): hashing a prompt is O(len),
        # and a page-starved queue is probed every tick — memoize per
        # request, keyed on the token count (readmits grow it)
        self._chains: Dict[int, tuple] = {}

    # ------------------------------------------------------------------
    # device programs

    @torch.no_grad()
    def _chunk_impl(self, tokens, slot_ids, starts, clens, temps, gen,
                    max_pages: int):
        """One continuation-chunk dispatch: prefill ``tokens`` (B,c)
        against the paged cache at absolute positions ``starts`` (in
        place); sample a candidate first token from each row's last-chunk
        logits (used only by rows whose prompt completes this chunk).
        ``max_pages`` narrows the block table to the batch's deepest
        prefix instead of the full slot horizon."""
        logits, self.cache = self.lm.prefill_paged(
            self.params, tokens, self.cache, slot_ids, starts, clens,
            max_pages=max_pages)
        return _sample_batch(logits, temps, gen)

    # ------------------------------------------------------------------
    # request intake

    def submit(self, prompt, **kw) -> int:
        kw.setdefault("slo_ttft", self.slo_ttft)
        kw.setdefault("slo_tpot", self.slo_tpot)
        return super().submit(prompt, **kw)

    def _sched_tokens(self, req: Request) -> np.ndarray:
        """Tokens whose KV must be cached before ``req`` can decode:
        the prompt, plus — after a preemption — everything generated
        except the still-pending last token (recompute-on-readmit)."""
        if req.out_tokens:
            return np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.out_tokens[:-1], np.int32)])
        return np.asarray(req.prompt, np.int32)

    # ------------------------------------------------------------------
    # admission (policy-ordered, prefix-aware, chunk-sized page needs)

    def _effective_chunk(self) -> int:
        """Prefill chunk after the degradation ladder's shrink rung
        (page-aligned by construction); the configured chunk otherwise."""
        if self.ladder is not None:
            return self.ladder.chunk_for(self.prefill_chunk, self.page_size)
        return self.prefill_chunk

    def _admit_new(self) -> None:
        if not self.queue:
            return
        now = time.perf_counter()
        if self.ladder is not None and self.ladder.shed:
            self._shed_excess(now)
        if not (self.queue and self.free):
            return
        for req in sorted(self.queue,
                          key=lambda r: self.policy.priority(r, now)):
            if not self.free:
                break
            if req.not_before > now:
                continue             # recovery backoff still running
            self._admit_one(req, now)

    def _admit_one(self, req: Request, now: float) -> bool:
        toks = self._sched_tokens(req)
        slot = self.free[0]
        chain = None
        if self.prefix is not None:
            cached = self._chains.get(req.rid)
            if cached is None or cached[0] != len(toks):
                cached = (len(toks), self.prefix.chain_digests(toks))
                self._chains[req.rid] = cached
            chain = cached[1]
        hit, pages = 0, []
        while True:
            # probe with count=False — the admission's outcome is counted
            # exactly once on success, however many probe ticks it took;
            # re-lookup after each eviction pass because evicting for
            # ourselves can drop pages of our own hit chain.  Terminates:
            # every retry evicted > 0 pages from a finite cache.
            hit, pages = (self.prefix.lookup(toks, count=False,
                                             chain=chain)
                          if self.prefix else (0, []))
            clen = min(self._effective_chunk(), len(toks) - hit)
            need = self.alloc.pages_needed(hit + clen,
                                           self.page_size) - len(pages)
            try:
                self.alloc.assign(slot, pages, need)
                break
            except OutOfPagesError as e:
                short = max(need - len(self.alloc.free), 1)
                if self.prefix is not None and \
                        self.prefix.evict_pages(short) > 0:
                    continue
                if not (self.active or self._prefilling):
                    if self.resilient:
                        if isinstance(e, InjectedPageFault) \
                                and req.retries < self.max_retries:
                            req.retries += 1     # spurious: retry next tick
                            self._c_recovered.inc()
                            return False
                        # pool permanently too small for this request
                        self._c_failed.inc()
                        self._cancel_queued(req, now, "failed")
                        return False
                    raise            # nothing in flight will free pages
                return False         # wait for retirements
        if self.prefix is not None:
            self.prefix.count_lookup(hit)
        self._chains.pop(req.rid, None)          # admitted: probe memo done
        self.queue.remove(req)
        self.free.popleft()
        req.slot = slot
        first = req.t_admit is None
        if first:
            req.t_admit = now
        self._obs_admit(req, now, first, policy=self.policy.name,
                        hit_tokens=hit,
                        pages=len(self.alloc.owned(slot)))
        req.progress = hit
        # While the slot is mid-prefill the fused decode dispatch still
        # lock-step "writes" a garbage token for it at host lengths[slot].
        # Keeping lengths == progress (page-aligned, with pages covering
        # exactly progress tokens between ticks) routes that write to the
        # null page or to the next chunk's first position, which the
        # chunk scatter then overwrites anyway.
        self.lengths[slot] = hit
        if not req.out_tokens:
            req.prefix_hit_tokens = hit
        self.stats.prefix_hit_tokens += hit
        self.stats.admitted += 1
        self.temps[slot] = req.temperature
        set_block_table_rows(self.cache, [slot], self.alloc.table[[slot]])
        self._prefilling[slot] = req
        return True

    # ------------------------------------------------------------------
    # page growth / preemption

    def _grow(self, slot: int, extra: int) -> None:
        """Extend ``slot`` by ``extra`` fresh pages, escalating from
        prefix-cache eviction to policy-chosen preemption.  Raises
        OutOfPagesError only when ``slot`` is the last work in flight and
        the (fully evicted) pool still cannot hold it — in resilient mode
        that terminal case is handled in place instead (the slot is
        preempted with backoff for a spurious injected fault, cancelled as
        ``failed`` for a genuine no-fit), so on return the slot has either
        grown or left active/_prefilling."""
        now = time.perf_counter()
        if len(self.alloc.owned(slot)) + extra > self.alloc.max_pages_per_slot:
            if self.resilient:
                self._c_failed.inc()
                self._cancel_slot(slot, now, "failed")
                return
            raise OutOfPagesError(
                f"slot {slot} would exceed {self.alloc.max_pages_per_slot} "
                f"pages; {self.alloc.occupancy_summary()}")
        while True:
            try:
                self.alloc.extend(slot, extra)
            except OutOfPagesError as e:
                short = extra - len(self.alloc.free)
                if self.prefix is not None and \
                        self.prefix.evict_pages(short) > 0:
                    continue
                victims = [r for s, r in
                           list(self.active.items())
                           + list(self._prefilling.items()) if s != slot]
                if not victims:
                    if self.resilient:
                        self._grow_blocked(slot, now, e)
                        return
                    raise
                victim = max(victims,
                             key=lambda r: self.policy.victim(r, now))
                self._preempt(victim.slot, now)
                continue
            set_block_table_rows(self.cache, [slot], self.alloc.table[[slot]])
            return

    def _grow_blocked(self, slot: int, now: float, err) -> None:
        """Terminal growth failure for the LAST in-flight slot: a
        spurious injected page fault preempts it (requeue with backoff —
        the fault clears on retry); a genuine no-fit retires it as
        ``failed`` (nothing left to evict, the pool cannot hold it)."""
        req = self.active.get(slot) or self._prefilling.get(slot)
        if isinstance(err, InjectedPageFault) \
                and req.retries < self.max_retries:
            req.retries += 1
            self._c_recovered.inc()
            self._preempt(slot, now)
            self._backoff(req, now)
            return
        self._c_failed.inc()
        self._cancel_slot(slot, now, "failed")

    def _preempt(self, slot: int, now: float) -> None:
        """Release ``slot``'s pages and requeue its request; readmission
        recomputes the KV (prompt + generated) before decode resumes."""
        req = self.active.pop(slot, None)
        if req is None:
            req = self._prefilling.pop(slot)
        self._release_slot(slot)
        req.slot = -1
        req.progress = 0
        req.preemptions += 1
        self.stats.preemptions += 1
        self.queue.append(req)
        tr = self.tracer
        if tr.enabled:
            tr.instant("preempt", req.rid, ts=now,
                       args={"policy": self.policy.name})
            # re-open the queue span: the readmit wait is queue time
            tr.begin("queue", req.rid, ts=now, args={"readmit": True})

    # ------------------------------------------------------------------
    # request-level isolation & recovery (repro_torch.resil)

    def _release_slot(self, slot: int) -> None:
        """Free ``slot``'s pages and host state and re-point its device
        block-table row at the null page, so lock-step garbage writes
        can't land in reallocated pages."""
        self.alloc.release(slot)
        self.lengths[slot] = 0
        self.temps[slot] = 0.0
        self.remaining[slot] = 0
        self.free.append(slot)
        set_block_table_rows(self.cache, [slot], self.alloc.table[[slot]])

    def _cancel_slot(self, slot: int, now: float, outcome: str) -> None:
        """Terminal cancellation of an in-flight slot: retire its request
        with ``outcome``, release every page, and return the slot to the
        free list."""
        req = self.active.pop(slot, None)
        if req is None:
            req = self._prefilling.pop(slot)
        req.outcome = outcome
        req.done = True
        req.t_done = now
        self.tracer.instant("cancel", req.rid, ts=now,
                            args={"outcome": outcome})
        self._obs_retire(req)
        self._release_slot(slot)

    def _cancel_queued(self, req: Request, now: float, outcome: str) -> None:
        """Terminal cancellation of a still-queued request (no pages to
        free — it holds no slot)."""
        self.queue.remove(req)
        self._chains.pop(req.rid, None)
        req.outcome = outcome
        req.done = True
        req.t_done = now
        self.tracer.end("queue", req.rid, ts=now,
                        args={"cancelled": outcome})
        self._obs_retire(req)

    def _shed_excess(self, now: float) -> None:
        """Shed rung: keep the policy's ``n_slots`` best-ranked queued
        requests, reject the rest with outcome ``shed`` and a
        policy-priced ``retry_after_s`` hint (FCFS sheds the latest
        arrivals, EDF the most slack)."""
        if len(self.queue) <= self.n_slots:
            return
        ranked = sorted(self.queue,
                        key=lambda r: self.policy.priority(r, now))
        for rank, req in enumerate(ranked[self.n_slots:],
                                   start=self.n_slots):
            self.queue.remove(req)
            self._chains.pop(req.rid, None)
            req.outcome = "shed"
            req.retry_after_s = self.policy.retry_after(req, now, rank)
            req.done = True
            req.t_done = now
            self._c_shed.inc()
            self.tracer.end("queue", req.rid, ts=now,
                            args={"shed": True,
                                  "retry_after_s":
                                      round(req.retry_after_s, 4)})
            self._obs_retire(req)

    def _expire_timeouts(self, now: float) -> None:
        """Per-request wall-clock deadline (``max_request_s`` from
        submit): expired queued requests retire in place; expired
        in-flight slots are cancelled and their pages freed."""
        dl = self.max_request_s
        for req in list(self.queue):
            if now - req.t_submit > dl:
                self._c_timeouts.inc()
                self._cancel_queued(req, now, "timed_out")
        for slot, req in list(self.active.items()) \
                + list(self._prefilling.items()):
            if now - req.t_submit > dl:
                self._c_timeouts.inc()
                self._cancel_slot(slot, now, "timed_out")

    def _backoff(self, req: Request, now: float) -> None:
        req.not_before = now + min(
            self.backoff_s * 2 ** (req.retries - 1), self.backoff_max_s)

    def _requeue_or_fail(self, slots, now: float) -> None:
        """Preempt each of ``slots`` with backoff, or retire it as
        ``failed`` once its request has used up ``max_retries``."""
        for slot in slots:
            req = self.active.get(slot) or self._prefilling.get(slot)
            if req is None:
                continue
            req.retries += 1
            if req.retries > self.max_retries:
                self._c_failed.inc()
                self._cancel_slot(slot, now, "failed")
            else:
                self._preempt(slot, now)
                self._backoff(req, now)

    def _recover_transient(self, err, now: float) -> None:
        """Transient dispatch failure: the fault fired at the host boundary
        BEFORE the dispatch committed any engine state, so the affected
        phase's slots are preempted and requeued with bounded exponential
        backoff; a request that exhausts ``max_retries`` retires as
        ``failed``."""
        kind = getattr(err, "kind", "dispatch")
        if kind in ("admit", "prefill_chunk"):
            slots = list(self._prefilling)
        elif kind in ("decode_block", "spec_round"):
            slots = list(self.active)
        else:
            slots = list(self._prefilling) + list(self.active)
        self._c_recovered.inc()
        tr = self.tracer
        if tr.enabled:
            tr.instant("fault", 0, ts=now, pid=PID_ENGINE,
                       args={"kind": kind, "error": str(err)})
        self._requeue_or_fail(slots, now)

    def _recover_oom(self, err, now: float) -> None:
        """Backstop for an allocation failure that escaped the inline
        handlers mid-tick: preempt everything in flight (pages released,
        recompute-on-readmit) so the next tick starts from a clean pool;
        retries are bounded like any transient fault."""
        self._c_recovered.inc()
        tr = self.tracer
        if tr.enabled:
            tr.instant("fault", 0, ts=now, pid=PID_ENGINE,
                       args={"kind": "page_oom", "error": str(err)})
        self._requeue_or_fail(list(self._prefilling) + list(self.active),
                              now)

    # ------------------------------------------------------------------
    # chunked prefill

    def _dispatch_chunks(self, emitted: list) -> None:
        """≤2 prefill dispatches per tick: one batched staging chunk for
        fresh rows (progress 0 — the base admission program, flash
        kernel) and one batched continuation chunk (progress > 0:
        prefix-cache hits and chunk 2+) through ``prefill_paged``
        (prefix-extend kernel)."""
        if not self._prefilling:
            return
        # snapshot group membership: a chunk advancing progress past 0
        # must not earn the same request a second chunk this tick
        groups = {False: [], True: []}
        for slot, req in self._prefilling.items():
            groups[req.progress > 0].append((slot, req))
        for cont in (False, True):
            ready = []
            for slot, req in groups[cont]:
                if slot not in self._prefilling:
                    continue
                toks = self._sched_tokens(req)
                clen = min(self._effective_chunk(),
                           len(toks) - req.progress)
                need = self.alloc.pages_needed(
                    req.progress + clen, self.page_size) \
                    - len(self.alloc.owned(slot))
                if need > 0:
                    self._grow(slot, need)
                ready.append((slot, req, toks, clen))
            # a later row's _grow may have preempted (or cancelled) an
            # earlier ready row
            ready = [r for r in ready if r[0] in self._prefilling]
            if not ready:
                continue
            # chaos hook AFTER page growth, BEFORE any dispatch state is
            # built: a raise here leaves the rows consistent (pages grown,
            # progress untouched) for preempt-and-requeue
            self._maybe_inject("prefill_chunk" if cont else "admit")
            slots = np.asarray([s for s, _, _, _ in ready], np.int32)
            clens = np.asarray([c for _, _, _, c in ready], np.int32)
            starts = np.asarray([r.progress for _, r, _, _ in ready],
                                np.int32)
            cpad = _pow2_bucket(int(clens.max()))
            tokens = np.zeros((len(ready), cpad), np.int32)
            for i, (_, req, toks, clen) in enumerate(ready):
                tokens[i, :clen] = toks[req.progress:req.progress + clen]
            if cont:
                # pow2-bucket the ROW count too, as the reference does (it
                # keeps the continuation program's shapes few).  Pad rows
                # are inert: clen 0 routes their scatter to the null page,
                # start 0 reads no prefix page, and the host loop below
                # never reads their sampled token.
                rpad = _pow2_bucket(len(ready), lo=1)
                if rpad > len(ready):
                    pad = rpad - len(ready)
                    slots = np.concatenate(
                        [slots, np.full(pad, slots[0], np.int32)])
                    starts = np.concatenate(
                        [starts, np.zeros(pad, np.int32)])
                    clens = np.concatenate([clens, np.zeros(pad, np.int32)])
                    tokens = np.concatenate(
                        [tokens, np.zeros((pad, cpad), np.int32)])
            dev = self.device
            temps = self.temps[slots]
            args = (torch.as_tensor(tokens, device=dev).long(),
                    torch.as_tensor(slots, device=dev).long(),
                    torch.as_tensor(starts, device=dev),
                    torch.as_tensor(clens, device=dev),
                    torch.as_tensor(temps, device=dev), self._gen_if(temps))
            t0 = time.perf_counter()
            if cont:
                # block table narrowed to the batch's deepest prefix
                # (pow2-bucketed), not the slot horizon
                mp = min(_pow2_bucket(-(-int(starts.max())
                                        // self.page_size), lo=1),
                         self.alloc.max_pages_per_slot)
                tok = self._chunk_impl(*args, max_pages=mp)
            else:
                tok = self._admit_impl(args[0], args[1], args[3], args[4],
                                       args[5])
            tok = tok.cpu().numpy()          # <- sync (1 per chunk batch)
            self.sync_count += 1
            now = time.perf_counter()
            self.t_prefill_s += now - t0
            self.stats.chunks += 1
            self._c_prefill_disp.inc()
            tr = self.tracer
            n_ready = len(ready)
            if tr.enabled:
                tr.complete("prefill_dispatch", 0, t0, now, pid=PID_ENGINE,
                            args={"rows": n_ready, "cont": bool(cont),
                                  "tokens": int(clens[:n_ready].sum())})
            for i, (slot, req, toks, clen) in enumerate(ready):
                if tr.enabled:
                    tr.complete(
                        "prefill_chunk", req.rid, t0, now,
                        args={"tokens": int(clen),
                              "start": int(req.progress),
                              "emitted": int(req.progress + clen
                                             >= len(toks)
                                             and not req.out_tokens)})
                req.progress += clen
                self.stats.prefill_tokens += clen
                if req.progress >= len(toks):
                    self._finish_prefill(slot, req, toks, int(tok[i]), now,
                                         emitted)
                else:
                    self.lengths[slot] = req.progress

    def _finish_prefill(self, slot: int, req: Request, toks: np.ndarray,
                        tok0: int, now: float, emitted: list) -> None:
        del self._prefilling[slot]
        if self.prefix is not None:
            n_full = len(req.prompt) // self.page_size
            if n_full:
                self.prefix.insert(
                    np.asarray(req.prompt[:n_full * self.page_size]),
                    self.alloc.owned(slot)[:n_full])
        total = len(toks)
        self.lengths[slot] = total
        self.active[slot] = req
        if not req.out_tokens:               # fresh prompt: sample now
            req.out_tokens.append(tok0)
            req.pos = total
            req.t_first = now
            self._obs_first(req)
            self._c_tokens.inc()
            emitted.append((req.rid, tok0))
            self.remaining[slot] = req.max_new_tokens - 1
            self.last_tok[slot] = tok0
            if (tok0 == self.eos or req.max_new_tokens <= 1
                    or req.pos >= self.max_len - 1):
                self._retire(slot, now)
        else:                                # readmit: resume mid-stream
            req.pos = total
            self.remaining[slot] = req.max_new_tokens - len(req.out_tokens)
            self.last_tok[slot] = req.out_tokens[-1]

    # ------------------------------------------------------------------
    # decode capacity (lazy growth)

    def _ensure_decode_pages(self) -> None:
        for slot in list(self.active):
            if slot not in self.active:      # preempted by an earlier grow
                continue
            horizon = min(int(self.lengths[slot]) + self.decode_horizon,
                          self.max_len)
            need = self.alloc.pages_needed(horizon, self.page_size) \
                - len(self.alloc.owned(slot))
            if need > 0:
                self._grow(slot, need)

    # ------------------------------------------------------------------
    # the engine tick

    def step(self) -> List[tuple]:
        """One tick: policy-ordered admission, at most two prefill-chunk
        dispatches, then one fused decode block for the running slots.

        In resilient mode (``injector``/``ladder``/``max_request_s``) the
        tick also updates the degradation ladder, expires per-request
        deadlines, and turns transient dispatch faults and page
        exhaustion into preempt-and-requeue recovery instead of
        propagating them; with all three knobs off this body is the plain
        tick verbatim."""
        emitted: List[tuple] = []
        if not self.resilient:
            self._admit_new()
            self._dispatch_chunks(emitted)
            if self.active:
                self._ensure_decode_pages()
                if self.active:
                    self._dispatch_decode(emitted)
            return emitted
        now = time.perf_counter()
        if self.ladder is not None:
            self.ladder.update()
        if self.max_request_s is not None:
            self._expire_timeouts(now)
        try:
            self._admit_new()
            self._dispatch_chunks(emitted)
            if self.active:
                self._ensure_decode_pages()
                if self.active:
                    self._dispatch_decode(emitted)
        except TransientDispatchError as e:
            self._recover_transient(e, time.perf_counter())
        except OutOfPagesError as e:
            self._recover_oom(e, time.perf_counter())
        if not emitted and self.queue \
                and not (self.active or self._prefilling):
            # every queued request is in recovery backoff: yield briefly
            # instead of spinning the host loop
            time.sleep(0.0005)
        return emitted

    def run_to_completion(self) -> Dict[int, Request]:
        while self.queue or self.active or self._prefilling:
            self.step()
        return dict(self.registry)

    # ------------------------------------------------------------------
    def slo_attainment(self) -> dict:
        """Fraction of completed requests meeting their OWN TTFT/TPOT
        targets (per-request ``slo_ttft``/``slo_tpot``; the engine-level
        defaults fill in at submit).  None when no request carried the
        target."""
        ttft_n = ttft_ok = tpot_n = tpot_ok = 0
        for r in self.registry.values():
            if not (r.done and r.t_first is not None):
                continue
            if r.slo_ttft is not None:
                ttft_n += 1
                ttft_ok += (r.t_first - r.t_submit) <= r.slo_ttft
            if (r.slo_tpot is not None and len(r.out_tokens) > 1
                    and r.t_done is not None):
                tpot_n += 1
                tpot_ok += ((r.t_done - r.t_first)
                            / (len(r.out_tokens) - 1)) <= r.slo_tpot
        return {"ttft_attainment": round(ttft_ok / ttft_n, 4)
                if ttft_n else None,
                "tpot_attainment": round(tpot_ok / tpot_n, 4)
                if tpot_n else None}

    def telemetry(self, since: Optional[dict] = None) -> dict:
        """The scheduler's counters as one dict, from a metrics snapshot;
        pass ``since=`` (an earlier ``metrics.snapshot()``) for per-drive
        deltas instead of lifetime totals."""
        snap = (self.metrics.snapshot() if since is None
                else self.metrics.delta(since))
        c, g = snap["counters"], snap["gauges"]
        out = {f.name: int(c.get(f"sched_{f.name}_total", 0))
               for f in dataclasses.fields(self.stats)}
        out["policy"] = self.policy.name
        if self.prefix is not None:
            lookups = int(c.get("prefix_lookups_total", 0))
            hits = int(c.get("prefix_hits_total", 0))
            out["prefix"] = {
                "lookups": lookups,
                "hits": hits,
                "hit_rate": round(hits / lookups, 4) if lookups else 0.0,
                "hit_tokens": int(c.get("prefix_hit_tokens_total", 0)),
                "cached_pages": int(g.get("prefix_cached_pages", 0)),
                "inserted": int(c.get("prefix_inserted_total", 0)),
                "evicted": int(c.get("prefix_evicted_total", 0)),
            }
        else:
            out["prefix"] = None
        out["sync_count"] = int(c.get("serve_host_syncs_total", 0))
        out["slo"] = self.slo_attainment()
        return out

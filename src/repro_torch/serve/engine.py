"""Continuous-batching serving over a paged KV cache.

The port of ``repro/serve/engine.py``'s ``PagedEngine``: a fixed decode
batch of ``n_slots``; queued requests are admitted in ONE right-padded,
power-of-two-bucketed prefill whose K/V is scattered into the page pools;
then every active slot decodes in lock-step through the paged-attention
kernel.  Sampling happens on the device (greedy, or temperature through a
``torch.Generator``), and ``decode_block`` steps run per dispatch with
per-slot EOS / budget masks kept on the device, so the host reads the
device once per block instead of once per token (``sync_count`` audits
this: one per admission batch plus one per decode block, as in the
reference).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import PID_ENGINE, Tracer
from repro_torch.resil.errors import OUTCOMES
from repro_torch.serve.paged import (PAGE, OutOfPagesError, PageAllocator,
                                     scatter_prefill_cache,
                                     set_block_table_rows)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (plen,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    pos: int = 0                       # next position to write
    done: bool = False
    t_submit: float = 0.0
    t_admit: Optional[float] = None    # first slot grant (queue wait end)
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    preemptions: int = 0
    rejected: bool = False
    outcome: Optional[str] = None      # one of OUTCOMES, set at retire


class _EngineBase:
    """Request intake, slot bookkeeping, metrics and tracing."""

    def __init__(self, lm, params, *, n_slots: int, max_len: int,
                 eos_id: int, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.lm = lm
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos_id
        self.free = deque(range(n_slots))
        self.active: Dict[int, Request] = {}     # slot -> req
        self.queue: deque[Request] = deque()
        self.registry: Dict[int, Request] = {}   # rid -> req (all ever seen)
        self._next_rid = 0
        # phase wall-clock (device dispatch + its host sync)
        self.t_prefill_s = 0.0
        self.t_decode_s = 0.0
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        m = self.metrics
        self._c_submitted = m.counter(
            "serve_requests_submitted_total", "requests accepted by submit()")
        self._c_retired = m.counter(
            "serve_requests_retired_total",
            "requests finished (incl. admission-time rejects)")
        self._c_tokens = m.counter(
            "serve_tokens_emitted_total", "tokens appended across requests")
        self._c_outcome = m.counter(
            "resil_requests_total",
            "request retirements by terminal outcome")
        for o in OUTCOMES:       # pre-create every series at 0
            self._c_outcome.inc(0.0, outcome=o)
        self._h_queue = m.histogram(
            "serve_queue_wait_seconds", "submit -> first slot grant")
        self._h_ttft = m.histogram(
            "serve_ttft_seconds", "submit -> first token")
        self._h_tpot = m.histogram(
            "serve_tpot_seconds", "mean per-token latency after the first")
        m.counter("serve_phase_seconds_total",
                  "dispatch+sync wall-clock by phase",
                  fn=lambda: self.t_prefill_s, phase="prefill")
        m.counter("serve_phase_seconds_total",
                  fn=lambda: self.t_decode_s, phase="decode")
        m.gauge("serve_queue_depth", "requests waiting for a slot",
                fn=lambda: len(self.queue))
        m.gauge("serve_slots_active", "slots currently decoding",
                fn=lambda: len(self.active))

    # ------------------------------------------------------------------
    # observability hooks (host clock only; no device reads)

    def _obs_submit(self, req: Request):
        self._c_submitted.inc()
        tr = self.tracer
        if tr.enabled:
            tr.name_thread(req.rid, f"req {req.rid}")
            tr.begin("request", req.rid, ts=req.t_submit,
                     args={"rid": req.rid, "prompt_tokens": len(req.prompt),
                           "max_new_tokens": req.max_new_tokens})
            tr.begin("queue", req.rid, ts=req.t_submit)

    def _obs_admit(self, req: Request, now: float, first: bool, **args):
        if first:
            self._h_queue.observe(now - req.t_submit)
        self.tracer.end("queue", req.rid, ts=now, args=args or None)

    def _obs_first(self, req: Request):
        if req.t_first is not None:
            self._h_ttft.observe(req.t_first - req.t_submit)

    def _obs_retire(self, req: Request):
        self._c_retired.inc()
        if req.outcome is None:
            req.outcome = "shed" if req.rejected else "ok"
        self._c_outcome.inc(outcome=req.outcome)
        if (req.t_done is not None and req.t_first is not None
                and len(req.out_tokens) > 1):
            self._h_tpot.observe((req.t_done - req.t_first)
                                 / (len(req.out_tokens) - 1))
        self.tracer.end("request", req.rid, ts=req.t_done,
                        args={"tokens": len(req.out_tokens),
                              "preemptions": req.preemptions,
                              "rejected": req.rejected,
                              "outcome": req.outcome})

    def submit(self, prompt, **kw) -> int:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens >= max_len={self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt,
                      t_submit=time.perf_counter(), **kw)
        self.queue.append(req)
        self.registry[rid] = req
        self._obs_submit(req)
        return rid

    def step(self) -> List[tuple]:
        raise NotImplementedError

    def run_to_completion(self) -> Dict[int, Request]:
        while self.queue or self.active:
            self.step()
        return dict(self.registry)


# ---------------------------------------------------------------------------
# Paged engine


def _sample_batch(logits: torch.Tensor, temps: torch.Tensor,
                  gen: Optional[torch.Generator]) -> torch.Tensor:
    """Device-side sampling: greedy (argmax, first maximum on ties) where
    temps <= 0, else temperature sampling by the Gumbel-max trick with
    noise from ``gen``.  ``gen=None`` means every row is greedy.
    logits: (S,V); temps: (S,)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if gen is None:
        return greedy
    t = torch.clamp(temps, min=1e-6)[:, None]
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    sampled = torch.argmax(logits / t - torch.log(-torch.log(u)),
                           dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def _pow2_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class PagedEngine(_EngineBase):
    """Continuous batching over a paged KV cache with a host-read-free
    inner loop (see module docstring).  Requires an attention-only
    decoder without a sliding window."""

    def __init__(self, lm, params, *, n_slots: int = 4, max_len: int = 512,
                 eos_id: int = -1, seed: int = 0, page_size: int = PAGE,
                 decode_block: int = 8, n_pages: Optional[int] = None,
                 metrics=None, tracer=None):
        cfg = lm.cfg
        a = cfg.attention
        if a is None or a.window is not None \
                or any(k != "attn" for k in cfg.block_pattern):
            raise ValueError("PagedEngine needs an attention-only decoder")
        super().__init__(lm, lm.prepare(params), n_slots=n_slots,
                         max_len=max_len, eos_id=eos_id, metrics=metrics,
                         tracer=tracer)
        self.device = lm.device
        self.page_size = page_size
        self.decode_block = decode_block
        from repro_torch.kvcache import paged_pool_shape
        pages_per_slot, default_pages = paged_pool_shape(n_slots, max_len,
                                                         page_size)
        if n_pages is None:
            n_pages = default_pages                  # incl. null page 0
        self.alloc = PageAllocator(n_pages, pages_per_slot, n_slots)
        self.cache = lm.init_paged_cache(n_slots, n_pages, pages_per_slot,
                                         page_size=page_size)
        self.lengths = np.zeros((n_slots,), np.int32)
        self.temps = np.zeros((n_slots,), np.float32)
        self.remaining = np.zeros((n_slots,), np.int32)
        self.last_tok = np.zeros((n_slots,), np.int32)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.sync_count = 0                      # device->host transitions
        self.steps_dispatched = 0                # decode_block per dispatch
        self.steps_run = 0                       # decode steps executed
        m = self.metrics
        m.counter("serve_host_syncs_total", "device->host sync points",
                  fn=lambda: self.sync_count)
        m.counter("serve_decode_steps_total",
                  "decode scan steps dispatched (incl. overrun no-ops)",
                  fn=lambda: self.steps_dispatched)
        m.gauge("serve_pages_free", "allocator free pages",
                fn=lambda: len(self.alloc.free))
        m.gauge("serve_pages_total", "allocator pool size (incl. null page)",
                fn=lambda: self.alloc.n_pages)
        self._c_decode_tokens = m.counter(
            "serve_decode_tokens_total",
            "tokens emitted by fused decode blocks (device-counted)")
        self._c_eos = m.counter(
            "serve_eos_total", "EOS fires inside decode blocks "
            "(device-counted)")
        self._c_requant = m.counter(
            "serve_kv_requant_events_total",
            "quantized page-scale entries changed by device KV writes")
        self._c_prefill_disp = m.counter(
            "serve_prefill_dispatches_total",
            "batched prefill / chunk dispatches")
        self._c_decode_disp = m.counter(
            "serve_decode_dispatches_total", "fused decode-block dispatches")

    # ------------------------------------------------------------------
    # device programs

    def _gen_if(self, temps: np.ndarray) -> Optional[torch.Generator]:
        return self.gen if bool((temps > 0).any()) else None

    @torch.no_grad()
    def _admit_impl(self, tokens, slot_ids, plens, temps, gen):
        """ONE padded prefill for every request admitted this tick, into a
        bf16 staging cache, scattered into the page pools in place; first
        token sampled on the device.  tokens: (nb, plen_pad)."""
        nb, t = tokens.shape
        tmp = self.lm.init_cache(nb, t, kv_dtype="bfloat16")
        logits, tmp = self.lm.prefill(self.params, tokens, tmp,
                                      lengths=plens)
        scatter_prefill_cache(self.cache, tmp, slot_ids, plens)
        return _sample_batch(logits, temps, gen)

    @torch.no_grad()
    def _decode_impl(self, tokens, lengths, active, remaining, temps,
                     n_steps: int, gen):
        """``n_steps`` decode steps (of a ``decode_block``-step block):
        sample on the device, advance per-slot lengths / budgets, mask
        finished slots.  Nothing here reads the device.  The reference
        skips all-inactive steps with an on-device ``lax.cond``; here the
        host bounds the loop by the largest budget it knows, and the
        remaining rows of the block are filled as the skipped steps
        would have left them.  A step after every slot hit EOS still runs:
        it only writes K/V past each slot's length, where no read
        reaches."""
        eos, max_len = self.eos, self.max_len
        s_n = tokens.shape[0]
        toks = torch.empty((self.decode_block, s_n), dtype=torch.int32,
                           device=self.device)
        emits = torch.zeros((self.decode_block, s_n), dtype=torch.bool,
                            device=self.device)
        stats = torch.zeros((2,), dtype=torch.int32, device=self.device)
        for i in range(n_steps):
            logits, self.cache = self.lm.decode_step(self.params, tokens,
                                                     self.cache, lengths)
            nxt = _sample_batch(logits, temps, gen)
            nxt = torch.where(active, nxt, tokens)
            stats += torch.stack([active.sum(), (active & (nxt == eos)).sum()
                                  ]).to(torch.int32)
            emits[i] = active
            lengths = torch.where(active, lengths + 1, lengths)
            remaining = torch.where(active, remaining - 1, remaining)
            done = (nxt == eos) | (remaining <= 0) | (lengths >= max_len - 1)
            active = active & ~done
            tokens = nxt
            toks[i] = tokens
        toks[n_steps:] = tokens
        return toks, emits, tokens, lengths, active, remaining, stats

    # ------------------------------------------------------------------
    # host loop

    def _retire(self, slot: int, now: float):
        req = self.active.pop(slot)
        req.done = True
        req.t_done = now
        self._obs_retire(req)
        self.alloc.release(slot)                 # zeroes the host bt row
        self.lengths[slot] = 0
        self.temps[slot] = 0.0
        self.free.append(slot)
        # point the device row at the null page so the retired slot's
        # lock-step garbage writes can't land in reallocated pages
        set_block_table_rows(self.cache, [slot], self.alloc.table[[slot]])

    def _try_admit(self) -> List[Request]:
        """Pop queue entries into free slots while pages last."""
        admitted = []
        while self.queue and self.free:
            req = self.queue[0]
            plen = len(req.prompt)
            horizon = min(plen + req.max_new_tokens, self.max_len)
            slot = self.free[0]
            try:
                self.alloc.alloc(slot, self.alloc.pages_needed(
                    horizon, self.page_size))
            except OutOfPagesError:
                if not self.active and not admitted:
                    raise            # nothing will ever free these pages
                break                # decode on; retirements free pages
            self.queue.popleft()
            self.free.popleft()
            req.slot = slot
            req.t_admit = time.perf_counter()
            self._obs_admit(req, req.t_admit, first=True,
                            pages=len(self.alloc.owned(slot)))
            admitted.append(req)
        return admitted

    def _dispatch_admit(self, admitted: List[Request], emitted: list):
        plens = np.asarray([len(r.prompt) for r in admitted], np.int32)
        slot_ids = np.asarray([r.slot for r in admitted], np.int32)
        plen_pad = _pow2_bucket(int(plens.max()))
        tokens = np.zeros((len(admitted), plen_pad), np.int32)
        for i, r in enumerate(admitted):
            tokens[i, :plens[i]] = r.prompt
            self.temps[r.slot] = r.temperature
        set_block_table_rows(self.cache, slot_ids, self.alloc.table[slot_ids])
        dev = self.device
        t0 = time.perf_counter()
        tok0 = self._admit_impl(
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(slot_ids, device=dev).long(),
            torch.as_tensor(plens, device=dev),
            torch.as_tensor(self.temps[slot_ids], device=dev),
            self._gen_if(self.temps[slot_ids]))
        tok0 = tok0.cpu().numpy()                # <- sync (1 per admit batch)
        self.sync_count += 1
        now = time.perf_counter()
        self.t_prefill_s += now - t0
        self._c_prefill_disp.inc()
        self._c_tokens.inc(len(admitted))
        tr = self.tracer
        if tr.enabled:
            tr.complete("prefill_dispatch", 0, t0, now, pid=PID_ENGINE,
                        args={"rows": len(admitted),
                              "tokens": int(plens.sum())})
        for i, req in enumerate(admitted):
            t = int(tok0[i])
            req.out_tokens.append(t)
            req.pos = int(plens[i])
            req.t_first = now
            if tr.enabled:
                tr.complete("prefill", req.rid, t0, now,
                            args={"tokens": int(plens[i]), "emitted": 1})
            self._obs_first(req)
            self.active[req.slot] = req
            self.lengths[req.slot] = plens[i]
            self.remaining[req.slot] = req.max_new_tokens - 1
            self.last_tok[req.slot] = t
            emitted.append((req.rid, t))
            if (t == self.eos or req.max_new_tokens <= 1
                    or req.pos >= self.max_len - 1):
                self._retire(req.slot, now)

    def _dispatch_decode(self, emitted: list):
        k_blk, s_n = self.decode_block, self.n_slots
        active_mask = np.zeros((s_n,), bool)
        for slot in self.active:
            active_mask[slot] = True
        # no active slot can emit more than min(remaining, room) tokens
        room = np.minimum(self.remaining, self.max_len - 1 - self.lengths)
        n_steps = int(min(k_blk, room[active_mask].max()))
        dev = self.device
        state = torch.as_tensor(np.stack([self.last_tok, self.lengths,
                                          active_mask.astype(np.int32),
                                          self.remaining]), device=dev)
        t0 = time.perf_counter()
        toks, emits, last, lengths, active, remaining, stats = \
            self._decode_impl(state[0], state[1], state[2].bool(), state[3],
                              torch.as_tensor(self.temps, device=dev),
                              n_steps, self._gen_if(self.temps))
        # ONE device->host copy for the whole block
        host = torch.cat([toks.flatten(), emits.flatten().to(torch.int32),
                          last, lengths, active.to(torch.int32), remaining,
                          stats]).cpu().numpy()
        self.sync_count += 1
        now = time.perf_counter()
        n = k_blk * s_n
        toks = host[:n].reshape(k_blk, s_n)
        emits = host[n:2 * n].reshape(k_blk, s_n).astype(bool)
        last, lengths, active, remaining = (
            host[2 * n + j * s_n:2 * n + (j + 1) * s_n].copy()
            for j in range(4))
        active = active.astype(bool)
        dstats = host[2 * n + 4 * s_n:]
        self.t_decode_s += now - t0
        self.steps_dispatched += k_blk
        self.steps_run += n_steps
        self._c_decode_disp.inc()
        self._c_decode_tokens.inc(int(dstats[0]))
        self._c_tokens.inc(int(dstats[0]))
        self._c_eos.inc(int(dstats[1]))
        self._c_requant.inc(0)                   # bf16 pools: no scales
        tr = self.tracer
        if tr.enabled:
            tr.complete("decode_block", 0, t0, now, pid=PID_ENGINE,
                        args={"rows": len(self.active), "steps": k_blk,
                              "tokens": int(dstats[0])})
            tr.counter("utilization",
                       {"queue_depth": len(self.queue),
                        "slots_active": len(self.active),
                        "pages_used": self.alloc.n_pages
                        - len(self.alloc.free)}, ts=now)
            for slot, req in self.active.items():
                n_tok = int(emits[:, slot].sum())
                if n_tok:
                    tr.complete("decode_block", req.rid, t0, now,
                                args={"tokens": n_tok})
        for i in range(k_blk):
            for slot in list(self.active):
                if emits[i, slot]:
                    req = self.active[slot]
                    req.out_tokens.append(int(toks[i, slot]))
                    req.pos += 1
                    emitted.append((req.rid, int(toks[i, slot])))
        self.last_tok, self.lengths, self.remaining = (last, lengths,
                                                       remaining)
        for slot in list(self.active):
            if not active[slot]:
                self._retire(slot, now)

    def step(self) -> List[tuple]:
        """One engine tick: batched admission (if anything is queued),
        then one fused ``decode_block``-step decode dispatch.  Returns
        [(rid, token), ...] emitted this tick."""
        emitted: List[tuple] = []
        if self.queue and self.free:
            admitted = self._try_admit()
            if admitted:
                self._dispatch_admit(admitted, emitted)
        if self.active:
            self._dispatch_decode(emitted)
        return emitted

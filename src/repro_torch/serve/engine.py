"""Continuous-batching serving engines.

Slot-based: a fixed decode batch of ``n_slots``; each request is prefilled
into a free slot, then all active slots decode in lock-step, and finished
slots free at once.  The port of ``repro/serve/engine.py``'s two engines:

``Engine`` — the eager engine: batch-1 prefill of each admitted request
into its slot, one batched decode step per tick, host-side sampling, and
one device->host sync per generated token.  It serves attention decoders
over contiguous per-slot caches (bf16, or int8 / fp8 with per-position
scales; sliding windows included), attention-free (RWKV-6) decoders and
Mamba hybrids (jamba), whose per-slot cache holds a constant-size
recurrent state for each RWKV-6 or Mamba block.

``PagedEngine`` — queued requests are admitted in ONE right-padded,
power-of-two-bucketed prefill whose K/V is scattered into the page pools;
then every active slot decodes in lock-step through the paged-attention
kernel.  Sampling happens on the device (greedy, or temperature through a
``torch.Generator``), and ``decode_block`` steps run per dispatch with
per-slot EOS / budget masks kept on the device, so the host reads the
device once per block instead of once per token (``sync_count`` audits
this: one per admission batch plus one per decode block, as in the
reference).

Every engine takes an off-by-default ``DispatchProfiler``
(``repro_torch.obs.profile``): each dispatch records the two host clock
reads the engine already takes, the second after the host read that ends
the dispatch, so profiling adds no sync.  ``run_open_loop`` drives an
engine with open-loop arrivals.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.roofline import CollectiveStats
from repro_torch.models.transformer import block_kinds
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import DispatchProfiler
from repro_torch.obs.trace import PID_ENGINE, Tracer
from repro_torch.resil.errors import OUTCOMES
from repro_torch.serve.paged import (PAGE, OutOfPagesError, PageAllocator,
                                     _attn_nodes, scatter_prefill_cache,
                                     set_block_table_rows)
from repro_torch.sharding.collectives import all_reduce
from repro_torch.sharding.tp import shard_model

#: the start of a sharded engine's refusal of host decisions that read the
#: wall clock (each rank's own; ranks that decide apart split the streams)
_SAME_DECISIONS = ("under a model axis > 1 every rank must take the same "
                   "host decisions, so a sharded engine takes ")


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
    # --- scheduler surface (repro_torch.sched; inert under PagedEngine) ---
    slo_ttft: Optional[float] = None   # per-request TTFT target, seconds
    slo_tpot: Optional[float] = None   # per-request TPOT target, seconds
    prefix_hit_tokens: int = 0         # prompt tokens served from cache
    preemptions: int = 0
    progress: int = 0                  # prefill tokens already cached
    rejected: bool = False
    # --- resilience surface (repro_torch.resil; inert without chaos) ---
    outcome: Optional[str] = None      # one of OUTCOMES, set at retire
    retries: int = 0                   # transient-fault recovery attempts
    not_before: float = 0.0            # backoff gate for re-admission
    retry_after_s: Optional[float] = None   # shed hint for the client


class _EngineBase:
    """Request intake, slot bookkeeping, metrics and tracing."""

    #: the KV layout the cost model prices for this engine
    kv_layout = "contiguous"

    def __init__(self, lm, params, *, n_slots: int, max_len: int,
                 eos_id: int, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 profiler: Optional[DispatchProfiler] = None):
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
        # per-dispatch wall-clock profiling (off by default): record()
        # only consumes host clock reads taken below anyway, so
        # sync_count and token streams are identical with it on or off
        self.profiler = (profiler if profiler is not None
                         else DispatchProfiler(enabled=False))
        self.profiler.bind(lm.cfg, model_parallel=lm.cfg.model_parallel,
                           layout=self.kv_layout)
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
# Eager engine


def has_source(cfg) -> bool:
    """True for a model that reads a ``modality_input`` (an encoder, or
    cross-attention blocks)."""
    return cfg.encoder is not None or cfg.cross_attn_every > 0


class Engine(_EngineBase):
    """The reference's eager ``Engine``: each admission prefills its
    prompt alone (batch 1) into its slot of the contiguous cache, then one
    decode step runs every slot, and the host reads the logits and samples
    (greedy, or from ``np.random.default_rng(seed)`` at a temperature) —
    one host sync per admission and one per decode step (``sync_count``).

    An attention slot's rows past its prompt keep whatever the slot's
    previous occupant left there; decode never reads them (it masks keys
    past each row's position) and overwrites them as it goes; an MLA
    slot's latent rows (``c_kv`` / ``k_pe``) likewise.  Differences from
    the reference, both deliberate: an RWKV-6 or Mamba slot's recurrent
    state (``wkv`` / ``x_prev``, ``ssm`` / ``conv``) is zeroed at
    admission (the reference prefills from whatever the slot's previous
    occupant left, so a reused slot changes the stream); and an
    encoder or cross-attention model is refused here, with a message (the
    reference's ``Engine`` passes no ``modality_input`` and fails its
    first admission on ``assert cross_src is not None``).  Those models
    run through ``LM.prefill(modality_input=)`` and ``LM.decode_step``."""

    def __init__(self, lm, params, *, n_slots: int = 4, max_len: int = 512,
                 eos_id: int = -1, seed: int = 0, metrics=None, tracer=None,
                 profiler=None):
        block_kinds(lm.cfg)          # refuses unknown block kinds
        if has_source(lm.cfg):
            raise ValueError(
                f"{lm.cfg.name}: the eager Engine passes no modality_input; "
                "run encoder / cross-attention models through "
                "LM.prefill(modality_input=) and LM.decode_step")
        super().__init__(lm, lm.prepare(params), n_slots=n_slots,
                         max_len=max_len, eos_id=eos_id, metrics=metrics,
                         tracer=tracer, profiler=profiler)
        self.device = lm.device
        self.rng = np.random.default_rng(seed)
        self.cache = lm.init_cache(n_slots, max_len)
        self.sync_count = 0                      # device->host transitions
        self.metrics.counter("serve_host_syncs_total",
                             "device->host sync points",
                             fn=lambda: self.sync_count)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _prefill_slot(self, prompt: np.ndarray, slot: int) -> torch.Tensor:
        """Batch-1 prefill of ``prompt`` into slot ``slot`` of the engine
        cache (in place); returns its last-token logits (V,) on the
        device.  Attention blocks write positions [0, len) of the slot's
        rows through views (scales included); RWKV-6 and Mamba blocks run
        from a zero state that is copied into the slot."""
        tokens = torch.as_tensor(prompt, device=self.device).long()[None]
        sub = [{blk: ({"kv": {n: t[slot:slot + 1]
                              for n, t in node["kv"].items()}}
                      if "kv" in node else
                      {"state": {n: torch.zeros_like(t[slot:slot + 1])
                                 for n, t in node["state"].items()}})
                for blk, node in group.items()} for group in self.cache]
        logits, sub = self.lm.prefill(self.params, tokens, sub)
        for group, new in zip(self.cache, sub):
            for blk, node in group.items():
                for name, leaf in node.get("state", {}).items():
                    leaf[slot:slot + 1].copy_(new[blk]["state"][name])
        return logits[0]

    def _sample(self, logits: np.ndarray, temp: float) -> int:
        if temp <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / temp)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def _retire(self, req: Request, slot: int) -> None:
        req.done = True
        self.free.append(slot)
        self._obs_retire(req)

    # ------------------------------------------------------------------
    def step(self) -> List[tuple]:
        """One engine tick: admit waiting requests into free slots
        (prefill), then one batched decode step.  Returns [(rid, token),
        ...] emitted this tick."""
        emitted = []
        while self.queue and self.free:
            req = self.queue.popleft()
            slot = self.free.popleft()
            req.slot = slot
            req.t_admit = time.perf_counter()
            plen = len(req.prompt)
            logits = self._prefill_slot(req.prompt, slot).cpu().numpy()
            self.sync_count += 1                 # <- sync (1 per admission)
            t1 = time.perf_counter()
            self.t_prefill_s += t1 - req.t_admit
            prof = self.profiler
            if prof.enabled:
                prof.record("admit", req.t_admit, t1, tokens=plen, rows=1,
                            bucket=plen, ctx=plen)
            self._obs_admit(req, req.t_admit, first=True)
            tok = self._sample(logits, req.temperature)
            req.out_tokens.append(tok)
            req.pos = plen
            req.t_first = time.perf_counter()
            self.tracer.complete("prefill", req.rid, req.t_admit,
                                 req.t_first, args={"tokens": plen,
                                                    "emitted": 1})
            self._obs_first(req)
            self._c_tokens.inc()
            emitted.append((req.rid, tok))
            if (tok == self.eos or req.max_new_tokens <= 1
                    or req.pos >= self.max_len - 1):
                req.t_done = req.t_first  # EOS / budget hit on first token
                self._retire(req, slot)
            else:
                self.active[slot] = req

        if not self.active:
            return emitted

        # batched decode: every slot steps; free slots step garbage in
        # their own rows / state, which the next admission overwrites
        tokens = np.zeros((self.n_slots,), np.int64)
        pos_by_slot = np.zeros((self.n_slots,), np.int32)
        for slot, req in self.active.items():
            tokens[slot] = req.out_tokens[-1]
            pos_by_slot[slot] = req.pos
        t0 = time.perf_counter()
        logits, self.cache = self.lm.decode_step(
            self.params, torch.as_tensor(tokens, device=self.device),
            self.cache, torch.as_tensor(pos_by_slot, device=self.device))
        logits = logits.cpu().numpy()            # <- sync (1 per step)
        self.sync_count += 1
        t1 = time.perf_counter()
        self.t_decode_s += t1 - t0
        tr = self.tracer
        if tr.enabled:
            tr.complete("decode_step", 0, t0, t1, pid=PID_ENGINE,
                        args={"rows": len(self.active)})
            tr.counter("utilization", {"queue_depth": len(self.queue),
                                       "slots_active": len(self.active)},
                       ts=t1)
        prof = self.profiler
        if prof.enabled:
            prof.record("decode_block", t0, t1, tokens=len(self.active),
                        rows=len(self.active), steps=1, bucket=1,
                        ctx=int(pos_by_slot.max()))
        for slot, req in list(self.active.items()):
            tok = self._sample(logits[slot], req.temperature)
            req.out_tokens.append(tok)
            req.pos += 1
            self._c_tokens.inc()
            if tr.enabled:
                tr.complete("decode_step", req.rid, t0, t1,
                            args={"tokens": 1})
            emitted.append((req.rid, tok))
            if (tok == self.eos or
                    len(req.out_tokens) >= req.max_new_tokens or
                    req.pos >= self.max_len - 1):
                req.t_done = time.perf_counter()
                del self.active[slot]
                self._retire(req, slot)
        return emitted


# ---------------------------------------------------------------------------
# Open-loop driving


def engine_busy(eng) -> bool:
    """True while the engine has queued or in-flight work (including a
    scheduler's mid-prefill slots)."""
    return bool(eng.queue or eng.active or getattr(eng, "_prefilling",
                                                   None))


def run_open_loop(eng, prompts, offsets, **submit_kw):
    """Submit ``prompts[i]`` at wall-clock offset ``offsets[i]`` seconds
    from now (open-loop arrivals), stepping the engine between arrivals
    and sleeping only when it is idle.  Returns the request ids in
    prompt order; drive results out of ``eng.registry``."""
    t0 = time.perf_counter()
    pending = sorted(zip(offsets, range(len(prompts))))
    ids: List[Optional[int]] = [None] * len(prompts)
    while pending or engine_busy(eng):
        now = time.perf_counter() - t0
        while pending and pending[0][0] <= now:
            _, i = pending.pop(0)
            ids[i] = eng.submit(prompts[i], **submit_kw)
        if not engine_busy(eng):
            if pending:
                time.sleep(min(pending[0][0] - now, 0.005))
            continue
        eng.step()
    return ids


# ---------------------------------------------------------------------------
# Paged engine


def _gumbel_argmax(scores: torch.Tensor,
                   gen: torch.Generator) -> torch.Tensor:
    """One sample of softmax(scores) along the last axis by the Gumbel-max
    trick, noise from ``gen``."""
    u = torch.rand(scores.shape, generator=gen, device=scores.device)
    return torch.argmax(scores - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


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
    return torch.where(temps > 0, _gumbel_argmax(logits / t, gen), greedy)


def _scale_snapshot(cache) -> Optional[torch.Tensor]:
    """Every quantized page-scale entry of a model cache's real pages,
    flattened into one new tensor (None for bf16 pools, which carry no
    scales).  The null page (row 0) is left out: free slots' duplicate
    writes set its scale in no fixed order on CUDA, and nothing reads it."""
    scales = [node[name][1:].reshape(-1) for node in _attn_nodes(cache)
              for name in ("k_scales", "v_scales") if name in node]
    return torch.cat(scales) if scales else None


def _pow2_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class PagedEngine(_EngineBase):
    """Continuous batching over a paged KV cache with a host-read-free
    inner loop (see module docstring).  Requires an attention-only
    decoder (no RWKV-6 or Mamba block) without a sliding window, MLA, an
    encoder or cross-attention, as the reference asserts."""

    kv_layout = "paged"

    def __init__(self, lm, params, *, n_slots: int = 4, max_len: int = 512,
                 eos_id: int = -1, seed: int = 0, page_size: int = PAGE,
                 decode_block: int = 8, n_pages: Optional[int] = None,
                 mesh=None, metrics=None, tracer=None, profiler=None,
                 injector=None):
        cfg = lm.cfg
        block_kinds(cfg)             # refuses unknown block kinds
        a = cfg.attention
        if a is None or a.window is not None or a.kind == "mla" \
                or has_source(cfg) \
                or any(k != "attn" for k in cfg.block_pattern):
            raise ValueError("PagedEngine needs an attention-only decoder "
                             "(no RWKV-6 or Mamba block, no MLA, no encoder "
                             "or cross-attention, no sliding window); serve "
                             f"{cfg.name} through the eager Engine")
        # sharded serving: a mesh whose model axis is > 1 serves this
        # rank's slice of the weights and kv heads (repro_torch.sharding);
        # every rank runs this host loop and makes the same decisions.
        # mesh=None (or a model axis of 1) is the unsharded path
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        if self.mesh is not None:
            if injector is not None:
                raise ValueError(_SAME_DECISIONS + "no chaos injector")
            lm, params = shard_model(lm, params, self.mesh)
        super().__init__(lm, lm.prepare(params), n_slots=n_slots,
                         max_len=max_len, eos_id=eos_id, metrics=metrics,
                         tracer=tracer, profiler=profiler)
        self.device = lm.device
        self.page_size = page_size
        self.decode_block = decode_block
        from repro_torch.kvcache import paged_pool_shape
        pages_per_slot, default_pages = paged_pool_shape(n_slots, max_len,
                                                         page_size)
        if n_pages is None:
            n_pages = default_pages                  # incl. null page 0
        self.alloc = PageAllocator(n_pages, pages_per_slot, n_slots)
        # the chaos harness (repro_torch.resil): consulted at the
        # allocator and at every dispatch boundary while enabled
        self.injector = injector
        if injector is not None:
            self.alloc.injector = injector
            injector.register_metrics(self.metrics)
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
            "quantized page-scale entries of real pages (not the null "
            "page) changed by device KV writes")
        self._c_prefill_disp = m.counter(
            "serve_prefill_dispatches_total",
            "batched prefill / chunk dispatches")
        self._c_decode_disp = m.counter(
            "serve_decode_dispatches_total", "fused decode-block dispatches")
        #: the collectives of the fused decode dispatches (sharded only)
        self.decode_collectives = CollectiveStats()
        if self.mesh is not None:
            st = self.mesh.stats
            for op in ("all-reduce", "all-gather"):
                key = f"{op}/model"
                m.counter("tp_collective_bytes_total",
                          "per-rank collective bytes by op",
                          fn=lambda key=key: st.bytes_by_op.get(key, 0.0),
                          op=op)
                m.counter("tp_collective_calls_total",
                          "per-rank collective calls by op",
                          fn=lambda key=key: st.count_by_op.get(key, 0),
                          op=op)
            m.gauge("tp_collective_bytes_per_decode_step",
                    "per-rank collective bytes of a fused decode step",
                    fn=lambda: self.decode_collectives.total_bytes
                    / max(self.steps_run, 1))

    def _global_count(self, n: torch.Tensor) -> torch.Tensor:
        """A count over this rank's kv heads, summed over the model group
        (so a sharded engine's counters equal a single rank's)."""
        if self.mesh is None:
            return n
        return all_reduce(n.float(), "sum", self.mesh).to(n.dtype)

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
        reaches.  ``stats`` counts [tokens emitted, EOS fires, quantized
        page-scale entries of real pages the block changed] on the device
        (the reference's ``_kv_scale_change_count``, which also counts the
        null page's)."""
        eos, max_len = self.eos, self.max_len
        s_n = tokens.shape[0]
        toks = torch.empty((self.decode_block, s_n), dtype=torch.int32,
                           device=self.device)
        emits = torch.zeros((self.decode_block, s_n), dtype=torch.bool,
                            device=self.device)
        stats = torch.zeros((3,), dtype=torch.int32, device=self.device)
        scales0 = _scale_snapshot(self.cache)
        for i in range(n_steps):
            logits, self.cache = self.lm.decode_step(self.params, tokens,
                                                     self.cache, lengths)
            nxt = _sample_batch(logits, temps, gen)
            nxt = torch.where(active, nxt, tokens)
            stats[:2] += torch.stack([active.sum(),
                                      (active & (nxt == eos)).sum()
                                      ]).to(torch.int32)
            emits[i] = active
            lengths = torch.where(active, lengths + 1, lengths)
            remaining = torch.where(active, remaining - 1, remaining)
            done = (nxt == eos) | (remaining <= 0) | (lengths >= max_len - 1)
            active = active & ~done
            tokens = nxt
            toks[i] = tokens
        toks[n_steps:] = tokens
        if scales0 is not None:
            stats[2] = self._global_count(
                (_scale_snapshot(self.cache) != scales0).sum())
        return toks, emits, tokens, lengths, active, remaining, stats

    # ------------------------------------------------------------------
    # host loop

    def _maybe_inject(self, kind: str) -> None:
        """Chaos hook at the host side of a dispatch boundary: no-op
        without an enabled injector; may sleep (latency spike) or raise
        :class:`~repro_torch.resil.errors.InjectedFault` BEFORE any state
        or device work of the dispatch."""
        inj = self.injector
        if inj is not None and inj.enabled:
            inj.pre_dispatch(kind)

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
        self._maybe_inject("admit")
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
        prof = self.profiler
        if prof.enabled:
            prof.record("admit", t0, now, tokens=int(plens.sum()),
                        rows=len(admitted), bucket=plen_pad, ctx=plen_pad)
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
        self._maybe_inject("decode_block")
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
        coll0 = None if self.mesh is None else self.mesh.stats.copy()
        t0 = time.perf_counter()
        toks, emits, last, lengths, active, remaining, stats = \
            self._decode_impl(state[0], state[1], state[2].bool(), state[3],
                              torch.as_tensor(self.temps, device=dev),
                              n_steps, self._gen_if(self.temps))
        if coll0 is not None:
            self.decode_collectives.merge(self.mesh.stats.since(coll0))
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
        self._c_requant.inc(int(dstats[2]))
        prof = self.profiler
        if prof.enabled:
            prof.record("decode_block", t0, now, tokens=int(dstats[0]),
                        rows=len(self.active), steps=k_blk, bucket=k_blk,
                        ctx=int(self.lengths.max()))
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

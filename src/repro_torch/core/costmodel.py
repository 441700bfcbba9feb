"""Analytic cost model on an H100 tier: Lat / Mem / Energy for a config.

The port's copy of ``repro/core/costmodel.py``.  A roofline model over the
*applied* ModelConfig:

  latency = T_prefill(512) + 128 · T_decode      (paper Appendix A.2
            measurement protocol: 512-token prompt, 128 generated)
  T_phase = max(FLOPs/peak, HBM_bytes/bw, collective_bytes/link)
  memory  = weights(quant-aware) + KV cache + activation high-water
  energy  = Σ_phase T·(idle + (tdp−idle)·util)   per chip × chips

Every peak is a field of the :class:`HwTier` being priced; the port's
tiers are ``h100-1`` (one H100 SXM at its data sheet's dense rates),
``h100-8`` (an HGX board) and ``h100-256`` (a SuperPOD's NVLink domain),
with the paper's ``consumer`` / ``datacenter`` / ``high_perf`` mapped onto
them in that order.  The runtime reads the same rooflines: SJF / EDF
admission (``repro_torch.sched.policy``), the degradation ladder's rung
prices, the speculative controller's quantized-decode rescale, and the
online calibration (:class:`CalibratedCostModel`) that folds measured
dispatch times (``repro_torch.obs.profile``) back into the estimates.

KV bytes are priced per layout: the paged engines pass ``layout="paged"``
(scales of quantized pools spread over a page), everything else the
contiguous default.  The reference picks the layout from its config's
``decode_attn_impl``, a field the port does not have.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.core.apply import apply_efficiency_config
from repro_torch.core.space import EfficiencyConfig
from repro_torch.kvcache.spec import kv_bytes_per_token


@dataclass(frozen=True)
class HwTier:
    name: str
    chips: int
    mem_cap: float           # bytes per chip
    power_budget: float      # watts total
    peak_flops_bf16: float   # FLOP/s per chip, dense
    peak_flops_int8: float   # op/s per chip, dense
    hbm_bw: float            # B/s per chip
    link_bw: float           # B/s per link (the decode collective term)
    links: int               # links per chip
    tdp_watts: float         # per chip (energy model)
    idle_watts: float        # per chip (energy model)


#: the idle card's ``power.draw``: median of 15 nvidia-smi samples a
#: second apart (71.19-128.66 W, the first two settling) on an NVIDIA H100
#: 80GB HBM3 at a 700 W limit, 2026-10-17 (``launch/idle_power.py``)
H100_IDLE_WATTS = 71.29


def _h100_tier(name: str, chips: int) -> HwTier:
    """``chips`` H100 SXM cards (NVIDIA data sheet, dense rates at 700 W:
    bf16 989.4 TFLOP/s, int8 1,978.9 TOP/s, 80 GB of HBM3 at 3.35 TB/s) in
    one NVLink 4 domain, 18 links of 50 GB/s a card through NVSwitch
    (unused at one card)."""
    return HwTier(name, chips, mem_cap=80e9, power_budget=700.0 * chips,
                  peak_flops_bf16=989.4e12, peak_flops_int8=1978.9e12,
                  hbm_bw=3.35e12, link_bw=50e9, links=18, tdp_watts=700.0,
                  idle_watts=H100_IDLE_WATTS)


# one card; one HGX H100 8-GPU board; a DGX H100 SuperPOD, 256 cards in
# one NVLink Switch System domain
TIERS = {name: _h100_tier(name, chips)
         for name, chips in (("h100-1", 1), ("h100-8", 8),
                             ("h100-256", 256))}
# The paper's hardware tiers (an RTX 4090, an A100-80GB, 8 × H200) mapped
# onto H100 tiers of 1, 8 and 256 cards, as the reference maps them onto
# its 1-, 8- and 256-chip tiers.  Pricing the paper's own cards would
# need their measured idle draws, and the port runs on H100s only.
TIERS["consumer"] = TIERS["h100-1"]
TIERS["datacenter"] = TIERS["h100-8"]
TIERS["high_perf"] = TIERS["h100-256"]

BYTES = {"bf16": 2.0, "fp8": 1.0, "int8": 1.0, "int4": 0.5}

# --- speculative decoding (repro_torch.spec; c_inf "spec" arm) -------------
# Workload-prior acceptance rates per drafter arm: acceptance is
# task-dependent (repetitive / retrieval text accepts most drafts,
# free-form text few), so the offline predictor needs a prior while the
# runtime controller measures the real rate.
SPEC_ACCEPT_RATE = {"none": 0.0, "ngram": 0.35, "draft": 0.6}
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


def _weight_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * BYTES.get(cfg.quant, 2.0)


def _active_weight_bytes(cfg: ModelConfig) -> float:
    return cfg.active_param_count() * BYTES.get(cfg.quant, 2.0)


def _kv_bytes_per_token(cfg: ModelConfig, layout: str) -> float:
    """Real stored bytes/token from the kvcache spec — per-dtype element
    sizes (bf16: 2, int8/fp8: 1) plus the fp32 scale tensors a quantized
    cache carries, per layout (the paged layout amortizes scales over the
    page)."""
    return kv_bytes_per_token(cfg, layout=layout)


def _flops_per_token(cfg: ModelConfig, ctx_len: int) -> float:
    """Forward FLOPs/token: 2·N_active + attention term 2·2·L_attn·d_kv·ctx."""
    n_act = cfg.active_param_count()
    a = cfg.attention
    attn_fl = 0.0
    if a is not None and "attn" in cfg.block_pattern:
        n_attn = sum(1 for b in cfg.block_pattern if b == "attn") \
            * cfg.num_groups
        span = min(ctx_len, a.window) if a.window else ctx_len
        attn_fl = 4.0 * n_attn * a.num_heads * a.head_dim * span
    return 2.0 * n_act + attn_fl


def chunk_prefill_hbm_bytes(cfg: ModelConfig, prompt: int, *, chunk: int,
                            fused: bool = True, horizon: int = None,
                            batch: int = 1,
                            layout: str = "contiguous") -> float:
    """HBM bytes for a CHUNKED prefill of ``prompt`` tokens against a
    paged cache, ``chunk`` tokens per dispatch (the scheduler's
    continuation path).

    ``fused=True`` prices the streamed prefix-extend kernel (B2): each
    chunk reads the active weights once, streams only its ACTUAL prefix
    from the pages at stored pool bytes (int8/fp8 pools stream at 1
    byte/elem), and writes the chunk once.

    ``fused=False`` prices a full-horizon gather: every chunk
    materializes the slot's full padded page ``horizon`` (default: the
    prompt's own page span) as an fp32 context — pool read + fp32 write
    + fp32 read-back — regardless of how little prefix exists yet.

    ``batch`` scales the per-row stream/write terms only: one chunk
    dispatch serves every row, so the active weights are read once per
    chunk regardless of batch."""
    kv_tok = _kv_bytes_per_token(cfg, layout)
    # fp32 bytes/token of a dequantized context copy = 2x the bf16 store
    # (bf16 carries no scale tensors, so this is exactly the element
    # bytes doubled)
    f32_tok = 2.0 * _kv_bytes_per_token(
        cfg.with_(kv_cache_dtype="bfloat16"), layout)
    awbytes = _active_weight_bytes(cfg)
    prompt = max(int(prompt), 1)
    chunk = max(int(chunk), 1)
    # closed form (this sits on the scheduler's per-tick policy path):
    # chunk i starts at prefix i*chunk, so streamed prefixes sum to
    # chunk * n(n-1)/2 and the chunk writes sum to the prompt
    n = -(-prompt // chunk)
    total = n * awbytes + batch * prompt * kv_tok        # weights + writes
    if fused:
        total += batch * kv_tok * chunk * n * (n - 1) / 2.0
    else:
        hz = horizon if horizon is not None else prompt
        total += batch * n * hz * (kv_tok + 2.0 * f32_tok)
    return total


def _peak_flops(cfg: ModelConfig, tier: HwTier) -> float:
    """Per-chip peak FLOPs for this config: the tier's int8 rate for int8
    weights, its bf16 rate otherwise (fp8 weights are widened to bf16 in
    registers by B6) — the ONE place the rate is chosen for both the
    search-time :func:`predict` and the runtime :func:`service_estimate`."""
    return tier.peak_flops_int8 if cfg.quant == "int8" \
        else tier.peak_flops_bf16


def _roofline_s(cfg: ModelConfig, tier: HwTier, flops: float,
                hbm_bytes: float) -> float:
    """Phase time = max(compute, HBM) across the tier's chips."""
    return max(flops / (tier.chips * _peak_flops(cfg, tier)),
               hbm_bytes / (tier.chips * tier.hbm_bw))


def _decode_collective_bytes(cfg: ModelConfig, tier: HwTier,
                             batch: int) -> float:
    """Link bytes per decode step under kv-head-sharded TP: 2 all-reduced
    activations per block (attention wo + MLP down contractions), d_model
    wide, bf16 payload, ring all-reduce ≈ 2× the payload.  No KV term:
    the paged pools are sharded by kv head, so decode attention moves no
    KV over the interconnect."""
    if tier.chips <= 1:
        return 0.0
    return 2 * cfg.num_layers * batch * cfg.d_model * 2.0 * 2.0


def _decode_collective_s(cfg: ModelConfig, tier: HwTier,
                         batch: int) -> float:
    """TP all-reduce per decode step; zero on single-chip tiers."""
    coll = _decode_collective_bytes(cfg, tier, batch)
    return coll / (tier.chips * tier.link_bw * tier.links)


def service_estimate(cfg: ModelConfig, tier: HwTier = TIERS["h100-1"], *,
                     prompt: int, gen: int, chunk: int = None,
                     layout: str = "contiguous") -> Dict[str, float]:
    """Per-request roofline work estimate for scheduler policies
    (``repro_torch.sched.policy``): prefill seconds and per-decode-token
    seconds for ONE request at batch 1 on ``tier`` — the same rooflines
    as :func:`predict` (shared helpers, collective decode term included),
    reduced to what admission ordering needs: shortest-job-first ranks by
    ``t_total_s`` and deadline-EDF converts it into slack.  Absolute
    numbers are tier-relative; what matters is the ranking they induce
    across requests of different prompt/generation lengths.

    ``chunk`` prices the scheduler's chunked prefill: per-chunk weight
    re-reads plus STREAMED prefix pages (the prefix-extend kernel;
    :func:`chunk_prefill_hbm_bytes`)."""
    awbytes = _active_weight_bytes(cfg)
    kv_tok = _kv_bytes_per_token(cfg, layout)
    prompt = max(int(prompt), 1)
    gen = max(int(gen), 0)
    if chunk is not None and prompt > chunk:
        by_pf = chunk_prefill_hbm_bytes(cfg, prompt, chunk=chunk,
                                        layout=layout)
    else:
        by_pf = awbytes + prompt * kv_tok
    t_pf = _roofline_s(cfg, tier,
                       prompt * _flops_per_token(cfg, max(prompt // 2, 1)),
                       by_pf)
    ctx = prompt + max(gen, 1) // 2
    t_coll = _decode_collective_s(cfg, tier, 1)
    t_dec = _roofline_s(cfg, tier, _flops_per_token(cfg, ctx),
                        awbytes + ctx * kv_tok) + t_coll
    # per-decode-step HBM split: weight-stream vs KV bytes, both
    # quant-aware, so SJF/EDF ordering and the spec controller see what
    # int8/fp8 weight streaming buys in the memory-bound decode regime
    return {"t_prefill_s": t_pf, "t_decode_tok_s": t_dec,
            "t_total_s": t_pf + gen * t_dec,
            "weight_bytes_decode": awbytes,
            "kv_bytes_decode": ctx * kv_tok,
            "hbm_bytes_decode": awbytes + ctx * kv_tok,
            # link collective traffic per decode step (0 on 1-chip tiers)
            "ici_collective_bytes_decode":
                _decode_collective_bytes(cfg, tier, 1),
            "t_collective_decode_s": t_coll}


def rung_estimate(cfg: ModelConfig, tier=TIERS["h100-1"], *,
                  spec_off: bool = False, prefill_chunk: int = None,
                  kv_dtype: str = None, prompt: int = 256,
                  gen: int = 64,
                  layout: str = "contiguous") -> Dict[str, float]:
    """Price ONE degradation-ladder rung (``repro_torch.resil.degrade``)
    with the same rooflines the offline ``c_inf`` search uses: the rung's
    overrides (spec gated off, shrunken prefill chunk, KV-dtype hint)
    applied to ``cfg`` and run through :func:`service_estimate`.

    ``tier`` accepts a :class:`HwTier` or a :data:`TIERS` key; spec is
    priced via :func:`spec_speedup` on the decode term (the only place
    the per-request estimate sees the spec arm)."""
    if isinstance(tier, str):
        tier = TIERS[tier]
    if kv_dtype is not None:
        cfg = cfg.with_(kv_cache_dtype=kv_dtype)
    spec = getattr(cfg, "spec_decode", "none")
    est = service_estimate(cfg, tier, prompt=prompt, gen=gen,
                           chunk=prefill_chunk, layout=layout)
    if spec != "none" and not spec_off:
        k = getattr(cfg, "spec_draft_k", 0)
        speed = spec_speedup(SPEC_ACCEPT_RATE.get(spec, 0.0), k,
                             draft_cost=SPEC_DRAFT_COST.get(spec, 0.05))
        est["t_decode_tok_s"] /= speed
        est["t_total_s"] = est["t_prefill_s"] + gen * est["t_decode_tok_s"]
    return {"spec_off": bool(spec_off),
            "prefill_chunk": prefill_chunk,
            "kv_dtype": kv_dtype,
            "t_prefill_s": est["t_prefill_s"],
            "t_decode_tok_s": est["t_decode_tok_s"],
            "t_total_s": est["t_total_s"],
            "hbm_bytes_decode": est["hbm_bytes_decode"]}


def quant_decode_scale(cfg: ModelConfig, tier: HwTier = TIERS["h100-1"], *,
                       prompt: int = 512, gen: int = 128,
                       layout: str = "contiguous") -> float:
    """Modeled decode-step time of ``cfg`` relative to the same config
    with bf16 weights (< 1 when weight quantization pays, e.g. ~0.5 for
    int8 in the weight-dominated regime).  The spec controller divides
    HOST-side draft costs by this: an n-gram lookup's absolute cost does
    not shrink when the target's verify step does, so its cost in
    decode-step units grows and the modeled-speedup argmax must see
    that."""
    if cfg.quant in ("bf16", "none", "fp16"):
        return 1.0
    t_q = service_estimate(cfg, tier, prompt=prompt, gen=gen,
                           layout=layout)["t_decode_tok_s"]
    t_b = service_estimate(cfg.with_(quant="bf16"), tier, prompt=prompt,
                           gen=gen, layout=layout)["t_decode_tok_s"]
    return t_q / max(t_b, 1e-12)


def predict(cfg_base: ModelConfig, eff: EfficiencyConfig, tier: HwTier, *,
            prompt: int = 512, gen: int = 128, batch: int = 1,
            spec_accept_rate: float = None,
            prefill_chunk: int = None,
            calibration: "CalibratedCostModel" = None,
            layout: str = "contiguous") -> Dict[str, float]:
    cfg = apply_efficiency_config(cfg_base, eff)
    chips = tier.chips
    peak = _peak_flops(cfg, tier)

    wbytes = _weight_bytes(cfg)
    awbytes = _active_weight_bytes(cfg)
    kv_tok = _kv_bytes_per_token(cfg, layout)

    # ---- prefill: compute-bound region ------------------------------------
    # ``prefill_chunk`` prices serving-style chunked prefill at the
    # prefix-extend kernel's streamed-page bytes instead of the one-shot
    # slab
    fl_prefill = batch * prompt * _flops_per_token(cfg, prompt // 2)
    if prefill_chunk is not None and prompt > prefill_chunk:
        by_prefill = chunk_prefill_hbm_bytes(cfg, prompt,
                                             chunk=prefill_chunk,
                                             batch=batch, layout=layout)
    else:
        by_prefill = awbytes + batch * prompt * kv_tok
    t_prefill = _roofline_s(cfg, tier, fl_prefill, by_prefill)

    # ---- decode: memory-bound region (reads active weights + KV/step) ----
    fl_dec = batch * _flops_per_token(cfg, prompt + gen // 2)
    by_dec = awbytes + batch * (prompt + gen // 2) * kv_tok
    # + TP all-reduce per layer in decode (2 per block, d_model acts)
    t_dec = _roofline_s(cfg, tier, fl_dec, by_dec) \
        + _decode_collective_s(cfg, tier, batch)

    # ---- speculative decoding (c_inf spec arm) ----------------------------
    # One verify round scores k+1 query positions in a single dispatch:
    # (k+1)x the decode FLOPs but the SAME HBM bytes (weights + KV are
    # read once), and emits E[a,k] = (1-a^(k+1))/(1-a) tokens, so the
    # effective per-token decode time divides by the expected haul.
    spec = getattr(cfg, "spec_decode", "none")
    if spec != "none" and gen > 0:
        k = cfg.spec_draft_k
        a = (SPEC_ACCEPT_RATE.get(spec, 0.0) if spec_accept_rate is None
             else spec_accept_rate)
        fl_ver = (k + 1) * fl_dec
        t_ver = _roofline_s(cfg, tier, fl_ver, by_dec) \
            + _decode_collective_s(cfg, tier, batch)
        t_round = t_ver + k * SPEC_DRAFT_COST.get(spec, 0.05) * t_dec
        t_dec = t_round / spec_tokens_per_step(a, k)

    # ---- measured calibration (repro_torch.obs.profile feedback loop) ----
    # multiplicative per-phase corrections fit online from profiled
    # dispatches; the analytic rooflines keep the *structure*, measurement
    # sets the level (EMA over log-ratio measured/predicted).
    if calibration is not None:
        t_prefill *= calibration.phase_scale("prefill")
        t_dec *= calibration.phase_scale("decode")

    latency = (t_prefill + gen * t_dec) * 1e3                    # ms

    # ---- memory high-water -------------------------------------------------
    act = batch * prompt * cfg.d_model * 2.0 * 4.0               # transient
    mem = (wbytes + batch * (prompt + gen) * kv_tok + act)       # bytes
    mem_gb = mem / 2**30

    # ---- energy -------------------------------------------------------------
    util_pf = min(1.0, fl_prefill / (chips * peak) / max(t_prefill, 1e-12))
    util_dec = min(1.0, fl_dec / (chips * peak) / max(t_dec, 1e-12))
    p_pf = tier.idle_watts + (tier.tdp_watts - tier.idle_watts) * util_pf
    p_dec = tier.idle_watts + (tier.tdp_watts - tier.idle_watts) * util_dec
    energy = chips * (t_prefill * p_pf + gen * t_dec * p_dec)    # joules

    power = chips * max(p_pf, p_dec)
    feasible = (mem / chips <= tier.mem_cap) and (power <= tier.power_budget)
    return {"latency_ms": latency, "memory_gb": mem_gb,
            "energy_j": energy, "power_w": power,
            "feasible": feasible,
            "flops_prefill": fl_prefill, "bytes_decode": by_dec}


# ---------------------------------------------------------------------------
# Per-dispatch estimates + online calibration (repro_torch.obs.profile loop)


# dispatch kinds -> the predict()/service_estimate() phase their
# corrections feed back into
PHASE_KINDS = {"prefill": ("admit", "prefill_chunk"),
               "decode": ("decode_block", "spec_round", "draft_propose")}


def _step_work(cfg: ModelConfig, *, kind: str, tokens: int, rows: int,
               bucket: int, ctx: int, layout: str) -> tuple:
    """(FLOPs, HBM bytes) of one step of a dispatch: a prefill's whole
    batch, one decode step, one verify of width ``bucket``, or the decode
    step a draft proposal is priced against."""
    awbytes = _active_weight_bytes(cfg)
    kv_tok = _kv_bytes_per_token(cfg, layout)
    rows = max(int(rows), 1)
    ctx = max(int(ctx), int(bucket), 1)
    if kind in ("admit", "prefill_chunk"):
        t = max(int(tokens), 1)
        flops = t * _flops_per_token(cfg, max(ctx // 2, 1))
        hbm = awbytes + t * kv_tok
        if kind == "prefill_chunk":
            # continuation chunks stream the live prefix from the pages
            hbm += rows * ctx * kv_tok
        return flops, hbm
    # decode-shaped dispatches share the per-step roofline
    fl_step = rows * _flops_per_token(cfg, ctx)
    by_step = awbytes + rows * ctx * kv_tok
    if kind == "spec_round":
        return max(int(bucket), 1) * fl_step, by_step
    if kind in ("decode_block", "draft_propose"):
        return fl_step, by_step
    raise ValueError(f"unknown dispatch kind {kind!r}")


def dispatch_work(cfg: ModelConfig, *, kind: str, tokens: int = 0,
                  rows: int = 1, steps: int = 1, bucket: int = 0,
                  ctx: int = 0, layout: str = "contiguous"):
    """(FLOPs, HBM bytes) the target model's device work of ONE dispatch
    needs, as :func:`dispatch_estimate` counts them (``steps`` decode
    steps for a ``decode_block``); None for ``draft_propose``, which the
    model prices as a fraction of a decode step, not as work of its own."""
    if kind == "draft_propose":
        return None
    fl, by = _step_work(cfg, kind=kind, tokens=tokens, rows=rows,
                        bucket=bucket, ctx=ctx, layout=layout)
    n = max(int(steps), 1) if kind == "decode_block" else 1
    return n * fl, n * by


def dispatch_estimate(cfg: ModelConfig, tier: HwTier = TIERS["h100-1"], *,
                      kind: str, tokens: int = 0, rows: int = 1,
                      steps: int = 1, bucket: int = 0, ctx: int = 0,
                      layout: str = "contiguous") -> float:
    """Analytic seconds for ONE engine dispatch of the given kind — the
    per-dispatch granularity of :func:`service_estimate`, shaped to what
    a :class:`repro_torch.obs.profile.ProfileSample` carries so measured
    and predicted service times compare one-to-one.

    * ``admit`` / ``prefill_chunk``: batched prefill of ``tokens`` real
      tokens (weights read once, KV written once, chunk continuations
      additionally stream their live prefix).
    * ``decode_block``: ``steps`` fused decode steps over ``rows``
      active slots at context ``ctx``.
    * ``spec_round``: one multi-query verify of width ``bucket`` —
      (k+1)× the decode FLOPs at the same HBM bytes.
    * ``draft_propose``: ``bucket`` draft tokens per row at the modeled
      per-token draft cost fraction.
    """
    fl, by = _step_work(cfg, kind=kind, tokens=tokens, rows=rows,
                        bucket=bucket, ctx=ctx, layout=layout)
    t = _roofline_s(cfg, tier, fl, by)
    if kind in ("admit", "prefill_chunk"):
        return t
    t_step = t + _decode_collective_s(cfg, tier, max(int(rows), 1))
    if kind == "decode_block":
        return max(int(steps), 1) * t_step
    if kind == "spec_round":
        return t_step
    # a draft dispatch happened, so spec_decode="none" on the config just
    # means the engine was built with an explicit drafter — fall back to
    # the cheapest modeled drafter, never 0 (a zero prediction is
    # uncalibratable: no factor can scale it)
    spec = getattr(cfg, "spec_decode", "none")
    frac = SPEC_DRAFT_COST.get(spec, 0.05) or SPEC_DRAFT_COST["ngram"]
    k = max(int(bucket), 1)
    return k * frac * t_step


class CalibratedCostModel:
    """Online measured-vs-predicted correction factors per
    (dispatch-kind × config-arm).

    Each profiled dispatch contributes ``log(measured / predicted)``
    into an EMA per ``(kind, arm)`` series; ``correction()`` returns
    ``exp(EMA)`` with a kind-level (sample-weighted) fallback for arms
    never profiled, and :meth:`phase_scale` folds the kind corrections
    back into :func:`predict`'s prefill/decode phase times.  JSON
    round-trips via :meth:`to_json` / :meth:`from_json` (the
    ``--calibration-out`` / ``--calibration-in`` artifact, the same file
    format as the reference's)."""

    def __init__(self, *, beta: float = 0.25):
        self.beta = float(beta)
        # (kind, arm) -> {"log_ratio": EMA, "n": samples}
        self.factors: Dict[tuple, dict] = {}

    # ------------------------------------------------------------------
    def update(self, kind: str, arm: str, measured_s: float,
               predicted_s: float) -> float:
        r = math.log(max(measured_s, 1e-12) / max(predicted_s, 1e-12))
        st = self.factors.get((kind, arm))
        if st is None:
            st = self.factors[(kind, arm)] = {"log_ratio": r, "n": 0}
        else:
            st["log_ratio"] = (1.0 - self.beta) * st["log_ratio"] \
                + self.beta * r
        st["n"] += 1
        return r

    def correction(self, kind: str, arm: str = None) -> float:
        """Multiplicative fix-up for an analytic per-dispatch estimate:
        exact (kind, arm) series if fit, else the kind-level
        sample-weighted mean, else 1.0 (uncalibrated)."""
        if arm is not None and (kind, arm) in self.factors:
            return math.exp(self.factors[(kind, arm)]["log_ratio"])
        num = den = 0.0
        for (k, _), st in self.factors.items():
            if k == kind:
                num += st["log_ratio"] * st["n"]
                den += st["n"]
        return math.exp(num / den) if den else 1.0

    def calibrate(self, kind: str, predicted_s: float,
                  arm: str = None) -> float:
        return predicted_s * self.correction(kind, arm)

    def phase_scale(self, phase: str) -> float:
        """exp of the sample-weighted mean log-ratio over the phase's
        dispatch kinds (1.0 when nothing was profiled)."""
        kinds = PHASE_KINDS.get(phase, ())
        num = den = 0.0
        for (k, _), st in self.factors.items():
            if k in kinds:
                num += st["log_ratio"] * st["n"]
                den += st["n"]
        return math.exp(num / den) if den else 1.0

    @property
    def n_samples(self) -> int:
        return sum(st["n"] for st in self.factors.values())

    # ------------------------------------------------------------------
    def fit_profile(self, profiler, cfg: ModelConfig,
                    tier: HwTier = TIERS["h100-1"], *,
                    layout: str = "contiguous") -> list:
        """Fold a :class:`~repro_torch.obs.profile.DispatchProfiler`'s
        samples in, *prequentially*: each sample is first predicted with
        the corrections fit so far (what an online controller would have
        used), then folded into the EMA.  Returns one record per sample
        with measured / analytic / calibrated seconds."""
        records = []
        for s in profiler.samples:
            pred = dispatch_estimate(cfg, tier, kind=s.kind,
                                     tokens=s.tokens, rows=s.rows,
                                     steps=s.steps, bucket=s.bucket,
                                     ctx=s.ctx, layout=layout)
            cal = self.calibrate(s.kind, pred, s.arm)
            self.update(s.kind, s.arm, s.dur_s, pred)
            records.append({"kind": s.kind, "arm": s.arm,
                            "measured_s": s.dur_s, "predicted_s": pred,
                            "calibrated_s": cal})
        return records

    # ------------------------------------------------------------------
    def register_metrics(self, registry) -> None:
        """Export ``costmodel_drift_ratio{kind=,arm=}`` (measured over
        predicted; 1.0 = the analytic model is exact) and the per-series
        sample counts."""
        g_drift = registry.gauge(
            "costmodel_drift_ratio",
            "measured/predicted dispatch service time (EMA of log-ratio)")
        g_n = registry.gauge(
            "costmodel_calibration_samples",
            "profiled dispatches folded into each calibration series")
        for (kind, arm), st in self.factors.items():
            g_drift.set(math.exp(st["log_ratio"]), kind=kind, arm=arm)
            g_n.set(st["n"], kind=kind, arm=arm)

    # ------------------------------------------------------------------
    def to_json(self) -> dict:
        return {"beta": self.beta,
                "factors": [{"kind": k, "arm": a,
                             "log_ratio": st["log_ratio"], "n": st["n"]}
                            for (k, a), st in sorted(self.factors.items())]}

    @classmethod
    def from_json(cls, blob: dict) -> "CalibratedCostModel":
        m = cls(beta=blob.get("beta", 0.25))
        for f in blob.get("factors", []):
            m.factors[(f["kind"], f["arm"])] = {
                "log_ratio": float(f["log_ratio"]), "n": int(f["n"])}
        return m

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path) -> "CalibratedCostModel":
        with open(path) as f:
            return cls.from_json(json.load(f))

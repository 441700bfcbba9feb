"""Configuration evaluation: the "actual hardware" step of Algorithm 1.

The port's copy of ``repro/core/evaluator.py``, analytic mode.  It returns
objective vectors ``[acc, lat_ms, mem_gb, en_j]``:

* ``analytic`` — the accuracy-effects model calibrated to the EfficientLLM/
  AE-LLM published findings (paper §5: int4 hurts numeric tasks ~2×; MLA
  helps understanding; optimal LoRA rank grows with model scale; RSLoRA
  scales better; MoE helps generation/code; int4×MoE routing instability),
  seeded noise for realism, and Lat/Mem/Energy from the cost model
  (``repro_torch.core.costmodel.predict``) at the evaluator's tier.

* ``proxy`` — trains a reduced same-family model with the applied config
  and reads its cross-entropy as the accuracy objective.  It needs the
  training path, which the port does not have yet (ROADMAP A7), so it
  raises instead of answering with analytic numbers.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import HwTier, predict
from repro_torch.core.features import TaskSpec
from repro_torch.core.space import EfficiencyConfig


# ---------------------------------------------------------------------------
# Analytic accuracy-effects model


def _seeded_noise(*keys, scale=0.1) -> float:
    h = hashlib.sha256("|".join(map(str, keys)).encode()).digest()
    return (int.from_bytes(h[:4], "little") / 2**32 - 0.5) * 2 * scale


def accuracy_model(cfg: ModelConfig, eff: EfficiencyConfig, task: TaskSpec,
                   base_acc: float) -> float:
    n = cfg.param_count()
    scale_b = n / 1e9
    d = 0.0
    # --- quantization (§5.3/§5.4) ----------------------------------------
    qd = {"bf16": 0.0, "fp8": -0.2, "int8": -0.4, "int4": -1.5}[eff.inf.quant]
    if task.numeric:
        qd *= 2.0
    qd *= {"gptq": 0.9, "awq": 0.8, "smoothquant": 0.95}.get(
        eff.inf.quant_method, 1.0) if eff.inf.quant != "bf16" else 1.0
    d += qd
    # --- attention kind (§5.1) --------------------------------------------
    d += {"mla": +0.3, "mha": +0.1, "gqa": 0.0, "mqa": -0.5}[
        eff.arch.attention] if "attn" in cfg.block_pattern else 0.0
    # --- KV-cache narrowing -------------------------------------------------
    d += {"full": 0.0, "gqa": -0.1, "mqa": -0.4}[eff.inf.kv_style]
    if task.domain == "long_context":
        d += {"full": 0.0, "gqa": -0.2, "mqa": -0.6}[eff.inf.kv_style]
    # --- MoE (§5.3: helps generation/code; diminishing beyond 8) ----------
    e = eff.arch.moe_experts
    if e > 0:
        gain = 0.25 * math.log2(e) * (0.5 + 0.5 * eff.arch.moe_top_k)
        if task.domain == "generation":
            gain *= 2.0
        d += gain
        if eff.inf.quant == "int4":
            d -= 1.0          # §5.5 cross-stage conflict: routing instability
        if eff.arch.attention in ("gqa", "mla"):
            d += 0.2          # §3.5 cross-stage synergy: MoE × attn variant
    # --- PEFT (§5.4: optimal rank scales with model size) ------------------
    m = eff.ft.method
    if m != "full":
        opt_rank = 16 if scale_b < 3 else (32 if scale_b < 20 else 96)
        r = eff.ft.rank
        rank_pen = 0.35 * abs(math.log2(max(r, 1) / opt_rank))
        d -= 0.25 + rank_pen
        if m == "dora":
            d += 0.15
        if m == "rslora":
            d += 0.25 if scale_b > 20 else 0.05   # rank-stabilized at scale
        if m == "qlora":
            d -= 0.25
        if eff.ft.alpha_mult == 4:
            d -= 0.1
    else:
        if scale_b < 2:
            d += 0.1           # small models: full FT competitive (§5.1)
    d += _seeded_noise(cfg.name, task.name, eff, scale=0.15)
    return max(base_acc + d, 0.0)


# ---------------------------------------------------------------------------
# Evaluator


class Evaluator:
    def __init__(self, cfg: ModelConfig, task: TaskSpec, tier: HwTier, *,
                 mode: str = "analytic", base_acc: float = 65.0,
                 proxy_steps: int = 60, seed: int = 0, calibration=None):
        if mode == "proxy":
            raise NotImplementedError(
                "the proxy evaluator trains a reduced model with the config "
                "applied; the port's training path is ROADMAP A7 — use "
                "mode='analytic'")
        if mode != "analytic":
            raise ValueError(f"unknown evaluator mode {mode!r}")
        self.cfg = cfg
        self.task = task
        self.tier = tier
        self.mode = mode
        self.base_acc = base_acc
        self.proxy_steps = proxy_steps
        self.seed = seed
        # measured-dispatch correction factors (CalibratedCostModel, fit
        # from repro_torch.obs.profile samples): every latency/energy
        # objective this evaluator produces is scaled by the profiled drift
        self.calibration = calibration

    # ------------------------------------------------------------------
    def evaluate(self, eff: EfficiencyConfig) -> np.ndarray:
        cost = predict(self.cfg, eff, self.tier,
                       prompt=min(self.task.seq_len, 512), gen=128,
                       calibration=self.calibration)
        acc = accuracy_model(self.cfg, eff, self.task, self.base_acc)
        return np.array([acc, cost["latency_ms"], cost["memory_gb"],
                         cost["energy_j"]])

    def feasible(self, eff: EfficiencyConfig) -> bool:
        return bool(predict(self.cfg, eff, self.tier)["feasible"])

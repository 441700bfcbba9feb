"""Configuration evaluation: the "actual hardware" step of Algorithm 1.

The port's copy of ``repro/core/evaluator.py``, analytic mode.  It returns
objective vectors ``[acc, lat_ms, mem_gb, en_j]``:

* ``analytic`` — the accuracy-effects model calibrated to the EfficientLLM/
  AE-LLM published findings (paper §5: int4 hurts numeric tasks ~2×; MLA
  helps understanding; optimal LoRA rank grows with model scale; RSLoRA
  scales better; MoE helps generation/code; int4×MoE routing instability),
  seeded noise for realism, and Lat/Mem/Energy from the cost model
  (``repro_torch.core.costmodel.predict``) at the evaluator's tier.

* ``proxy`` — *measured*: trains a reduced same-family model
  (``_reduce_config``) with the config applied on synthetic structured
  data and turns its held-out cross-entropy into the accuracy objective,
  while Lat/Mem/Energy come from the cost model over the applied
  full-size config.  It runs on the evaluator's ``device`` (the GPU unless
  the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.apply import apply_efficiency_config, apply_to_params
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
                 proxy_steps: int = 60, seed: int = 0, calibration=None,
                 device=None):
        if mode not in ("analytic", "proxy"):
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
        self.device = device          # the proxy's; resolved when it runs
        self._proxy_cache: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def evaluate(self, eff: EfficiencyConfig) -> np.ndarray:
        cost = predict(self.cfg, eff, self.tier,
                       prompt=min(self.task.seq_len, 512), gen=128,
                       calibration=self.calibration)
        if self.mode == "proxy":
            acc = self._proxy_accuracy(eff)
        else:
            acc = accuracy_model(self.cfg, eff, self.task, self.base_acc)
        return np.array([acc, cost["latency_ms"], cost["memory_gb"],
                         cost["energy_j"]])

    def feasible(self, eff: EfficiencyConfig) -> bool:
        return bool(predict(self.cfg, eff, self.tier)["feasible"])

    # ------------------------------------------------------------------
    def _proxy_accuracy(self, eff: EfficiencyConfig) -> float:
        """Train a reduced same-family model with the config applied for
        ``proxy_steps`` steps (batch 16 x 64, cosine schedule from 8e-3);
        acc = 100·exp(−max(eval_ce − 1, 0)/3) over two held-out
        batches.  MLA arms train through the MLA forward.  An encoder or
        cross-attention model raises: the synthetic data has no
        ``modality_input`` (the reference's proxy fails there too)."""
        if self.cfg.encoder is not None or self.cfg.cross_attn_every:
            raise ValueError(
                f"proxy evaluation of {self.cfg.name}: SyntheticLMData has "
                "no modality_input for an encoder or cross-attention model; "
                "use mode='analytic'")
        key = str(eff)
        if key in self._proxy_cache:
            return self._proxy_cache[key]
        import torch

        from repro_torch.data.pipeline import SyntheticLMData
        from repro_torch.models.model import LM
        from repro_torch.optim.adamw import cosine_schedule, init_adamw
        from repro_torch.peft.lora import trainable_mask
        from repro_torch.train.loop import make_train_step

        proxy = apply_efficiency_config(_reduce_config(self.cfg), eff)
        lm = LM(proxy, device=self.device)
        params = _proxy_params(lm, eff, self.seed)
        mask = (trainable_mask(params, eff.ft.method)
                if eff.ft.method != "full" else None)
        step = make_train_step(lm, lr=cosine_schedule(
            8e-3, 10, self.proxy_steps), mask=mask)
        opt = init_adamw(params, mask)

        def batches(pipe):
            return {k: torch.from_numpy(v).to(lm.device, dtype=torch.long)
                    for k, v in pipe.next_batch().items()}
        pipe = SyntheticLMData(proxy.vocab_size, 64, 16, seed=self.seed)
        for _ in range(self.proxy_steps):
            params, opt, _, _ = step(params, opt, batches(pipe), None)
        # eval CE on held-out batches
        eval_pipe = SyntheticLMData(proxy.vocab_size, 64, 16,
                                    seed=self.seed + 999)
        ce = 0.0
        with torch.no_grad():
            for _ in range(2):
                _, m = lm.loss(params, batches(eval_pipe))
                ce += float(m["ce_loss"]) / 2
        acc = 100.0 * math.exp(-max(ce - 1.0, 0.0) / 3.0)
        self._proxy_cache[key] = acc
        return acc


def _proxy_params(lm, eff: EfficiencyConfig, seed: int) -> dict:
    """The proxy's parameters before its first step: ``lm.init(seed)``
    with the configuration applied (adapters from seed 1), as the
    reference builds them (its from JAX keys)."""
    return apply_to_params(lm.init(seed), eff, 1)


def _reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same family, laptop size (used by proxy evaluation)."""
    a = cfg.attention
    if a is not None:
        heads = min(a.num_heads, 4)
        kv = max(1, min(a.kv_heads_effective(), 2))
        a = dataclasses.replace(
            a, num_heads=heads,
            num_kv_heads=kv if a.kind in ("gqa", "mha") else a.num_kv_heads,
            head_dim=16, kv_lora_rank=min(a.kv_lora_rank, 32),
            rope_head_dim=8, q_lora_rank=0)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=min(moe.num_experts, 4),
                                  top_k=min(moe.top_k, 2), d_ff=64,
                                  num_shared_experts=min(
                                      moe.num_shared_experts, 1),
                                  shared_d_ff=64 if moe.num_shared_experts
                                  else 0)
        moe = dataclasses.replace(moe, top_k=min(moe.top_k,
                                                 moe.num_experts))
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, head_dim=16, d_state=8)
    enc = cfg.encoder
    if enc is not None:
        enc = dataclasses.replace(enc, num_layers=2, max_source_len=24)
    n_groups = min(cfg.num_groups, 2)
    return dataclasses.replace(
        cfg, num_layers=n_groups * cfg.blocks_per_group, d_model=64,
        d_ff=128, vocab_size=min(cfg.vocab_size, 512), attention=a, moe=moe,
        ssm=ssm, encoder=enc, num_image_tokens=16, moe_group_size=32,
        ce_chunk=64, max_seq_len=256, scan_layers=True)

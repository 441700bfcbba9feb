"""Apply an EfficiencyConfig to a model: the port's copy of
``repro/core/apply.py``.

``apply_efficiency_config`` — ModelConfig -> ModelConfig (architecture +
inference arms; what the cost model prices and the engines serve).
``apply_to_params``         — params -> params: quantization (c_inf,
with calibrated AWQ / SmoothQuant scales when ``calib=`` is given) and
PEFT adapters (c_ft).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.space import EfficiencyConfig


def apply_efficiency_config(cfg: ModelConfig,
                            eff: EfficiencyConfig) -> ModelConfig:
    out = cfg
    a = cfg.attention
    # --- c_arch: attention kind -------------------------------------------
    if a is not None and "attn" in cfg.block_pattern:
        kind = eff.arch.attention
        if kind != a.kind:
            if kind == "mla":
                a = dataclasses.replace(
                    a, kind="mla",
                    kv_lora_rank=min(512, max(16, cfg.d_model // 4)),
                    rope_head_dim=max(8, a.head_dim // 2),
                    q_lora_rank=0)
            elif kind == "mqa":
                a = dataclasses.replace(a, kind="mqa", num_kv_heads=1)
            elif kind == "mha":
                a = dataclasses.replace(a, kind="mha",
                                        num_kv_heads=a.num_heads)
            else:  # gqa: keep the model's own kv count (or heads//4)
                kv = a.num_kv_heads if a.kind == "gqa" else \
                    max(1, a.num_heads // 4)
                a = dataclasses.replace(a, kind="gqa", num_kv_heads=kv)
        out = dataclasses.replace(out, attention=a)
    # --- c_arch: MoE -------------------------------------------------------
    if eff.arch.moe_experts > 0 and cfg.moe is None:
        # dense -> sparse upcycling: split the FFN into E experts holding
        # 2× the dense capacity in total, top-k routed — active compute
        # becomes 2k/E of dense (the efficiency win the paper describes:
        # "scale computation without increasing inference latency
        # proportionally"), memory pays the 2× FFN capacity.
        e = eff.arch.moe_experts
        d_ff_e = max(128, (2 * cfg.d_ff) // e)
        out = dataclasses.replace(
            out, moe=MoEConfig(num_experts=e, top_k=eff.arch.moe_top_k,
                               d_ff=d_ff_e),
            family="moe" if cfg.family == "dense" else cfg.family)
    elif eff.arch.moe_experts > 0 and cfg.moe is not None:
        # models that are already MoE keep their expert count (the arm
        # only adjusts routing k within the model's capability)
        out = dataclasses.replace(
            out, moe=dataclasses.replace(
                cfg.moe, top_k=min(eff.arch.moe_top_k, cfg.moe.num_experts)))
    # --- c_inf --------------------------------------------------------------
    out = dataclasses.replace(
        out,
        quant=eff.inf.quant if eff.inf.quant != "bf16" else "bf16",
        quant_method=(eff.inf.quant_method if eff.inf.quant != "bf16"
                      else "none"),
        kv_cache_style=eff.inf.kv_style if out.attention is not None
        else "full",
        kv_cache_dtype={"int8": "int8", "int4": "int8",
                        "fp8": "fp8"}.get(eff.inf.quant, "bfloat16"),
        # speculative decoding rides the paged serving path only; SSM
        # families have no paged engine, so the arm is a no-op there
        spec_decode=(eff.inf.spec if out.attention is not None else "none"),
        spec_draft_k=eff.inf.draft_k,
    )
    return out


def apply_to_params(params, eff: EfficiencyConfig, seed=0, *,
                    calib: dict | None = None):
    """Quantize weights (c_inf) and attach PEFT adapters (c_ft), as the
    reference does: ``qlora`` or ``int4`` quantizes the base to int4 first,
    ``int8`` / ``fp8`` give those weights (``quantize_tree``); then a
    non-full fine-tuning arm attaches its adapters (``apply_peft``, rank
    ``ft.rank``, alpha ``rank * alpha_mult``), drawn from ``seed`` (an int
    or a generator on the weights' device; the reference's is a JAX key).
    ``calib`` maps linear paths to equalization scales
    (``quant.calibrate``; see ``quantize_tree``)."""
    from repro_torch.peft.lora import apply_peft
    from repro_torch.quant.qops import quantize_tree

    if eff.ft.method == "qlora" or eff.inf.quant == "int4":
        params = quantize_tree(params, quant="int4", calib=calib)
    elif eff.inf.quant in ("int8", "fp8"):
        params = quantize_tree(params, quant=eff.inf.quant, calib=calib)
    if eff.ft.method != "full":
        params = apply_peft(params, seed, method=eff.ft.method,
                            rank=eff.ft.rank,
                            alpha=float(eff.ft.rank * eff.ft.alpha_mult))
    return params

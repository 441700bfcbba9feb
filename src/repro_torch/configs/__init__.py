"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke_config``.  Holds the ten assigned architectures, as the
reference registry (``repro.configs``) does, and falls back to the
paper's own evaluation models (``paper_models``) in ``get_config``.  The
port serves the dense-attention archs (MLA under the search's arm), the
MoE archs and RWKV-6 through its engines, and runs the encoder and
cross-attention archs through ``LM.prefill(modality_input=)`` and
``LM.decode_step``; the Mamba hybrid (jamba) and RWKV-6 through the
eager ``Engine`` only."""
from __future__ import annotations

from repro_torch.configs import (deepseek_coder_33b, granite_moe_3b_a800m,
                                 jamba_1_5_large_398b, llama3_2_1b,
                                 llama3_2_vision_11b, llama4_scout_17b_a16e,
                                 qwen2_1_5b, rwkv6_1_6b, stablelm_1_6b,
                                 whisper_base)
from repro_torch.configs.base import (SHAPES, AttentionConfig,
                                     EncoderConfig, ModelConfig, MoEConfig,
                                     SSMConfig, ShapeConfig)
from repro_torch.configs.paper_models import PAPER_MODELS

_ARCH_MODULES = {
    m.ARCH_ID: m
    for m in (stablelm_1_6b, deepseek_coder_33b, llama3_2_1b, qwen2_1_5b,
              rwkv6_1_6b, llama4_scout_17b_a16e, granite_moe_3b_a800m,
              whisper_base, llama3_2_vision_11b, jamba_1_5_large_398b)
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _norm(arch_id: str) -> str:
    return arch_id.replace("_", "-").lower()


def get_config(arch_id: str) -> ModelConfig:
    a = _norm(arch_id)
    if a in _ARCH_MODULES:
        return _ARCH_MODULES[a].config()
    if a in PAPER_MODELS:
        return PAPER_MODELS[a]()
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}"
                   f" + paper models {sorted(PAPER_MODELS)}")


def get_smoke_config(arch_id: str) -> ModelConfig:
    a = _norm(arch_id)
    if a not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; "
                       f"known: {sorted(_ARCH_MODULES)}")
    return _ARCH_MODULES[a].smoke_config()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def first_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    """``cfg`` cut to its first ``n`` layers: whole groups when ``n`` is a
    multiple of the group's length, else one group of the first ``n``
    entries of ``block_pattern`` (jamba's first five layers: 4 Mamba
    blocks and the attention block, what one H100 holds at full
    width)."""
    if n % cfg.blocks_per_group == 0:
        return cfg.with_(num_layers=n)
    if n > cfg.blocks_per_group:
        raise ValueError(f"{n} layers: more than one group of "
                         f"{cfg.blocks_per_group} blocks and not a whole "
                         "number of groups")
    return cfg.with_(num_layers=n, block_pattern=cfg.block_pattern[:n])


__all__ = ["ARCH_IDS", "AttentionConfig", "EncoderConfig", "ModelConfig",
           "MoEConfig", "PAPER_MODELS", "SHAPES", "SSMConfig", "ShapeConfig",
           "first_layers", "get_config", "get_shape", "get_smoke_config"]

"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke_config``.  Holds the dense-attention archs the paged serving
path runs and RWKV-6, which the eager ``Engine`` serves; the reference
registry (``repro.configs``) has the rest."""
from __future__ import annotations

from repro_torch.configs import (llama3_2_1b, qwen2_1_5b, rwkv6_1_6b,
                                 stablelm_1_6b)
from repro_torch.configs.base import (AttentionConfig, EncoderConfig,
                                     ModelConfig, MoEConfig, SSMConfig)

_ARCH_MODULES = {m.ARCH_ID: m
                 for m in (qwen2_1_5b, llama3_2_1b, stablelm_1_6b,
                           rwkv6_1_6b)}

ARCH_IDS = tuple(_ARCH_MODULES)


def _norm(arch_id: str) -> str:
    return arch_id.replace("_", "-").lower()


def get_config(arch_id: str) -> ModelConfig:
    a = _norm(arch_id)
    if a not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return _ARCH_MODULES[a].config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    a = _norm(arch_id)
    if a not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return _ARCH_MODULES[a].smoke_config()


__all__ = ["ARCH_IDS", "AttentionConfig", "EncoderConfig", "ModelConfig",
           "MoEConfig", "SSMConfig", "get_config", "get_smoke_config"]

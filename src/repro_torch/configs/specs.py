"""The stub frontends' input shape: the port's copy of ``modality_spec``
from ``repro/configs/specs.py`` (the rest of that file is the dry-run's
abstract inputs, ROADMAP A8).

Modality frontends are stubs: audio provides (B, 1500, d) frame
embeddings (the encoder's ``max_source_len``), a VLM (B, n_img, d) patch
embeddings, both in bf16.  ``LM.prefill`` / ``logits`` / ``loss`` take
them as ``modality_input``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig


class ModalitySpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def modality_spec(cfg: ModelConfig, batch: int) -> Optional[ModalitySpec]:
    """The shape and dtype of ``modality_input`` for ``batch`` rows, or
    None for a model without a source."""
    if cfg.family == "audio":
        return ModalitySpec((batch, cfg.encoder.max_source_len, cfg.d_model),
                            torch.bfloat16)
    if cfg.family == "vlm":
        return ModalitySpec((batch, cfg.num_image_tokens, cfg.d_model),
                            torch.bfloat16)
    return None

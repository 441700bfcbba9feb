"""Abstract stand-ins for every model input of a dry-run cell: the
port's copy of ``repro/configs/specs.py``.

The reference lowers against ``jax.ShapeDtypeStruct``s; the port's
counterpart is a tensor on ``torch.device("meta")``, which has a shape
and a dtype and allocates nothing.  ``mode`` follows the assigned shape
grid (``configs.base.SHAPES``):

  train    -> the train step's batch {tokens, labels, mask[,
              modality_input]}
  prefill  -> tokens + an empty contiguous cache [+ modality_input]
  decode   -> one token a sequence + a cache holding ``seq_len``
              positions (paged for ``decode_attn_impl="paged_pallas"``;
              a cross-attention block's source K / V as well, which the
              reference's ``init_cache`` allocates) + per-sequence
              positions

The caches are built by the port's own ``LM.init_cache`` /
``init_paged_cache`` on meta, whole (the config's ``model_parallel``
is 1: a mesh's placements cut them into a rank's pieces,
``launch.steps``).  Modality frontends are stubs: audio provides (B,
1500, d) frame embeddings (the encoder's ``max_source_len``), a VLM (B,
n_img, d) patch embeddings, both in bf16; ``LM.prefill`` / ``logits`` /
``loss`` take them as ``modality_input``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

META = torch.device("meta")
I32 = torch.int32
F32 = torch.float32
BF16 = torch.bfloat16


class ModalitySpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def modality_spec(cfg: ModelConfig, batch: int) -> Optional[ModalitySpec]:
    """The shape and dtype of ``modality_input`` for ``batch`` rows, or
    None for a model without a source."""
    if cfg.family == "audio":
        return ModalitySpec((batch, cfg.encoder.max_source_len, cfg.d_model),
                            BF16)
    if cfg.family == "vlm":
        return ModalitySpec((batch, cfg.num_image_tokens, cfg.d_model),
                            BF16)
    return None


def _modality(cfg: ModelConfig, batch: int) -> Optional[torch.Tensor]:
    m = modality_spec(cfg, batch)
    return None if m is None else _meta(m.shape, m.dtype)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> list:
    """The contiguous cache on meta (no allocation)."""
    from repro_torch.models.model import LM
    return LM(cfg, device=META).init_cache(batch, max_len)


def abstract_paged_cache(cfg: ModelConfig, n_slots: int,
                         max_len: int) -> list:
    """The paged decode cache on meta, sized to hold ``max_len`` tokens a
    slot (``decode_attn_impl="paged_pallas"``); the sizing is the
    engine's, ``kvcache.paged_pool_shape``."""
    from repro_torch.kvcache import paged_pool_shape
    from repro_torch.models.model import LM
    from repro_torch.serve.paged import PAGE
    pps, n_pages = paged_pool_shape(n_slots, max_len, PAGE)
    return LM(cfg, device=META).init_paged_cache(n_slots, n_pages, pps,
                                                 page_size=PAGE)


def train_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), I32), "labels": _meta((b, s), I32),
             "mask": _meta((b, s), F32)}
    m = _modality(cfg, b)
    if m is not None:
        batch["modality_input"] = m
    return {"batch": batch}


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((b, s), I32), "cache": abstract_cache(cfg, b, s)}
    m = _modality(cfg, b)
    if m is not None:
        out["modality_input"] = m
    return out


def _with_source_kv(cfg: ModelConfig, cache: list, batch: int) -> list:
    """``cache`` with each cross-attention block's source K / V, (B,
    T_src, KH, D) in bf16, T_src the encoder's ``max_source_len`` or
    ``num_image_tokens`` (the reference's ``init_cache``; the port's
    caches add them at prefill, from the source)."""
    from repro_torch.models.transformer import block_kinds
    kinds = block_kinds(cfg)
    if not any(bk["xattn"] for bk in kinds):
        return cache
    a = cfg.attention
    t_src = (cfg.encoder.max_source_len if cfg.encoder is not None
             else cfg.num_image_tokens)
    shape = (batch, t_src, a.kv_heads_effective(), a.head_dim)
    for group in cache:
        for i, bk in enumerate(kinds):
            if bk["xattn"]:
                group[f"blk{i}"].update(xk=_meta(shape, BF16),
                                        xv=_meta(shape, BF16))
    return cache


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    cache = (abstract_paged_cache(cfg, b, s)
             if cfg.decode_attn_impl == "paged_pallas"
             else abstract_cache(cfg, b, s))
    return {"token": _meta((b,), I32),
            "cache": _with_source_kv(cfg, cache, b),
            "pos": _meta((b,), I32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if shape.mode == "train":
        return train_specs(cfg, shape)
    if shape.mode == "prefill":
        return prefill_specs(cfg, shape)
    if shape.mode == "decode":
        return decode_specs(cfg, shape)
    raise ValueError(shape.mode)


# ---------------------------------------------------------------------------
# Applicability of (arch × shape) cells (the reference's long_500k policy)


SUBQUADRATIC = {"rwkv6-1.6b", "jamba-1.5-large-398b", "llama4-scout-17b-a16e"}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, ("skipped: pure full-attention arch; 500k dense "
                       "prefill/decode is quadratic (DESIGN.md §long_500k)")
    return True, ""

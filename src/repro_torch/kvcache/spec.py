"""CacheSpec — the one description of a KV cache's layout × dtype × style.

The port's copy of ``repro/kvcache/spec.py``:

  layout ∈ {contiguous, paged}   — (B, S, KH, D) slabs vs page pools +
                                   block tables (serve/paged.py)
  dtype  ∈ {bf16, int8, fp8}     — quantized caches carry fp32 amax
                                   scales per (page, kv head) in pools,
                                   per (row, position, kv head) in slabs
  style  ∈ {full, gqa, mqa}      — stored-head narrowing (heads are
                                   mean-merged before the write)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import AttentionConfig, ModelConfig

FP8 = torch.float8_e4m3fn

#: largest exactly-representable magnitude per quantized dtype
QMAX = {"int8": 127.0, "fp8": 448.0}

STORE_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                "int8": torch.int8, "fp8": FP8}

ELEM_BYTES = {"bf16": 2.0, "bfloat16": 2.0, "int8": 1.0, "fp8": 1.0}


def normalize_dtype(name: str) -> str:
    if name in ("bf16", "bfloat16"):
        return "bfloat16"
    if name not in ("int8", "fp8"):
        raise ValueError(f"unsupported kv cache dtype {name!r} "
                         "(bf16 | bfloat16 | int8 | fp8)")
    return name


@dataclass(frozen=True)
class CacheSpec:
    layout: str = "contiguous"        # contiguous | paged
    dtype: str = "bfloat16"           # bfloat16 | int8 | fp8
    style: str = "full"               # full | gqa | mqa
    page_size: int = 256              # paged layout only

    def __post_init__(self):
        if self.layout not in ("contiguous", "paged"):
            raise ValueError(f"layout {self.layout!r}")
        object.__setattr__(self, "dtype", normalize_dtype(self.dtype))
        if self.style not in ("full", "gqa", "mqa"):
            raise ValueError(f"style {self.style!r}")

    @classmethod
    def from_config(cls, cfg: ModelConfig, *, layout: str = "contiguous",
                    page_size: int = 256) -> "CacheSpec":
        return cls(layout=layout, dtype=cfg.kv_cache_dtype,
                   style=cfg.kv_cache_style, page_size=page_size)

    @property
    def quantized(self) -> bool:
        return self.dtype != "bfloat16"

    @property
    def store_dtype(self) -> torch.dtype:
        return STORE_DTYPES[self.dtype]

    def stored_kv_heads(self, a: AttentionConfig) -> int:
        return cache_kv_heads(a, self.style)


def cache_kv_heads(a: AttentionConfig, style: str) -> int:
    """The *stored* kv head count (gqa-style: min(kvh, 8); mqa-style: 1)."""
    kvh = a.kv_heads_effective()
    if style == "mqa":
        return 1
    if style == "gqa":
        return min(kvh, 8)
    return kvh


def paged_pool_shape(n_slots: int, max_len: int,
                     page_size: int) -> tuple[int, int]:
    """(pages_per_slot, n_pages) for a pool where every slot can hold
    ``max_len`` tokens, plus the reserved null page 0."""
    pages_per_slot = (max_len + page_size - 1) // page_size
    return pages_per_slot, n_slots * pages_per_slot + 1


# ---------------------------------------------------------------------------
# Byte accounting (cost model)


def kv_bytes_per_token(cfg: ModelConfig, *, layout: str = "contiguous",
                       page_size: int = 256) -> float:
    """Stored bytes per context token across all attention layers,
    including the fp32 scale tensors a quantized cache carries
    (per-position for contiguous: 2·KH·4 B/token; per-page for paged:
    2·KH·4/page_size B/token).  MLA latent caches count as bf16."""
    a = cfg.attention
    if a is None or "attn" not in cfg.block_pattern:
        return 0.0
    n_attn = sum(1 for b in cfg.block_pattern if b == "attn") * cfg.num_groups
    spec = CacheSpec.from_config(cfg, layout=layout, page_size=page_size)
    if a.kind == "mla":
        return n_attn * (a.kv_lora_rank + a.rope_head_dim) * 2.0  # bf16 only
    kvh = spec.stored_kv_heads(a)
    elem = ELEM_BYTES[spec.dtype]
    per_tok = 2.0 * kvh * a.head_dim * elem
    if spec.quantized:
        scale_tok = 2.0 * kvh * 4.0
        if layout == "paged":
            scale_tok /= page_size
        per_tok += scale_tok
    return n_attn * per_tok

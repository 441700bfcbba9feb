"""CacheSpec — the one description of a KV cache's layout × dtype × style.

The port's copy of ``repro/kvcache/spec.py``:

  layout ∈ {contiguous, paged}   — (B, S, KH, D) slabs vs page pools +
                                   block tables (serve/paged.py)
  dtype  ∈ {bf16, int8, fp8}     — quantized caches carry fp32 amax scales
                                   (their writes arrive in a later slice)
  style  ∈ {full, gqa, mqa}      — stored-head narrowing (heads are
                                   mean-merged before the write)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import AttentionConfig

FP8 = torch.float8_e4m3fn

#: largest exactly-representable magnitude per quantized dtype
QMAX = {"int8": 127.0, "fp8": 448.0}

STORE_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                "int8": torch.int8, "fp8": FP8}


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

"""Block / group / stack assembly (attention-only decoders).

A *group* is one repeat of ``cfg.block_pattern``.  The reference scans
over group-stacked parameters; the port keeps a Python list of groups and
loops over it.  Block layout (pre-norm residual):

    x = x + attn(norm1(x))
    x = x + mlp(norm2(x))

Only attention blocks with a dense SwiGLU MLP are ported; other block
kinds raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import init_mlp, init_norm, mlp_apply, norm_apply


def block_kinds(cfg: ModelConfig) -> list[dict]:
    """Per-block metadata for one group (attention blocks only)."""
    out = []
    for kind in cfg.block_pattern:
        if kind != "attn":
            raise NotImplementedError(
                f"block kind {kind!r}: only attention blocks are ported")
        out.append({"kind": kind})
    return out


def init_group(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device=None) -> dict:
    group = {}
    for i, _ in enumerate(block_kinds(cfg)):
        group[f"blk{i}"] = {
            "norm1": init_norm(cfg.norm, cfg.d_model, dtype, device),
            "attn": attn_mod.init_attention(gen, cfg.d_model, cfg.attention,
                                            dtype, device),
            "norm2": init_norm(cfg.norm, cfg.d_model, dtype, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, bias=cfg.mlp_bias,
                            dtype=dtype, device=device),
        }
    return group


def init_group_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     paged: bool = False, n_pages: int = 0,
                     pages_per_slot: int = 0, page_size: int = 256,
                     kv_dtype: Optional[str] = None, device=None,
                     block_table: Optional[torch.Tensor] = None) -> dict:
    """KV caches for one group: contiguous (B, S, KH, D) slabs, or page
    pools + a block table when ``paged`` (``block_table`` shares one table
    tensor across layers).  ``kv_dtype`` overrides ``cfg.kv_cache_dtype``
    (the paged engine prefills into a bf16 staging cache)."""
    from repro_torch.kvcache import CacheSpec, alloc_contiguous, alloc_paged
    spec = CacheSpec(layout="paged" if paged else "contiguous",
                     dtype=kv_dtype or cfg.kv_cache_dtype,
                     style=cfg.kv_cache_style, page_size=page_size)
    cache = {}
    for i, _ in enumerate(block_kinds(cfg)):
        if paged:
            kv = alloc_paged(spec, cfg.attention, batch, n_pages,
                             pages_per_slot, device, block_table)
        else:
            kv = alloc_contiguous(spec, cfg.attention, batch, max_len, device)
        cache[f"blk{i}"] = {"kv": kv}
    return cache


def group_forward(gp: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  mode: str, cache: Optional[dict],
                  pos: Optional[torch.Tensor]):
    """One group.  ``mode`` is "prefill" (full sequence; fills a
    contiguous cache when given) or "decode" (one token per slot against
    a paged cache, ``pos`` the (S,) write positions)."""
    a = cfg.attention
    new_cache: Dict[str, Any] = {}
    for i, _ in enumerate(block_kinds(cfg)):
        blk = gp[f"blk{i}"]
        c = cache[f"blk{i}"] if cache is not None else None
        h = norm_apply(cfg.norm, blk["norm1"], x, cfg.norm_eps)
        if mode == "prefill":
            if c is None:
                y = attn_mod.attention_forward(blk["attn"], h, a,
                                               use_flash=cfg.use_kernels)
            else:
                y, kv = attn_mod.attention_prefill(
                    blk["attn"], h, a, c["kv"], use_flash=cfg.use_kernels)
                new_cache[f"blk{i}"] = {"kv": kv}
        elif mode == "decode":
            if c is None or "k_pages" not in c["kv"]:
                raise NotImplementedError(
                    "decode runs against a paged cache only")
            y, kv = attn_mod.attention_decode_paged(blk["attn"], h, a,
                                                    c["kv"], pos)
            new_cache[f"blk{i}"] = {"kv": kv}
        else:
            raise ValueError(f"mode {mode!r}")
        x = x + y
        h = norm_apply(cfg.norm, blk["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(blk["mlp"], h)
    return x, (new_cache if cache is not None else None)


def init_stack(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device=None) -> List[dict]:
    return [init_group(gen, cfg, dtype, device)
            for _ in range(cfg.num_groups)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     device=None, **kw) -> List[dict]:
    if kw.get("paged") and kw.get("block_table") is None:
        kw["block_table"] = torch.zeros(
            (batch, kw.get("pages_per_slot", 0)), dtype=torch.int32,
            device=device)
    return [init_group_cache(cfg, batch, max_len, device=device, **kw)
            for _ in range(cfg.num_groups)]


def stack_forward(params: List[dict], x: torch.Tensor, cfg: ModelConfig, *,
                  mode: str = "prefill", cache: Optional[List[dict]] = None,
                  pos: Optional[torch.Tensor] = None):
    """Python loop over the groups (the reference's ``lax.scan``)."""
    new_cache = [] if cache is not None else None
    for i, gp in enumerate(params):
        x, nc = group_forward(gp, x, cfg, mode=mode,
                              cache=cache[i] if cache is not None else None,
                              pos=pos)
        if cache is not None:
            new_cache.append(nc)
    return x, new_cache

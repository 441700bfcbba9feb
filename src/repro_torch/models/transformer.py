"""Block / group / stack assembly.

A *group* is one repeat of ``cfg.block_pattern``.  The reference scans
over group-stacked parameters; the port keeps a Python list of groups and
loops over it.  Block layout (pre-norm residual):

    x = x + mixer(norm1(x))            mixer ∈ {attn, rwkv6}
    x = x + mlp(norm2(x))

Attention and RWKV-6 blocks with a dense SwiGLU MLP are ported; Mamba
(ROADMAP A6) and other block kinds raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import init_mlp, init_norm, mlp_apply, norm_apply


def block_kinds(cfg: ModelConfig) -> list[dict]:
    """Per-block metadata for one group (attention and RWKV-6 blocks)."""
    out = []
    for kind in cfg.block_pattern:
        if kind == "mamba":
            raise NotImplementedError(
                "block kind 'mamba' is not ported yet (ROADMAP A6)")
        if kind not in ("attn", "rwkv6"):
            raise NotImplementedError(
                f"block kind {kind!r}: only attention and RWKV-6 blocks "
                "are ported")
        out.append({"kind": kind})
    return out


def init_group(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device=None) -> dict:
    group = {}
    for i, bk in enumerate(block_kinds(cfg)):
        blk = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, device)}
        if bk["kind"] == "attn":
            blk["attn"] = attn_mod.init_attention(gen, cfg.d_model,
                                                  cfg.attention, dtype,
                                                  device)
        else:
            blk["rwkv"] = ssm_mod.init_rwkv6(gen, cfg.d_model, cfg.ssm,
                                             dtype, device)
        blk["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, device)
        blk["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, bias=cfg.mlp_bias,
                              dtype=dtype, device=device)
        group[f"blk{i}"] = blk
    return group


def init_group_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     paged: bool = False, n_pages: int = 0,
                     pages_per_slot: int = 0, page_size: int = 256,
                     kv_dtype: Optional[str] = None, device=None,
                     block_table: Optional[torch.Tensor] = None) -> dict:
    """Caches for one group.  Attention blocks: contiguous (B, S, KH, D)
    slabs, or page pools + a block table when ``paged`` (``block_table``
    shares one table tensor across layers); ``kv_dtype`` overrides
    ``cfg.kv_cache_dtype`` (the paged engine prefills into a bf16 staging
    cache).  RWKV-6 blocks: ``{"state": {"wkv": (B,H,D,D), "x_prev":
    (B,d)}}`` in fp32, position-free."""
    from repro_torch.kvcache import CacheSpec, alloc_contiguous, alloc_paged
    spec = CacheSpec(layout="paged" if paged else "contiguous",
                     dtype=kv_dtype or cfg.kv_cache_dtype,
                     style=cfg.kv_cache_style, page_size=page_size)
    cache = {}
    for i, bk in enumerate(block_kinds(cfg)):
        if bk["kind"] == "rwkv6":
            cache[f"blk{i}"] = {"state": ssm_mod.init_rwkv6_state(
                batch, cfg.d_model, cfg.ssm, device)}
            continue
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
    contiguous cache when given, or — on a paged cache — one chunk per row
    at ``pos = (slot_ids, starts, lengths[, max_pages])``), "decode" (one
    token per row, ``pos`` the (S,) write positions; the cache's layout
    picks paged or contiguous attention, where the reference reads
    ``decode_attn_impl``) or "verify" (a speculative chunk per slot over
    the paged cache, ``pos = (lengths, widths[, max_pages])``; the cache
    node is ``{"kv": paged, "stage": contiguous}`` and only the stage is
    written).  RWKV-6 blocks run their recurrence from the cache's state
    (zeros without a cache) and ignore ``pos``."""
    a = cfg.attention
    # the quantized linears' execution choice (every forward of the port
    # is an inference forward: the reference's training "ref" never applies)
    impl = cfg.quant_matmul_impl
    # chunked attention on the CPU (CUDA tensors take the flash kernel)
    chunk_kw = dict(attn_impl=cfg.attn_impl, q_block=cfg.attn_q_block,
                    kv_block=cfg.attn_kv_block, chunk_min=cfg.attn_chunk_min)
    new_cache: Dict[str, Any] = {}
    for i, bk in enumerate(block_kinds(cfg)):
        blk = gp[f"blk{i}"]
        c = cache[f"blk{i}"] if cache is not None else None
        h = norm_apply(cfg.norm, blk["norm1"], x, cfg.norm_eps)
        if mode not in ("prefill", "decode", "verify"):
            raise ValueError(f"mode {mode!r}")
        if mode == "verify" and bk["kind"] != "attn":
            raise NotImplementedError("verify runs attention blocks only")
        if bk["kind"] == "rwkv6":
            st = c["state"] if c is not None else ssm_mod.init_rwkv6_state(
                x.shape[0], cfg.d_model, cfg.ssm, x.device)
            step = (ssm_mod.rwkv6_decode if mode == "decode"
                    else ssm_mod.rwkv6_forward)
            y, st2 = step(blk["rwkv"], h, cfg.ssm, st, impl=impl)
            if c is not None:
                new_cache[f"blk{i}"] = {"state": st2}
        elif mode == "prefill":
            if c is None:
                y = attn_mod.attention_forward(blk["attn"], h, a,
                                               use_flash=cfg.use_kernels,
                                               impl=impl, **chunk_kw)
            elif "k_pages" in c["kv"]:
                y, kv = attn_mod.attention_prefill_paged(blk["attn"], h, a,
                                                         c["kv"], pos, impl)
                new_cache[f"blk{i}"] = {"kv": kv}
            else:
                y, kv = attn_mod.attention_prefill(
                    blk["attn"], h, a, c["kv"], use_flash=cfg.use_kernels,
                    impl=impl, **chunk_kw)
                new_cache[f"blk{i}"] = {"kv": kv}
        elif mode == "verify":
            y, stage = attn_mod.attention_verify_paged(
                blk["attn"], h, a, c["kv"], c["stage"], pos, impl)
            new_cache[f"blk{i}"] = {"stage": stage}
        else:
            if c is None:
                raise ValueError("attention decode needs a cache")
            step = (attn_mod.attention_decode_paged if "k_pages" in c["kv"]
                    else attn_mod.attention_decode)
            y, kv = step(blk["attn"], h, a, c["kv"], pos, impl)
            new_cache[f"blk{i}"] = {"kv": kv}
        x = x + y
        h = norm_apply(cfg.norm, blk["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(blk["mlp"], h, impl)
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

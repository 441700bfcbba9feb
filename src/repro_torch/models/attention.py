"""Attention (MHA / MQA / GQA: one grouped implementation).

Entry points per layer, as in ``repro/models/attention.py``:
  * ``attention_forward``      — full-sequence causal attention
  * ``attention_prefill``      — the same, filling a contiguous cache
  * ``attention_decode_paged`` — one token per slot, all slots in one
    paged-attention launch (``kernels/paged_attention``)

On CUDA tensors the full-sequence products always go through the flash
kernel (``kernels/flash_attention``).  On the CPU ``use_flash`` chooses
between the flash op's plain version and a plain grouped ``sdpa``, as
the reference's flag chooses between its Pallas kernel and jnp.  Cache allocation and writes live in ``repro_torch.kvcache``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.models.layers import apply_rope, init_linear, linear_apply

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Init


def init_attention(gen: torch.Generator, d_model: int, a: AttentionConfig,
                   dtype=torch.bfloat16, device=None) -> dict:
    kvh = a.kv_heads_effective()
    hp = a.heads_padded
    kw = dict(dtype=dtype, device=device)
    p = {"wq": init_linear(gen, d_model, hp * a.head_dim, bias=a.qkv_bias,
                           **kw),
         "wk": init_linear(gen, d_model, kvh * a.head_dim, bias=a.qkv_bias,
                           **kw),
         "wv": init_linear(gen, d_model, kvh * a.head_dim, bias=a.qkv_bias,
                           **kw),
         "wo": init_linear(gen, hp * a.head_dim, d_model, **kw)}
    if hp != a.num_heads:
        # zero the padded heads (wq cols / wo rows): exact semantics
        mask = _pad_head_mask(a, device)
        p["wq"]["w"] = p["wq"]["w"] * mask[None, :].to(dtype)
        p["wo"]["w"] = p["wo"]["w"] * mask[:, None].to(dtype)
        if "b" in p["wq"]:
            p["wq"]["b"] = p["wq"]["b"] * mask.to(dtype)
    return p


# ---------------------------------------------------------------------------
# Core SDPA (grouped-query, fp32 softmax)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor], scale: torch.Tensor) -> torch.Tensor:
    """q: (B,S,KH,G,D)  k,v: (B,T,KH,D)  mask: (S,T) or None -> (B,S,KH,G,D).
    Scores accumulate in fp32; probabilities round to v's dtype before the
    second product, as the reference does."""
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores,
                             torch.tensor(NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def causal_mask(s: int, t: int, *, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(s, t) boolean mask; query i sees key j <= i (and j > i - window)."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def _pad_head_mask(a: AttentionConfig, device=None) -> torch.Tensor:
    """bool[(hp·hd)]: True for live head slots (group-aware padding)."""
    hp = a.heads_padded
    kvh = a.kv_heads_effective()
    slot = torch.arange(hp, device=device) % (hp // kvh)
    live = slot < a.num_heads // kvh
    return torch.repeat_interleave(live, a.head_dim)


def _mask_pad_heads(o_flat: torch.Tensor, a: AttentionConfig) -> torch.Tensor:
    """Zero the padded heads' outputs before wo."""
    if a.heads_padded == a.num_heads:
        return o_flat
    return o_flat * _pad_head_mask(a, o_flat.device).to(o_flat.dtype)


def _merge_heads(x: torch.Tensor, kvh_store: int) -> torch.Tensor:
    """Mean-merge kv heads (B,T,KH,D) -> (B,T,kvh_store,D) for a narrowed
    cache."""
    b, t, kh, d = x.shape
    if kh == kvh_store:
        return x
    return x.reshape(b, t, kvh_store, kh // kvh_store, d).mean(dim=3)


def _scale(a: AttentionConfig) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(a.head_dim, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Forward (prefill)


def _project(p: dict, x: torch.Tensor, a: AttentionConfig,
             positions: torch.Tensor):
    """q (B,S,Hp,D), rotated k (B,S,KH,D) and v from one projection."""
    b, s, _ = x.shape
    kvh = a.kv_heads_effective()
    q = linear_apply(p["wq"], x).reshape(b, s, a.heads_padded, a.head_dim)
    k = linear_apply(p["wk"], x).reshape(b, s, kvh, a.head_dim)
    v = linear_apply(p["wv"], x).reshape(b, s, kvh, a.head_dim)
    return (apply_rope(q, positions, a.rope_theta),
            apply_rope(k, positions, a.rope_theta), v)


def _attend(p: dict, q, k, v, a: AttentionConfig, use_flash: bool):
    b, s = q.shape[:2]
    kvh = a.kv_heads_effective()
    # CUDA tensors always take the flash kernel; ``use_flash`` picks the
    # branch only on the CPU, where the op runs its plain version (the
    # parity tests hold both branches against the reference's)
    if q.is_cuda or (use_flash and a.causal):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=a.causal,
                            window=a.window if a.causal else None)
    else:
        mask = (causal_mask(s, s, window=a.window, device=q.device)
                if a.causal else None)
        qg = q.reshape(b, s, kvh, a.heads_padded // kvh, a.head_dim)
        o = sdpa(qg, k, v, mask, _scale(a).to(q.device))
    o = o.reshape(b, s, a.heads_padded * a.head_dim)
    return linear_apply(p["wo"], _mask_pad_heads(o, a))


def attention_forward(p: dict, x: torch.Tensor, a: AttentionConfig, *,
                      use_flash: bool = False) -> torch.Tensor:
    """Full-sequence attention at positions [0, S).  x: (B,S,d) -> (B,S,d)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project(p, x, a, positions)
    return _attend(p, q, k, v, a, use_flash)


def attention_prefill(p: dict, x: torch.Tensor, a: AttentionConfig,
                      cache: dict, *, use_flash: bool = False
                      ) -> tuple[torch.Tensor, dict]:
    """Full-seq attention AND fill the contiguous cache for positions
    [0, s).  K/V are projected once and shared by both (the reference
    projects them twice; the values are identical)."""
    from repro_torch import kvcache
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project(p, x, a, positions)
    y = _attend(p, q, k, v, a, use_flash)
    kvh_store = cache["k"].shape[2]
    cache = kvcache.prefill_write(cache, {"k": _merge_heads(k, kvh_store),
                                          "v": _merge_heads(v, kvh_store)})
    return y, cache


# ---------------------------------------------------------------------------
# Paged decode


def attention_decode_paged(p: dict, x: torch.Tensor, a: AttentionConfig,
                           cache: dict, pos: torch.Tensor
                           ) -> tuple[torch.Tensor, dict]:
    """One-token decode against a paged KV cache, all slots in one
    paged-attention launch.

    x: (S,1,d); pos: (S,) per-slot lengths — where this token's K/V is
    written.  cache: {k_pages, v_pages, block_table} from
    ``repro_torch.kvcache.alloc_paged``, updated in place.  Slots without
    allocated pages write to the null page; their outputs are garbage the
    engine masks."""
    from repro_torch import kvcache
    from repro_torch.kernels.paged_attention.ops import paged_attention
    if a.window is not None:
        raise NotImplementedError("paged decode: sliding window unsupported")
    b = x.shape[0]
    kvh = a.kv_heads_effective()
    kvh_store = cache["k_pages"].shape[2]
    posv = pos[:, None]
    q = linear_apply(p["wq"], x).reshape(b, 1, a.heads_padded, a.head_dim)
    k_new = linear_apply(p["wk"], x).reshape(b, 1, kvh, a.head_dim)
    v_new = linear_apply(p["wv"], x).reshape(b, 1, kvh, a.head_dim)
    q = apply_rope(q, posv, a.rope_theta)[:, 0]                  # (S,H,D)
    k_new = _merge_heads(apply_rope(k_new, posv, a.rope_theta),
                         kvh_store)[:, 0]                        # (S,KH,D)
    v_new = _merge_heads(v_new, kvh_store)[:, 0]
    cache = kvcache.paged_write_batch(cache, pos, k_new, v_new)
    k_pages, v_pages, k_sc, v_sc, bt = kvcache.paged_views(cache)
    o = paged_attention(q.contiguous(), k_pages, v_pages, bt,
                        (pos + 1).to(torch.int32), k_sc, v_sc)   # (S,H,D)
    o = o.reshape(b, 1, a.heads_padded * a.head_dim)
    y = linear_apply(p["wo"], _mask_pad_heads(o.to(x.dtype), a))
    return y, cache

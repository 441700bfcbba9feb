"""Attention (MHA / MQA / GQA: one grouped implementation).

Entry points per layer, as in ``repro/models/attention.py``:
  * ``attention_forward``      — full-sequence causal attention
  * ``attention_prefill``      — the same, filling a contiguous cache
  * ``attention_prefill_paged`` — one prompt chunk per row straight
    into a paged cache, attended through the prefix-extend op
    (``kernels/paged_attention``)
  * ``attention_verify_paged`` — a speculative verify chunk (last
    accepted token + drafts) per slot against its paged prefix, through
    the same prefix-extend op; the chunk's K/V goes to a bf16 staging
    cache, not to the pages
  * ``attention_decode_paged`` — one token per slot, all slots in one
    paged-attention launch (``kernels/paged_attention``)
  * ``attention_decode``       — one token per row over a contiguous
    cache (the eager ``Engine``'s and a draft LM's decode), bf16 / float32
    or int8 / fp8 with per-position scales, plain torch as in the
    reference

On CUDA tensors the full-sequence products always go through the flash
kernel (``kernels/flash_attention``): the same online softmax as
``chunked_attention``, never materializing the (S, T) scores, and the
port's memory-bounded attention at any length.  On the CPU the choice is
the reference's: ``use_flash`` takes the flash op's plain version, else
``attn_impl`` "chunked" (or "auto" at S >= ``chunk_min``) takes
``chunked_attention`` and anything else the plain grouped ``sdpa``.
Cache allocation and writes live in ``repro_torch.kvcache``; quantized
contiguous caches are read fused (the K scale multiplies the scores, the
V scale folds into the probabilities), with no dequantized copy.
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


# ---------------------------------------------------------------------------
# Chunked attention: online softmax over kv blocks (the reference's XLA
# fallback for long sequences; the flash kernel computes the same function)


def _block_attn(q, k, v, carry, mask, scale):
    """One (q_block x kv_block) online-softmax update.
    q: (B,KH,G,Sq,D)  k,v: (B,KH,Bk,D)  carry = (m, l, acc) in fp32."""
    m_prev, l_prev, acc = carry
    s = torch.einsum("bkgsd,bktd->bkgst", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[None, None, None], s,
                        torch.tensor(NEG_INF, device=s.device))
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgst,bktd->bkgsd", p.to(v.dtype), v)
    return m_new, l_new, acc * corr[..., None] + pv.float()


def chunked_attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int],
                      scale: torch.Tensor, q_block: int = 1024,
                      kv_block: int = 1024) -> torch.Tensor:
    """qg: (B,S,KH,G,D)  k,v: (B,T,KH,D) -> (B,S,KH,G,D) in v's dtype.

    The (S, T) scores are never materialized: each q block walks the kv
    blocks with a running (max, denominator, accumulator).  Blocks that do
    not divide S and T fall back to one block each, as in the reference.
    A q block visits only the kv blocks its causal / window mask can
    reach (the reference's block bounds); a skipped block would add
    exact zeros, so the result is the reference's rolled scan's."""
    b, s, kh, g, d = qg.shape
    t = k.shape[1]
    qb, kb = min(q_block, s), min(kv_block, t)
    if s % qb or t % kb:
        qb, kb = s, t                       # fallback: single block
    nq, nk = s // qb, t // kb
    q_sw = qg.permute(0, 2, 3, 1, 4)                   # (B,KH,G,S,D)
    k_sw, v_sw = k.transpose(1, 2), v.transpose(1, 2)  # (B,KH,T,D)
    dev = qg.device
    outs = []
    for qi in range(nq):
        hi = nk if not causal else min(nk, ((qi + 1) * qb + kb - 1) // kb)
        lo = 0 if window is None else max(0, (qi * qb - window) // kb)
        carry = (torch.full((b, kh, g, qb), NEG_INF, device=dev),
                 torch.zeros((b, kh, g, qb), device=dev),
                 torch.zeros((b, kh, g, qb, d), device=dev))
        q_i = q_sw[:, :, :, qi * qb:(qi + 1) * qb]
        qpos = qi * qb + torch.arange(qb, device=dev)[:, None]
        for j in range(lo, hi):
            kpos = j * kb + torch.arange(kb, device=dev)[None, :]
            mask = None
            if causal or window is not None:
                mask = torch.ones((qb, kb), dtype=torch.bool, device=dev)
                if causal:
                    mask &= kpos <= qpos
                if window is not None:
                    mask &= kpos > qpos - window
            carry = _block_attn(q_i, k_sw[:, :, j * kb:(j + 1) * kb],
                                v_sw[:, :, j * kb:(j + 1) * kb], carry,
                                mask, scale)
        _, l, acc = carry
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    o = torch.cat(outs, dim=3)                         # (B,KH,G,S,D)
    return o.permute(0, 3, 1, 2, 4).to(v.dtype)


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
             positions: torch.Tensor, impl: str = "ref"):
    """q (B,S,Hp,D), rotated k (B,S,KH,D) and v from one projection."""
    b, s, _ = x.shape
    kvh = a.kv_heads_effective()
    q = linear_apply(p["wq"], x, impl).reshape(b, s, a.heads_padded,
                                               a.head_dim)
    k = linear_apply(p["wk"], x, impl).reshape(b, s, kvh, a.head_dim)
    v = linear_apply(p["wv"], x, impl).reshape(b, s, kvh, a.head_dim)
    return (apply_rope(q, positions, a.rope_theta),
            apply_rope(k, positions, a.rope_theta), v)


def _attend(p: dict, q, k, v, a: AttentionConfig, use_flash: bool,
            impl: str = "ref", attn_impl: str = "auto", q_block: int = 1024,
            kv_block: int = 1024, chunk_min: int = 2048):
    b, s = q.shape[:2]
    kvh = a.kv_heads_effective()
    # CUDA tensors always take the flash kernel; the flags pick the
    # branch only on the CPU, where the op runs its plain version (the
    # parity tests hold every branch against the reference's)
    if q.is_cuda or (use_flash and a.causal):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=a.causal,
                            window=a.window if a.causal else None)
    else:
        qg = q.reshape(b, s, kvh, a.heads_padded // kvh, a.head_dim)
        if attn_impl == "chunked" or (attn_impl == "auto"
                                      and s >= chunk_min):
            o = chunked_attention(qg, k, v, causal=a.causal,
                                  window=a.window,
                                  scale=_scale(a).to(q.device),
                                  q_block=q_block, kv_block=kv_block)
        else:
            mask = (causal_mask(s, s, window=a.window, device=q.device)
                    if a.causal else None)
            o = sdpa(qg, k, v, mask, _scale(a).to(q.device))
    o = o.reshape(b, s, a.heads_padded * a.head_dim)
    return linear_apply(p["wo"], _mask_pad_heads(o, a), impl)


def attention_forward(p: dict, x: torch.Tensor, a: AttentionConfig, *,
                      use_flash: bool = False, impl: str = "ref",
                      **chunk_kw) -> torch.Tensor:
    """Full-sequence attention at positions [0, S).  x: (B,S,d) -> (B,S,d).
    ``impl`` is the quantized linears' ``quant_matmul_impl``; ``chunk_kw``
    (``attn_impl``, ``q_block``, ``kv_block``, ``chunk_min``) picks
    chunked attention on the CPU, as the reference's config does."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project(p, x, a, positions, impl)
    return _attend(p, q, k, v, a, use_flash, impl, **chunk_kw)


def attention_prefill(p: dict, x: torch.Tensor, a: AttentionConfig,
                      cache: dict, *, use_flash: bool = False,
                      impl: str = "ref", **chunk_kw
                      ) -> tuple[torch.Tensor, dict]:
    """Full-seq attention AND fill the contiguous cache for positions
    [0, s) (int8 / fp8 caches quantized per position on the way in).
    K/V are projected once and shared by both (the reference projects
    them twice; the values are identical)."""
    from repro_torch import kvcache
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project(p, x, a, positions, impl)
    y = _attend(p, q, k, v, a, use_flash, impl, **chunk_kw)
    kvh_store = cache["k"].shape[2]
    cache = kvcache.prefill_write(cache, {"k": _merge_heads(k, kvh_store),
                                          "v": _merge_heads(v, kvh_store)})
    return y, cache


# ---------------------------------------------------------------------------
# Paged prefill (chunked prefill continuation)


def attention_prefill_paged(p: dict, x: torch.Tensor, a: AttentionConfig,
                            cache: dict, spos, impl: str = "ref"
                            ) -> tuple[torch.Tensor, dict]:
    """Chunked / continuation prefill directly against a paged KV cache.

    x: (B,c,d) — one prompt chunk per row; ``spos`` is ``(slot_ids (B,),
    starts (B,), lengths (B,)[, max_pages])``: row b's chunk covers logical
    positions ``starts[b] .. starts[b]+lengths[b]-1`` of slot
    ``slot_ids[b]`` (rows right-padded to c).  The optional ``max_pages``
    (a Python int) narrows the block table handed to the kernel to its
    first ``max_pages`` columns; the result is the same, the kernel never
    reads a page past a row's prefix.

    The chunk's K/V is written into the slot's pages (in place) and its
    queries attend the cached prefix (positions < starts[b], read page by
    page) plus the chunk's own fresh K/V causally, in one prefix-extend
    launch.  A prefix-cache warm start and a cold chunked run execute the
    same computation for any continuation chunk."""
    from repro_torch import kvcache
    from repro_torch.kernels.paged_attention.ops import (
        paged_prefix_extend_attention)
    if a.window is not None:
        raise NotImplementedError("paged prefill: sliding window unsupported")
    slot_ids, starts, lengths, *rest = spos
    max_pages = rest[0] if rest else None
    b, c, _ = x.shape
    kvh_store = cache["k_pages"].shape[2]
    apos = starts[:, None].long() + torch.arange(c, device=x.device)[None, :]
    q, k_new, v_new = _project(p, x, a, apos, impl)
    k_new = _merge_heads(k_new, kvh_store).contiguous()
    v_new = _merge_heads(v_new, kvh_store).contiguous()
    cache = kvcache.paged_scatter_prefill(cache, slot_ids, lengths, k_new,
                                          v_new, starts)
    # the prefix < starts[b] is read from the pages; the chunk's own
    # just-scattered rows are masked there in favour of the fresh values
    kp, vp, k_sc, v_sc, bt = kvcache.paged_views(cache)
    rows = bt[slot_ids.long()]                                   # (B,P)
    if max_pages is not None and max_pages < rows.shape[1]:
        rows = rows[:, :max_pages]
    o = paged_prefix_extend_attention(
        q.contiguous(), kp, vp, rows.contiguous(), starts.to(torch.int32),
        k_new, v_new, lengths.to(torch.int32), k_sc, v_sc)
    o = o.reshape(b, c, a.heads_padded * a.head_dim)
    y = linear_apply(p["wo"], _mask_pad_heads(o.to(x.dtype), a), impl)
    return y, cache


# ---------------------------------------------------------------------------
# Speculative verify


def attention_verify_paged(p: dict, x: torch.Tensor, a: AttentionConfig,
                           cache: dict, stage: dict, spos, impl: str = "ref"
                           ) -> tuple[torch.Tensor, dict]:
    """Speculative-verify attention: score W chunk positions per slot in
    one prefix-extend launch against the paged cache (``repro_torch.spec``).

    x: (S, W, d) — the fed chunk (last accepted token + drafts), right-
    padded; ``spos`` is ``(lengths (S,), widths (S,)[, max_pages])``: slot
    s's chunk sits at logical positions ``lengths[s] + [0, widths[s])``.
    Query w attends the cached prefix (positions < lengths[s], read from
    the pages; int8 / fp8 pools dequantized in the kernel) plus the chunk's
    own K/V causally (keys j <= w, j < widths[s]).  ``max_pages`` (a
    Python int) narrows the block table to its first columns: only the
    prefix is read from the pages, so the deepest slot's prefix bounds it.

    Write-after-accept: the chunk's K/V goes into the contiguous bf16
    ``stage`` node (in place), NOT the pages; the engine commits only the
    accepted prefix afterwards (``serve.paged.commit_spec_cache``), so a
    rejected tail never grows a page's running amax.  The kernel takes
    the chunk in bf16 whatever q's dtype (fp32 q takes its FMA step)."""
    from repro_torch import kvcache
    from repro_torch.kernels.paged_attention.ops import (
        paged_prefix_extend_attention)
    if a.window is not None:
        raise NotImplementedError("paged verify: sliding window unsupported")
    lengths, widths, *rest = spos
    max_pages = rest[0] if rest else None
    b, w, _ = x.shape
    kvh_store = cache["k_pages"].shape[2]
    apos = lengths[:, None].long() + torch.arange(w, device=x.device)[None, :]
    q, k_new, v_new = _project(p, x, a, apos, impl)
    k_new = _merge_heads(k_new, kvh_store)
    v_new = _merge_heads(v_new, kvh_store)
    stage = kvcache.prefill_write(stage, {"k": k_new, "v": v_new})
    kp, vp, k_sc, v_sc, bt = kvcache.paged_views(cache)
    if max_pages is not None and max_pages < bt.shape[1]:
        bt = bt[:, :max_pages]
    o = paged_prefix_extend_attention(
        q.contiguous(), kp, vp, bt.contiguous(), lengths.to(torch.int32),
        stage["k"][:, :w].contiguous(), stage["v"][:, :w].contiguous(),
        widths.to(torch.int32), k_sc, v_sc)
    o = o.reshape(b, w, a.heads_padded * a.head_dim)
    y = linear_apply(p["wo"], _mask_pad_heads(o.to(x.dtype), a), impl)
    return y, stage


# ---------------------------------------------------------------------------
# Contiguous decode


def attention_decode(p: dict, x: torch.Tensor, a: AttentionConfig,
                     cache: dict, pos: torch.Tensor, impl: str = "ref"
                     ) -> tuple[torch.Tensor, dict]:
    """One-token step over a contiguous cache (in place).  x: (B,1,d);
    pos: (B,) per-row positions; keys past a row's position (a reused
    slot's stale rows) and outside its window are masked.  bf16 / float32
    caches: scores accumulate in fp32 from q and the cache in q's dtype,
    and probabilities round to x's dtype before the V product.  int8 /
    fp8 caches, fused as the reference reads them: fp32 scores times the
    per-position K scale, fp32 probabilities times the V scale before the
    V product, rounded to x's dtype after it."""
    from repro_torch import kvcache
    b = x.shape[0]
    kvh = a.kv_heads_effective()
    kvh_store = cache["k"].shape[2]
    g = a.heads_padded // kvh_store
    pos = torch.broadcast_to(torch.as_tensor(pos, device=x.device).long(),
                             (b,))
    posv = pos[:, None]
    q = linear_apply(p["wq"], x, impl).reshape(b, 1, a.heads_padded,
                                               a.head_dim)
    k_new = linear_apply(p["wk"], x, impl).reshape(b, 1, kvh, a.head_dim)
    v_new = linear_apply(p["wv"], x, impl).reshape(b, 1, kvh, a.head_dim)
    q = apply_rope(q, posv, a.rope_theta)
    k_new = _merge_heads(apply_rope(k_new, posv, a.rope_theta), kvh_store)
    v_new = _merge_heads(v_new, kvh_store)
    cache = kvcache.decode_write(cache, {"k": k_new, "v": v_new}, pos)
    k_cache, v_cache, k_s, v_s = kvcache.kv_views(cache)
    kpos = torch.arange(k_cache.shape[1], device=x.device)
    valid = kpos[None, :] <= posv                                # (B,T)
    if a.window is not None:
        valid &= kpos[None, :] > posv - a.window
    valid = valid[:, None, None, None, :]
    neg = torch.tensor(NEG_INF, device=x.device)
    qg = q.reshape(b, 1, kvh_store, g, a.head_dim)
    scale = _scale(a).to(x.device)
    if k_s is None:
        scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                              k_cache.to(qg.dtype).float()) * scale
        probs = torch.softmax(torch.where(valid, scores, neg),
                              dim=-1).to(x.dtype)
        o = torch.einsum("bkgst,btkd->bskgd", probs, v_cache.to(x.dtype))
    else:
        # (B,T,KH) scales -> (B,KH,1,1,T) factors on the score/probs axes
        ks_t = k_s.transpose(1, 2)[:, :, None, None, :]
        vs_t = v_s.transpose(1, 2)[:, :, None, None, :]
        scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                              k_cache.float()) * scale * ks_t
        probs = torch.softmax(torch.where(valid, scores, neg), dim=-1)
        o = torch.einsum("bkgst,btkd->bskgd", probs * vs_t,
                         v_cache.float()).to(x.dtype)
    o = o.reshape(b, 1, a.heads_padded * a.head_dim)
    y = linear_apply(p["wo"], _mask_pad_heads(o, a), impl)
    return y, cache


# ---------------------------------------------------------------------------
# Paged decode


def attention_decode_paged(p: dict, x: torch.Tensor, a: AttentionConfig,
                           cache: dict, pos: torch.Tensor, impl: str = "ref"
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
    q = linear_apply(p["wq"], x, impl).reshape(b, 1, a.heads_padded,
                                               a.head_dim)
    k_new = linear_apply(p["wk"], x, impl).reshape(b, 1, kvh, a.head_dim)
    v_new = linear_apply(p["wv"], x, impl).reshape(b, 1, kvh, a.head_dim)
    q = apply_rope(q, posv, a.rope_theta)[:, 0]                  # (S,H,D)
    k_new = _merge_heads(apply_rope(k_new, posv, a.rope_theta),
                         kvh_store)[:, 0]                        # (S,KH,D)
    v_new = _merge_heads(v_new, kvh_store)[:, 0]
    cache = kvcache.paged_write_batch(cache, pos, k_new, v_new)
    k_pages, v_pages, k_sc, v_sc, bt = kvcache.paged_views(cache)
    o = paged_attention(q.contiguous(), k_pages, v_pages, bt,
                        (pos + 1).to(torch.int32), k_sc, v_sc)   # (S,H,D)
    o = o.reshape(b, 1, a.heads_padded * a.head_dim)
    y = linear_apply(p["wo"], _mask_pad_heads(o.to(x.dtype), a), impl)
    return y, cache

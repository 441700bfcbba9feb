"""Plain PyTorch versions of paged decode attention and of multi-query
prefix-extend attention (GQA, per-slot lengths).

The counterparts of ``repro/kernels/paged_attention/ref.py``
``paged_attention_ref`` and ``paged_prefix_extend_ref``: gather every
slot's pages into a contiguous copy and run a masked fp32 softmax.  Fully
masked rows (a free engine slot; an empty chunk row) return zeros, as the
kernels do.  Quantized pools (int8 / fp8 e4m3) are dequantized up front
with their per-(page, kv head) fp32 scales.  Pages wholly past a
slot's length are zeroed in V before the product: the reference kernels
never visit them (their contents are another slot's, or garbage, and an
fp8 page may hold NaN where the reference's conversion overflowed).  The
masked rows of a partly filled page are multiplied by zero probability,
as the reference kernels do.  Wrappers take these versions
for CPU tensors; ``chip_smoke.py`` holds the CUDA kernels against them on
the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _gather_pages(k_pages, v_pages, block_table, k_scales, v_scales):
    """Every slot's pages as contiguous fp32 (S, P·page, KH, D) K and V,
    dequantized with their per-(page, kv head) scales when given."""
    s_n, p_n = block_table.shape
    _, page, kh, d = k_pages.shape
    bt = block_table.long()
    k = k_pages[bt].float()                              # (S,P,page,KH,D)
    v = v_pages[bt].float()
    if k_scales is not None:
        k = k * k_scales[bt][:, :, None, :, None]
        v = v * v_scales[bt][:, :, None, :, None]
    return (k.reshape(s_n, p_n * page, kh, d),
            v.reshape(s_n, p_n * page, kh, d))


def _visited(p_n: int, page: int, lengths: torch.Tensor) -> torch.Tensor:
    """(S, P·page) bool: positions on a page that starts below the slot's
    length, the pages the reference kernels visit."""
    start = torch.arange(p_n * page, device=lengths.device) // page * page
    return start[None, :] < lengths[:, None]


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        lengths: torch.Tensor,
                        k_scales: Optional[torch.Tensor] = None,
                        v_scales: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q: (S,H,D); k_pages/v_pages: (N,page,KH,D); block_table: (S,P) int32;
    lengths: (S,) int32 — keys at kpos < lengths[s] are live;
    k_scales/v_scales: (N,KH) fp32 for quantized pools -> (S,H,D)."""
    s_n, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    p_n = block_table.shape[1]
    g = h // kh
    k, v = _gather_pages(k_pages, v_pages, block_table, k_scales,
                         v_scales)                       # (S,T,KH,D)
    qg = q.reshape(s_n, kh, g, d).float()
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    scores = torch.einsum("skgd,stkd->skgt", qg, k) * scale
    valid = (torch.arange(p_n * page, device=q.device)[None, :]
             < lengths[:, None])                         # (S,T)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    v = torch.where(_visited(p_n, page, lengths)[:, :, None, None], v, 0.0)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * valid[:, None, None, :]
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("skgt,stkd->skgd", p / torch.clamp(l, min=1e-30), v)
    return o.reshape(s_n, h, d).to(q.dtype)


def paged_prefix_extend_ref(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_table: torch.Tensor,
                            prefix_lens: torch.Tensor, chunk_k: torch.Tensor,
                            chunk_v: torch.Tensor, widths: torch.Tensor,
                            k_scales: Optional[torch.Tensor] = None,
                            v_scales: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Multi-query prefix-extend attention.

    q: (S,W,H,D) — query ``w`` of slot ``s`` sits at logical position
    ``prefix_lens[s] + w``.  Every query attends the slot's paged prefix
    (positions < prefix_lens[s]; whatever the pages hold at or past it —
    a prefill chunk's own just-scattered rows — is masked in favour of the
    fresh chunk) and the chunk's own K/V ``chunk_k``/``chunk_v``
    (S,W,KH,D) causally: key ``j <= w`` with ``j < widths[s]``.  Rows at
    ``w >= widths[s]`` are padding, computed under the same masks.
    -> (S,W,H,D) in q's dtype."""
    s_n, w_n, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    t = block_table.shape[1] * page
    g = h // kh
    k, v = _gather_pages(k_pages, v_pages, block_table, k_scales, v_scales)
    qg = q.reshape(s_n, w_n, kh, g, d).float()
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    neg = torch.tensor(NEG_INF, device=q.device)
    s_ctx = torch.einsum("swkgd,stkd->skgwt", qg, k) * scale
    ctx_ok = (torch.arange(t, device=q.device)[None, :]
              < prefix_lens[:, None])                             # (S,T)
    s_ctx = torch.where(ctx_ok[:, None, None, None, :], s_ctx, neg)
    v = torch.where(_visited(block_table.shape[1], page,
                             prefix_lens)[:, :, None, None], v, 0.0)
    s_chk = torch.einsum("swkgd,sjkd->skgwj", qg, chunk_k.float()) * scale
    jj = torch.arange(w_n, device=q.device)
    chk_ok = ((jj[None, :] <= jj[:, None])[None]
              & (jj[None, None, :] < widths[:, None, None]))      # (S,W,W)
    s_chk = torch.where(chk_ok[:, None, None], s_chk, neg)
    s_all = torch.cat([s_ctx, s_chk], dim=-1)
    ok_all = torch.cat([ctx_ok[:, None, :].expand(s_n, w_n, t), chk_ok],
                       dim=-1)                                    # (S,W,T+W)
    m = s_all.amax(dim=-1, keepdim=True)
    p = torch.exp(s_all - m) * ok_all[:, None, None]
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    o = (torch.einsum("skgwt,stkd->swkgd", p[..., :t], v)
         + torch.einsum("skgwj,sjkd->swkgd", p[..., t:], chunk_v.float()))
    return o.reshape(s_n, w_n, h, d).to(q.dtype)

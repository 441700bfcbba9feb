"""Plain PyTorch version of paged decode attention (GQA, per-slot lengths).

The counterpart of ``repro/kernels/paged_attention/ref.py``
``paged_attention_ref``: gather every slot's pages into a contiguous copy
and run a masked fp32 softmax.  Fully masked slots (length 0, a free
engine slot) return zeros, as the kernel does.  Quantized pools (int8 /
fp8 e4m3) are dequantized up front with their per-(page, kv head) fp32
scales.  Wrappers take this version for CPU tensors; ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


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
    bt = block_table.long()
    k = k_pages[bt].float()                              # (S,P,page,KH,D)
    v = v_pages[bt].float()
    if k_scales is not None:
        k = k * k_scales[bt][:, :, None, :, None]
        v = v * v_scales[bt][:, :, None, :, None]
    k = k.reshape(s_n, p_n * page, kh, d)                # (S,T,KH,D)
    v = v.reshape(s_n, p_n * page, kh, d)
    qg = q.reshape(s_n, kh, g, d).float()
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    scores = torch.einsum("skgd,stkd->skgt", qg, k) * scale
    valid = (torch.arange(p_n * page, device=q.device)[None, :]
             < lengths[:, None])                         # (S,T)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * valid[:, None, None, :]
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("skgt,stkd->skgd", p / torch.clamp(l, min=1e-30), v)
    return o.reshape(s_n, h, d).to(q.dtype)

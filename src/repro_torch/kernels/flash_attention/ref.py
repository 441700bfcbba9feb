"""Plain PyTorch version of flash attention (GQA, causal, sliding window).

The counterpart of ``repro/kernels/flash_attention/ref.py``
``attention_ref``: fp32 scores, masked softmax, fp32 p·v, output in the
input dtype.  Wrappers take it for CPU tensors; ``chip_smoke.py`` holds
the CUDA kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,KH,D) with H % KH == 0 -> (B,S,H,D)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, d).float()
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        m = kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
        scores = torch.where(m[None, None, None], scores,
                             torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return o.reshape(b, s, h, d).to(q.dtype)

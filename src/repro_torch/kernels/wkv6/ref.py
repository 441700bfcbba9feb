"""Plain PyTorch versions of the RWKV-6 WKV recurrence.

The counterparts of ``repro/kernels/wkv6/ref.py``.  Per head (D = head
dim), all fp32:

    o_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t = exp(logw_t) ∈ (0,1)

``wkv6_scan_ref``    — step by step (the ground-truth oracle).
``wkv6_chunked_ref`` — the chunked linear-attention form that the CUDA
kernel computes; every exponent is a difference of cumulative log-decays
(≤ 0).  Unlike the reference's chunked form it takes any sequence length:
the tail chunk is padded with r = k = v = 0 and logw = 0, which adds
k⊗v = 0 to the state and decays it by exp(0) = 1, so the state is exactly
what the real tokens leave, and the pad rows of o are dropped.
"""
from __future__ import annotations

from typing import Tuple

import torch

DEFAULT_CHUNK = 64


def wkv6_scan_ref(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,logw: (B,S,H,D) fp32; u: (H,D); s0: (B,H,D,D) -> (o, s_final)."""
    s = s0
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,D,D)
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 s + u[None, :, :, None] * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv6_chunked_ref(r, k, v, logw, u, s0, *, chunk: int = DEFAULT_CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,logw: (B,S,H,D) fp32 (any S >= 1); u: (H,D); s0: (B,H,D,D)
    fp32 -> (o (B,S,H,D), s_final (B,H,D,D))."""
    b, s, h, d = r.shape
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                         for x in (r, k, v, logw))
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)                            # q < t
    eye = torch.eye(c, dtype=r.dtype, device=r.device)
    state = s0
    outs = []
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        r_c, k_c, v_c, lw_c = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        cw = torch.cumsum(lw_c, dim=1)                       # inclusive
        cwe = cw - lw_c                                      # exclusive
        # pairwise decay exponent (t, q): cwe_t - cw_q  (≤ 0 for q < t)
        diff = cwe[:, :, None] - cw[:, None, :]              # (B,C,C,H,D)
        decay = torch.where(tri[None, :, :, None, None], torch.exp(diff),
                            torch.zeros((), dtype=r.dtype, device=r.device))
        scores = torch.einsum("bthd,bqhd,btqhd->bhtq", r_c, k_c, decay)
        diag = torch.einsum("bthd,bthd,hd->bht", r_c, k_c, u)
        scores = scores + diag[:, :, :, None] * eye[None, None]
        o_intra = torch.einsum("bhtq,bqhd->bthd", scores, v_c)
        o_state = torch.einsum("bthd,bhde->bthe", r_c * torch.exp(cwe), state)
        w_end = cw[:, -1]                                    # (B,H,D)
        kdec = k_c * torch.exp(w_end[:, None] - cw)          # (B,C,H,D)
        state = (torch.exp(w_end)[..., None] * state
                 + torch.einsum("bqhd,bqhe->bhde", kdec, v_c))
        outs.append(o_intra + o_state)
    o = torch.cat(outs, dim=1)[:, :s]
    return o, state

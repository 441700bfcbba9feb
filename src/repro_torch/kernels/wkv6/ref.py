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
``wkv6_tc_emulate`` — the CUDA kernel's own arithmetic (the state chunk
after chunk, then a chunk-parallel output pass, products on the tensor
cores from TF32 hi + lo operands), for the tests only: it shows on the
CPU that the kernel's plan meets the bar the card holds it to.
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
        # the exponent is masked before exp as well as after: the values
        # are the reference's, and a large positive diff above the
        # diagonal cannot turn the backward's 0 * exp(diff) into NaN
        live = tri[None, :, :, None, None]
        decay = torch.where(live, torch.exp(torch.where(live, diff, 0.0)),
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


SUB = 16    # tokens of a sub-chunk: one 16-row tensor-core block
TILE = 4    # tokens of an FMA tile in a diagonal block


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tc_product(a: torch.Tensor, b: torch.Tensor, split: str):
    """a @ b as the kernel feeds the tensor cores, fp32 sums.  "tf32x3":
    each operand as hi = tf32(x) and lo = tf32(x - hi), three products
    hi·hi + hi·lo + lo·hi (an operand exact in TF32, such as a bf16
    value, has lo = 0).  "bf16": each operand as one bf16 term."""
    if split == "bf16":
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + ah @ bl + al @ bh


def _diag_block(r, k, cw, cwe, u):
    """Scores of one diagonal sub-chunk block on the kernel's FMA tiles:
    (..., n, D) operands, n a multiple of 4 -> (..., n, n), q <= t.  A
    tile below the diagonal factors exp(cwe_t - cw_q) at its anchor a (the
    tile's last cw): both exponents are <= 0.  A tile on the diagonal
    takes one exponential a pair and the u bonus at q = t."""
    n = r.shape[-2]
    sc = torch.zeros(r.shape[:-2] + (n, n), dtype=r.dtype)
    for tt in range(n // TILE):
        t = slice(TILE * tt, TILE * tt + TILE)
        for tq in range(tt):
            q = slice(TILE * tq, TILE * tq + TILE)
            a = cw[..., TILE * tq + TILE - 1, None, :]
            ra = r[..., t, :] * torch.exp(cwe[..., t, :] - a)
            kb = k[..., q, :] * torch.exp(a - cw[..., q, :])
            sc[..., t, q] = ra @ kb.transpose(-1, -2)
        for x in range(TILE):
            tx = TILE * tt + x
            for y in range(x):
                qy = TILE * tt + y
                sc[..., tx, qy] = (r[..., tx, :] * k[..., qy, :] * torch.exp(
                    cwe[..., tx, :] - cw[..., qy, :])).sum(-1)
            sc[..., tx, tx] = (r[..., tx, :] * k[..., tx, :] * u).sum(-1)
    return sc


def wkv6_tc_emulate(r, k, v, logw, u, s0, *, chunk: int = DEFAULT_CHUNK,
                    split: str = "tf32x3"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's arithmetic on the CPU (tests only).  r,k,v,logw:
    (B,S,H,D), any S >= 1, in the type the kernel reads them (bf16 r/k/v
    are exact in fp32); u: (H,D); s0: (B,H,D,D) -> (o, s_final) fp32.

    State, chunk after chunk: ΔS = (k ⊙ exp(cw_end - cw))ᵀ v and S <-
    exp(cw_end) ⊙ S + ΔS, the state entering each chunk kept (the kernel
    forms every ΔS in parallel, then carries S along them).  Output
    pass, every chunk on its own: scores in 16-token sub-chunks, block (i,
    j < i) as (r_i ⊙ exp(cwe_i - A_i)) (k_j ⊙ exp(A_i - cw_j))ᵀ with A_i
    the cwe of sub-chunk i's first token (every exponent <= 0), diagonal
    blocks on fp32 FMA tiles (``_diag_block``); o = scores v + (r ⊙
    exp(cwe)) S_entering.  Every product takes its fp32 operands as TF32
    hi + lo terms (``split`` "tf32x3", the kernel's) or as one bf16 term
    (``split`` "bf16", which the tests show is not enough)."""
    b, s, h, d = r.shape
    r, k, v, logw = (x.float().permute(0, 2, 1, 3) for x in (r, k, v, logw))
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                         for x in (r, k, v, logw))
    u = u.float()[None]                                  # (1,H,D)
    state = s0.float()
    entering, outs = [], []
    for c in range(nc):                                  # the state
        sl = slice(c * chunk, (c + 1) * chunk)
        cw = torch.cumsum(logw[:, :, sl], dim=2)
        w_end = cw[:, :, -1]                             # (B,H,D)
        kd = k[:, :, sl] * torch.exp(w_end[:, :, None] - cw)
        entering.append(state)
        state = (torch.exp(w_end)[..., None] * state
                 + _tc_product(kd.transpose(-1, -2), v[:, :, sl], split))
    for c in range(nc):                                  # output pass
        sl = slice(c * chunk, (c + 1) * chunk)
        r_c, k_c, v_c, lw_c = (x[:, :, sl] for x in (r, k, v, logw))
        cw = torch.cumsum(lw_c, dim=2)
        cwe = cw - lw_c
        scores = torch.zeros((b, h, chunk, chunk))
        anchor = [cwe[:, :, SUB * i, None, :] for i in range(chunk // SUB)]
        for i in range(chunk // SUB):
            ti = slice(SUB * i, SUB * i + SUB)
            rp = r_c[:, :, ti] * torch.exp(cwe[:, :, ti] - anchor[i])
            for j in range(i):
                # k * exp(A_i - cw) as the kernel forms it: k * exp(A_(j+1)
                # - cw) once a token, times exp(A_i - A_(j+1)) a channel
                tj = slice(SUB * j, SUB * j + SUB)
                kp = (k_c[:, :, tj] * torch.exp(anchor[j + 1] - cw[:, :, tj])
                      * torch.exp(anchor[i] - anchor[j + 1]))
                scores[:, :, ti, tj] = _tc_product(rp, kp.transpose(-1, -2),
                                                   split)
            scores[:, :, ti, ti] = _diag_block(
                r_c[:, :, ti], k_c[:, :, ti], cw[:, :, ti], cwe[:, :, ti], u)
        outs.append(_tc_product(scores, v_c, split)
                    + _tc_product(r_c * torch.exp(cwe), entering[c], split))
    o = torch.cat(outs, dim=2)[:, :, :s].permute(0, 2, 1, 3).contiguous()
    return o, state

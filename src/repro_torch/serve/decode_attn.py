"""Context-parallel decode attention (the flash-decoding combine): the
port's copy of ``repro/serve/decode_attn.py``.

When the model axis does not divide the kv-head count (qwen2-1.5b's 2 kv
heads on 4 ranks), a rank cannot hold whole kv heads, and the reference
notes that naive pjit would all-gather the whole cache every step.  The
fix: split the cache's *sequence* over the axis, let each rank compute
fp32 partial softmax statistics (o·l, m, l) over its shard, and combine
them with one max and two sum all-reduces of (B, KH, G[, D]) instead of
moving (B, S, KH, D):

    m_g = max_s m_s;   l_g = Σ_s l_s·e^{m_s−m_g};
    o_g = Σ_s o_s·e^{m_s−m_g} / l_g

:func:`context_parallel_decode` is the reference's function of the same
name (its ``shard_map`` becomes this rank's call: the caches it takes are
the rank's shard); ``models.attention.attention_decode_cp`` is the
decode step built on :func:`partial_attn` and :func:`combine`, which
``models.transformer.group_forward`` dispatches to when the config asks
for ``decode_attn_impl="cp"`` under a mesh.  The combine's three
all-reduces run in fp32 and are its only collectives; the result is the
same on every rank of the axis.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding.collectives import all_reduce

NEG_INF = -1e30


def partial_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, scale):
    """q: (B,H,hd); k, v: (B,T,KH,hd); valid: (B,T) -> fp32 partials
    (o·l (B,KH,G,hd), m (B,KH,G), l (B,KH,G)) over this shard's T keys
    (the reference's ``_partial_attn``)."""
    b, kh = q.shape[0], k.shape[2]
    g = q.shape[1] // kh
    qg = q.reshape(b, kh, g, -1)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * scale
    mask = valid[:, None, None, :]
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=s.device))
    m = s.amax(dim=-1)                                           # (B,KH,G)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros((), device=p.device))
    l = p.sum(dim=-1)                                            # (B,KH,G)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o, m, l


def combine(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, mesh,
            axis: str = "model") -> torch.Tensor:
    """The shards' partials combined over ``axis``: one max and two sum
    all-reduces in fp32 -> (B,KH,G,hd) fp32, the same on every rank."""
    m_g = all_reduce(m, "max", mesh, axis)
    corr = torch.exp(m - m_g)
    l_g = all_reduce(l * corr, "sum", mesh, axis)
    o_g = all_reduce(o * corr[..., None], "sum", mesh, axis)
    return o_g / torch.clamp(l_g, min=1e-30)[..., None]


def shard_valid(pos: torch.Tensor, lo: int, s_local: int,
                window: Optional[int] = None) -> torch.Tensor:
    """(B, s_local) bool: the keys of the shard starting at global
    position ``lo`` that row b's query at ``pos[b]`` attends (causal, and
    inside ``window`` when given)."""
    kpos = lo + torch.arange(s_local, device=pos.device)
    valid = kpos[None, :] <= pos[:, None]
    if window is not None:
        valid &= kpos[None, :] > pos[:, None] - window
    return valid


def context_parallel_decode(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, pos, mesh, *,
                            axis: str = "model",
                            window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,hd), the same on every rank; ``k_cache`` / ``v_cache``:
    this rank's shard (B, S/n, KH, hd) of the sequence split over
    ``axis`` (rank i of the axis holds positions [i·S/n, (i+1)·S/n));
    ``pos``: the query position (a scalar, or (B,)).  Returns the (B,H,hd)
    attention output in q's dtype, the same on every rank."""
    b, h, hd = q.shape
    s_local = k_cache.shape[1]
    pos = torch.broadcast_to(torch.as_tensor(pos, device=q.device).long(),
                             (b,))
    lo = mesh.coords.get(axis, 0) * s_local
    valid = shard_valid(pos, lo, s_local, window)
    o, m, l = partial_attn(q, k_cache, v_cache, valid, 1.0 / (hd ** 0.5))
    return combine(o, m, l, mesh, axis).reshape(b, h, hd).to(q.dtype)

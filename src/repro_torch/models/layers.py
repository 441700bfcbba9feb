"""Core layers: norms, embeddings, rotary, SwiGLU MLP, linear.

Parameters are plain nested dicts of tensors, in the reference's layout
(``repro/models/layers.py``): a linear is ``{"w": (d_in, d_out)[, "b"]}``.
Each layer is a pair ``init_*(generator, ...) -> params`` and
``*_apply(params, x) -> y``.  The fp32 crossing points and the rounding
order are the reference's, so a float32 forward matches it to rounding.
"""
from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Linear


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.bfloat16,
                device=None) -> dict:
    scale = 1.0 / d_in ** 0.5
    w = torch.rand((d_in, d_out), generator=gen, device=device,
                   dtype=torch.float32) * (2 * scale) - scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms


def init_rmsnorm(d: int, dtype=torch.bfloat16, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype=torch.bfloat16, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p: dict, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def init_norm(kind: str, d: int, dtype=torch.bfloat16, device=None) -> dict:
    if kind == "rmsnorm":
        return init_rmsnorm(d, dtype, device)
    return init_layernorm(d, dtype, device)


def norm_apply(kind: str, p: dict, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm_apply(p, x, eps)
    return layernorm_apply(p, x, eps)


# ---------------------------------------------------------------------------
# Embedding


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32) * 0.02
    return {"w": w.to(dtype)}


def embedding_apply(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["w"][ids]


# ---------------------------------------------------------------------------
# Rotary position embeddings


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  Rotates in fp32 and rounds once to x's dtype."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             bias: bool = False, dtype=torch.bfloat16, device=None) -> dict:
    kw = dict(bias=bias, dtype=dtype, device=device)
    return {"gate": init_linear(gen, d_model, d_ff, **kw),
            "up": init_linear(gen, d_model, d_ff, **kw),
            "down": init_linear(gen, d_ff, d_model, **kw)}


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = linear_apply(p["gate"], x)
    u = linear_apply(p["up"], x)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return linear_apply(p["down"], h)

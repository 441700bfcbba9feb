"""Core layers: norms, embeddings, rotary, SwiGLU MLP, linear.

Parameters are plain nested dicts of tensors, in the reference's layout
(``repro/models/layers.py``): a linear is ``{"w": (d_in, d_out)[, "b"]}``,
or ``{"qw", "scale"[, "b"]}`` once quantized (``repro_torch.quant``).
Each layer is a pair ``init_*(generator, ...) -> params`` and
``*_apply(params, x) -> y``.  The fp32 crossing points and the rounding
order are the reference's, so a float32 forward matches it to rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.sharding.collectives import active, column_input

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


def linear_apply(p: dict, x: torch.Tensor, impl: str = "ref", *,
                 row: bool = False) -> torch.Tensor:
    """Dense or quantized linear, plus its PEFT adapter when it carries
    one (``"lora"``: the low-rank update of ``repro_torch.peft.lora``, in
    every forward, serving ones included).  Quantized params carry
    ``{"qw", "scale"}``; their bias goes to ``quantized_matmul`` (which
    folds it into the decode kernels' epilogue) and ``impl`` is the
    model's ``quant_matmul_impl``, or ``"train"`` in a training
    forward.  A ``"_capture"`` callable in ``p`` (calibration's copy of
    the tree, ``quant.calibrate.collect_linear_inputs``) is handed the
    input first.

    ``row=True`` marks a row-split linear (``wo``, ``down``): inside a
    tensor-parallel forward (``sharding.collectives.active()``) its
    rank computes the fp32 partial product over its slice of the
    contraction, and the partials are summed in fp32, rounded once and
    the bias added once (``sharding.tp.row_linear``).  Outside one the
    flag changes nothing.  A column-split linear (``row=False``) in a
    tensor-parallel training forward reads its input through
    ``collectives.column_input`` (identity forward, gradient summed over
    the model axis); serving, under ``no_grad``, reads ``x`` itself."""
    if "_capture" in p:
        p["_capture"](x)
    if not row:
        x = column_input(x)
    tp = active() if row else None
    if tp is not None:
        from repro_torch.sharding.tp import row_linear
        if "qw" in p:
            from repro_torch.quant.qops import row_partial
            part = row_partial(x, p, impl, tp.mesh)
        else:
            part = x.float() @ p["w"].float()
        y = row_linear(part, x.dtype, p.get("b"), tp.mesh)
    elif "qw" in p:
        from repro_torch.quant.qops import quantized_matmul
        y = quantized_matmul(x, p, bias=p.get("b"), impl=impl)
    else:
        y = x @ p["w"].to(x.dtype)
        if "b" in p:
            y = y + p["b"].to(y.dtype)
    if "lora" in p:
        from repro_torch.peft.lora import lora_delta
        y = y + lora_delta(p["lora"], x)
    return y


# ---------------------------------------------------------------------------
# Norms


def init_rmsnorm(d: int, dtype=torch.bfloat16, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The plain RMSNorm (the reference's ``rmsnorm_apply``) on any
    device; the model's norms go through :func:`norm_apply`."""
    return rmsnorm_ref(x, p["scale"], eps)


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


def norm_apply(kind: str, p: dict, x: torch.Tensor, eps: float, *,
               train: bool = False) -> torch.Tensor:
    """RMSNorm through the B7 op (its kernel on CUDA tensors, the plain
    version on the CPU); layernorm stays plain, as in the reference.  A
    training forward (``train=True``) takes the plain, differentiable
    :func:`rmsnorm_apply` on every device, as the reference trains
    through its jnp norm."""
    if kind == "rmsnorm":
        if train:
            return rmsnorm_apply(p, x, eps)
        return rmsnorm_ops.rmsnorm(x, p["scale"], eps)
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


def mlp_apply(p: dict, x: torch.Tensor, impl: str = "ref") -> torch.Tensor:
    g = linear_apply(p["gate"], x, impl)
    u = linear_apply(p["up"], x, impl)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return linear_apply(p["down"], h, impl, row=True)

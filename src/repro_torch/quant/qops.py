"""Quantized linear execution and weight-tree quantization.

The port's copy of ``repro/quant/qops.py``, AE-LLM's ``c_inf`` weight
arm: {bf16, fp8, int8, int4} applied to the parameter tree after
``LM.init``.  A quantized linear carries ``{"qw", "scale"[, "b"]}`` and
``models.layers.linear_apply`` sends it here.

int8 = W8A8 (dynamic per-row activation quantization).
int4 = W4A16 weight-only, packed two per byte (uint8).
fp8  = e4m3 weights, wide activations.

The execution choice is an argument, not a module-level context as in
the reference: ``impl`` is ``cfg.quant_matmul_impl``, passed down by the
model's forwards.  On CUDA tensors the kernels always run, whatever it
says.  On the CPU ``"fused"`` runs the kernels' plain versions and
``"ref"`` the oracles, as the reference's switch picks between its
Pallas kernels and jnp.  A training forward passes ``"train"``: the
reference's "ref" oracles on every device, which autograd differentiates
as JAX does the jnp ones (the int8 path passes gradient through the
activations' amax scale; ``round`` has zero gradient), and which launch
no kernel (the kernels have no backward).
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from repro_torch.kernels.int8_matmul.ops import (DECODE_M_MAX,
                                                 fp8_matmul_decode,
                                                 int4_matmul,
                                                 int8_matmul_dynamic,
                                                 w8a8_matmul_decode)
from repro_torch.kernels.int8_matmul.ref import (_div, int8_dot,
                                                 int8_matmul_ref,
                                                 quantize_colwise,
                                                 quantize_int4_colwise,
                                                 quantize_rowwise,
                                                 unpack_int4)

FP8 = torch.float8_e4m3fn
IMPLS = ("fused", "ref", "train")

QUANT_TARGETS = (r"/(wq|wk|wv|wo|gate|up|down|q_up|kv_up_k|kv_up_v|"
                 r"kv_down|in_proj|out_proj|wr|wg|wout)$")


def quantized_matmul(x: torch.Tensor, p: dict, *,
                     bias: Optional[torch.Tensor] = None,
                     impl: str = "ref") -> torch.Tensor:
    """Dispatch on ``qw``'s dtype: int8 = W8A8, uint8 = packed int4
    (W4A16), float8_e4m3fn = fp8 weights.  M is the product of
    ``x.shape[:-1]`` (the padded shape the caller passes): M <= 128 takes
    the decode kernels, larger M the tiled one.  ``bias`` (if given) is
    ALWAYS applied here — folded into the fp32 epilogue on the decode
    paths, added after the cast in the out type otherwise — so callers
    must not add it again."""
    if impl not in IMPLS:
        raise ValueError(f"unknown quant impl {impl!r}")
    qw = p["qw"]
    kernels = impl != "train" and (x.is_cuda or impl == "fused")
    m = 1
    for d in x.shape[:-1]:
        m *= d

    def _plus_bias(y):
        return y if bias is None else y + bias.to(y.dtype)

    def _decode(fn):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = fn(x2, qw, p["scale"], bias=bias, out_dtype=x.dtype)
        return y.reshape(*x.shape[:-1], qw.shape[1])

    if qw.dtype == torch.int8:
        if kernels and m <= DECODE_M_MAX:
            return _decode(w8a8_matmul_decode)
        if impl == "train":
            return _plus_bias(_int8_oracle(x, qw, p["scale"]))
        return _plus_bias(int8_matmul_dynamic(x, qw, p["scale"]))
    if qw.dtype == torch.uint8:
        return _plus_bias(int4_matmul(x, qw, p["scale"]))
    if qw.dtype == FP8:
        if kernels and m <= DECODE_M_MAX:
            return _decode(fp8_matmul_decode)
        # the per-column scale commutes with the contraction: applied to
        # the (smaller) output; the reference computes this outside any
        # Pallas kernel too
        y = x.float() @ qw.float()
        return _plus_bias((y * p["scale"]).to(x.dtype))
    raise ValueError(f"unrecognized quantized dtype {qw.dtype}")


def row_partial(x: torch.Tensor, p: dict, impl: str,
                mesh) -> torch.Tensor:
    """This rank's fp32 partial of a row-split quantized linear, with its
    scale applied and no bias (``sharding.tp.row_linear`` sums the
    partials and adds the bias once): x (..., K/m) holds the rank's slice
    of each row and ``qw`` the matching K/m rows.

    * int8 (W8A8): the activation quantization stays the whole row's:
      the ranks' row maxima are all-reduced (max) first, so each rank
      quantizes its slice to exactly the int8 values one rank would.
      Serving runs the tiled W8A8 op (B4 on CUDA tensors, any M: B5
      quantizes inside its launch, against the slice's own maxima); a
      training forward (impl ``"train"``) the reference's oracle, whose
      gradient reaches x only through the row maximum: summed over the
      ranks, it is split evenly over the row's elements that reach the
      maximum, whichever ranks hold them, as one rank splits it.
    * fp8: B6 (its plain version on the CPU under impl ``"fused"``) with
      an fp32 output at M <= 128 in serving; else the reference's plain
      fp32 product, the scale applied to the output.
    * int4 (packed two rows a byte along K): the plain unpack-and-
      dequantize product, as the reference's; a K/m that is odd would
      split a packed pair and is refused.
    In a training forward the scale (whole on every rank, applied to a
    partial) is read through ``collectives.replicated``."""
    from repro_torch.kernels.int8_matmul import ops as qmm
    from repro_torch.sharding.collectives import all_reduce, replicated
    if impl not in IMPLS:
        raise ValueError(f"unknown quant impl {impl!r}")
    qw = p["qw"]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    out_shape = (*x.shape[:-1], qw.shape[1])
    if qw.dtype == torch.int8:
        local = x2.float().abs().amax(dim=-1, keepdim=True)
        amax = all_reduce(local.detach(), "max", mesh)
        if impl != "train":
            xq, xs = quantize_rowwise(x2, amax)
            y = qmm.int8_matmul(xq, qw, xs, p["scale"],
                                out_dtype=torch.float32)
            return y.reshape(out_shape)
        # the gradient through the row maximum: one rank's splits it
        # evenly over the row's elements that reach it, so each rank
        # takes the share of them it holds (ties across ranks included)
        ties = (x2.detach().float().abs() == amax).sum(
            -1, keepdim=True).float()
        share = ties / all_reduce(ties, "sum", mesh)
        amax, ws = replicated(amax + (local - local.detach()) * share,
                              p["scale"])
        xq, xs = quantize_rowwise(x2, amax)
        y = int8_dot(xq, qw).float() * xs[:, None] * ws[None, :]
        return y.reshape(out_shape)
    if qw.dtype == torch.uint8:
        if k != 2 * qw.shape[0]:
            from repro_torch.sharding.tp import A88
            raise ValueError(
                f"row-split int4 linear: a rank's slice of K is {k} wide "
                f"against {qw.shape[0]} packed rows; int4 packs two rows "
                f"of K a byte, so the model axis must leave K/m even: {A88}")
        (ws,) = replicated(p["scale"])
        w = unpack_int4(qw).float() * ws[None, :]
        return (x2.float() @ w).reshape(out_shape)
    if qw.dtype == FP8:
        kernels = impl != "train" and (x.is_cuda or impl == "fused")
        if kernels and x2.shape[0] <= DECODE_M_MAX:
            y = fp8_matmul_decode(x2.contiguous(), qw, p["scale"],
                                  out_dtype=torch.float32)
            return y.reshape(out_shape)
        (ws,) = replicated(p["scale"])
        return ((x2.float() @ qw.float()) * ws).reshape(out_shape)
    raise ValueError(f"unrecognized quantized dtype {qw.dtype}")


def _int8_oracle(x: torch.Tensor, qw: torch.Tensor,
                 w_scale: torch.Tensor) -> torch.Tensor:
    """The reference's W8A8 oracle (row quantization, the exact int32
    product, ``(acc·xs)·ws``) in plain torch on any device."""
    xq, xs = quantize_rowwise(x.reshape(-1, x.shape[-1]))
    y = int8_matmul_ref(xq, qw, xs, w_scale, out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], qw.shape[1])


def quantize_linear(p: dict, *, quant: str,
                    scales: Optional[torch.Tensor] = None) -> dict:
    """One linear's params quantized (a new dict); ``scales`` is an
    optional per-input-channel equalization vector folded into w."""
    w = p["w"].float()
    if scales is not None:
        # the folded equalization (reference fault R9: nothing divides
        # the activations by it)
        w = w * torch.as_tensor(scales, dtype=torch.float32,
                                device=w.device)[:, None]
    out = {k: v for k, v in p.items() if k != "w"}
    if quant == "int8":
        qw, s = quantize_colwise(w)
    elif quant == "int4":
        qw, s = quantize_int4_colwise(w)
    elif quant == "fp8":
        amax = w.abs().amax(dim=0)
        s = _div(torch.clamp(amax, min=1e-8), 448.0)   # e4m3 max normal
        qw = (w / s[None, :]).to(FP8)
    else:
        raise ValueError(quant)
    out.update(qw=qw, scale=s)
    return out


def quantize_tree(params, *, quant: str = "int8",
                  targets: str = QUANT_TARGETS, calib: Optional[dict] = None):
    """Quantize every matching linear of a parameter tree (nested dicts
    and lists, paths joined with "/", a list's i-th entry named ``g{i}``
    as the reference names its unscanned groups; the port's layer stack
    is a list of groups, so every linear's ``w`` is 2-D).  ``calib`` maps
    a linear's path (``/layers/g0/blk0/mlp/gate``) to its equalization
    scales (``quant.calibrate``), folded into W before quantizing; the
    reference ignores it on its scanned (stacked) layout.  As in the
    reference's ``QUANT_TARGETS``, a MoE layer's expert stacks (bare ``(E, d, f)``
    arrays, not ``{"w"}`` linears) and its router (``/moe/router``, kept
    fp32) are not targets; its shared expert's ``gate`` / ``up`` /
    ``down`` are.  bf16 / none / fp16 return the tree as it is."""
    if quant in ("bf16", "none", "fp16"):
        return params

    def visit(node, prefix=""):
        if isinstance(node, list):
            return [visit(sub, f"{prefix}/g{i}") for i, sub in enumerate(node)]
        if not isinstance(node, dict):
            return node
        new = {}
        for name, sub in node.items():
            path = f"{prefix}/{name}"
            if (isinstance(sub, dict) and "w" in sub and sub["w"].ndim == 2
                    and re.search(targets, path)):
                new[name] = quantize_linear(
                    sub, quant=quant, scales=calib.get(path) if calib
                    else None)
            else:
                new[name] = visit(sub, path)
        return new

    return visit(params)


def memory_bytes(params) -> int:
    """Bytes of every tensor in a parameter tree."""
    if isinstance(params, dict):
        return sum(memory_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(memory_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0

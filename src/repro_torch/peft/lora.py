"""Parameter-efficient fine-tuning: LoRA, QLoRA, DoRA, rsLoRA.  The port's
copy of ``repro/peft/lora.py``, AE-LLM's ``c_ft`` arm.

Adapters sit *inside* the wrapped linear's dict under ``"lora"``, so
``models.layers.linear_apply`` adds their update in every forward;
``trainable_mask`` then freezes everything but the adapters.  Every
adapter leaf is an fp32 tensor of the tree, ``scaling`` too: it is a
trainable leaf that AdamW moves, as in the reference.

Scaling:   LoRA / QLoRA / DoRA: alpha / r     rsLoRA: alpha / sqrt(r)
QLoRA = LoRA on int4-quantized base weights (quantize first, then attach).
DoRA carries the base's column norms as a magnitude ``m``, trained and
decayed with the adapter; as in the reference, ``lora_delta`` does not
read it (ROADMAP C, faults of the reference).  Over a quantized base
(the search pairs dora with int4 weights) ``m`` is the dequantized
base's column norms, where the reference's ``init_lora`` fails an
assert.

The port's groups are unstacked, so an adapter is 2-D (``a`` (d_in, r),
``b`` (r, d_out), ``scaling`` (1,), ``m`` (d_out,)) where the
reference's scanned tree stacks it on the group axis.  The reference
draws ``a`` from ``jax.random``; the port draws it from a
``torch.Generator`` (the same distribution, other numbers).
"""
from __future__ import annotations

import re
from typing import Tuple, Union

import torch

from repro_torch.sharding.collectives import replicated
from repro_torch.tree import leaves, tree_map

# target projections for adapter injection (paper: attention + MLP)
DEFAULT_TARGETS = r"/(wq|wk|wv|wo|gate|up|down|q_up|kv_up_k|kv_up_v)$"
METHODS = ("lora", "qlora", "dora", "rslora")


def init_lora(gen: torch.Generator, d_in: int, d_out: int, *, rank: int,
              alpha: float, method: str = "lora", w_col_norm=None,
              device=None) -> dict:
    scale = alpha / (rank ** 0.5 if method == "rslora" else rank)
    f32 = dict(dtype=torch.float32, device=device)
    p = {"a": torch.randn((d_in, rank), generator=gen, **f32) * 0.01,
         "b": torch.zeros((rank, d_out), **f32),
         "scaling": torch.full((1,), scale, **f32)}
    if method == "dora":
        if w_col_norm is None:
            raise ValueError("dora needs the base weight's column norms")
        p["m"] = w_col_norm.float()                 # trainable magnitude
    return p


def lora_delta(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The low-rank update ``(x @ a) @ b * scaling`` in fp32, cast to x's
    dtype.  DoRA's ``m`` is not read, as in the reference.  Under a model
    axis (a column-split linear) ``b`` is the rank's columns and the
    update the rank's columns of it; in a training forward ``a`` and
    ``scaling``, whole on every rank but read against this rank's
    columns only, go through ``collectives.replicated`` (their gradients
    summed over the axis)."""
    a, scaling = replicated(p["a"], p["scaling"])
    y = (x.float() @ a) @ p["b"] * scaling
    return y.to(x.dtype)


def lora_row_partial(p: dict, x: torch.Tensor, part: torch.Tensor,
                     mesh) -> torch.Tensor:
    """A row-split linear's fp32 partial ``part`` (..., N) with this
    rank's share of the adapter's update added: the rank's K/m rows of
    ``a`` against its slice ``x`` (..., K/m) give a partial of ``x @ a``
    (r wide), summed over the model axis (one r-wide all-reduce; in
    training its gradient is summed back, since each rank's columns of
    ``b`` see only part of it); ``u @ b_local * scaling`` lands in the
    rank's own N/m columns of ``part``, and the linear's all-reduce
    carries it to every rank."""
    from repro_torch.sharding.collectives import (copy_to_model,
                                                  reduce_from_model)
    a, scaling = replicated(p["a"], p["scaling"])
    k, n = x.shape[-1], p["b"].shape[1]
    r0, c0 = mesh.model_rank * k, mesh.model_rank * n
    u = reduce_from_model(x.float() @ a[r0:r0 + k], mesh)
    if torch.is_grad_enabled() and u.requires_grad:
        u = copy_to_model(u, mesh)
    delta = u @ p["b"] * scaling
    return torch.cat([part[..., :c0], part[..., c0:c0 + n] + delta,
                      part[..., c0 + n:]], dim=-1)


def _col_norm(w: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(w.float(), dim=0)


def _dequantize(p: dict) -> torch.Tensor:
    """A quantized linear's fp32 (d_in, d_out) weight: int8 / fp8 ``qw``
    or packed int4, times the column scales."""
    from repro_torch.kernels.int8_matmul.ref import unpack_int4
    qw = p["qw"]
    w = unpack_int4(qw) if qw.dtype == torch.uint8 else qw
    return w.float() * p["scale"].float()[None, :]


def apply_peft(params, seed: Union[int, torch.Generator] = 0, *,
               method: str = "lora", rank: int = 16, alpha: float = 32.0,
               targets: str = DEFAULT_TARGETS):
    """Attach adapters to every linear of the tree whose path matches
    ``targets`` (dense ``{"w"}`` or quantized ``{"qw"}``; a packed int4
    ``qw`` holds two input rows a byte).  ``method`` is lora | qlora |
    dora | rslora (qlora expects the base already int4-quantized; its
    adapters attach as lora's); "full" returns the tree as it is.
    Adapters are drawn from ``seed`` (a generator on the weights' device,
    or an int for one) in the tree's order, on the weights' device."""
    if method == "full":
        return params
    if method not in METHODS:
        raise ValueError(f"unknown PEFT method {method!r}")
    gen = seed
    if not isinstance(seed, torch.Generator):
        dev = leaves(params)[0].device
        gen = torch.Generator(device=dev).manual_seed(int(seed))

    def visit(node, prefix=""):
        if isinstance(node, list):
            return [visit(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        new = {}
        for name, sub in node.items():
            path = f"{prefix}/{name}"
            if isinstance(sub, dict) and re.search(targets, path) and \
                    ("w" in sub or "qw" in sub):
                w = sub.get("w")
                if w is None:   # quantized base: dims from the packed qw
                    qw = sub["qw"]
                    d_in = qw.shape[0] * (2 if qw.dtype == torch.uint8 else 1)
                    d_out, dev = qw.shape[1], qw.device
                    cn = (_col_norm(_dequantize(sub)) if method == "dora"
                          else None)
                else:
                    d_in, d_out = w.shape
                    dev = w.device
                    cn = _col_norm(w) if method == "dora" else None
                sub = dict(sub)
                sub["lora"] = init_lora(gen, d_in, d_out, rank=rank,
                                        alpha=alpha, method=method,
                                        w_col_norm=cn, device=dev)
                new[name] = sub
            else:
                new[name] = visit(sub, path)
        return new

    return visit(params)


def trainable_mask(params, method: str = "lora"):
    """True for the leaves the optimizer updates: every leaf under
    ``"lora"`` (``scaling`` and DoRA's ``m`` included); all of them for
    "full"."""
    if method == "full":
        return tree_map(lambda _: True, params)

    def visit(node, in_lora=False):
        if isinstance(node, dict):
            return {k: visit(v, in_lora or k == "lora")
                    for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, in_lora) for v in node]
        return bool(in_lora)

    return visit(params)


@torch.no_grad()
def merge_lora(params, mesh=None):
    """Fold each dense linear's adapter into its weight (deployment):
    ``w + (a @ b) * scaling`` in fp32, rounded once to w's dtype.  An
    adapter on a quantized base stays attached, as in the reference.

    ``mesh``: ``params`` is one rank's tree under its model axis
    (``sharding.rules.shard_params``).  A column-split ``w`` (K, N/m) takes
    ``a @ b_local`` as it stands; a row-split one (K/m, N) takes the
    rank's K/m rows of ``a`` against ``b`` gathered whole over the axis
    (one all-gather a linear, on every rank), so the result is the rank's
    piece of the merged whole tree."""
    def visit(node):
        if isinstance(node, list):
            return [visit(v) for v in node]
        if not isinstance(node, dict):
            return node
        if "lora" in node and "w" in node:
            node = dict(node)
            lo = node.pop("lora")
            a, b, w = lo["a"], lo["b"], node["w"]
            if w.shape[0] != a.shape[0]:          # a rank's rows of w
                if mesh is None:
                    raise ValueError(
                        f"merge_lora: w {tuple(w.shape)} against a "
                        f"{tuple(a.shape)} is a row-split rank's piece; "
                        "pass its mesh")
                from repro_torch.sharding.collectives import all_gather
                k = w.shape[0]
                a = a[mesh.model_rank * k:(mesh.model_rank + 1) * k]
                b = all_gather(b, 1, mesh)
            delta = (a @ b) * lo["scaling"][..., None]
            node["w"] = (w.float() + delta).to(w.dtype)
        return {k: visit(v) for k, v in node.items()}

    return visit(params)


def count_trainable(params, mask) -> Tuple[int, int]:
    """(trainable elements, all elements) of the tree."""
    n = leaves(tree_map(lambda p, m: p.numel() if m else 0, params, mask))
    total = leaves(tree_map(lambda p: p.numel(), params))
    return int(sum(n)), int(sum(total))

"""Weight bridge: the reference's ``LM.init`` parameter tree, as numpy
arrays, into the port's parameters.

The reference keeps its layer stack either stacked on a leading group
axis (``scan_layers=True``) or as ``g{i}`` keys; the port keeps a list of
groups.  Linears keep the ``(d_in, d_out)`` layout on both sides, and a
tied head is the embedding on both sides.  bf16 and fp8 e4m3 arrays
arrive with an ``ml_dtypes`` dtype, which numpy cannot hand to torch
directly: they are recognised by ``dtype.name`` and cross bit for bit
through a 16- or 8-bit integer view.  Quantized trees (``{"qw", "scale"}``
linears: int8, packed-int4 uint8 or fp8 ``qw``) cross the same way, and so
do RWKV-6 blocks (``rwkv``: ``tmix``, ``wdecay``, ``u``, ``ln_x`` and the
five linears), Mamba blocks (``mamba``: ``in_proj``, ``x_proj``,
``dt_proj``, ``out_proj``, ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``
and ``D``), their recurrent states (:func:`state_from_numpy`) and MoE
layers (``moe``: the fp32 router, the ``(E, d, f)`` expert stacks, sliced
per group from the reference's ``(G, E, d, f)``, and the shared expert),
and so do PEFT adapters (``lora``: ``a``, ``b``, ``scaling`` and DoRA's
``m``, sliced per group like any other leaf) over dense or int4 bases,
and so do MLA attention (``kv_down``, ``k_rope``, ``kv_up_k``,
``kv_up_v``, ``q_up``[, ``q_down``]), cross-attention blocks (``norm_x``,
``xattn``) and the encoder, whose layers the reference stacks on a leading
axis and the port keeps as a list.  Every array keeps its numpy dtype.  :func:`params_to_numpy` goes the
other way (the tests compare whole trees after training steps).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def tensor_from_numpy(a: Any, device=None) -> torch.Tensor:
    """One numpy array (bf16 and fp8 e4m3 included) as a tensor on
    ``device``."""
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    return torch.from_numpy(a).to(device)


def _tree(node: Any, device, index=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, index) for k, v in node.items()}
    a = np.asarray(node)
    return tensor_from_numpy(a if index is None else a[index], device)


def _groups(stack: dict, cfg: ModelConfig, device) -> list:
    """A reference layer stack (``g{i}`` keys, or stacked on a leading
    group axis) -> the port's list of groups."""
    if "g0" in stack:
        return [_tree(stack[f"g{i}"], device) for i in range(cfg.num_groups)]
    return [_tree(stack, device, i) for i in range(cfg.num_groups)]


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """Reference parameter tree (nested dicts of numpy arrays) -> the
    port's parameters on ``device``."""
    groups = _groups(tree["layers"], cfg, device)
    out = {"embed": _tree(tree["embed"], device), "layers": groups,
           "final_norm": _tree(tree["final_norm"], device)}
    if not cfg.tie_embeddings:
        out["lm_head"] = _tree(tree["lm_head"], device)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [_tree(enc["layers"], device, i)
                       for i in range(cfg.encoder.num_layers)],
            "final_norm": _tree(enc["final_norm"], device)}
    return out


def state_from_numpy(cache: dict, cfg: ModelConfig, device=None) -> list:
    """Reference contiguous cache (``init_cache``, in either layout, as
    numpy arrays) -> the port's cache on ``device``: per block an
    attention block's ``{"kv": ...}`` (and a cross-attention block's
    ``xk`` / ``xv``), an RWKV-6 block's ``{"state": {"wkv", "x_prev"}}``
    or a Mamba block's ``{"state": {"ssm", "conv"}}``, mixed within a
    group in a hybrid model (jamba)."""
    return _groups(cache, cfg, device)


def _to_numpy(t):
    """A tensor as numpy; bf16 and fp8 widen to float32 exactly (numpy
    has neither, and the port imports no ``ml_dtypes``).  ``None`` (an
    integer leaf's gradient) stays ``None``."""
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.float()
    return t.numpy().copy()


def _numpy_tree(node: Any):
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    return _to_numpy(node)


def _stack(groups: list):
    first = groups[0]
    if isinstance(first, dict):
        return {k: _stack([g[k] for g in groups]) for k in first}
    if first is None:
        return None
    return np.stack(groups)


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The port's parameter (or gradient) tree -> the reference's layout
    as numpy: the groups stacked on a leading axis (``scan_layers``) or
    under ``g{i}`` keys, the encoder's layers always stacked."""
    groups = [_numpy_tree(g) for g in params["layers"]]
    out = {k: _numpy_tree(v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "layers": _stack([_numpy_tree(lp) for lp in enc["layers"]]),
            "final_norm": _numpy_tree(enc["final_norm"])}
    out["layers"] = (_stack(groups) if cfg.scan_layers
                     else {f"g{i}": g for i, g in enumerate(groups)})
    return {k: out[k] for k in params}

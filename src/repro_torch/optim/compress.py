"""Gradient compression with error feedback: the port's copy of
``repro/optim/compress.py``.

* top-k sparsification: keep the ``ratio`` largest-magnitude entries of
  each leaf (logical bytes ratio ``ratio``);
* int8 quantization: one scale a leaf, round to int8, dequantize (bytes
  ratio 0.25).

The error each leaves behind is fed into the next step's gradient.  The
train step applies it between the gradients and the clip when
``compress != "none"``.  Leaves without a gradient (``None``: integer
leaves) pass through.

"Each leaf" is a leaf of the reference's tree.  With ``stacked``
(``cfg.scan_layers``, the reference's default) the reference stacks a
group leaf over all groups, so the top-k threshold and the int8 scale
are taken over every group's copy of it together; the port's groups are
unstacked, so those copies are compressed as one unit here.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import leaves_with_path, tree_map


def init_error_feedback(params) -> Any:
    """Zero fp32 error for every float leaf (``None`` elsewhere)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                    if p.is_floating_point() else None, params)


def _by_unit(fn: Callable, grads, error, stacked: bool):
    """``fn(list of fp32 gradient-plus-error tensors) -> list of kept
    fp32 tensors`` over each unit (a leaf of the reference's tree) ->
    (compressed grads in their dtypes, new error)."""
    gl = leaves_with_path(grads)
    el = dict(leaves_with_path(error))
    units: dict = {}
    for path, g in gl:
        if g is not None:
            key = re.sub(r"^layers/\d+/", "layers/*/", path) \
                if stacked else path
            units.setdefault(key, []).append(path)
    gd = dict(gl)
    kept, err = {}, {}
    for paths in units.values():
        gfs = [gd[p].float() + el[p] for p in paths]
        for p, gf, k in zip(paths, gfs, fn(gfs)):
            kept[p], err[p] = k.to(gd[p].dtype), gf - k
    it_k = iter([kept.get(p) for p, _ in gl])
    it_e = iter([err.get(p, el[p]) for p, _ in gl])
    return (tree_map(lambda _: next(it_k), grads),
            tree_map(lambda _: next(it_e), grads))


def _topk(ratio: float):
    def fn(gfs):
        n = sum(g.numel() for g in gfs)
        k = max(1, int(n * ratio))
        mags = torch.cat([g.abs().reshape(-1) for g in gfs])
        thresh = torch.topk(mags, k).values[-1]
        return [torch.where(g.abs() >= thresh, g, torch.zeros_like(g))
                for g in gfs]
    return fn


def _int8(gfs):
    amax = torch.stack([g.abs().amax() for g in gfs]).amax()
    amax = torch.clamp(amax, min=1e-12)
    scale = amax / torch.full_like(amax, 127.0)
    return [torch.clamp(torch.round(g / scale), -127, 127) * scale
            for g in gfs]


@torch.no_grad()
def topk_compress(grads, error, *, ratio: float = 0.01,
                  stacked: bool = True):
    """-> (sparse grads, new error, logical bytes ratio)."""
    kept, err = _by_unit(_topk(ratio), grads, error, stacked)
    return kept, err, ratio


@torch.no_grad()
def int8_compress(grads, error, *, stacked: bool = True):
    """-> (dequantized grads, new error, bytes ratio 0.25)."""
    deq, err = _by_unit(_int8, grads, error, stacked)
    return deq, err, 0.25


def compress_grads(grads, error, *, scheme: str = "none",
                   topk_ratio: float = 0.01,
                   stacked: bool = True) -> Tuple[Any, Any, float]:
    if scheme == "none":
        return grads, error, 1.0
    if scheme == "topk":
        return topk_compress(grads, error, ratio=topk_ratio, stacked=stacked)
    if scheme == "int8":
        return int8_compress(grads, error, stacked=stacked)
    raise ValueError(scheme)

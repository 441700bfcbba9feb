"""AdamW (fp32 state, trainable-mask aware), global-norm clipping and the
cosine schedule: the port's copy of ``repro/optim/adamw.py``.

The state mirrors the parameter tree.  Masked (frozen) and non-float
leaves carry zero-size ``(0,)`` placeholders, as in the reference.  The
update runs in place on the parameters and the state (the reference's
arrays are immutable; torch's are not, so a caller that must keep an old
value copies it).  Each leaf's update is computed in fp32 and rounded
once into the parameter's dtype.

Weight decay reaches a leaf when the reference's copy of it has two or
more dimensions.  The reference stacks every group leaf on a leading
group axis (``scan_layers=True``), so there a norm scale, a bias, a LoRA
``scaling`` and a DoRA magnitude are matrices and are decayed; the port
keeps unstacked groups, so the caller passes that decision as a ``decay``
tree (:func:`decay_mask`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def _is_float(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def init_adamw(params, mask=None) -> AdamWState:
    """Zero fp32 moments for every trainable float leaf, ``(0,)`` for
    frozen and non-float ones."""
    def zeros(p, m=True):
        if m and _is_float(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return torch.zeros((0,), dtype=torch.float32, device=p.device)

    if mask is None:
        mu, nu = tree_map(zeros, params), tree_map(zeros, params)
    else:
        mu, nu = tree_map(zeros, params, mask), tree_map(zeros, params, mask)
    return AdamWState(step=0, mu=mu, nu=nu)


def decay_mask(params, *, stacked: bool = True):
    """True for the leaves weight decay reaches: those with two or more
    dimensions in the reference's tree, where ``stacked``
    (``cfg.scan_layers``) adds the group axis to every leaf of
    ``params["layers"]``."""
    def rank_rule(extra):
        return lambda p: _is_float(p) and p.ndim + extra >= 2
    out = {k: tree_map(rank_rule(0), v) for k, v in params.items()
           if k != "layers"}
    out["layers"] = tree_map(rank_rule(1 if stacked else 0), params["layers"])
    return {k: out[k] for k in params}


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *,
                 lr: Union[float, Callable], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, mask=None, decay=None):
    """One AdamW step, in place -> ``(params, new state)``.  ``lr`` is a
    number or ``callable(step)``; ``grads`` has ``None`` at non-float
    leaves; ``mask`` (trainable) and ``decay`` (:func:`decay_mask`; by
    default the leaves' own rank >= 2) are bool trees.  Bias corrections
    and the rate are fp32 scalars, as the reference's."""
    step = state.step + 1
    dev = next(p.device for p in leaves(params) if _is_float(p))
    lr_t = (lr(step) if callable(lr) else _f32(lr)).to(dev)
    b1c = (1.0 - _f32(b1) ** _f32(step)).to(dev)
    b2c = (1.0 - _f32(b2) ** _f32(step)).to(dev)
    if mask is None:
        mask = tree_map(lambda _: True, params)
    if decay is None:
        decay = tree_map(lambda p: _is_float(p) and p.ndim >= 2, params)

    def upd(p, g, m, v, trainable, dec):
        if not trainable or not _is_float(p) or m.numel() == 0:
            return
        gf = g.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if weight_decay and dec:
            delta = delta + weight_decay * p.float()
        p.copy_((p.float() - lr_t * delta).to(p.dtype))

    tree_map(upd, params, grads, state.mu, state.nu, mask, decay)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / ||g||), ||g||): the fp32 norm
    over every float gradient leaf, frozen weights' included, as the
    reference's (it differentiates the whole tree)."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves(grads)
          if _is_float(g)]
    gnorm = torch.sqrt(sum(sq[1:], sq[0]))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype)
                    if _is_float(g) else g, grads), gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """``lr(step)`` -> fp32 scalar tensor: linear warmup to ``base_lr``,
    then cosine decay to ``min_ratio * base_lr`` at ``total``."""
    def lr(step: int) -> torch.Tensor:
        s = _f32(step)
        if step < warmup:
            return _f32(base_lr) * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return _f32(base_lr) * (min_ratio + (1 - min_ratio) * 0.5
                                * (1 + torch.cos(_f32(math.pi) * prog)))
    return lr

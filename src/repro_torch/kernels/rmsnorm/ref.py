"""Plain PyTorch version of RMSNorm.

The counterpart of ``repro/kernels/rmsnorm/ref.py`` ``rmsnorm_ref`` (and
of ``repro/models/layers.py`` ``rmsnorm_apply``, the same function): fp32
mean of squares over the last axis, rsqrt, times the scale, cast back to
x's dtype.  Wrappers take it for CPU tensors; ``chip_smoke.py`` holds the
CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,) -> (..., d) in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)

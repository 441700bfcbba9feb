"""Weight bridge: the reference's ``LM.init`` parameter tree, as numpy
arrays, into the port's parameters.

The reference keeps its layer stack either stacked on a leading group
axis (``scan_layers=True``) or as ``g{i}`` keys; the port keeps a list of
groups.  Linears keep the ``(d_in, d_out)`` layout on both sides, and a
tied head is the embedding on both sides.  bf16 arrays arrive with an
``ml_dtypes`` dtype, which numpy cannot hand to torch directly: they are
recognised by ``dtype.name == "bfloat16"`` and cross bit for bit through
a 16-bit integer view.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def tensor_from_numpy(a: Any, device=None) -> torch.Tensor:
    """One numpy array (bf16 included) as a tensor on ``device``."""
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _tree(node: Any, device, index=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, index) for k, v in node.items()}
    a = np.asarray(node)
    return tensor_from_numpy(a if index is None else a[index], device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """Reference parameter tree (nested dicts of numpy arrays) -> the
    port's parameters on ``device``."""
    layers = tree["layers"]
    if "g0" in layers:
        groups = [_tree(layers[f"g{i}"], device)
                  for i in range(cfg.num_groups)]
    else:
        groups = [_tree(layers, device, i) for i in range(cfg.num_groups)]
    out = {"embed": _tree(tree["embed"], device), "layers": groups,
           "final_norm": _tree(tree["final_norm"], device)}
    if not cfg.tie_embeddings:
        out["lm_head"] = _tree(tree["lm_head"], device)
    return out

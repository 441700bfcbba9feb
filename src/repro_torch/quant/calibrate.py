"""Post-training quantization calibration: GPTQ, AWQ, SmoothQuant.  The
port's copy of ``repro/quant/calibrate.py``.

These implement the *algorithms* at matrix level (the part the paper's
``c_inf`` arm varies); ``quantize_tree(calib=...)`` folds the resulting
per-channel equalization scales into the weights.

GPTQ  — column-by-column quantization with Hessian-driven error
        compensation (Frantar et al. 2022; Cholesky formulation), in
        numpy float64 on the host, the reference's operations in its
        order.
AWQ   — activation-aware per-in-channel scale search minimizing the
        layer-output error on calibration activations (Lin et al. 2024).
SmoothQuant — closed-form difficulty migration s_j = amax_x^α / amax_w^(1-α)
        (Xiao et al. 2023).

AWQ and SmoothQuant run in fp32 torch on the tensors' device.  As in the
reference, the fold multiplies the scales into W and nothing divides the
activations by them, so a calibrated linear computes x·Q(diag(s)·W), not
x·W (ROADMAP C, R9); the port copies it, so calibrated trees are the
reference's bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.int8_matmul.ref import _div


# ---------------------------------------------------------------------------
# RTN helper


def _rtn(w: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-to-nearest per output column: (q as floats in [-qmax-1,
    qmax], the column scales)."""
    qmax = 2 ** (bits - 1) - 1
    scale = _div(torch.clamp(w.abs().amax(dim=0), min=1e-8), float(qmax))
    q = torch.clamp(torch.round(w / scale[None, :]), -qmax - 1, qmax)
    return q, scale


# ---------------------------------------------------------------------------
# GPTQ


def gptq_quantize_matrix(w, hessian, *, bits: int = 4,
                         percdamp: float = 0.01,
                         block: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize W (K, N) given H = 2 E[x xᵀ] (K, K).

    Processes the rows of W in blocks; after quantizing row k the residual
    error is propagated to the not-yet-quantized rows through the inverse
    Hessian (Cholesky form), which is what lets GPTQ beat round-to-nearest.
    Returns (w_dequantized, per-col scales) as float64 numpy arrays.
    """
    w = np.array(_host(w), np.float64)
    k, n = w.shape
    h = np.array(_host(hessian), np.float64)
    dead = np.diag(h) == 0
    h[dead, dead] = 1.0
    w[dead, :] = 0.0
    damp = percdamp * np.mean(np.diag(h))
    h[np.diag_indices(k)] += damp
    # Hinv via Cholesky of inverse (upper), as in the reference impl
    hinv = np.linalg.inv(h)
    hinv = np.linalg.cholesky(hinv).T          # upper triangular

    qmax = 2 ** (bits - 1) - 1
    scale = np.maximum(np.max(np.abs(w), axis=0), 1e-8) / qmax

    q_out = np.zeros_like(w)
    for b0 in range(0, k, block):
        b1 = min(b0 + block, k)
        w_blk = w[b0:b1].copy()
        err_blk = np.zeros_like(w_blk)
        for i in range(b1 - b0):
            ki = b0 + i
            d = hinv[ki, ki]
            q = np.clip(np.round(w_blk[i] / scale), -qmax - 1, qmax)
            dq = q * scale
            q_out[ki] = dq
            err = (w_blk[i] - dq) / d
            # propagate within block
            w_blk[i + 1:] -= np.outer(hinv[ki, ki + 1:b1], err)
            err_blk[i] = err
        # propagate to the remaining rows
        if b1 < k:
            w[b1:] -= hinv[b0:b1, b1:].T @ err_blk
    return q_out, scale


def _host(a):
    """A tensor (any device, any float dtype) or an array as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return a


def hessian_from_inputs(x) -> np.ndarray:
    """H = 2 X Xᵀ / n from calibration activations x (n, K)."""
    x = np.asarray(_host(x), np.float64)
    return 2.0 * (x.T @ x) / max(len(x), 1)


# ---------------------------------------------------------------------------
# SmoothQuant


def smoothquant_scales(act_amax: torch.Tensor, w: torch.Tensor,
                       alpha: float = 0.5) -> torch.Tensor:
    """Per-in-channel equalization s_j: activations divided by s, weights
    multiplied (folded by ``quantize_tree``).  Returns the *weight-side*
    multiplier (K,) in fp32."""
    w_amax = torch.clamp(w.float().abs().amax(dim=1), min=1e-8)
    s = (torch.clamp(act_amax.float(), min=1e-8) ** alpha) \
        / (w_amax ** (1.0 - alpha))
    return torch.clamp(s, min=1e-4)


# ---------------------------------------------------------------------------
# AWQ


def awq_search_scales(w: torch.Tensor, x_calib: torch.Tensor, *,
                      bits: int = 4, n_grid: int = 20) -> torch.Tensor:
    """Grid-search per-in-channel scales minimizing ‖x(W) − x·Q(W·s)/s‖²
    on calibration activations (the AWQ objective); the first grid point
    of least error wins, as in the reference."""
    w, x_calib = w.float(), x_calib.float()
    act_amax = x_calib.abs().amax(dim=0)                     # (K,)
    y_ref = x_calib @ w
    best_err = torch.tensor(float("inf"), device=w.device)
    best_s = torch.ones((w.shape[0],), device=w.device)
    for g in range(n_grid):
        ratio = g / n_grid
        s = torch.clamp(act_amax, min=1e-8) ** ratio
        s = s / torch.sqrt(torch.clamp(s.max() * s.min(), min=1e-12))
        q, sc = _rtn(w * s[:, None], bits)
        wq = (q * sc[None, :]) / s[:, None]
        err = torch.mean((x_calib @ wq - y_ref) ** 2)
        best_s = torch.where(err < best_err, s, best_s)
        best_err = torch.minimum(err, best_err)
    return best_s


# ---------------------------------------------------------------------------
# Model-level capture


def collect_linear_inputs(lm, params, tokens, *,
                          targets=("wq", "gate")) -> dict:
    """Run one forward (``LM.backbone``, no cache) capturing the input
    activations of every linear whose name contains one of ``targets``;
    returns ``{path: fp32 activations (n <= 256, K)}`` on the model's
    device, paths in the reference's names (``/layers/g{i}/blk{j}/attn/wq``).

    The forward runs on a copy of the tree whose target linears carry a
    ``"_capture"`` callable, which ``models.layers.linear_apply`` hands
    its input, so every call site reaches it.  The reference patches the
    module attribute ``layers.linear_apply`` instead, which
    ``models/attention.py`` imported by name, so it captures only the
    MLP's ``gate`` (ROADMAP C, R8); the port captures ``wq`` too, as the
    docstring promised.  A linear called twice keeps its last input, as
    in the reference."""
    captured: dict = {}

    def hook(path):
        def capture(x):
            captured[path] = x.reshape(-1, x.shape[-1])[:256].float().clone()
        return capture

    def walk(node, prefix=""):
        if isinstance(node, list):
            return [walk(v, f"{prefix}/g{i}") for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        out = {}
        for name, sub in node.items():
            path = f"{prefix}/{name}"
            out[name] = walk(sub, path)
            if isinstance(sub, dict) and ("w" in sub or "qw" in sub) and \
                    any(t in name for t in targets):
                out[name]["_capture"] = hook(path)
        return out

    with torch.no_grad():
        lm.backbone(walk(params), tokens, mode="prefill")
    return captured

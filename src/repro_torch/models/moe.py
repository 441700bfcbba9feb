"""Mixture-of-Experts: GShard / Switch-style capacity-factor dispatch.

The port of ``repro/models/moe.py``, with the same entry points:
  * ``moe_apply``        — the einsum dispatch: tokens are cut into groups,
    each group builds a one-hot ``(group, tokens, experts, capacity)``
    dispatch mask over ``top_k`` choice rounds, the experts run batched
    over a leading E dim, and a combine einsum brings their outputs back
  * ``moe_apply_gather`` — the sort / scatter dispatch: the same routing,
    capacity overflow dropped by token order instead of choice round
  * ``init_moe``, and the aux losses (Switch load balance ``E·Σ f_e·p_e``,
    router z-loss, dropped fraction) in the returned ``aux`` dict

Capacity is per group, so a token's output depends on the other tokens
of its group: padded prompt positions, idle decode slots and bucket
padding all compete for it, as in the reference.  The casts are the
reference's: router logits in fp32 from ``x.float()``, combine weights
renormalised in fp32 and cast to x's dtype before the combine product,
``silu`` in fp32 cast back before the product with ``up``.  The expert
products are plain batched matrix products (no MoE kernel exists in the
reference either).  Differences, both deliberate: the reference's
sharding constraints and ``jax.checkpoint`` have no single-card meaning
and are dropped, and the gather dispatch sums a token's ``top_k``
contributions one after another in ascending expert order (the order
of the reference's scatter-add on the CPU) instead of through an
atomic scatter-add, so repeated calls are bit-equal on the card.

Under a model axis (``sharding.collectives.active()``; the placements of
``sharding.rules``, as the reference's ``"model"`` constraints on the
expert buffers) routing, capacity and the aux losses run on every rank
from the same whole activations and the replicated fp32 router, so they
are the same everywhere.  A rank then runs either its E/m experts on its
slice of the dispatch buffers (EP, where the axis divides the padded
expert count) or every expert over its f/m slice of the hidden width
(the TP fallback, its ``down`` product an fp32 partial).  Either way it
produces an fp32 partial of the routed output, the shared expert's
row-split ``down`` partial joins it, and one fp32 all-reduce a layer
sums them, rounded once (``sharding.tp.row_linear``).  In a training
forward the gates are read through ``copy_to_model`` (a rank's gates
reach only its experts, so the router's gradient through them is
partial) and the expert inputs through ``column_input``; the aux
losses, whole on every rank, read the router's probabilities directly
and so count once.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import (init_mlp, mlp_apply, mlp_hidden,
                                       row_partial)
from repro_torch.sharding.collectives import (active, column_input,
                                              copy_to_model)


def init_moe(gen: torch.Generator, d_model: int, m: MoEConfig,
             dtype=torch.bfloat16, device=None) -> dict:
    """Router ``{"w": (d, E_pad)}`` in fp32 whatever the model's dtype,
    expert stacks ``gate_e`` / ``up_e`` ``(E_pad, d, f)`` and ``down_e``
    ``(E_pad, f, d)``, and the shared expert (a SwiGLU MLP) if any.  An
    expert stack is drawn one expert at a time in fp32 and cast into the
    stack, so no fp32 copy of a whole stack is made (12.9 GB for one of
    jamba's); on the CPU the values equal one draw of the whole stack."""
    e, f = m.padded_experts, m.d_ff
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, bound):
        return torch.rand(shape, generator=gen, **f32) * (2 * bound) - bound

    def expert_stack(d_in, d_out):
        out = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
        for i in range(e):
            out[i] = uniform((d_in, d_out), 1.0 / d_in ** 0.5)
        return out

    p = {"router": {"w": uniform((d_model, e), 1.0 / d_model ** 0.5)},
         "gate_e": expert_stack(d_model, f),
         "up_e": expert_stack(d_model, f),
         "down_e": expert_stack(f, d_model)}
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, d_model,
                               m.num_shared_experts * m.shared_d_ff,
                               dtype=dtype, device=device)
    return p


def _capacity(tokens_per_group: int, m: MoEConfig, train: bool) -> int:
    cf = m.capacity_factor if train else m.eval_capacity_factor
    cap = int(np.ceil(tokens_per_group * m.top_k * cf / m.num_experts))
    return max(cap, m.top_k)


def _mask_pad_experts(logits: torch.Tensor, m: MoEConfig) -> torch.Tensor:
    """-1e30 the padded experts' router logits: never routed, exact."""
    if m.padded_experts == m.num_experts:
        return logits
    ids = torch.arange(m.padded_experts, device=logits.device)
    return torch.where(ids < m.num_experts, logits,
                       torch.tensor(-1e30, device=logits.device))


def _groups(x: torch.Tensor, group_size: int):
    """x (B, S, d) -> (groups (g, gs, d), n_tok): the tokens flattened
    and zero-padded to a whole number of groups of min(group_size,
    B·S)."""
    b, s, d = x.shape
    n_tok = b * s
    gs = min(group_size, n_tok)
    flat = x.reshape(n_tok, d)
    n_pad = (-n_tok) % gs
    if n_pad:
        flat = torch.cat([flat, flat.new_zeros((n_pad, d))], 0)
    return flat.reshape(-1, gs, d), n_tok


def _route(xg: torch.Tensor, p: dict, m: MoEConfig):
    logits = _mask_pad_experts(xg.float() @ p["router"]["w"], m)
    return logits, torch.softmax(logits, dim=-1)               # (g,s,E)


def _expert_ffn(p: dict, xin: torch.Tensor,
                partial: bool = False) -> torch.Tensor:
    """xin (E, rows, d) -> (E, rows, d): every expert's SwiGLU
    (``partial``: over this rank's slice of the hidden width, the ``down``
    product an fp32 partial)."""
    gate_h = torch.bmm(xin, p["gate_e"].to(xin.dtype))
    up_h = torch.bmm(xin, p["up_e"].to(xin.dtype))
    h = F.silu(gate_h.float()).to(xin.dtype) * up_h
    if partial:
        return torch.bmm(h.float(), p["down_e"].float())
    return torch.bmm(h, p["down_e"].to(h.dtype))


def _share(p: dict, m: MoEConfig):
    """(scope, e0, e1, fallback): under a tensor-parallel scope the
    experts [e0, e1) this rank runs (its stacks' leading dim under EP;
    every expert over its f/m slice under the TP fallback, ``fallback``
    True); ``(None, 0, E, False)`` outside one."""
    tp = active()
    e = m.padded_experts
    if tp is None:
        return None, 0, e, False
    n = p["gate_e"].shape[0]
    e0 = tp.mesh.model_rank * n if n < e else 0
    return tp, e0, e0 + n, n == e and p["gate_e"].shape[2] < m.d_ff


def _gate_probs(probs: torch.Tensor, tp) -> torch.Tensor:
    """The router probabilities the gates are read from: under a
    tensor-parallel training forward through ``copy_to_model`` (a rank's
    gates reach only its experts), else ``probs`` itself."""
    if tp is None or not torch.is_grad_enabled() or not probs.requires_grad:
        return probs
    return copy_to_model(probs, tp.mesh)


def _tp_out(p: dict, x: torch.Tensor, part: torch.Tensor, quant_impl: str,
            tp) -> torch.Tensor:
    """The layer's output from this rank's fp32 partial of the routed
    output (B, S, d): the shared expert's ``down`` partial added, one
    fp32 all-reduce, rounded once, the shared ``down`` bias added once."""
    from repro_torch.sharding.tp import row_linear
    bias = None
    if "shared" in p:
        sh = p["shared"]
        part = part + row_partial(sh["down"], mlp_hidden(sh, x, quant_impl),
                                  quant_impl, tp.mesh)
        bias = sh["down"].get("b")
    return row_linear(part, x.dtype, bias, tp.mesh)


def _xla_mean(t: torch.Tensor) -> torch.Tensor:
    """The fp32 mean of every element as the reference's eager
    ``jnp.mean`` computes it: the sum times the fp32 reciprocal of the
    count (the dropped fraction is held equal to it, not within a
    rounding)."""
    return t.float().sum() * torch.tensor(1.0 / t.numel(),
                                          dtype=torch.float32)


def _aux(m: MoEConfig, f_e, probs, logits, dropped) -> dict:
    p_e = probs.mean(1)                                         # (g,E)
    lb_loss = m.num_experts * torch.mean(torch.sum(f_e * p_e, -1))
    z_loss = torch.mean(torch.logsumexp(logits, -1) ** 2)
    return {"moe_lb_loss": lb_loss * m.aux_loss_weight,
            "moe_z_loss": z_loss * m.z_loss_weight,
            "moe_dropped_frac": dropped}


def _shared(p: dict, x: torch.Tensor, out: torch.Tensor,
            quant_impl: str) -> torch.Tensor:
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, quant_impl)
    return out


def moe_apply(p: dict, x: torch.Tensor, m: MoEConfig, *, train: bool = True,
              group_size: int = 512, impl: str = "einsum",
              quant_impl: str = "ref") -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out, aux), aux = {moe_lb_loss, moe_z_loss,
    moe_dropped_frac}.  ``impl`` is "einsum" (GShard one-hot dispatch) or
    "gather" (sort / scatter, :func:`moe_apply_gather`); ``quant_impl``
    is the model's ``quant_matmul_impl`` for a quantized shared
    expert."""
    if impl == "gather":
        return moe_apply_gather(p, x, m, train=train, group_size=group_size,
                                quant_impl=quant_impl)
    if impl != "einsum":
        raise ValueError(f"unknown MoE impl {impl!r}")
    b, s, d = x.shape
    tp, e0, e1, fallback = _share(p, m)
    xg, n_tok = _groups(x, group_size)
    g, gs, _ = xg.shape
    logits, probs = _route(xg, p, m)
    gprobs = _gate_probs(probs, tp)
    cap = _capacity(gs, m, train)
    e = m.padded_experts
    dev = x.device

    # --- top-k dispatch with per-expert capacity bookkeeping -------------
    dispatch = torch.zeros((g, gs, e, cap), dtype=torch.bool, device=dev)
    combine = torch.zeros((g, gs, e, cap), dtype=torch.float32, device=dev)
    gates_sum = torch.zeros((g, gs), dtype=torch.float32, device=dev)
    counts = torch.zeros((g, e), dtype=torch.int32, device=dev)
    fract_assigned = torch.zeros((g, e), dtype=torch.float32, device=dev)
    masked = gprobs
    for _ in range(m.top_k):
        idx = torch.argmax(masked, dim=-1)                      # (g,s)
        onehot = F.one_hot(idx, e).float()                      # (g,s,E)
        gate = torch.sum(gprobs * onehot, -1)                   # (g,s)
        # position of each token within its expert's buffer
        pos_in_e = torch.cumsum(onehot, 1) - onehot
        pos = torch.sum(pos_in_e * onehot, -1) + torch.gather(
            counts, 1, idx).float()                             # (g,s)
        fits = pos < cap
        pos_c = torch.clamp(pos.to(torch.int32), 0, cap - 1).long()
        d_k = (onehot[..., None] * F.one_hot(pos_c, cap).float()[:, :, None]
               * fits[..., None, None])
        dispatch = dispatch | d_k.bool()
        combine = combine + d_k * gate[..., None, None]
        gates_sum = gates_sum + gate * fits.float()
        counts = counts + torch.sum(onehot * fits[..., None].float(),
                                    1).to(torch.int32)
        fract_assigned = fract_assigned + onehot.mean(1)
        masked = masked * (1.0 - onehot)                        # next choice

    # renormalize combine weights over the k selected experts
    combine = combine / torch.clamp(gates_sum, min=1e-9)[..., None, None]
    dispatch_f = dispatch.to(x.dtype)

    # --- expert computation: this rank's experts' slice of the dispatch
    # buffers (every expert outside a tensor-parallel scope) --------------
    xcol = x if tp is None else column_input(x)
    xc = xg if xcol is x else _groups(xcol, group_size)[0]
    n = e1 - e0
    xin = torch.einsum("gsec,gsd->egcd", dispatch_f[:, :, e0:e1], xc)
    xout = _expert_ffn(p, xin.reshape(n, g * cap, d), fallback).reshape(
        n, g, cap, d)
    # the combine weights rounded to x's dtype; a rank's partial takes the
    # products and their sum in fp32
    cw = combine[:, :, e0:e1].to(x.dtype)
    if tp is not None:
        cw, xout = cw.float(), xout.float()
    out = torch.einsum("gsec,egcd->gsd", cw, xout)
    out = out.reshape(-1, d)[:n_tok].reshape(b, s, d)
    if tp is None:
        out = _shared(p, x, out, quant_impl)
    else:
        out = _tp_out(p, x, out, quant_impl, tp)

    # --- aux losses (f: fraction of tokens dispatched to e; P: mean
    # router prob for e) ----------------------------------------------------
    kept = torch.sum(dispatch_f, (2, 3)) / m.top_k              # x's dtype
    dropped = 1.0 - _xla_mean(kept).to(x.dtype)
    return out, _aux(m, fract_assigned / m.top_k, probs, logits, dropped)


# ---------------------------------------------------------------------------
# Gather / sort dispatch (see moe_apply)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply_gather(p: dict, x: torch.Tensor, m: MoEConfig, *,
                     train: bool = True, group_size: int = 512,
                     quant_impl: str = "ref") -> Tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    tp, e0, e1, fallback = _share(p, m)
    xg, n_tok = _groups(x, group_size)
    g, gs, _ = xg.shape
    logits, probs = _route(xg, p, m)
    e, k = m.padded_experts, m.top_k
    cap = _capacity(gs, m, train)
    dev = x.device

    gate, idx = _top_k(_gate_probs(probs, tp), k)               # (g,s,k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # stable sort of every group's slots by expert; rank within an
    # expert = slot order
    eid = idx.reshape(g, gs * k)                                # slot -> e
    order = torch.argsort(eid, dim=-1, stable=True)             # (g,gs·k)
    eid_s = torch.gather(eid, 1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, eid, torch.ones_like(eid))
    starts = torch.cumsum(counts, -1) - counts                  # exclusive
    pos_s = torch.arange(gs * k, device=dev) - torch.gather(starts, 1, eid_s)
    keep_s = pos_s < cap
    tok_s = order // k                                          # slot -> token
    dest = torch.where(keep_s, eid_s * cap + pos_s, e * cap)    # drop bin
    rows = torch.arange(g, device=dev)[:, None]
    # scatter tokens into each group's (E·cap, d) expert buffer
    xcol = x if tp is None else column_input(x)
    xc = xg if xcol is x else _groups(xcol, group_size)[0]
    buf = xc.new_zeros((g, e * cap + 1, d))
    buf[rows, dest] = xc[rows, tok_s]
    # (E,g,cap,d), this rank's experts' rows of it under EP
    xin = buf[:, :-1].reshape(g, e, cap, d).transpose(0, 1)[e0:e1]
    n = e1 - e0
    xout = _expert_ffn(p, xin.reshape(n, g * cap, d), fallback).reshape(
        n, g, cap, d)
    xout = xout.transpose(0, 1).reshape(g, n * cap, d)          # (g,n·cap,d)

    # the slots this rank's experts hold (every kept slot outside EP)
    held = keep_s & (eid_s >= e0) & (eid_s < e1)
    src = torch.where(held, (eid_s - e0) * cap
                      + torch.clamp(pos_s, max=cap - 1), 0)
    y_s = xout[rows, src]                                       # (g,gs·k,d)
    w_s = torch.gather(gate.reshape(g, gs * k), 1, order) * held
    w_s = w_s[..., None].to(y_s.dtype)
    if tp is not None:
        y_s, w_s = y_s.float(), w_s.float()
    y_s = y_s * w_s
    # token-major, each token's k contributions in the sorted slots'
    # (ascending expert) order, summed one after another in y's dtype
    # (fp32 for a rank's partial)
    by_token = torch.argsort(tok_s, dim=-1, stable=True)
    y_tok = y_s[rows, by_token].reshape(g, gs, k, d)
    out = y_tok[:, :, 0]
    for j in range(1, k):
        out = out + y_tok[:, :, j]
    out = out.reshape(-1, d)[:n_tok].reshape(b, s, d)
    if tp is None:
        out = _shared(p, x, out, quant_impl)
    else:
        out = _tp_out(p, x, out, quant_impl, tp)

    # aux losses (the einsum path's formulas)
    f_e = counts.float() / (gs * k)
    dropped = 1.0 - _xla_mean(keep_s)
    return out, _aux(m, f_e, probs, logits, dropped)

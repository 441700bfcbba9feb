"""Attention-free sequence mixers: RWKV-6 ("Finch") and Mamba (selective
SSM).

The port of ``repro/models/ssm.py``, with the same entry points:
  * ``rwkv6_forward`` / ``mamba_forward`` — full sequence (prefill and
    training), returns (y, final_state)
  * ``rwkv6_decode`` / ``mamba_decode``  — one-token step on the
    constant-size state, plain torch as in the reference
  * ``init_rwkv6`` / ``init_rwkv6_state`` / ``init_mamba`` /
    ``init_mamba_state``

RWKV-6: the WKV recurrence goes through ``kernels/wkv6/ops.py`` (the B8
kernel on CUDA tensors, its plain chunked version on the CPU).  The
reference's casts are kept exactly: the five mixed streams are rounded
to x's dtype, ``logw`` is fp32, prefill rounds the WKV output to x's
dtype before the group norm while decode keeps it fp32, and the gated
group-norm output is rounded to bf16 (in float32 configs too) before
``wout``.  The state is fp32; ``x_prev`` is stored fp32 and cast back to
x's dtype when used.

Mamba is plain torch on every device, as the reference computes it in
jnp (no ``pallas_call``).  Its casts are the reference's: the depthwise
causal conv sums in ``xi``'s dtype (weights and carried context cast to
it), ``silu(xc + conv_b)`` in fp32 rounded to ``xi``'s dtype, ``dt`` /
``B`` / ``C`` in fp32, and ``y + D·x`` gated by ``silu(z)`` in fp32,
rounded to x's dtype before ``out_proj``.  The state is fp32
``{"ssm": (B, d_inner, N), "conv": (B, d_conv - 1, d_inner)}``.  The
selective scan runs in chunks of ``MAMBA_CHUNK`` tokens, so no more than
one chunk's (B, C, d_inner, N) tensors are live: within a chunk a
log-step (Hillis–Steele) scan of the ``(exp(dt·A), dt·x·B)`` pairs
(:func:`mamba_chunk_scan`, 7 steps at 128), across chunks the carried
state.  :func:`mamba_scan_ref`, the sequential recurrence, is its plain
oracle.  The port takes any length: where the reference cuts the prompt
into ``max(1, S // 128)`` equal chunks and asserts that they divide S
(its fault 10: a 301-token prompt fails), the port's last chunk is
shorter, and the scan does not depend on where chunks break.  Under
``train=True`` each chunk step is checkpointed, as the reference's
``jax.checkpoint``, so backward keeps one (B, d_inner, N) carry a chunk.

Under a tensor-parallel scope (``sharding.collectives.active()``, a model
axis of m) a rank computes its piece of the one-device mixer on the
pieces the placement rules give it (``sharding.rules``):
  * RWKV-6 by heads: ``wr`` / ``wk`` / ``wv`` / ``wg`` hold d/m columns,
    which are the rank's H/m WKV heads; the token shift and the five-stream
    mix run on the whole activations, the rank takes its columns of
    ``logw`` and ``ln_x`` and its heads of ``u`` (the whole leaves through
    ``collectives.replicated`` in training, so their gradients are summed
    over the axis), runs the WKV and the group norm over its heads, and
    ``wout``'s rows give an fp32 partial summed once.  The state is the
    rank's heads of ``wkv`` and the whole ``x_prev`` (the token shift of
    every rank reads all of it; B x d in fp32, so no gather a step).
  * Mamba by channels: ``in_proj``'s column piece is gathered whole
    (``layers.whole_projection``) and the rank takes its
    d_inner/m channels of x and of z; the conv, ``conv_b``, ``dt_bias``,
    ``A_log``, ``D`` and ``dt_proj``'s columns are the rank's channels;
    ``x_proj`` (row-split) gives an fp32 partial of (dt_rank + 2N) summed
    once and whole on every rank (through ``copy_to_model`` in training:
    it feeds only the rank's channels); ``out_proj`` is row-split.  The
    state is the rank's channels of ``ssm`` and ``conv``.  A rank makes 1
    all-gather and 2 all-reduces a layer.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import DEFAULT_CHUNK, wkv6_chunked_ref
from repro_torch.models.layers import (init_linear, linear_apply,
                                       whole_projection)
from repro_torch.sharding.collectives import (active, copy_to_model,
                                              replicated)

LORA_MIX = 32          # low-rank width of the five-stream lerp
LORA_DECAY = 64        # low-rank width of the decay
GROUP_NORM_EPS = 64e-5
MAMBA_CHUNK = 128      # tokens a selective-scan chunk
DT_BIAS_INIT = -4.6    # softplus^-1(0.01)


def init_rwkv6(gen: torch.Generator, d_model: int, s: SSMConfig,
               dtype=torch.bfloat16, device=None) -> dict:
    hd = s.head_dim
    h = d_model // hd
    lo = LORA_MIX
    f32 = dict(dtype=torch.float32, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, **f32) * 0.01

    u = torch.rand((h, hd), generator=gen, **f32) * 2.0 - 1.0
    return {
        "tmix": {
            "x_maa": torch.zeros((d_model,), **f32),
            "maas": torch.zeros((5, d_model), **f32),  # w,k,v,r,g lerp
            "tm_w1": normal(d_model, 5 * lo),
            "tm_w2": normal(5, lo, d_model),
        },
        "wdecay": {
            "w0": torch.full((d_model,), -6.0, **f32),
            "w1": normal(d_model, LORA_DECAY),
            "w2": normal(LORA_DECAY, d_model),
        },
        "u": u,
        **{name: init_linear(gen, d_model, d_model, dtype=dtype,
                             device=device)
           for name in ("wr", "wk", "wv", "wg", "wout")},
        "ln_x": {"scale": torch.ones((d_model,), **f32),
                 "bias": torch.zeros((d_model,), **f32)},
    }


def init_rwkv6_state(batch: int, d_model: int, s: SSMConfig,
                     device=None, model: int = 1) -> dict:
    """Zero state; under a model axis of ``model`` a rank's piece: its
    H/model heads of ``wkv``, and ``x_prev`` whole (every rank's token
    shift reads all of it)."""
    hd = s.head_dim
    h = d_model // hd
    f32 = dict(dtype=torch.float32, device=device)
    return {"wkv": torch.zeros((batch, h // model, hd, hd), **f32),
            "x_prev": torch.zeros((batch, d_model), **f32)}


def _tp_mesh():
    """The mesh of the enclosing tensor-parallel scope (``None`` outside
    one)."""
    tp = active()
    return None if tp is None else tp.mesh


def _rank_heads(p: dict, logw: torch.Tensor, width: int, hd: int, mesh):
    """(logw, u, ln_x scale, ln_x bias) over the rank's ``width`` columns
    (its heads) of the whole ``logw`` (B,S,d) and the whole leaves; all
    of them where the rank computes every head.  The rank's ``logw`` is
    made contiguous, as B8 takes it.  In a training forward the whole
    tensors go through one ``replicated`` before they are cut, so their
    gradients (each rank's covers its columns only) are summed over the
    model axis."""
    u, ln = p["u"], p["ln_x"]
    if width == logw.shape[-1]:
        return logw, u, ln["scale"], ln["bias"]
    logw, u, scale, bias = replicated(logw, u, ln["scale"], ln["bias"])
    lo = mesh.model_rank * width
    return (logw.narrow(-1, lo, width).contiguous(),
            u.narrow(0, lo // hd, width // hd),
            scale.narrow(0, lo, width), bias.narrow(0, lo, width))


def _rwkv6_mix(p: dict, x: torch.Tensor, x_prev_tok: torch.Tensor,
               impl: str):
    """Token shift + data-dependent lerp -> (r, k, v, g, logw)."""
    tm = p["tmix"]
    sx = x_prev_tok - x                                          # (B,S,d)
    xf = x.float()
    sxf = sx.float()
    xxx = xf + sxf * tm["x_maa"]
    lr = torch.tanh(xxx @ tm["tm_w1"])                           # (B,S,5*lo)
    lr = lr.reshape(*lr.shape[:-1], 5, -1)                       # (B,S,5,lo)
    m = torch.einsum("bsfl,fld->bsfd", lr, tm["tm_w2"])          # (B,S,5,d)
    mixed = xf[..., None, :] + sxf[..., None, :] * (tm["maas"] + m)
    xw, xk, xv, xr, xg = [mixed[..., i, :].to(x.dtype) for i in range(5)]

    wd = p["wdecay"]
    logw = -torch.exp(wd["w0"] + torch.tanh(xw.float() @ wd["w1"])
                      @ wd["w2"])                                # (B,S,d) <=0
    r = linear_apply(p["wr"], xr, impl)
    k = linear_apply(p["wk"], xk, impl)
    v = linear_apply(p["wv"], xv, impl)
    g = torch.nn.functional.silu(linear_apply(p["wg"], xg, impl).float())
    return r, k, v, g, logw


def _rwkv6_out(p: dict, o: torch.Tensor, g: torch.Tensor, scale, bias,
               h: int, hd: int, impl: str) -> torch.Tensor:
    """Per-head group norm, gate, and the output projection on bf16
    (``wout`` row-split under a tensor-parallel scope: ``h`` is the
    rank's heads, ``scale`` / ``bias`` its columns of ``ln_x``)."""
    b, s_ = o.shape[:2]
    og = o.reshape(b, s_, h, hd).float()
    mu = og.mean(-1, keepdim=True)
    var = og.var(-1, keepdim=True, unbiased=False)
    og = (og - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    of = og.reshape(b, s_, h * hd) * scale + bias
    y = (of * g).to(torch.bfloat16)
    if o.dtype != torch.float32:
        y = y.to(o.dtype)
    return linear_apply(p["wout"], y, impl, row=True)


def rwkv6_forward(p: dict, x: torch.Tensor, s: SSMConfig, state: dict, *,
                  impl: str = "ref",
                  train: bool = False) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d) -> (y (B,S,d), new state).  Starts from ``state``.  A
    training forward (``train=True``) runs the plain chunked WKV on every
    device, differentiable (the B8 kernel has no backward; the reference
    trains through its jnp form)."""
    b, sl, d = x.shape
    hd = s.head_dim
    mesh = _tp_mesh()
    x_prev_tok = torch.cat([state["x_prev"].to(x.dtype)[:, None],
                            x[:, :-1]], dim=1)
    r, k, v, g, logw = _rwkv6_mix(p, x, x_prev_tok, impl)
    logw, u, scale, bias = _rank_heads(p, logw, r.shape[-1], hd, mesh)
    h = r.shape[-1] // hd
    heads = [t.reshape(b, sl, h, hd) for t in (r, k, v, logw)]
    if train:
        o, wkv = wkv6_chunked_ref(*(t.float() for t in heads),
                                  u.float(), state["wkv"].float(),
                                  chunk=DEFAULT_CHUNK)
    else:
        o, wkv = wkv_ops.wkv6(*heads, u, state["wkv"])
    y = _rwkv6_out(p, o.to(x.dtype), g, scale, bias, h, hd, impl)
    new_state = {"wkv": wkv, "x_prev": x[:, -1].to(state["x_prev"].dtype)}
    return y, new_state


def rwkv6_decode(p: dict, x: torch.Tensor, s: SSMConfig, state: dict, *,
                 impl: str = "ref") -> Tuple[torch.Tensor, dict]:
    """x: (B,1,d) single token; state carries wkv + previous token."""
    b, _, d = x.shape
    hd = s.head_dim
    mesh = _tp_mesh()
    x_prev_tok = state["x_prev"].to(x.dtype)[:, None]
    r, k, v, g, logw = _rwkv6_mix(p, x, x_prev_tok, impl)
    logw, u, scale, bias = _rank_heads(p, logw, r.shape[-1], hd, mesh)
    h = r.shape[-1] // hd
    rh = r.reshape(b, h, hd).float()
    kh = k.reshape(b, h, hd).float()
    vh = v.reshape(b, h, hd).float()
    w = torch.exp(logw.reshape(b, h, hd))
    wkv = state["wkv"]
    # o = r·(S + u ⊙ k ⊗ v); S' = diag(w) S + k ⊗ v
    kv = kh[..., :, None] * vh[..., None, :]                     # (B,H,hd,hd)
    o = torch.einsum("bhi,bhij->bhj", rh, wkv + u[None, :, :, None] * kv)
    new_wkv = w[..., None] * wkv + kv
    y = _rwkv6_out(p, o.reshape(b, 1, h, hd), g, scale, bias, h, hd, impl)
    return y, {"wkv": new_wkv, "x_prev": x[:, -1].to(state["x_prev"].dtype)}


# ===========================================================================
# Mamba


def init_mamba(gen: torch.Generator, d_model: int, s: SSMConfig,
               dtype=torch.bfloat16, device=None) -> dict:
    di = s.expand * d_model
    dtr = s.dt_rank or max(1, d_model // 16)
    f32 = dict(dtype=torch.float32, device=device)
    a_init = torch.log(torch.arange(1, s.d_state + 1, **f32))[None].repeat(
        di, 1)
    return {
        "in_proj": init_linear(gen, d_model, 2 * di, dtype=dtype,
                               device=device),
        "conv_w": torch.randn((di, s.d_conv), generator=gen, **f32) * 0.02,
        "conv_b": torch.zeros((di,), **f32),
        "x_proj": init_linear(gen, di, dtr + 2 * s.d_state, dtype=dtype,
                              device=device),
        "dt_proj": init_linear(gen, dtr, di, dtype=dtype, device=device),
        "dt_bias": torch.full((di,), DT_BIAS_INIT, **f32),
        "A_log": a_init,
        "D": torch.ones((di,), **f32),
        "out_proj": init_linear(gen, di, d_model, dtype=dtype, device=device),
    }


def init_mamba_state(batch: int, d_model: int, s: SSMConfig,
                     device=None, model: int = 1) -> dict:
    """Zero state; under a model axis of ``model`` a rank's d_inner/model
    channels."""
    di = s.expand * d_model // model
    f32 = dict(dtype=torch.float32, device=device)
    return {"ssm": torch.zeros((batch, di, s.d_state), **f32),
            "conv": torch.zeros((batch, s.d_conv - 1, di), **f32)}


def _mamba_xz(p: dict, x: torch.Tensor, impl: str):
    """``in_proj`` of x (..., d) -> (x, z) (..., di) each; under a
    tensor-parallel scope the rank's di/m channels of each, taken from
    the projection gathered whole (its column piece spans x or z, not
    both halves' channels alike)."""
    mesh = _tp_mesh()
    if mesh is None:
        return torch.chunk(linear_apply(p["in_proj"], x, impl), 2, dim=-1)
    di = p["conv_w"].shape[0]                      # the rank's channels
    half = di * mesh.model
    xz = whole_projection(p["in_proj"], x, 2 * half, mesh, "model", impl)
    lo = mesh.model_rank * di
    return xz.narrow(-1, lo, di), xz.narrow(-1, half + lo, di)


def _mamba_ssm_params(p: dict, xc: torch.Tensor, s: SSMConfig, impl: str):
    """xc (B,S,di) -> dt (B,S,di), A (di,N), B and C (B,S,N), all fp32.
    ``dt_proj.w`` is read directly, as the reference reads it.  Under a
    tensor-parallel scope ``x_proj`` is row-split: the rank's channels
    give an fp32 partial, summed once; the whole (dt, B, C) feed only the
    rank's channels, so in training their gradient is summed over the
    axis (``copy_to_model``)."""
    dtr = p["dt_proj"]["w"].shape[0]
    proj = linear_apply(p["x_proj"], xc, impl, row=True).float()
    mesh = _tp_mesh()
    if mesh is not None and torch.is_grad_enabled() and proj.requires_grad:
        proj = copy_to_model(proj, mesh)
    dt, bmat, cmat = torch.split(proj, [dtr, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"]["w"].float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    return dt, a, bmat, cmat


def mamba_chunk_scan(h0: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     bmat: torch.Tensor, cmat: torch.Tensor,
                     x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the selective scan, ``h_t = exp(dt_t·A) h_{t-1} +
    dt_t x_t B_t`` and ``y_t = h_t · C_t``, as a log-step (Hillis–Steele)
    scan of the pairs over the chunk's C tokens (ceil(log2 C) steps; the
    reference's ``associative_scan`` with the same combine).  h0 (B,di,N);
    dt, x (B,C,di); a (di,N); bmat, cmat (B,C,N), all fp32 -> (h_C
    (B,di,N), y (B,C,di))."""
    da = torch.exp(dt[..., None] * a)                            # (B,C,di,N)
    dbx = (dt * x)[..., None] * bmat[:, :, None, :]              # (B,C,di,N)
    c, k = dt.shape[1], 1
    while k < c:
        # (a1, b1) earlier, (a2, b2) later -> (a2·a1, a2·b1 + b2)
        dbx = torch.cat([dbx[:, :k], da[:, k:] * dbx[:, :-k] + dbx[:, k:]],
                        dim=1)
        da = torch.cat([da[:, :k], da[:, k:] * da[:, :-k]], dim=1)
        k *= 2
    h = da * h0[:, None] + dbx
    return h[:, -1], torch.einsum("bcdn,bcn->bcd", h, cmat)


def mamba_scan(h0, dt, a, bmat, cmat, x, *, chunk: int = MAMBA_CHUNK,
               train: bool = False):
    """The selective scan over S tokens in chunks of ``chunk`` (the last
    one shorter when ``chunk`` does not divide S), the state carried
    between them; each chunk step checkpointed under ``train``.  Shapes
    as :func:`mamba_chunk_scan` with S for C -> (h_S, y (B,S,di))."""
    h, ys = h0, []
    for lo in range(0, dt.shape[1], chunk):
        args = (h, dt[:, lo:lo + chunk], a, bmat[:, lo:lo + chunk],
                cmat[:, lo:lo + chunk], x[:, lo:lo + chunk])
        h, y = (checkpoint(mamba_chunk_scan, *args, use_reentrant=False)
                if train else mamba_chunk_scan(*args))
        ys.append(y)
    return h, torch.cat(ys, dim=1)


def mamba_scan_ref(h0, dt, a, bmat, cmat, x):
    """Plain oracle of :func:`mamba_scan`: the sequential recurrence, one
    token at a time."""
    h, ys = h0, []
    for t in range(dt.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * x[:, t])[..., None] * bmat[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    return h, torch.stack(ys, dim=1)


def mamba_scan_inputs(p: dict, x: torch.Tensor, s: SSMConfig, state: dict,
                      impl: str = "ref") -> tuple:
    """The full-sequence forward up to the scan: ``in_proj``, the causal
    depthwise conv over the carried context and the SSM parameters.
    x (B,S,d) -> (z (B,S,di) in x's dtype, then fp32 x (B,S,di), dt
    (B,S,di), A (di,N), B and C (B,S,N), and the new conv context)."""
    sl = x.shape[1]
    xi, z = _mamba_xz(p, x, impl)                                # (B,S,di)

    # causal depthwise conv with carried context, summed in xi's dtype
    ctx = state["conv"].to(xi.dtype)                             # (B,k-1,di)
    xpad = torch.cat([ctx, xi], dim=1)
    new_conv = (xpad[:, -(s.d_conv - 1):].to(state["conv"].dtype)
                if s.d_conv > 1 else state["conv"])
    w = p["conv_w"].to(xi.dtype)
    xc = xpad[:, 0:sl] * w[:, 0]
    for i in range(1, s.d_conv):
        xc = xc + xpad[:, i:i + sl] * w[:, i]
    xc = F.silu(xc.float() + p["conv_b"]).to(xi.dtype)

    dt, a, bmat, cmat = _mamba_ssm_params(p, xc, s, impl)
    return z, xc.float(), dt, a, bmat, cmat, new_conv


def mamba_forward(p: dict, x: torch.Tensor, s: SSMConfig, state: dict, *,
                  impl: str = "ref",
                  train: bool = False) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d) -> (y (B,S,d), new state), from ``state``; any S."""
    z, xf, dt, a, bmat, cmat, new_conv = mamba_scan_inputs(p, x, s, state,
                                                           impl)
    h_last, y = mamba_scan(state["ssm"].float(), dt, a, bmat, cmat, xf,
                           train=train)
    y = y + p["D"] * xf
    y = (y * F.silu(z.float())).to(x.dtype)
    out = linear_apply(p["out_proj"], y, impl, row=True)
    return out, {"ssm": h_last.to(state["ssm"].dtype), "conv": new_conv}


def mamba_decode(p: dict, x: torch.Tensor, s: SSMConfig, state: dict, *,
                 impl: str = "ref") -> Tuple[torch.Tensor, dict]:
    """x: (B,1,d) single token; the state carries the SSM state and the
    conv's last ``d_conv - 1`` inputs."""
    xi, z = (t[:, 0] for t in _mamba_xz(p, x, impl))             # (B,di)

    ctx = state["conv"].to(xi.dtype)                             # (B,k-1,di)
    window = torch.cat([ctx, xi[:, None]], dim=1)                # (B,k,di)
    xc = torch.einsum("bkd,dk->bd", window, p["conv_w"].to(xi.dtype))
    xc = F.silu(xc.float() + p["conv_b"]).to(xi.dtype)
    new_conv = window[:, 1:].to(state["conv"].dtype)

    dt, a, bmat, cmat = _mamba_ssm_params(p, xc[:, None], s, impl)
    dt, bmat, cmat = dt[:, 0], bmat[:, 0], cmat[:, 0]
    xf = xc.float()
    da = torch.exp(dt[..., None] * a)                            # (B,di,N)
    dbx = (dt * xf)[..., None] * bmat[:, None, :]
    h = da * state["ssm"].float() + dbx
    y = torch.einsum("bdn,bn->bd", h, cmat) + p["D"] * xf
    y = (y * F.silu(z.float())).to(x.dtype)
    out = linear_apply(p["out_proj"], y[:, None], impl, row=True)
    return out, {"ssm": h.to(state["ssm"].dtype), "conv": new_conv}

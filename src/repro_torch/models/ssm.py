"""Attention-free sequence mixer: RWKV-6 ("Finch").

The RWKV-6 half of ``repro/models/ssm.py``, with the same entry points:
  * ``rwkv6_forward`` — full sequence (prefill), returns (y, final_state);
    the WKV recurrence goes through ``kernels/wkv6/ops.py`` (the B8
    kernel on CUDA tensors, its plain chunked version on the CPU)
  * ``rwkv6_decode``  — one-token step on the constant-size state, plain
    torch as in the reference
  * ``init_rwkv6`` / ``init_rwkv6_state``

The reference's casts are kept exactly: the five mixed streams are
rounded to x's dtype, ``logw`` is fp32, prefill rounds the WKV output to
x's dtype before the group norm while decode keeps it fp32, and the gated
group-norm output is rounded to bf16 (in float32 configs too) before
``wout``.  The state is fp32; ``x_prev`` is stored fp32 and cast back to
x's dtype when used.  Mamba is not ported (ROADMAP A6.3): the block
assembly refuses it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import DEFAULT_CHUNK, wkv6_chunked_ref
from repro_torch.models.layers import init_linear, linear_apply

LORA_MIX = 32          # low-rank width of the five-stream lerp
LORA_DECAY = 64        # low-rank width of the decay
GROUP_NORM_EPS = 64e-5


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
                     device=None) -> dict:
    hd = s.head_dim
    h = d_model // hd
    f32 = dict(dtype=torch.float32, device=device)
    return {"wkv": torch.zeros((batch, h, hd, hd), **f32),
            "x_prev": torch.zeros((batch, d_model), **f32)}


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


def _rwkv6_out(p: dict, o: torch.Tensor, g: torch.Tensor, h: int, hd: int,
               impl: str) -> torch.Tensor:
    """Per-head group norm, gate, and the output projection on bf16."""
    b, s_ = o.shape[:2]
    og = o.reshape(b, s_, h, hd).float()
    mu = og.mean(-1, keepdim=True)
    var = og.var(-1, keepdim=True, unbiased=False)
    og = (og - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    of = og.reshape(b, s_, h * hd) * p["ln_x"]["scale"] + p["ln_x"]["bias"]
    y = (of * g).to(torch.bfloat16)
    if o.dtype != torch.float32:
        y = y.to(o.dtype)
    return linear_apply(p["wout"], y, impl)


def rwkv6_forward(p: dict, x: torch.Tensor, s: SSMConfig, state: dict, *,
                  impl: str = "ref",
                  train: bool = False) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d) -> (y (B,S,d), new state).  Starts from ``state``.  A
    training forward (``train=True``) runs the plain chunked WKV on every
    device, differentiable (the B8 kernel has no backward; the reference
    trains through its jnp form)."""
    b, sl, d = x.shape
    hd = s.head_dim
    h = d // hd
    x_prev_tok = torch.cat([state["x_prev"].to(x.dtype)[:, None],
                            x[:, :-1]], dim=1)
    r, k, v, g, logw = _rwkv6_mix(p, x, x_prev_tok, impl)
    heads = [t.reshape(b, sl, h, hd) for t in (r, k, v, logw)]
    if train:
        o, wkv = wkv6_chunked_ref(*(t.float() for t in heads),
                                  p["u"].float(), state["wkv"].float(),
                                  chunk=DEFAULT_CHUNK)
    else:
        o, wkv = wkv_ops.wkv6(*heads, p["u"], state["wkv"])
    y = _rwkv6_out(p, o.to(x.dtype), g, h, hd, impl)
    new_state = {"wkv": wkv, "x_prev": x[:, -1].to(state["x_prev"].dtype)}
    return y, new_state


def rwkv6_decode(p: dict, x: torch.Tensor, s: SSMConfig, state: dict, *,
                 impl: str = "ref") -> Tuple[torch.Tensor, dict]:
    """x: (B,1,d) single token; state carries wkv + previous token."""
    b, _, d = x.shape
    hd = s.head_dim
    h = d // hd
    x_prev_tok = state["x_prev"].to(x.dtype)[:, None]
    r, k, v, g, logw = _rwkv6_mix(p, x, x_prev_tok, impl)
    rh = r.reshape(b, h, hd).float()
    kh = k.reshape(b, h, hd).float()
    vh = v.reshape(b, h, hd).float()
    w = torch.exp(logw.reshape(b, h, hd))
    wkv = state["wkv"]
    # o = r·(S + u ⊙ k ⊗ v); S' = diag(w) S + k ⊗ v
    kv = kh[..., :, None] * vh[..., None, :]                     # (B,H,hd,hd)
    o = torch.einsum("bhi,bhij->bhj", rh, wkv + p["u"][None, :, :, None] * kv)
    new_wkv = w[..., None] * wkv + kv
    y = _rwkv6_out(p, o.reshape(b, 1, h, hd), g, h, hd, impl)
    return y, {"wkv": new_wkv, "x_prev": x[:, -1].to(state["x_prev"].dtype)}


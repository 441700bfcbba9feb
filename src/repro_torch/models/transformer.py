"""Block / group / stack assembly, and the encoder.

A *group* is one repeat of ``cfg.block_pattern`` (dense: 1 block; VLM:
``cross_attn_every`` blocks with cross-attention on the last).  The
reference scans over group-stacked parameters; the port keeps a Python
list of groups and loops over it; in a training forward each group is
wrapped in the config's remat policy, as the reference wraps its scan
body.  Block layout (pre-norm residual):

    x = x + mixer(norm1(x))            mixer ∈ {attn (GQA or MLA), mamba,
                                                rwkv6}
    [x = x + xattn(norm_x(x), src)]    (VLM / encoder-decoder blocks)
    x = x + mlp_or_moe(norm2(x))

Cross-attention reads the source's K / V, projected once at prefill and
kept in the cache (``xk`` / ``xv``) for decode.  The encoder (whisper) is
a bidirectional stack over the stub frame embeddings, a list of layers
where the reference has a vmapped stack.  A hybrid group (jamba: Mamba
blocks and one attention block) carries each Mamba block's recurrent
state beside the attention block's K / V in the same cache.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (init_mlp, init_norm, linear_apply,
                                       mlp_apply, norm_apply,
                                       whole_projection)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.sharding.collectives import active, scoped
from repro_torch.sharding.tp import local_attention, whole_heads


def block_kinds(cfg: ModelConfig) -> list[dict]:
    """Per-block metadata for one group: the mixer kind, a MoE layer on
    every ``moe_every``-th block, and cross-attention on every
    ``cross_attn_every``-th block (VLM) or on every attention block of an
    encoder-decoder model, as in the reference."""
    out = []
    for i, kind in enumerate(cfg.block_pattern):
        if kind not in ("attn", "mamba", "rwkv6"):
            raise NotImplementedError(
                f"block kind {kind!r}: only attention, Mamba and RWKV-6 "
                "blocks exist")
        xattn = (cfg.cross_attn_every > 0
                 and (i + 1) % cfg.cross_attn_every == 0) \
            or (cfg.encoder is not None and kind == "attn")
        out.append({"kind": kind, "xattn": xattn,
                    "moe": cfg.moe is not None and i % cfg.moe_every == 0})
    return out


def _noncausal(a):
    """The config's attention without a causal mask (cross-attention and
    the encoder's self-attention)."""
    return dataclasses.replace(a, causal=False)


def init_group(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device=None) -> dict:
    group = {}
    for i, bk in enumerate(block_kinds(cfg)):
        blk = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, device)}
        if bk["kind"] == "attn":
            blk["attn"] = attn_mod.init_attention(gen, cfg.d_model,
                                                  cfg.attention, dtype,
                                                  device)
        elif bk["kind"] == "mamba":
            blk["mamba"] = ssm_mod.init_mamba(gen, cfg.d_model, cfg.ssm,
                                              dtype, device)
        else:
            blk["rwkv"] = ssm_mod.init_rwkv6(gen, cfg.d_model, cfg.ssm,
                                             dtype, device)
        if bk["xattn"]:
            blk["norm_x"] = init_norm(cfg.norm, cfg.d_model, dtype, device)
            blk["xattn"] = attn_mod.init_attention(
                gen, cfg.d_model, _noncausal(cfg.attention), dtype, device)
        blk["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, device)
        if bk["moe"]:
            blk["moe"] = init_moe(gen, cfg.d_model, cfg.moe, dtype, device)
        else:
            blk["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff,
                                  bias=cfg.mlp_bias, dtype=dtype,
                                  device=device)
        group[f"blk{i}"] = blk
    return group


def init_group_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     paged: bool = False, n_pages: int = 0,
                     pages_per_slot: int = 0, page_size: int = 256,
                     kv_dtype: Optional[str] = None, device=None,
                     block_table: Optional[torch.Tensor] = None) -> dict:
    """Caches for one group.  Attention blocks: contiguous (B, S, KH, D)
    slabs (KH: this rank's kv heads under a model axis, every kv head
    where the axis does not divide them: ``tp.whole_heads``), or page
    pools (this rank's kv heads) +
    a block table when ``paged`` (``block_table`` shares one table tensor
    across layers); ``kv_dtype`` overrides
    ``cfg.kv_cache_dtype`` (the paged engine prefills into a bf16 staging
    cache; MLA's latent ``{"c_kv", "k_pe"}`` is contiguous only).  RWKV-6
    blocks: ``{"state": {"wkv": (B,H,D,D), "x_prev": (B,d)}}``, Mamba
    blocks ``{"state": {"ssm": (B,di,N), "conv": (B,d_conv-1,di)}}``, in
    fp32, position-free; under a model axis of m a rank's H/m heads of
    ``wkv`` (``x_prev`` whole) and di/m channels, as a cell places them.  A
    cross-attention block's source K / V (``"xk"`` / ``"xv"``, (B, T_src,
    KH, D) in bf16, position-free) join its node at prefill, so none is
    held before there is a source."""
    from repro_torch.kvcache import CacheSpec, alloc_contiguous, alloc_paged
    spec = CacheSpec(layout="paged" if paged else "contiguous",
                     dtype=kv_dtype or cfg.kv_cache_dtype,
                     style=cfg.kv_cache_style, page_size=page_size)
    cache = {}
    a = cfg.attention if not paged and whole_heads(cfg) \
        else local_attention(cfg)
    m = cfg.model_parallel
    for i, bk in enumerate(block_kinds(cfg)):
        if bk["kind"] == "rwkv6":
            c = {"state": ssm_mod.init_rwkv6_state(batch, cfg.d_model,
                                                   cfg.ssm, device, m)}
        elif bk["kind"] == "mamba":
            c = {"state": ssm_mod.init_mamba_state(batch, cfg.d_model,
                                                   cfg.ssm, device, m)}
        elif paged:
            c = {"kv": alloc_paged(spec, a, batch, n_pages, pages_per_slot,
                                   device, block_table)}
        else:
            c = {"kv": alloc_contiguous(spec, a, batch, max_len, device)}
        cache[f"blk{i}"] = c
    return cache


# ---------------------------------------------------------------------------
# Cross-attention (source K / V projected once, read from the cache at
# decode)


def _attn_arm(cfg: ModelConfig):
    """(attention config, mesh) of a rank's contiguous full-sequence
    attention (and cross-attention): its own heads (mesh ``None``), or
    under a tensor-parallel scope whose model axis does not divide the
    heads every head, gathered whole (the whole-heads arm,
    ``models.attention``: the scope's mesh)."""
    tp = active()
    if tp is not None and whole_heads(cfg):
        return cfg.attention, tp.mesh
    return local_attention(cfg), None


def _xattn_kv(p: dict, src: torch.Tensor, a, impl: str = "ref", mesh=None):
    """The source's K / V (B, T, KH, D): no RoPE, as in the reference;
    ``mesh``: every kv head, gathered whole."""
    b, t, _ = src.shape
    kvh, hd = a.kv_heads_effective(), a.head_dim
    if mesh is None:
        xk, xv = (linear_apply(p[n], src, impl) for n in ("wk", "wv"))
    else:
        xk, xv = (whole_projection(p[n], src, kvh * hd, mesh, "model",
                                   impl) for n in ("wk", "wv"))
    return xk.reshape(b, t, kvh, hd), xv.reshape(b, t, kvh, hd)


def _xattn_with_kv(p: dict, x: torch.Tensor, a, xk: torch.Tensor,
                   xv: torch.Tensor, impl: str = "ref",
                   train: bool = False, mesh=None) -> torch.Tensor:
    """x's queries (no RoPE) over every source position, no mask, through
    the attention's own dispatch (``_attend``): the flash kernel's
    non-causal path on CUDA tensors outside training (S != T: S the
    prompt at prefill, 1 at decode), the plain grouped ``sdpa`` on the
    CPU and in training, as the reference computes it.  ``mesh``: every
    head (the whole-heads arm; ``xk`` / ``xv`` hold every kv head)."""
    b, s, _ = x.shape
    hw = a.heads_padded * a.head_dim
    q = linear_apply(p["wq"], x, impl) if mesh is None else \
        whole_projection(p["wq"], x, hw, mesh, "model", impl)
    q = q.reshape(b, s, a.heads_padded, a.head_dim)
    return attn_mod._attend(p, q, xk.to(x.dtype), xv.to(x.dtype),
                            _noncausal(a), False, impl, train=train,
                            attn_impl="sdpa", mesh=mesh)


def group_forward(gp: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  mode: str, cache: Optional[dict],
                  pos: Optional[torch.Tensor], train: bool = False,
                  cross_src: Optional[torch.Tensor] = None):
    """One group.  ``mode`` is "prefill" (full sequence; fills a
    contiguous cache when given, or — on a paged cache — one chunk per row
    at ``pos = (slot_ids, starts, lengths[, max_pages])``), "decode" (one
    token per row, ``pos`` the (S,) write positions; the cache's layout
    picks paged or contiguous attention, where the reference reads
    ``decode_attn_impl``, which under a mesh can ask for the
    context-parallel decode of a contiguous bf16 / float32 cache split
    over the model axis's sequence, ``attention_decode_cp``) or "verify"
    (a speculative chunk per slot over
    the paged cache, ``pos = (lengths, widths[, max_pages])``; the cache
    node is ``{"kv": paged, "stage": contiguous}`` and only the stage is
    written).  RWKV-6 and Mamba blocks run their recurrence from the
    cache's state (zeros without a cache) and ignore ``pos``.  A cross-attention block
    attends ``cross_src`` (B, T, d: the encoder's output or the stub patch
    embeddings) in "prefill", storing its K / V in the cache when there is
    one, and the cached K / V in "decode".

    ``train=True`` is the training forward (``LM.loss``): "prefill" with
    no cache, through the reference's training math in plain torch on
    every device (norms, attention, quantized linears and the WKV launch
    no kernel: none has a backward; each Mamba scan chunk checkpointed),
    MoE layers at their training capacity.  Returns ``(x, new cache, aux)``, ``aux`` the MoE layers'
    losses and dropped fractions summed over the group's blocks.  Under a
    model axis (``cfg.model_parallel`` > 1) attention runs this rank's
    heads (``sharding.tp.local_attention``); where the axis does not
    divide them, the contiguous prefill, the training forward and
    cross-attention run every head (:func:`_attn_arm`), and the paged
    paths and the eager decode refuse them (A8.8)."""
    # context-parallel decode (``decode_attn_impl="cp"``) under a model
    # axis: the projections are gathered whole, so the config's heads
    # need not divide over the axis
    tp = active()
    cp = mode == "decode" and cfg.decode_attn_impl == "cp" \
        and tp is not None
    a, whole = _attn_arm(cfg)
    if train and (mode != "prefill" or cache is not None):
        raise ValueError("a training forward is a full sequence without a "
                         "cache (mode='prefill', cache=None)")
    # the quantized linears' execution choice: the model's serving impl,
    # or the reference's differentiable oracles in a training forward
    impl = "train" if train else cfg.quant_matmul_impl
    # chunked attention on the CPU and in training (serving CUDA tensors
    # take the flash kernel)
    chunk_kw = dict(attn_impl=cfg.attn_impl, q_block=cfg.attn_q_block,
                    kv_block=cfg.attn_kv_block, chunk_min=cfg.attn_chunk_min)
    new_cache: Dict[str, Any] = {}
    aux_total: Dict[str, torch.Tensor] = {}
    for i, bk in enumerate(block_kinds(cfg)):
        blk = gp[f"blk{i}"]
        c = cache[f"blk{i}"] if cache is not None else None
        h = norm_apply(cfg.norm, blk["norm1"], x, cfg.norm_eps, train=train)
        if mode not in ("prefill", "decode", "verify"):
            raise ValueError(f"mode {mode!r}")
        if mode == "verify" and bk["kind"] != "attn":
            raise NotImplementedError("verify runs attention blocks only")
        if bk["kind"] == "rwkv6":
            st = c["state"] if c is not None else ssm_mod.init_rwkv6_state(
                x.shape[0], cfg.d_model, cfg.ssm, x.device,
                cfg.model_parallel)
            if mode == "decode":
                y, st2 = ssm_mod.rwkv6_decode(blk["rwkv"], h, cfg.ssm, st,
                                              impl=impl)
            else:
                y, st2 = ssm_mod.rwkv6_forward(blk["rwkv"], h, cfg.ssm, st,
                                               impl=impl, train=train)
            if c is not None:
                new_cache[f"blk{i}"] = {"state": st2}
        elif bk["kind"] == "mamba":
            st = c["state"] if c is not None else ssm_mod.init_mamba_state(
                x.shape[0], cfg.d_model, cfg.ssm, x.device,
                cfg.model_parallel)
            if mode == "decode":
                y, st2 = ssm_mod.mamba_decode(blk["mamba"], h, cfg.ssm, st,
                                              impl=impl)
            else:
                y, st2 = ssm_mod.mamba_forward(blk["mamba"], h, cfg.ssm, st,
                                               impl=impl, train=train)
            if c is not None:
                new_cache[f"blk{i}"] = {"state": st2}
        elif mode == "prefill":
            if c is None:
                y = attn_mod.attention_forward(blk["attn"], h, a,
                                               use_flash=cfg.use_kernels,
                                               impl=impl, train=train,
                                               mesh=whole, **chunk_kw)
            elif "k_pages" in c["kv"]:
                y, kv = attn_mod.attention_prefill_paged(
                    blk["attn"], h, local_attention(cfg), c["kv"], pos,
                    impl)
                new_cache[f"blk{i}"] = {"kv": kv}
            else:
                y, kv = attn_mod.attention_prefill(
                    blk["attn"], h, a, c["kv"], use_flash=cfg.use_kernels,
                    impl=impl, mesh=whole, **chunk_kw)
                new_cache[f"blk{i}"] = {"kv": kv}
        elif mode == "verify":
            y, stage = attn_mod.attention_verify_paged(
                blk["attn"], h, local_attention(cfg), c["kv"], c["stage"],
                pos, impl)
            new_cache[f"blk{i}"] = {"stage": stage}
        else:
            if c is None:
                raise ValueError("attention decode needs a cache")
            if cp and "k_pages" not in c["kv"] and a.kind != "mla" \
                    and "k_scale" not in c["kv"]:
                # the cache's sequence over the model axis; quantized
                # caches fall through to the eager decode, as in the
                # reference
                y, kv = attn_mod.attention_decode_cp(
                    blk["attn"], h, cfg.attention, c["kv"], pos, tp.mesh,
                    impl=impl)
            else:
                step = (attn_mod.attention_decode_paged
                        if "k_pages" in c["kv"]
                        else attn_mod.attention_decode)
                y, kv = step(blk["attn"], h, local_attention(cfg), c["kv"],
                             pos, impl)
            new_cache[f"blk{i}"] = {"kv": kv}
        x = x + y
        if bk["xattn"]:
            hx = norm_apply(cfg.norm, blk["norm_x"], x, cfg.norm_eps,
                            train=train)
            if mode == "decode":
                if "xk" not in c:
                    raise ValueError("cross-attention decode reads the "
                                     "source's K / V that prefill caches")
                xk, xv = c["xk"], c["xv"]
            elif mode == "prefill":
                if cross_src is None:
                    raise ValueError("cross-attention needs the source: "
                                     "pass modality_input")
                xk, xv = _xattn_kv(blk["xattn"], cross_src, a, impl, whole)
            else:
                raise NotImplementedError("verify runs attention blocks "
                                          "without cross-attention only")
            y = _xattn_with_kv(blk["xattn"], hx, a, xk, xv, impl, train,
                               whole)
            if c is not None:
                new_cache[f"blk{i}"].update(xk=xk.to(torch.bfloat16),
                                            xv=xv.to(torch.bfloat16))
            x = x + y
        h = norm_apply(cfg.norm, blk["norm2"], x, cfg.norm_eps, train=train)
        if bk["moe"]:
            # capacity_factor in training, eval_capacity_factor serving
            y, aux = moe_apply(blk["moe"], h, cfg.moe, train=train,
                               group_size=cfg.moe_group_size,
                               impl=cfg.moe_impl, quant_impl=impl)
            for k, v in aux.items():
                aux_total[k] = aux_total[k] + v if k in aux_total else v
        else:
            y = mlp_apply(blk["mlp"], h, impl)
        x = x + y
    return x, (new_cache if cache is not None else None), aux_total


def init_stack(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device=None) -> List[dict]:
    return [init_group(gen, cfg, dtype, device)
            for _ in range(cfg.num_groups)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     device=None, **kw) -> List[dict]:
    if kw.get("paged") and kw.get("block_table") is None:
        kw["block_table"] = torch.zeros(
            (batch, kw.get("pages_per_slot", 0)), dtype=torch.int32,
            device=device)
    return [init_group_cache(cfg, batch, max_len, device=device, **kw)
            for _ in range(cfg.num_groups)]


def _save_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    matrix products' outputs, recompute everything else (JAX's
    ``checkpoint_dots``).  The collectives of a sharded forward are kept
    too, so a recompute makes none."""
    return (CheckpointPolicy.MUST_SAVE if op in _PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
             torch.ops.repro_torch.collective.default}


def _remat(fn, policy: str):
    """The reference's ``_remat_wrap`` around one group: "full" keeps only
    the group's inputs (``checkpoint``), "dots" its matrix products too
    (selective checkpointing), "none" everything."""
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    ctx = {}
    if policy == "dots":
        ctx["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_products)
    return functools.partial(checkpoint, fn, use_reentrant=False, **ctx)


def stack_forward(params: List[dict], x: torch.Tensor, cfg: ModelConfig, *,
                  mode: str = "prefill", cache: Optional[List[dict]] = None,
                  pos: Optional[torch.Tensor] = None, train: bool = False,
                  cross_src: Optional[torch.Tensor] = None):
    """Python loop over the groups (the reference's ``lax.scan``) ->
    ``(x, new cache, aux)``, ``aux`` summed over the groups.  A training
    forward wraps each group in ``cfg.remat_policy`` where the reference
    does (its scanned layout, ``scan_layers=True``).  ``cross_src`` is
    the cross-attention blocks' source (see ``group_forward``).  A
    checkpointed group runs under the tensor-parallel scope it was
    called in, its recompute in backward included."""
    new_cache = [] if cache is not None else None
    policy = cfg.remat_policy if train and cfg.scan_layers else "none"
    body = _remat(scoped(group_forward, active()), policy)
    aux_total: Dict[str, torch.Tensor] = {}
    for i, gp in enumerate(params):
        x, nc, aux = body(gp, x, cfg, mode=mode,
                          cache=cache[i] if cache is not None else None,
                          pos=pos, train=train, cross_src=cross_src)
        if cache is not None:
            new_cache.append(nc)
        for k, v in aux.items():
            aux_total[k] = aux_total[k] + v if k in aux_total else v
    return x, new_cache, aux_total


# ---------------------------------------------------------------------------
# Whisper-style encoder (bidirectional attention stack, no cache)


def init_encoder(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
                 device=None) -> dict:
    """``{"layers": [layer, ...], "final_norm"}``: one dict a layer (the
    reference stacks them on a leading axis), each a pre-norm block of
    non-causal attention and a dense MLP."""
    enc_attn = _noncausal(cfg.attention)
    layers = []
    for _ in range(cfg.encoder.num_layers):
        layers.append({
            "norm1": init_norm(cfg.norm, cfg.d_model, dtype, device),
            "attn": attn_mod.init_attention(gen, cfg.d_model, enc_attn,
                                            dtype, device),
            "norm2": init_norm(cfg.norm, cfg.d_model, dtype, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                            device=device)})
    return {"layers": layers,
            "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, device)}


def encoder_forward(p: dict, frames: torch.Tensor, cfg: ModelConfig, *,
                    train: bool = False) -> torch.Tensor:
    """frames (B, T, d) -> the encoder's output (B, T, d).  Self-attention
    at positions [0, T) (RoPE on), without a mask: the flash kernel's
    non-causal path on CUDA tensors outside training, the reference's
    plain choice on the CPU and in training (``sdpa``, chunked from 2,048
    positions: the reference's encoder passes ``attention_forward``'s
    defaults, not the config's chunk settings).  Under a model axis a
    rank runs its heads, or every head where the axis does not divide
    them (:func:`_attn_arm`)."""
    a, whole = _attn_arm(cfg)
    enc_attn = _noncausal(a)
    impl = "train" if train else cfg.quant_matmul_impl
    x = frames
    for lp in p["layers"]:
        h = norm_apply(cfg.norm, lp["norm1"], x, cfg.norm_eps, train=train)
        x = x + attn_mod.attention_forward(lp["attn"], h, enc_attn,
                                           impl=impl, train=train,
                                           mesh=whole)
        h = norm_apply(cfg.norm, lp["norm2"], x, cfg.norm_eps, train=train)
        x = x + mlp_apply(lp["mlp"], h, impl)
    return norm_apply(cfg.norm, p["final_norm"], x, cfg.norm_eps,
                      train=train)

"""What one rank of a tensor-parallel model computes.

Under a model axis of m (``cfg.model_parallel``), a rank holds the slice
of every parameter that ``sharding.rules`` gives it and computes:
  * the column-split linears (``wq`` / ``wk`` / ``wv``, ``gate`` / ``up``)
    on their local columns, bias slices added locally;
  * attention over its H/m query heads and KVH/m kv heads, on page pools
    that hold only those kv heads (:func:`local_attention` is the
    attention config a rank runs and allocates with); or, on the
    contiguous full-sequence paths (prefill, training, the encoder,
    cross-attention) where the axis does not divide the head counts,
    over every head: the whole-heads arm (:func:`whole_heads`,
    ``models.attention``), whose projections are gathered whole and
    whose ``wo`` reads the rank's rows of the whole output;
  * the row-split linears (``wo``, ``down``) as an fp32 partial product
    over its slice of the contraction, all-reduced in fp32 and rounded
    once to the activation dtype, the bias added once after (the
    reference's ``f32_accum``: the sum a single device computes, not a
    sum of rounded partials);
  * quantized linears (int8 / fp8 / int4) on their slices alike, the
    row-split ones through ``quant.qops.row_partial``, and PEFT adapters
    unmerged (``models.layers.linear_apply``);
  * MoE layers (``models.moe``): routing on every rank from the whole
    activations, the rank's E/m experts (EP, where the axis divides the
    padded expert count) or every expert over its f/m slice of the
    hidden width (the TP fallback), one fp32 all-reduce a layer;
  * RWKV-6 blocks over its H/m WKV heads and Mamba blocks over its
    d_inner/m channels (``models.ssm``), their recurrent state the
    rank's heads or channels;
  * a vocab-split embedding lookup (:func:`embed`) and vocab-split fp32
    logits, gathered before sampling.
Activations stay whole between the blocks (the reference's
``seq_parallel`` placement hint has no counterpart).  In a training
forward the reductions go through ``collectives.reduce_from_model`` and
the column-split inputs through ``copy_to_model``, so autograd gives
every rank the gradient of its slice; the row-split partials stay fp32
there too (the reference accumulates them in fp32 only when serving).

:func:`check_servable` and :func:`check_trainable` refuse, each with a
message naming its ROADMAP item (A8.8), what the port does not shard:
head counts the axis does not divide in the engines (their page pools
split kv heads) and in the paged or eager decode, widths or expert
counts it does not divide (RWKV-6 heads and Mamba's d_inner among
them), MLA, projections whose widths it does not divide, an odd K/m
under int4, quantized RWKV-6 / Mamba linears and a narrowed KV-head
style.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.sharding.collectives import (all_gather, local_piece,
                                              reduce_from_model)

#: the ROADMAP item that shards what the port still refuses
A88 = ("ROADMAP A8.8 (layouts a model axis does not split: MLA, head "
       "counts it does not divide in the engines, widths, expert counts, "
       "RWKV-6 heads or Mamba channels it does not divide, an odd K/m "
       "under int4, quantized RWKV-6 / Mamba linears, a narrowed "
       "kv_cache_style)")


def local_attention(cfg):
    """The attention config one rank runs: H/m query heads over KVH/m kv
    heads (``cfg.attention`` itself when ``cfg.model_parallel`` is 1)."""
    a, m = cfg.attention, cfg.model_parallel
    if a is None or m == 1:
        return a
    refusal = _heads_refusal(cfg)
    if refusal:
        raise ValueError(refusal)
    return dataclasses.replace(a, num_heads=a.num_heads // m,
                               num_kv_heads=a.num_kv_heads // m)


def _heads_refusal(cfg) -> str:
    """Why the model axis cannot split ``cfg``'s attention heads ("" where
    it can, and for a config without attention)."""
    a, m = cfg.attention, cfg.model_parallel
    if a is None:
        return ""
    kvh = a.kv_heads_effective()
    if a.kind == "mla" or a.heads_padded != a.num_heads \
            or a.num_heads % m or kvh % m:
        return (f"{cfg.name}: a model axis of {m} must divide both the "
                f"{a.num_heads} query heads (num_heads) and the {kvh} kv "
                f"heads (num_kv_heads) of a {a.kind} attention without "
                "padded heads; the port refuses head counts the axis does "
                f"not divide (the reference replicates them): {A88}")
    return ""


def whole_heads(cfg) -> bool:
    """Whether a rank of ``cfg`` computes its full-sequence attention over
    every head (the whole-heads arm): a model axis > 1 that does not
    split the heads (:func:`_heads_refusal`) of an attention that is not
    MLA.  The rules still split ``wq`` / ``wk`` / ``wv`` by columns and
    ``wo`` by rows, which need not be whole heads."""
    a = cfg.attention
    return cfg.model_parallel > 1 and a is not None and a.kind != "mla" \
        and bool(_heads_refusal(cfg))


def _whole_refusal(cfg) -> str:
    """Why a rank cannot compute every head of ``cfg`` ("" where it can):
    MLA, or a projection width the axis does not divide (the gathered
    columns and ``wo``'s rows must be the rules' even pieces)."""
    a, m = cfg.attention, cfg.model_parallel
    if a is None:
        return ""
    if a.kind == "mla":
        return _heads_refusal(cfg)
    widths = {a.heads_padded * a.head_dim, a.kv_heads_effective()
              * a.head_dim}
    if any(w % m for w in widths):
        return (f"{cfg.name}: a model axis of {m} must divide the "
                f"projections' widths {sorted(widths)} to compute every "
                f"head on each rank: {A88}")
    return ""


def _widths_refusal(cfg) -> str:
    """Why the model axis cannot split ``cfg``'s MLP or MoE widths ("" where
    it can): a dense d_ff, or an expert count (EP) and else the experts'
    hidden width (the TP fallback), and the shared experts' width."""
    m, moe = cfg.model_parallel, cfg.moe
    dense = moe is None or cfg.moe_every > 1
    if dense and cfg.d_ff % m:
        return f"{cfg.name}: a model axis of {m} must divide d_ff {cfg.d_ff}"
    refusal = _ssm_refusal(cfg)
    if refusal:
        return refusal
    if moe is None:
        return ""
    if moe.padded_experts % m and moe.d_ff % m:
        return (f"{cfg.name}: a model axis of {m} must divide the "
                f"{moe.padded_experts} (padded) experts or their hidden "
                f"width {moe.d_ff}")
    shared = moe.num_shared_experts * moe.shared_d_ff
    if shared % m:
        return (f"{cfg.name}: a model axis of {m} must divide the shared "
                f"experts' hidden width {shared}")
    return ""


def _ssm_refusal(cfg) -> str:
    """Why the model axis cannot split ``cfg``'s RWKV-6 heads or Mamba
    channels ("" where it can): a rank runs whole WKV heads (its d/m
    columns of ``wr`` / ``wk`` / ``wv`` / ``wg``) and d_inner/m Mamba
    channels."""
    m, s = cfg.model_parallel, cfg.ssm
    kinds = set(cfg.block_pattern)
    if "rwkv6" in kinds and (cfg.d_model // s.head_dim) % m:
        return (f"{cfg.name}: a model axis of {m} must divide the "
                f"{cfg.d_model // s.head_dim} RWKV-6 heads (d_model / "
                "head_dim)")
    if "mamba" in kinds and (s.expand * cfg.d_model) % m:
        return (f"{cfg.name}: a model axis of {m} must divide the Mamba "
                f"blocks' d_inner {s.expand * cfg.d_model}")
    return ""


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, node


def _tree_refusal(cfg, params) -> str:
    """Why the model axis cannot split a leaf of ``params`` ("" where it
    can): a row-split int4 ``qw`` whose K/m is odd (a packed byte holds
    two rows of K), or a quantized RWKV-6 / Mamba linear (the rules
    leave most of them whole)."""
    m = cfg.model_parallel
    for path, leaf in _leaves(params):
        if path.endswith("/qw") and ("/rwkv/" in path or "/mamba/" in path):
            return (f"{path}: quantized RWKV-6 / Mamba linears are not "
                    f"split over a model axis of {m}")
        if path.endswith(("/down/qw", "/wo/qw")) \
                and leaf.dtype == torch.uint8 and leaf.shape[0] % m:
            return (f"{path}: int4 packs two rows of K a byte, so a model "
                    f"axis of {m} must leave K/m even (K = "
                    f"{2 * leaf.shape[0]})")
    return ""


def cp_decode(cfg) -> bool:
    """Whether ``cfg``'s contiguous decode takes the context-parallel
    step under a model axis (``decode_attn_impl="cp"``, an unquantized
    cache, not MLA): there the axis splits the cache's sequence, not the
    heads, so any head count is served (``models.attention.
    attention_decode_cp``)."""
    from repro_torch.kvcache import normalize_dtype
    a = cfg.attention
    return (cfg.decode_attn_impl == "cp" and a is not None
            and a.kind != "mla"
            and normalize_dtype(cfg.kv_cache_dtype) == "bfloat16")


def check_servable(cfg, params, *, cell: Optional[str] = None) -> None:
    """Raise ``ValueError`` for a config or tree the port does not serve
    under a model axis of ``cfg.model_parallel`` > 1.  MoE layers (EP or
    the TP fallback), RWKV-6 and Mamba blocks, int8 / fp8 / int4 weights
    and PEFT adapters (unmerged) are served.  ``cell`` is the
    mode of a dry-run cell (``launch.steps``): a ``"prefill"`` cell
    computes head counts the axis does not divide over every head (the
    whole-heads arm), and so does a ``"decode"`` cell whose
    self-attention takes the context-parallel step (:func:`cp_decode`;
    its cross-attention takes the whole-heads arm).  The engines pass no
    cell and keep refusing such heads: their page pools split kv heads
    (A8.8)."""
    from repro_torch.kvcache import cache_kv_heads
    if cell == "prefill" or (cell == "decode" and cp_decode(cfg)):
        refusal = _whole_refusal(cfg)    # MLA, widths it does not divide
        if refusal:
            raise ValueError(refusal)
    else:
        local_attention(cfg)             # refuses non-dividing heads, MLA
    refusal = _widths_refusal(cfg) or _tree_refusal(cfg, params)
    if refusal:
        raise ValueError(f"{refusal}: {A88}")
    a = cfg.attention
    if a is not None and cache_kv_heads(a, cfg.kv_cache_style) \
            != a.kv_heads_effective():
        raise ValueError(f"kv_cache_style {cfg.kv_cache_style!r} merges kv "
                         "heads; under a model axis > 1 the pools keep "
                         f"every kv head (kv_cache_style 'full'): {A88}")


def check_trainable(cfg, params) -> None:
    """Raise ``ValueError`` for a config or tree that training does not
    shard under a model axis of ``cfg.model_parallel`` > 1: MLA,
    projection widths, widths, expert counts, RWKV-6 heads or Mamba
    channels the axis does not divide (A8.8).  Head counts it does not
    divide train through the whole-heads arm (:func:`whole_heads`); MoE
    layers, RWKV-6 and Mamba blocks, encoders and cross-attention, PEFT
    adapters, int8 / int4 / fp8 bases and either ``tp_attn_impl`` train
    (the arms differ only on paged pools, which training never reads).
    A data axis alone (``model_parallel`` 1) refuses nothing."""
    m = cfg.model_parallel
    if m == 1:
        return
    refusal = _whole_refusal(cfg) if whole_heads(cfg) else _heads_refusal(cfg)
    if refusal:
        raise ValueError(refusal)
    refusal = _widths_refusal(cfg) or _tree_refusal(cfg, params)
    if refusal:
        raise ValueError(f"{refusal}: {A88}")


def shard_model(lm, params, mesh):
    """(this rank's LM, this rank's parameters) for an unsharded LM and
    its whole parameters (the same on every rank, e.g. from one seed):
    the config marked with the mesh's model axis, refused by
    :func:`check_servable` where the port does not serve it, and the
    tree sliced by the placement rules."""
    from repro_torch.sharding.rules import make_param_specs, shard_params
    cfg = lm.cfg.with_(model_parallel=mesh.model)
    check_servable(cfg, params)
    local = shard_params(params, make_param_specs(params, mesh), mesh)
    return type(lm)(cfg, device=lm.device, mesh=mesh), local


def embed(w: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """Lookup in a vocab-split table: this rank's rows where it holds the
    id, zeros elsewhere, summed over the group (one rank contributes
    each row, so the fp32 sum is exact; the gradient reaches the rows
    this rank holds)."""
    rows = w.shape[0]
    local = ids.long() - mesh.model_rank * rows
    hit = (local >= 0) & (local < rows)
    x = torch.where(hit[..., None], w[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=w.dtype, device=w.device))
    return reduce_from_model(x.float(), mesh).to(w.dtype)


def row_linear(partial: torch.Tensor, dtype: torch.dtype, bias,
               mesh) -> torch.Tensor:
    """A row-split linear's output from this rank's fp32 partial: summed
    in fp32, rounded once, the bias added once."""
    y = reduce_from_model(partial, mesh).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def over_all_heads(fn: Callable, args: Sequence, head_dims: Sequence,
                   out_dim: int, mesh) -> torch.Tensor:
    """The ``gather`` attention arm (the reference's naive baseline): the
    operands that carry heads (``head_dims[i]`` is their head dim, ``None``
    for the rest) are all-gathered from every rank, ``fn`` runs over all
    heads, and this rank keeps its own heads of the output."""
    full = [a if d is None or a is None else all_gather(a, d, mesh)
            for a, d in zip(args, head_dims)]
    return local_piece(fn(*full), out_dim, mesh).contiguous()


def logits_whole(logits: torch.Tensor, padded_vocab: int,
                 mesh) -> torch.Tensor:
    """Vocab-split logits (..., V/m) gathered to (..., V); logits of a
    whole head pass through."""
    if mesh is None or logits.shape[-1] == padded_vocab:
        return logits
    return all_gather(logits, logits.ndim - 1, mesh)

"""What one rank of a tensor-parallel model computes.

Under a model axis of m (``cfg.model_parallel``), a rank holds the slice
of every parameter that ``sharding.rules`` gives it and computes:
  * the column-split linears (``wq`` / ``wk`` / ``wv``, ``gate`` / ``up``)
    on their local columns, bias slices added locally;
  * attention over its H/m query heads and KVH/m kv heads, on page pools
    that hold only those kv heads (:func:`local_attention` is the
    attention config a rank runs and allocates with);
  * the row-split linears (``wo``, ``down``) as an fp32 partial product
    over its slice of the contraction, all-reduced in fp32 and rounded
    once to the activation dtype, the bias added once after (the
    reference's ``f32_accum``: the sum a single device computes, not a
    sum of rounded partials);
  * a vocab-split embedding lookup (:func:`embed`) and vocab-split fp32
    logits, gathered before sampling.
Activations stay whole between the blocks (the reference's
``seq_parallel`` placement hint has no counterpart).

:func:`check_servable` refuses, each with a message, what this slice
does not shard: head counts the axis does not divide (the reference
replicates them), a d_ff it does not divide, MoE layers, fp8 / int4
weights, PEFT adapters and a narrowed KV-head style.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.sharding.collectives import (all_gather, all_reduce,
                                              local_piece)

#: the ROADMAP part that shards what this slice refuses
LATER = "ROADMAP A8.3 (MoE, fp8 and int4 weights under a model axis)"


def local_attention(cfg):
    """The attention config one rank runs: H/m query heads over KVH/m kv
    heads (``cfg.attention`` itself when ``cfg.model_parallel`` is 1)."""
    a, m = cfg.attention, cfg.model_parallel
    if a is None or m == 1:
        return a
    kvh = a.kv_heads_effective()
    if a.kind == "mla" or a.heads_padded != a.num_heads \
            or a.num_heads % m or kvh % m:
        raise ValueError(
            f"{cfg.name}: a model axis of {m} must divide both the "
            f"{a.num_heads} query heads (num_heads) and the {kvh} kv heads "
            f"(num_kv_heads) of a {a.kind} attention without padded heads; "
            "the port refuses head counts the axis does not divide (the "
            "reference replicates them)")
    return dataclasses.replace(a, num_heads=a.num_heads // m,
                               num_kv_heads=a.num_kv_heads // m)


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, node


def check_servable(cfg, params) -> None:
    """Raise ``ValueError`` for a config or tree this slice does not serve
    under a model axis of ``cfg.model_parallel`` > 1."""
    from repro_torch.kvcache import cache_kv_heads
    m = cfg.model_parallel
    local_attention(cfg)                 # refuses non-dividing heads
    if cfg.moe is not None:
        raise ValueError(f"{cfg.name}: MoE layers under a model axis > 1 "
                         f"are not sharded yet: {LATER}")
    if cfg.d_ff % m:
        raise ValueError(f"{cfg.name}: a model axis of {m} must divide "
                         f"d_ff {cfg.d_ff}")
    if cache_kv_heads(cfg.attention, cfg.kv_cache_style) \
            != cfg.attention.kv_heads_effective():
        raise ValueError(f"kv_cache_style {cfg.kv_cache_style!r} merges kv "
                         "heads; under a model axis > 1 the pools keep "
                         "every kv head (kv_cache_style 'full')")
    for path, leaf in _leaves(params):
        if path.endswith("/lora") or "/lora/" in path:
            raise ValueError(f"{path}: PEFT adapters under a model axis > 1 "
                             "are not sharded; merge them first "
                             "(peft.lora.merge_lora)")
        if path.endswith("/qw") and leaf.dtype != torch.int8:
            kind = "int4" if leaf.dtype == torch.uint8 else "fp8"
            raise ValueError(f"{path}: {kind} weights under a model axis "
                             f"> 1 are not sharded yet: {LATER}")


def shard_model(lm, params, mesh):
    """(this rank's LM, this rank's parameters) for an unsharded LM and
    its whole parameters (the same on every rank, e.g. from one seed):
    the config marked with the mesh's model axis, refused by
    :func:`check_servable` where this slice does not serve it, and the
    tree sliced by the placement rules."""
    from repro_torch.sharding.rules import make_param_specs, shard_params
    cfg = lm.cfg.with_(model_parallel=mesh.model)
    check_servable(cfg, params)
    local = shard_params(params, make_param_specs(params, mesh), mesh)
    return type(lm)(cfg, device=lm.device, mesh=mesh), local


def embed(w: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """Lookup in a vocab-split table: this rank's rows where it holds the
    id, zeros elsewhere, summed over the group (one rank contributes
    each row, so the fp32 sum is exact)."""
    rows = w.shape[0]
    local = ids.long() - mesh.model_rank * rows
    hit = (local >= 0) & (local < rows)
    x = torch.where(hit[..., None], w[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=w.dtype, device=w.device))
    return all_reduce(x.float(), "sum", mesh).to(w.dtype)


def row_linear(partial: torch.Tensor, dtype: torch.dtype, bias,
               mesh) -> torch.Tensor:
    """A row-split linear's output from this rank's fp32 partial: summed
    in fp32, rounded once, the bias added once."""
    y = all_reduce(partial, "sum", mesh).to(dtype)
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

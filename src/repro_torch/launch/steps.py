"""Step functions and their placements for the dry-run and the card: the
port's copy of ``repro/launch/steps.py``.

``build_cell(cfg, shape, mesh)`` returns one "cell" of the (arch × shape
× mesh) grid: this rank's step function, the step's whole abstract
arguments (meta tensors from ``configs.specs``) and their placements
(``sharding.rules.Placement`` tuples, one tree an argument).  The cell
runs in either of two ways:
  * on an abstract mesh (``launch.mesh.abstract_mesh``), on meta
    tensors: :meth:`Cell.trace` runs one rank's step on its pieces of the
    arguments and yields its roofline terms (the counterpart of the
    reference's ``lower().compile()``);
  * on a real mesh (or one rank), on real tensors: :meth:`Cell.local`
    cuts whole arguments into this rank's pieces and ``cell.fn`` runs the
    step.

Placement policy (the reference's baseline):
  * params: the path rules' TP over "model"; big models (training state,
    or serving weights, past ``budget_gb`` a rank) additionally ZeRO-3
    over "data" (:func:`auto_fsdp`), sized as the reference's stacked
    tree (``make_param_specs(stacked_groups=)``);
  * batch: (B, S) over ("pod", "data") where they divide B;
  * KV caches: batch over the data axes where they divide it; the
    sequence over the remaining axes until a rank's slab is under 4 GB
    (12 GB at prefill), or over "model" for the context-parallel decode
    (``decode_attn_impl="cp"``, an unquantized cache); page pools split
    their kv heads over "model"; recurrent states their first big
    feature dim over "model".
The placements are the reference's (tests hold them leaf by leaf at 16 ×
16 and 2 × 16 × 16); what a rank computes on them is the port's: it
refuses, with the ROADMAP item, what ``sharding.tp`` does not shard
(``check_trainable`` / ``check_servable``).  Head counts the model axis
does not divide are computed whole on every rank in the prefill and
train cells and in cross-attention (the whole-heads arm), and by the
context-parallel step in the decode cell.  FSDP-split parameters are
gathered whole over "data" in every cell: a layer group at a time as
the stack reaches it in the serving cells, the whole tree once a step in
the train cell.  The port's stack is a list of groups, so a cache or
parameter leaf has no stacked group dim.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.specs import input_specs
from repro_torch.launch.roofline import RooflineTerms, roofline_from_trace
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWState, init_adamw
from repro_torch.sharding.rules import (batch_spec, dp_axes, local_leaf,
                                        make_param_specs)
from repro_torch.tree import leaves_with_path


@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable                       # this rank's step
    args: tuple                        # whole abstract args (meta)
    in_shardings: tuple                # placements, one tree an argument
    out_shardings: Any
    mesh: Any = None
    lm: Optional[LM] = None            # this rank's LM

    def local(self, args: Optional[tuple] = None) -> tuple:
        """This rank's pieces of ``args`` (whole arguments shaped as
        :attr:`args`; default the abstract ones, giving meta pieces)."""
        args = self.args if args is None else args
        return tuple(_local_tree(a, s, self.mesh)
                     for a, s in zip(args, self.in_shardings))

    def trace(self, model_flops: float = 1.0) -> RooflineTerms:
        """One rank's step on its meta pieces under the cell's abstract
        mesh -> roofline terms (FLOPs, bytes, collectives, memory)."""
        if not getattr(self.mesh, "abstract", False):
            raise ValueError("Cell.trace runs on an abstract mesh "
                             "(launch.mesh.abstract_mesh)")
        return roofline_from_trace(self.fn, self.local(), mesh=self.mesh,
                                   n_chips=self.mesh.world,
                                   model_flops=model_flops)


def _local_tree(tree, spec, mesh):
    """``tree`` cut to this rank's pieces by its placements (dicts,
    lists, tuples and NamedTuples alike; non-tensor leaves kept)."""
    if isinstance(tree, dict):
        return {k: _local_tree(v, spec[k], mesh) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(tree.step, _local_tree(tree.mu, spec.mu, mesh),
                          _local_tree(tree.nu, spec.nu, mesh))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local_tree(v, s, mesh) for v, s in
                          zip(tree, spec))
    if not isinstance(tree, torch.Tensor):
        return tree
    return local_leaf(tree, spec, mesh)


# ---------------------------------------------------------------------------
# Placements


def _map(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _dp(mesh):
    axes = dp_axes(mesh)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _dp_total(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def batch_shardings(batch_abs: dict, mesh) -> dict:
    """(B, ...) leaves over the data-parallel axes where they divide B."""
    return _map(lambda _, l: batch_spec(mesh, l.shape[0],
                                        trailing=l.ndim - 1), batch_abs)


def cache_shardings(cache_abs: Any, mesh, cfg: ModelConfig,
                    shape: ShapeConfig, *,
                    seq_threshold: Optional[float] = None) -> Any:
    """Placements of a cache tree (the reference's rules; see the module
    docstring).  Prefill writes the whole cache and a seq-split
    destination reshards every layer's k / v, so prefill splits the
    sequence only past 12 GB a rank; decode reads are cheap to
    distribute, so it spreads at 4 GB."""
    from repro_torch.kvcache import normalize_dtype
    if seq_threshold is None:
        seq_threshold = (12 if shape.mode == "prefill" else 4) * 2**30
    dpt, dp = _dp_total(mesh), _dp(mesh)
    model = mesh.shape.get("model", 1)
    total_bytes = sum(l.numel() * l.element_size()
                      for _, l in leaves_with_path(cache_abs)
                      if isinstance(l, torch.Tensor))

    def leaf(ks, l):
        if not isinstance(l, torch.Tensor):
            return l
        dims = [None] * l.ndim
        if "k_scales" in ks or "v_scales" in ks:
            # paged (N, KH) scales follow the pools' kv-head split
            if model > 1 and l.shape[-1] % model == 0:
                dims[-1] = "model"
            return tuple(dims)
        if "pages" in ks:
            # page pools: no batch dim; TP splits the kv heads
            h_dim = l.ndim - 2
            if model > 1 and l.shape[h_dim] % model == 0:
                dims[h_dim] = "model"
            return tuple(dims)
        if "block_table" in ks:
            return tuple(dims)                # tiny; replicated
        b_dim = 0                             # no stacked group dim
        batch_sharded = False
        if dp is not None and l.shape[b_dim] % dpt == 0:
            dims[b_dim] = dp
            batch_sharded = True
        if "state" in ks or "x_prev" in ks:
            # recurrent state: the first big feature dim over "model"
            for i in range(b_dim + 1, l.ndim):
                if l.shape[i] % model == 0 and l.shape[i] >= 2 * model:
                    dims[i] = "model"
                    break
            return tuple(dims)
        s_dim = b_dim + 1
        if (cfg.decode_attn_impl == "cp" and shape.mode == "decode"
                and normalize_dtype(cfg.kv_cache_dtype) == "bfloat16"
                and "/kv/" in ks and l.ndim > s_dim
                and l.shape[s_dim] % model == 0):
            # context-parallel decode: the cache's sequence over "model"
            dims[s_dim] = "model"
            return tuple(dims)
        if l.ndim > s_dim and l.shape[s_dim] == shape.seq_len:
            used = set(dp_axes(mesh)) if batch_sharded else set()
            free = [a for a in ("data", "model") if a not in used]
            per_chip = total_bytes / (dpt if batch_sharded else 1)
            seq_axes = []
            for a in free:
                if per_chip <= seq_threshold and (batch_sharded or seq_axes):
                    break
                if l.shape[s_dim] % mesh.shape[a] == 0:
                    seq_axes.append(a)
                    per_chip /= mesh.shape[a]
            if seq_axes:
                dims[s_dim] = tuple(seq_axes) if len(seq_axes) > 1 \
                    else seq_axes[0]
        return tuple(dims)

    return _map(leaf, cache_abs)


def param_shardings(params_abs: Any, mesh, *, fsdp: bool,
                    stacked_groups: int = 1) -> Any:
    """The path rules' placements (``make_param_specs``), FSDP sized
    over ``stacked_groups`` as the reference's scanned stack."""
    return make_param_specs(params_abs, mesh, fsdp=fsdp,
                            stacked_groups=stacked_groups)


def auto_fsdp(cfg: ModelConfig, mesh, mode: str = "train", *,
              budget_gb: float = 12.0) -> bool:
    """ZeRO-3 the params over "data" only when TP alone cannot hold the
    training state (params + grads + AdamW ≈ 4× bf16 weights) / the
    serving weights within ``budget_gb`` a rank.  Inference prefers pure
    TP: FSDP gathers weights every step, which decode latency cannot
    hide."""
    model = mesh.shape.get("model", 1)
    w = cfg.param_count() * 2 / model                 # bf16 weights/rank
    need = 4 * w if mode == "train" else w
    return need > budget_gb * 2**30


def _rank_cache_placement(c_sh: Any, cache_abs: Any, mesh, rank_cfg, *,
                          cp: bool) -> Any:
    """The cache placement a rank of the port computes on: the
    reference's, except that under a model axis > 1 that divides the
    heads (``rank_cfg`` does not take the whole-heads arm) a contiguous
    attention cache outside the context-parallel decode, and a
    cross-attention block's source K / V, split their kv heads over
    "model" (the port's rank writes and reads only its own kv heads, the
    layout its engines hold; the reference keeps every kv head on each
    chip and lets GSPMD gather).  An RWKV-6 block's ``wkv`` state splits
    its heads over "model" wherever the axis divides them (the rank's WKV
    heads; the reference's rule, the first feature dim of at least 2m,
    splits the same dim wherever H >= 2m), and its ``x_prev`` (B, d) is
    whole on every rank (each rank's token shift reads all of it; the
    reference's rule splits d)."""
    from repro_torch.sharding.tp import whole_heads
    model = mesh.shape.get("model", 1)
    if model == 1:
        return c_sh
    kv_heads = not whole_heads(rank_cfg)

    def over_model(spec, dim):
        """``spec`` with "model" on ``dim`` alone (on none: ``None``)."""
        dims = [tuple(a for a in _axes(e) if a != "model") or None
                if e is not None else None for e in spec]
        dims = [d[0] if isinstance(d, tuple) and len(d) == 1 else d
                for d in dims]
        if dim is not None:
            dims[dim] = "model"
        return tuple(dims)

    def leaf(path, spec):
        if not isinstance(spec, tuple):
            return spec
        if path.endswith("/state/x_prev"):
            return over_model(spec, None)
        if path.endswith("/state/wkv"):
            l = _at(cache_abs, path)
            return spec if l.shape[1] % model else over_model(spec, 1)
        source = path.endswith(("/xk", "/xv"))
        if not kv_heads or not (source or ("/kv/" in path and not cp)) \
                or "pages" in path or path.endswith("block_table"):
            return spec
        l = _at(cache_abs, path)
        if l.ndim < 3 or l.shape[2] % model:
            return spec
        return over_model(spec, 2)

    return _map(leaf, c_sh)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _dp_offset(mesh, batch: int) -> int:
    """The first of this rank's rows of a ``batch`` split over the
    data-parallel axes (0 when they do not split it)."""
    from repro_torch.sharding.rules import _split_index
    dp = _dp(mesh)
    if dp is None or batch % _dp_total(mesh):
        return 0
    idx, total = _split_index(dp, mesh.shape, mesh.coords)
    return idx * (batch // total)


def _fsdp_view(params: dict, specs: dict, mesh, *,
               skip: tuple = ()) -> dict:
    """A serving step's parameters whole over the data axis
    (``train.loop.fsdp_leaf`` on every leaf FSDP splits): the layer
    groups one at a time, as the stack reaches them (a generator, so a
    rank holds one gathered group at a time), every other top-level
    entry once a step; the entries in ``skip`` (what the step does not
    read) are left out."""
    from repro_torch.train.loop import fsdp_leaf
    from repro_torch.tree import tree_map

    def whole(tree, spec):
        return tree_map(lambda t, s: fsdp_leaf(t, s, mesh), tree, spec)
    out = {k: whole(v, specs[k]) for k, v in params.items()
           if k != "layers" and k not in skip}
    out["layers"] = (whole(g, s) for g, s in zip(params["layers"],
                                                   specs["layers"]))
    return out


def _own_slots(cache: Any, lo: int, n: int) -> Any:
    """A paged cache whose block table is whole (replicated, as the
    reference places it) seen from this rank's ``n`` slots from ``lo``
    on: the table's rows of those slots (the pools are shared by every
    slot, so the rank's writes land in them)."""
    def node(c):
        if isinstance(c, dict) and "block_table" in c:
            bt = c["block_table"]
            return c if bt.shape[0] == n else \
                {**c, "block_table": bt[lo:lo + n]}
        if isinstance(c, dict):
            return {k: node(v) for k, v in c.items()}
        if isinstance(c, list):
            return [node(v) for v in c]
        return c
    return node(cache)


# ---------------------------------------------------------------------------
# Cells


def abstract_params(cfg: ModelConfig) -> dict:
    """The whole parameter tree on meta (``LM.init``; a quantized tree for
    ``cfg.quant`` != bf16)."""
    params = LM(cfg, device="meta").init(torch.Generator())
    if cfg.quant != "bf16":
        from repro_torch.quant.qops import quantize_tree
        params = quantize_tree(params, quant=cfg.quant)
    return params


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               fsdp: Optional[bool] = None, lr: float = 3e-4,
               microbatches: int = 1) -> Cell:
    """The cell of ``cfg`` (the whole model: ``model_parallel`` 1) at
    ``shape`` on ``mesh`` (an abstract mesh, a host mesh, or one rank's
    ``make_host_mesh()``).  This rank's LM runs ``cfg`` under the mesh's
    model axis on ``mesh.device``; the step functions:
      * train: ``LM.loss`` under autograd on this rank's rows, gradients
        accumulated over ``microbatches`` (consecutive runs of the rows),
        ``clip_by_global_norm(1.0)``, AdamW at ``lr``
        (``train.loop.make_train_step``); returns (params, AdamW state,
        metrics with ``grad_norm``), both updated in place;
      * prefill: ``LM.prefill`` (with ``modality_input`` where the config
        has one) -> (logits, cache);
      * decode: ``LM.decode_step`` over a contiguous, paged
        (``decode_attn_impl="paged_pallas"``) or context-parallel
        (``"cp"``) cache -> (logits, cache)."""
    from repro_torch.sharding.tp import (check_servable, check_trainable,
                                         cp_decode)
    from repro_torch.train.loop import make_train_step
    if fsdp is None:
        fsdp = auto_fsdp(cfg, mesh, shape.mode)
    params_abs = abstract_params(cfg if shape.mode != "train"
                                 else cfg.with_(quant="bf16"))
    p_sh = param_shardings(params_abs, mesh, fsdp=fsdp,
                           stacked_groups=cfg.num_groups
                           if cfg.scan_layers else 1)
    rank_cfg = cfg.with_(model_parallel=mesh.shape.get("model", 1))
    lm = LM(rank_cfg, device=mesh.device, mesh=mesh)
    specs = input_specs(cfg, shape)
    name = f"{cfg.name}:{shape.name}"

    if shape.mode == "train":
        if rank_cfg.model_parallel > 1:
            check_trainable(rank_cfg, params_abs)
        opt_abs = init_adamw(params_abs)
        o_sh = AdamWState(step=0, mu=p_sh, nu=p_sh)
        batch_abs = specs["batch"]
        b_sh = batch_shardings(batch_abs, mesh)
        step = make_train_step(lm, lr=lr, num_microbatches=microbatches,
                               mesh=mesh if mesh.world > 1 else None,
                               specs=p_sh, local_batch=True)

        def train_step(params, opt_state, batch):
            params, opt_state, _, metrics = step(params, opt_state, batch,
                                                 None)
            return params, opt_state, metrics

        return Cell(name, train_step, (params_abs, opt_abs, batch_abs),
                    (p_sh, o_sh, b_sh), (p_sh, o_sh, None), mesh, lm)

    if rank_cfg.model_parallel > 1:
        check_servable(rank_cfg, params_abs, cell=shape.mode)
    logits_sh = (_dp(mesh) if shape.global_batch % _dp_total(mesh) == 0
                 else None, None)
    cache_abs = specs["cache"]
    c_sh = _rank_cache_placement(
        cache_shardings(cache_abs, mesh, cfg, shape), cache_abs, mesh,
        rank_cfg, cp=shape.mode == "decode" and cp_decode(cfg))

    def view(params, skip=()):
        return _fsdp_view(params, p_sh, mesh, skip=skip) if fsdp \
            else params
    if shape.mode == "prefill":
        tok_sh = batch_shardings({"t": specs["tokens"]}, mesh)["t"]
        args, in_sh = [specs["tokens"], cache_abs], [tok_sh, c_sh]
        if "modality_input" in specs:
            args.append(specs["modality_input"])
            in_sh.append(batch_shardings({"m": specs["modality_input"]},
                                         mesh)["m"])

            def prefill_step(params, tokens, cache, modality_input):
                return lm.prefill(view(params), tokens, cache,
                                  modality_input=modality_input)
        else:
            def prefill_step(params, tokens, cache):
                return lm.prefill(view(params), tokens, cache)

        return Cell(name, prefill_step, (params_abs, *args),
                    (p_sh, *in_sh), (logits_sh, c_sh), mesh, lm)

    vec_sh = (_dp(mesh) if shape.global_batch % _dp_total(mesh) == 0
              else None,)

    lo = _dp_offset(mesh, shape.global_batch)

    def serve_step(params, token, cache, pos):
        return lm.decode_step(view(params, ("encoder",)), token,
                              _own_slots(cache, lo, token.shape[0]), pos)

    return Cell(name, serve_step,
                (params_abs, specs["token"], cache_abs, specs["pos"]),
                (p_sh, vec_sh, c_sh, vec_sh), (logits_sh, c_sh), mesh, lm)

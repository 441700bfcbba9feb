"""Path-based parameter placement rules (T5X / MaxText style).

The port's copy of ``repro/sharding/rules.py``.  ``make_param_specs``
walks a parameter tree and gives each leaf a *placement*: a tuple with one
entry per dim, each ``None`` (whole), ``"model"``, ``"data"`` or a tuple
of those axes (split over their product).  It is the tuple that
``tuple(PartitionSpec)`` gives on the reference's side, found by the same
ordered regex rules on the leaf's path.  Rules are written for the
unstacked parameter; a leaf with extra leading dims (the reference's
group-stacked layer stack) is left-padded with ``None``, so the port's
list layout (``layers/0/blk0/attn/wq/w``) and the reference's stacked one
(``layers/blk0/attn/wq/w``) place their linears alike.

Tensor-parallel choices: projections split their flattened head dim,
MoE expert stacks their expert dim when the axis divides it (else the
per-expert hidden dim), embeddings their vocab dim; norms and biases of
row-split linears stay whole.  ``fsdp=True`` adds the ``"data"`` axis to
large leaves as the reference's ZeRO-3 rule does (``train.loop``'s
``Trainer(mesh=, param_specs=)`` trains with it).  The port honours
``fsdp_min_size``, which the reference accepts and never passes on
(ROADMAP C, reference fault 11); at its default both place alike.

JAX places a tree with these specs; the port slices it instead:
:func:`shard_params` gives one rank its local tree, :func:`unshard` joins
the ranks' trees again.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Sequence, Tuple

import torch

Placement = Tuple[Any, ...]


def _p(*axes):
    def build(shape, ctx):  # noqa: ARG001
        return tuple(axes)
    return build


def _expert_spec(shape: tuple, ctx: dict) -> Placement:
    """(E, d_in, d_out) expert stacks: EP over the model axis when it
    divides E, else the per-expert output dim."""
    if shape[0] % ctx["model_size"] == 0:
        return ("model", None, None)
    return (None, None, "model")


RULES = [
    # --- embeddings / head ---
    (r"(^|/)embed/w$", _p("model", None)),
    (r"(^|/)(lm_head|unembed)/w$", _p(None, "model")),
    # --- attention projections (flattened head dim split) ---
    (r"/attn[^/]*/(wq|wk|wv)/w$", _p(None, "model")),
    (r"/attn[^/]*/(wq|wk|wv)/b$", _p("model")),
    (r"/attn[^/]*/wo/w$", _p("model", None)),
    # MLA projections
    (r"/attn[^/]*/(kv_down|q_down|k_rope)/w$", _p(None, None)),
    (r"/attn[^/]*/(kv_up_k|kv_up_v|q_up)/w$", _p(None, "model")),
    # --- cross attention (VLM / enc-dec) ---
    (r"/xattn/(wq|wk|wv)/w$", _p(None, "model")),
    (r"/xattn/wo/w$", _p("model", None)),
    # --- dense MLP ---
    (r"/mlp/(gate|up)/w$", _p(None, "model")),
    (r"/mlp/down/w$", _p("model", None)),
    # --- MoE ---
    (r"/moe/router/w$", _p(None, None)),
    (r"/moe/(gate|up)_e$", _expert_spec),
    (r"/moe/down_e$",
     lambda shape, ctx: (("model", None, None)
                         if shape[0] % ctx["model_size"] == 0
                         else (None, "model", None))),
    (r"/moe/shared/(gate|up)/w$", _p(None, "model")),
    (r"/moe/shared/down/w$", _p("model", None)),
    # --- RWKV6 ---
    (r"/rwkv/(wr|wk|wv|wg)/w$", _p(None, "model")),
    (r"/rwkv/wout/w$", _p("model", None)),
    (r"/rwkv/wdecay/(w1|w2)$", _p(None, None)),
    (r"/rwkv/tmix/.*$", _p(None)),
    # --- Mamba ---
    (r"/mamba/in_proj/w$", _p(None, "model")),
    (r"/mamba/out_proj/w$", _p("model", None)),
    (r"/mamba/(conv_w|conv_b|A_log|D|dt_bias)$",
     lambda shape, ctx: (("model",) + (None,) * (len(shape) - 1))
     if shape[0] % ctx["model_size"] == 0 else (None,) * len(shape)),
    (r"/mamba/x_proj/w$", _p("model", None)),
    (r"/mamba/dt_proj/w$", _p(None, "model")),
    # --- LoRA adapters (follow the wrapped matmul's column split) ---
    (r"/lora/a$", _p(None, None)),
    (r"/lora/b$", _p(None, "model")),
    (r"/lora/m$", _p("model")),
    # --- quantized weights inherit the dense layout; a per-channel scale
    # or bias follows its weight's split OUTPUT axis (the fused epilogue
    # applies it to the local columns) ---
    (r"/(gate|up|wq|wk|wv|q_up|kv_up_k|kv_up_v)/qw$", _p(None, "model")),
    (r"/(down|wo)/qw$", _p("model", None)),
    (r"/(gate|up|wq|wk|wv|q_up|kv_up_k|kv_up_v)/scale$", _p("model")),
    (r"/(down|wo)/scale$", _p(None)),
    (r"(^|/)(lm_head|unembed)/qw$", _p(None, "model")),
    (r"(^|/)(lm_head|unembed)/scale$", _p("model")),
    (r"/mlp/(gate|up)/b$", _p("model")),
    (r"/moe/shared/(gate|up)/b$", _p("model")),
    # (down / wo biases add AFTER the row-split contraction's reduce:
    # whole, through the catch-all below)
    # --- norms, biases, scalars: whole ---
    (r".*", lambda shape, ctx: (None,) * len(shape)),
]


def spec_for_path(path: str, shape: tuple, ctx: dict) -> Placement:
    """The placement of the first rule matching ``path``, left-padded
    with ``None`` for leading (stacked) dims."""
    for pat, build in RULES:
        if re.search(pat, path):
            spec = tuple(build(shape, ctx))
            pad = len(shape) - len(spec)
            if pad > 0:
                spec = (None,) * pad + spec
            return spec
    raise AssertionError(f"no rule matched {path}")


def _ctx(mesh) -> dict:
    return {"model_size": mesh.shape.get("model", 1),
            "data_size": mesh.shape.get("data", 1)}


def _map_with_path(fn, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over every leaf carrying a ``shape`` (tensors,
    or shape structs standing in for them); other leaves stay as they
    are.  Paths join dict keys and list indices with "/"."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    if not hasattr(tree, "shape"):
        return tree
    return fn(prefix, tree)


def make_param_specs(params: Any, mesh, *, fsdp: bool = False,
                     fsdp_min_size: int = 1 << 20,
                     stacked_groups: int = 1) -> Any:
    """A placement for every leaf of ``params`` (tensors, on any device
    including ``meta``, or anything with a ``shape``), in a tree of the
    same structure.  ``mesh`` needs only a ``shape`` dict.

    ``fsdp=True`` additionally splits every leaf of at least
    ``fsdp_min_size`` elements over the "data" axis (ZeRO-3 style): the
    largest dim the tensor-parallel rule left whole and the data axis
    divides.  ``stacked_groups`` (the dry-run's placements) decides that
    for a leaf of the layer stack (``layers/...``) as the reference's
    scanned tree has it, stacked over that many groups: its size counts
    every group (the port's list holds one group a leaf)."""
    ctx = _ctx(mesh)

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        spec = spec_for_path(path, shape, ctx)
        if fsdp and stacked_groups > 1 and path.startswith("layers/"):
            full = _with_fsdp((None,) + spec, (stacked_groups,) + shape,
                              ctx, fsdp_min_size)
            if full[0] is not None:
                raise ValueError(f"{path}: FSDP would split the stacked "
                                 "group dim, which the port's list of "
                                 "groups does not have")
            spec = full[1:]
        elif fsdp:
            spec = _with_fsdp(spec, shape, ctx, fsdp_min_size)
        return _sanitize(spec, shape, ctx)

    return _map_with_path(leaf_spec, params)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _sanitize(spec: Placement, shape: tuple, ctx: dict) -> Placement:
    """Drop axis assignments the dim does not divide (granite's vocab
    49,155 or whisper's 51,865 on a 16-way axis stay whole instead)."""
    sizes = {"model": ctx["model_size"], "data": ctx["data_size"],
             "pod": ctx.get("pod_size", 1)}
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        total = 1
        for n in _axes(entry):
            total *= sizes.get(n, 1)
        out.append(entry if shape[dim] % total == 0 else None)
    return tuple(out)


def _with_fsdp(spec: Placement, shape: tuple, ctx: dict,
               min_size: int = 1 << 20) -> Placement:
    n = 1
    for s in shape:
        n *= s
    if n < min_size or ctx["data_size"] == 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    # the largest unsharded dim (embed / hidden); a stacked leaf's
    # leading group dim is rarely the largest, so it stays whole
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if entries[i] is None and shape[i] % ctx["data_size"] == 0 \
                and shape[i] >= ctx["data_size"]:
            entries[i] = "data"
            return tuple(entries)
    return spec


# ---------------------------------------------------------------------------
# Activation / batch placements


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_spec(mesh, batch: int, *, trailing: int = 1) -> Placement:
    """Placement of a (batch, ...) input: batch over the data-parallel
    axes when they divide it."""
    axes = dp_axes(mesh)
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    if axes and batch % total == 0:
        # one axis is named bare, as PartitionSpec normalizes it
        return (axes[0] if len(axes) == 1 else axes,) + (None,) * trailing
    return (None,) * (trailing + 1)


# ---------------------------------------------------------------------------
# One rank's slice of a tree


def _split_index(entry, shape: Dict[str, int], coords: Dict[str, int]
                 ) -> Tuple[int, int]:
    """(index, count) of a rank's piece of a dim split over ``entry``'s
    axes: the axes are major to minor, as a ``PartitionSpec`` tuple."""
    idx, total = 0, 1
    for n in _axes(entry):
        idx = idx * shape.get(n, 1) + coords.get(n, 0)
        total *= shape.get(n, 1)
    return idx, total


def _local(t: torch.Tensor, spec: Placement, shape: dict,
           coords: dict) -> torch.Tensor:
    out = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, total = _split_index(entry, shape, coords)
        n = t.shape[dim] // total
        out = out.narrow(dim, idx * n, n)
    # a copy, so the whole tensor can be freed once every leaf is sliced
    return out.clone() if out is not t else t


def shard_params(params: Any, specs: Any, mesh) -> Any:
    """This rank's local tree: every leaf sliced on the dims its
    placement names (``mesh.coords`` gives the rank's index on each
    axis); dims :func:`_sanitize` left whole stay whole, and a leaf that
    is whole everywhere is the same tensor."""
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_params(v, s, mesh) for v, s in zip(params, specs)]
    if not isinstance(params, torch.Tensor):
        return params
    return _local(params, specs, mesh.shape, mesh.coords)


def split_axes(spec: Placement) -> tuple:
    """The axes a placement splits its leaf over."""
    return tuple(a for e in spec if e is not None for a in _axes(e))


def counted_once(spec: Placement, mesh) -> bool:
    """Whether this rank's piece of a leaf placed by ``spec`` enters a sum
    over the whole tree (a global norm): on each axis the leaf is either
    split, or whole and counted on that axis's rank 0 only."""
    split = split_axes(spec)
    return all(a in split or mesh.coords.get(a, 0) == 0
               for a in ("data", "model") if mesh.shape.get(a, 1) > 1)


def gather_leaf(piece: torch.Tensor, spec: Placement,
                mesh) -> torch.Tensor:
    """The whole leaf from this rank's piece (no gradient): gathered
    along each split dim over its axis (collectives on every rank of
    those axes)."""
    from repro_torch.sharding.collectives import all_gather
    for dim, entry in enumerate(spec):
        if entry is not None:
            if isinstance(entry, tuple):
                raise ValueError(f"placement {spec}: one axis a dim")
            piece = all_gather(piece, dim, mesh, entry)
    return piece


def local_leaf(whole: torch.Tensor, spec: Placement,
               mesh) -> torch.Tensor:
    """This rank's piece of a whole leaf (:func:`shard_params` on one
    leaf)."""
    return _local(whole, spec, mesh.shape, mesh.coords)


#: the axes of a mesh from major to minor: the model axis is minor, so a
#: model group is a run of consecutive ranks
AXIS_ORDER = ("stage", "pod", "data", "model")


def rank_coords(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """A global rank's index on each axis of ``shape`` (always ``"data"``
    and ``"model"``; ``"stage"`` and ``"pod"`` where the mesh has them),
    the axes laid out as :data:`AXIS_ORDER`."""
    coords = {}
    for axis in reversed(AXIS_ORDER):
        if axis in shape or axis in ("data", "model"):
            n = shape.get(axis, 1)
            coords[axis] = rank % n
            rank //= n
    return {a: coords[a] for a in AXIS_ORDER if a in coords}


def global_rank(coords: Dict[str, int], shape: Dict[str, int]) -> int:
    """The inverse of :func:`rank_coords`."""
    rank = 0
    for axis in AXIS_ORDER:
        rank = rank * shape.get(axis, 1) + coords.get(axis, 0)
    return rank


def unshard(shards: Sequence[Any], specs: Any,
            shape: Dict[str, int]) -> Any:
    """The whole tree from every rank's local tree (``shards`` in global
    rank order): the inverse of :func:`shard_params`."""
    first = shards[0]
    if isinstance(first, dict):
        return {k: unshard([s[k] for s in shards], specs[k], shape)
                for k in first}
    if isinstance(first, list):
        return [unshard([s[i] for s in shards], specs[i], shape)
                for i in range(len(first))]
    if not isinstance(first, torch.Tensor):
        return first
    full = list(first.shape)
    for dim, entry in enumerate(specs):
        if entry is not None:
            full[dim] *= _split_index(entry, shape, {})[1]
    out = torch.empty(full, dtype=first.dtype, device=first.device)
    for rank, piece in enumerate(shards):
        coords = rank_coords(rank, shape)
        view = out
        for dim, entry in enumerate(specs):
            if entry is None:
                continue
            idx, _ = _split_index(entry, shape, coords)
            n = piece.shape[dim]
            view = view.narrow(dim, idx * n, n)
        view.copy_(piece)
    return out

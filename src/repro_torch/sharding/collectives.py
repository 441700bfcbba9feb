"""The collectives of the sharded paths, over one axis of a mesh.

Every call names an axis: ``"model"`` (the tensor-parallel group, the
default), ``"data"`` (the ranks with the same model coordinate, over
which the batch and FSDP's leaves are split), ``"stage"`` (the ranks of
one pipeline position, ``sharding.pipeline``) or ``"world"`` (every
rank).  Three primitives, made on every device alike (the CPU tests take
the route the card takes):
  * :func:`all_reduce` (sum or max), on a copy;
  * :func:`all_gather` along a dim, built from one ``broadcast`` per rank
    of the axis on a byte view of the pieces: exact for any dtype, and
    within what gloo offers on CUDA tensors (``broadcast`` and
    ``all_reduce`` only);
  * :func:`ppermute`, the ring permute (rank i's tensor to rank i + 1 of
    the axis), built the same way: one ``broadcast`` per rank, each rank
    keeping its predecessor's piece.
Each call adds its operand bytes (an all-gather's: this rank's piece;
a reduce-scatter's: the whole operand; a permute's: the tensor it
sends) to the mesh's
:class:`~repro_torch.launch.roofline.CollectiveStats` under
``"<kind>/<axis>"`` (``all-reduce/model``, ``all-gather/data``,
``collective-permute/stage``, ...), the port's source of collective
bytes: a permute counts once, under its own kind, whatever broadcasts
carry it.  On an abstract mesh (``launch.mesh.abstract_mesh``) a call
moves nothing: it counts the same kind and bytes and returns a meta
tensor of the result's shape, and it raises for a tensor that is not on
``meta``.  Both run as one registered
operator (``repro_torch::collective``), so that a selective-checkpoint
policy can keep its outputs (``models.transformer._save_products``):
a recompute then makes no collective and counts none.

:func:`broadcast_clock` is the engines' one host collective: the model
group's first rank's reading of its host clock, sent as a CPU float64
over the group's gloo group (``serve.engine.shared_clock``), so that
every rank takes a decision that reads the clock alike.

Under autograd the sharded training forward goes through three pairs
(Megatron's f / g, and a gather over an axis):
  * :func:`copy_to_model`: identity forward, all-reduce SUM of the
    gradient over the model axis; on a whole activation entering
    column-split work, and (as :func:`replicated`, one all-reduce for
    several) on the whole leaves that a rank reads only in part (LoRA's
    ``a`` and ``scaling``, a row-split quantized linear's scale);
  * :func:`reduce_from_model`: all-reduce SUM forward, identity backward;
    what the row-split linears and the vocab-split lookups reduce
    through;
  * :func:`gather_from`: all-gather over an axis forward, reduce-scatter
    backward (all-reduce SUM, then this rank's piece): FSDP's gather of
    a leaf over the data axis (``train.loop.fsdp_leaf``), and the whole-heads
    arm's gather of a column-split projection over the model axis
    (``models.attention``), whose gradient is a partial on every rank
    (each rank's ``wo`` reads only its rows of the whole output).
Every reduction runs in fp32 and rounds once to the operand's dtype.
Outside autograd (``no_grad`` serving) :func:`all_reduce` and
:func:`all_gather` compute what they always did.

:func:`tensor_parallel` is the scope a sharded ``LM`` forward runs in
(the reference's ``current_mesh()`` / ``f32_accum`` contexts): the layers
read :func:`active` to find the mesh and the attention arm.
"""
from __future__ import annotations

import weakref
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

TP_ATTN_IMPLS = ("kv_shard", "gather")
AXES = ("model", "data", "stage", "pod", "world")


@dataclass(frozen=True)
class TensorParallel:
    mesh: object               # repro_torch.launch.mesh.Mesh
    attn_impl: str = "kv_shard"
    # the last activation handed to copy_to_model and its copy, so that
    # the column-split linears reading one input (wq / wk / wv, gate /
    # up) share one gradient all-reduce
    last_copy: list = field(default_factory=lambda: [None, None],
                            compare=False)


_ACTIVE: ContextVar[Optional[TensorParallel]] = ContextVar(
    "repro_torch_tensor_parallel", default=None)


class tensor_parallel:
    """Context manager: run the block under ``mesh``'s model axis with
    attention arm ``attn_impl`` (``mesh=None``: unsharded, whatever scope
    encloses it)."""

    def __init__(self, mesh, attn_impl: str = "kv_shard"):
        if attn_impl not in TP_ATTN_IMPLS:
            raise ValueError(f"tp_attn_impl {attn_impl!r}: one of "
                             f"{TP_ATTN_IMPLS}")
        self.value = None if mesh is None else TensorParallel(mesh,
                                                              attn_impl)

    def __enter__(self):
        self._tok = _ACTIVE.set(self.value)
        return self.value

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tok)
        return False


def active() -> Optional[TensorParallel]:
    return _ACTIVE.get()


def scoped(fn, scope: Optional[TensorParallel]):
    """``fn`` run under ``scope`` wherever it is called: a checkpointed
    group's recompute runs in backward, outside the forward's scope (and
    on another thread on the card)."""
    if scope is None:
        return fn

    def run(*args, **kwargs):
        with tensor_parallel(scope.mesh, scope.attn_impl):
            return fn(*args, **kwargs)
    return run


# ---------------------------------------------------------------------------
# The primitives


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
#: meshes the registered operator reaches by key (its arguments are
#: tensors, numbers and strings)
_MESHES: "weakref.WeakValueDictionary[int, object]" = \
    weakref.WeakValueDictionary()


def _axis(mesh, axis: str):
    """(process group, its global ranks in axis order, this rank's index
    on the axis) of ``axis``; the world's group is the default one.  On
    an abstract mesh the group is ``None`` and the ranks are those a
    group would hold."""
    if axis not in AXES:
        raise ValueError(f"axis {axis!r}: one of {AXES}")
    if axis == "world":
        return None, tuple(range(mesh.world)), mesh.rank
    if getattr(mesh, "abstract", False):
        from repro_torch.sharding.rules import global_rank
        members = tuple(global_rank({**mesh.coords, axis: i}, mesh.shape)
                        for i in range(mesh.shape.get(axis, 1)))
        return None, members, mesh.coords.get(axis, 0)
    if axis == "model":
        return mesh.group, mesh.ranks, mesh.model_rank
    if axis == "data":
        return mesh.data_group, mesh.data_ranks, mesh.data_rank
    if axis == "stage":
        return mesh.stage_group, mesh.stage_ranks, mesh.stage_rank
    raise ValueError(f"axis {axis!r}: only an abstract mesh has it")


#: the operator's library: a plain registration (``custom_op`` would
#: import torch._dynamo, seconds in every rank, at the first call)
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("collective(Tensor x, int mesh_key, str kind, str axis, "
            "int dim) -> Tensor")


_LABELS = {"sum": "all-reduce", "max": "all-reduce", "gather": "all-gather",
           "scatter": "reduce-scatter", "permute": "collective-permute"}


def _abstract(x: torch.Tensor, mesh, kind: str, axis: str,
              dim: int) -> torch.Tensor:
    """An abstract mesh's call: the kind and bytes counted, the result's
    shape on meta."""
    n = mesh.shape.get(axis, 1) if axis != "world" else mesh.world
    mesh.stats.add(f"{_LABELS[kind]}/{axis}", x.numel() * x.element_size())
    shape = list(x.shape)
    if kind == "gather":
        shape[dim] *= n
    elif kind == "scatter":
        shape[dim] //= n
    return torch.empty(shape, dtype=x.dtype, device="meta")


def _collective(x: torch.Tensor, mesh_key: int, kind: str, axis: str,
                dim: int) -> torch.Tensor:
    """``kind`` "sum" / "max" (all-reduce), "gather" (all-gather along
    ``dim``), "scatter" (reduce-scatter: the sum's piece along ``dim``)
    or "permute" (the ring permute: the axis predecessor's ``x``) of
    ``x`` over ``axis``; a new tensor, in ``x``'s dtype."""
    mesh = _MESHES[mesh_key]
    group, ranks, index = _axis(mesh, axis)
    x = x.contiguous()
    if kind in ("gather", "permute"):
        keep = (index - 1) % len(ranks)
        pieces = []
        for i, src in enumerate(ranks):
            buf = x if i == index else torch.empty_like(x)
            dist.broadcast(buf.view(-1).view(torch.uint8), src=src,
                           group=group)
            pieces.append(buf)
        mesh.stats.add(f"{_LABELS[kind]}/{axis}",
                       x.numel() * x.element_size())
        if kind == "permute":
            return pieces[keep]
        return torch.cat(pieces, dim)
    y = x.clone()
    dist.all_reduce(y, op=_OPS["sum" if kind == "scatter" else kind],
                    group=group)
    mesh.stats.add(f"{_LABELS[kind]}/{axis}", y.numel() * y.element_size())
    if kind == "scatter":
        n = y.shape[dim] // len(ranks)
        y = y.narrow(dim, index * n, n).clone()
    return y


_LIB.impl("collective", _collective, "CompositeExplicitAutograd")


def _call(x, mesh, kind: str, axis: str, dim: int = 0) -> torch.Tensor:
    abstract = getattr(mesh, "abstract", False)
    if abstract and not x.is_meta:
        raise ValueError(f"{_LABELS[kind]} on an abstract mesh takes meta "
                         f"tensors, not {x.device} (its ranks are views; "
                         "nothing moves)")
    if len(_axis(mesh, axis)[1]) == 1:      # one rank: nothing to move
        return x if kind in ("gather", "scatter", "permute") else x.clone()
    if abstract:
        return _abstract(x, mesh, kind, axis, dim)
    _MESHES[id(mesh)] = mesh
    return torch.ops.repro_torch.collective(x, id(mesh), kind, axis, dim)


def all_reduce(x: torch.Tensor, op: str = "sum", mesh=None,
               axis: str = "model") -> torch.Tensor:
    """``x`` reduced over ``axis`` (a new tensor; no gradient)."""
    mesh = mesh if mesh is not None else active().mesh
    return _call(x, mesh, op, axis)


def all_gather(x: torch.Tensor, dim: int, mesh=None,
               axis: str = "model") -> torch.Tensor:
    """The axis's pieces of ``x`` (equal shapes) joined along ``dim`` in
    axis order (no gradient)."""
    mesh = mesh if mesh is not None else active().mesh
    return _call(x, mesh, "gather", axis, dim)


def ppermute(x: torch.Tensor, mesh, axis: str = "stage") -> torch.Tensor:
    """The ring permute over ``axis`` (the reference's ``ppermute`` with
    pairs ``(i, (i + 1) % n)``): this rank sends ``x`` to its successor
    on the axis and returns its predecessor's (no gradient)."""
    return _call(x, mesh, "permute", axis)


def local_piece(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's piece of ``x`` split evenly along ``dim``."""
    n = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_rank * n, n)


def barrier(mesh) -> None:
    """Every rank of the world waits for the others (an all-reduce of
    one element)."""
    all_reduce(torch.zeros(1, device=mesh.device), "sum", mesh, "world")


def broadcast_clock(t: float, mesh) -> float:
    """The first rank of ``mesh``'s model group's reading ``t`` of its
    host clock, on every rank of the group (the others' ``t`` is
    ignored): one float64 broadcast as a CPU tensor over the group's host
    group (``Mesh.host_group``, gloo), so it makes no device sync.
    Counted as ``broadcast/clock``, apart from the model's collectives."""
    if mesh.model == 1:
        return t
    buf = torch.tensor([t], dtype=torch.float64)
    dist.broadcast(buf, src=mesh.ranks[0], group=mesh.host_group)
    mesh.stats.add("broadcast/clock", buf.element_size())
    return float(buf[0])


def _reduce_f32(x: torch.Tensor, mesh, kind: str, axis: str,
                dim: int = 0) -> torch.Tensor:
    return _call(x.float(), mesh, kind, axis, dim).to(x.dtype)


# ---------------------------------------------------------------------------
# Autograd pairs


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _reduce_f32(x, mesh, "sum", "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, dim, mesh, axis):
        ctx.dim, ctx.mesh, ctx.axis = dim, mesh, axis
        return _call(piece, mesh, "gather", axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_f32(g, ctx.mesh, "scatter", ctx.axis, ctx.dim), \
            None, None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if len(gs) == 1:                # one tensor: kept in its shape
            return None, _reduce_f32(gs[0], ctx.mesh, "sum", "model")
        flat = _reduce_f32(torch.cat([g.float().reshape(-1) for g in gs]),
                           ctx.mesh, "sum", "model")
        out = [piece.view_as(g).to(g.dtype) for g, piece in zip(
            gs, torch.split(flat, [g.numel() for g in gs]))]
        return (None, *out)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the model axis (the
    column-split work each rank does on ``x`` gives a partial one)."""
    return _CopyToModel.apply(mesh, x)[0]


def replicated(*xs: torch.Tensor):
    """Whole leaves (the same on every rank) whose use on one rank gives
    only a partial gradient (a LoRA ``a`` against this rank's rows or
    columns, a row-split linear's scale), read under a tensor-parallel
    scope with grad enabled through one :func:`copy_to_model` for all of
    them: identity forward, their gradients summed over the model axis
    in one fp32 all-reduce.  Elsewhere (serving, one rank) ``xs``
    themselves.  Returns a tuple, one tensor per argument."""
    tp = active()
    if tp is None or not torch.is_grad_enabled() \
            or not any(x.requires_grad for x in xs):
        return xs
    return _CopyToModel.apply(tp.mesh, *xs)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the model axis in fp32, rounded once to its
    dtype; the gradient passes through unchanged."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from(piece: torch.Tensor, dim: int, mesh,
                axis: str = "model") -> torch.Tensor:
    """The axis's pieces of ``piece`` joined along ``dim`` (as
    :func:`all_gather`); its gradient, a partial on every rank, summed
    over the axis in fp32 and cut back to this rank's piece (one
    reduce-scatter, counted as ``reduce-scatter/<axis>``)."""
    return _Gather.apply(piece, dim, mesh, axis)


def column_input(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-split linear: under a tensor-parallel scope
    with grad enabled, ``x`` through :func:`copy_to_model`, once for
    consecutive linears that read the same ``x``; ``x`` itself
    elsewhere (serving, one rank)."""
    tp = active()
    if tp is None or not torch.is_grad_enabled() or not x.requires_grad:
        return x
    last = tp.last_copy
    if last[0] is not x:
        last[0], last[1] = x, copy_to_model(x, tp.mesh)
    return last[1]

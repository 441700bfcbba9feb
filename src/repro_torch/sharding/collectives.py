"""The collectives of the sharded paths, over one axis of a mesh.

Every call names an axis: ``"model"`` (the tensor-parallel group, the
default), ``"data"`` (the ranks with the same model coordinate, over
which the batch and FSDP's leaves are split) or ``"world"`` (every
rank).  Two primitives, made on every device alike (the CPU tests take
the route the card takes):
  * :func:`all_reduce` (sum or max), on a copy;
  * :func:`all_gather` along a dim, built from one ``broadcast`` per rank
    of the axis on a byte view of the pieces: exact for any dtype, and
    within what gloo offers on CUDA tensors (``broadcast`` and
    ``all_reduce`` only).
Each call adds its operand bytes (an all-gather's: this rank's piece;
a reduce-scatter's: the whole operand) to the mesh's
:class:`~repro_torch.launch.roofline.CollectiveStats` under
``"<kind>/<axis>"`` (``all-reduce/model``, ``all-gather/data``, ...),
the port's source of collective bytes.  Both run as one registered
operator (``repro_torch::collective``), so that a selective-checkpoint
policy can keep its outputs (``models.transformer._save_products``):
a recompute then makes no collective and counts none.

Under autograd the sharded training forward goes through three pairs
(Megatron's f / g, and FSDP's gather):
  * :func:`copy_to_model`: identity forward, all-reduce SUM of the
    gradient over the model axis; on a whole activation entering
    column-split work;
  * :func:`reduce_from_model`: all-reduce SUM forward, identity backward;
    what the row-split linears and the vocab-split lookups reduce
    through;
  * :func:`fsdp_gather`: all-gather over the data axis forward,
    reduce-scatter backward (all-reduce SUM, then this rank's piece).
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
AXES = ("model", "data", "world")


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
    on the axis) of ``axis``; the world's group is the default one."""
    if axis == "model":
        return mesh.group, mesh.ranks, mesh.model_rank
    if axis == "data":
        return mesh.data_group, mesh.data_ranks, mesh.data_rank
    if axis == "world":
        return None, tuple(range(mesh.world)), mesh.rank
    raise ValueError(f"axis {axis!r}: one of {AXES}")


#: the operator's library: a plain registration (``custom_op`` would
#: import torch._dynamo, seconds in every rank, at the first call)
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("collective(Tensor x, int mesh_key, str kind, str axis, "
            "int dim) -> Tensor")


def _collective(x: torch.Tensor, mesh_key: int, kind: str, axis: str,
                dim: int) -> torch.Tensor:
    """``kind`` "sum" / "max" (all-reduce), "gather" (all-gather along
    ``dim``) or "scatter" (reduce-scatter: the sum's piece along ``dim``)
    of ``x`` over ``axis``; a new tensor, in ``x``'s dtype."""
    mesh = _MESHES[mesh_key]
    group, ranks, index = _axis(mesh, axis)
    x = x.contiguous()
    if kind == "gather":
        pieces = []
        for i, src in enumerate(ranks):
            buf = x if i == index else torch.empty_like(x)
            dist.broadcast(buf.view(-1).view(torch.uint8), src=src,
                           group=group)
            pieces.append(buf)
        mesh.stats.add(f"all-gather/{axis}", x.numel() * x.element_size())
        return torch.cat(pieces, dim)
    y = x.clone()
    dist.all_reduce(y, op=_OPS["sum" if kind == "scatter" else kind],
                    group=group)
    label = "reduce-scatter" if kind == "scatter" else "all-reduce"
    mesh.stats.add(f"{label}/{axis}", y.numel() * y.element_size())
    if kind == "scatter":
        n = y.shape[dim] // len(ranks)
        y = y.narrow(dim, index * n, n).clone()
    return y


_LIB.impl("collective", _collective, "CompositeExplicitAutograd")


def _call(x, mesh, kind: str, axis: str, dim: int = 0) -> torch.Tensor:
    if len(_axis(mesh, axis)[1]) == 1:      # one rank: nothing to move
        return x if kind in ("gather", "scatter") else x.clone()
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


def local_piece(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's piece of ``x`` split evenly along ``dim``."""
    n = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_rank * n, n)


def barrier(mesh) -> None:
    """Every rank of the world waits for the others (an all-reduce of
    one element)."""
    all_reduce(torch.zeros(1, device=mesh.device), "sum", mesh, "world")


def _reduce_f32(x: torch.Tensor, mesh, kind: str, axis: str,
                dim: int = 0) -> torch.Tensor:
    return _call(x.float(), mesh, kind, axis, dim).to(x.dtype)


# ---------------------------------------------------------------------------
# Autograd pairs


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_f32(g, ctx.mesh, "sum", "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _reduce_f32(x, mesh, "sum", "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _call(piece, mesh, "gather", "data", dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_f32(g, ctx.mesh, "scatter", "data", ctx.dim), \
            None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the model axis (the
    column-split work each rank does on ``x`` gives a partial one)."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the model axis in fp32, rounded once to its
    dtype; the gradient passes through unchanged."""
    return _ReduceFromModel.apply(x, mesh)


def fsdp_gather(piece: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The whole leaf from this rank's piece along ``dim`` over the data
    axis; its gradient reduce-scattered back to the piece (summed over
    the axis in fp32)."""
    return _FsdpGather.apply(piece, dim, mesh)


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

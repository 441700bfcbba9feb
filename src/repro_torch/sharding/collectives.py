"""The collectives of tensor-parallel serving, over a mesh's model group.

Two calls, made on every device alike (the CPU tests take the route the
card takes):
  * :func:`all_reduce` (sum or max), in place on a copy;
  * :func:`all_gather` along a dim, built from one ``broadcast`` per rank
    of the group on a byte view of the pieces: exact for any dtype, and
    within what gloo offers on CUDA tensors (``broadcast`` and
    ``all_reduce`` only).
Each call adds its operand bytes (this rank's piece) and its kind to the
mesh's :class:`~repro_torch.launch.roofline.CollectiveStats`, the port's
source of collective bytes.

:func:`tensor_parallel` is the scope a sharded ``LM`` forward runs in
(the reference's ``current_mesh()`` / ``f32_accum`` contexts): the layers
read :func:`active` to find the mesh and the attention arm.
"""
from __future__ import annotations

from contextvars import ContextVar
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

TP_ATTN_IMPLS = ("kv_shard", "gather")


@dataclass(frozen=True)
class TensorParallel:
    mesh: object               # repro_torch.launch.mesh.Mesh
    attn_impl: str = "kv_shard"


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


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, op: str = "sum", mesh=None) -> torch.Tensor:
    """``x`` reduced over the model group (a new tensor)."""
    mesh = mesh if mesh is not None else active().mesh
    y = x.contiguous().clone()
    dist.all_reduce(y, op=_OPS[op], group=mesh.group)
    mesh.stats.add("all-reduce", y.numel() * y.element_size())
    return y


def all_gather(x: torch.Tensor, dim: int, mesh=None) -> torch.Tensor:
    """The group's pieces of ``x`` (equal shapes) joined along ``dim`` in
    model-axis order."""
    mesh = mesh if mesh is not None else active().mesh
    x = x.contiguous()
    pieces = []
    for i, src in enumerate(mesh.ranks):
        buf = x if i == mesh.model_rank else torch.empty_like(x)
        dist.broadcast(buf.view(-1).view(torch.uint8), src=src,
                       group=mesh.group)
        pieces.append(buf)
    mesh.stats.add("all-gather", x.numel() * x.element_size())
    return torch.cat(pieces, dim)


def local_piece(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's piece of ``x`` split evenly along ``dim``."""
    n = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_rank * n, n)

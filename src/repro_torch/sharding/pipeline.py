"""GPipe-style pipeline parallelism over a ``"stage"`` mesh axis: the
port's copy of ``repro/sharding/pipeline.py``.

With S stages and M microbatches the schedule runs S + M - 1 ticks; at
tick t, stage s works on microbatch t - s.  Stage 0 reads its microbatch
from the input, every other stage the activation its predecessor sent on
the tick before; a stage with no microbatch at a tick (t - s outside [0,
M)) passes its buffer on unchanged.  Activations move one stage forward
each tick by the ring permute (``collectives.ppermute``, counted as
``collective-permute/stage``); the last stage writes each output, and
one sum all-reduce over the stage axis gives every stage the outputs.

A rank is one stage (``launch.mesh.make_host_mesh(stage=S)``) and holds
only that stage's parameters: its piece of a stage-stacked tree under a
``("stage", ...)`` placement.  The reference runs
``stage_fn`` on every tick and selects with ``where``; a rank here calls
it only on the ticks where its stage has a microbatch (the host knows
them), which selects the same values.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.sharding.collectives import all_reduce, ppermute
from repro_torch.tree import tree_map


def stage_piece(params_stacked: Any) -> Any:
    """This rank's stage of a stage-stacked tree as the ``("stage", ...)``
    placement gives it (every leaf's leading dim 1): the leaves without
    that dim."""
    def piece(leaf):
        if leaf.shape[0] != 1:
            raise ValueError(f"a stage's piece has a leading dim of 1, not "
                             f"{leaf.shape[0]} (shard the stacked tree by "
                             "its ('stage', ...) placement first)")
        return leaf[0]
    return tree_map(piece, params_stacked)


def pipeline_forward(stage_fn: Callable, params_stacked: Any,
                     x_microbatches: torch.Tensor, mesh, *,
                     axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(stage_params, x) -> x`` (shape-preserving) as a
    GPipe pipeline over ``axis``.

    params_stacked: this rank's piece of the stage-stacked tree (every
    leaf's leading dim 1).
    x_microbatches: (M, mb, ...) microbatched input, the same on every
    rank.  Returns the (M, mb, ...) outputs of the last stage, the same
    on every rank."""
    n_stages = mesh.shape.get(axis, 1)
    stage = mesh.coords.get(axis, 0)
    m = x_microbatches.shape[0]
    p_local = stage_piece(params_stacked)
    xs = x_microbatches
    buf = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
    outputs = torch.zeros_like(xs)
    for t in range(n_stages + m - 1):
        mb = t - stage
        active = 0 <= mb < m
        y = buf
        if active:
            y = stage_fn(p_local, xs[mb] if stage == 0 else buf)
            if stage == n_stages - 1:
                outputs[mb] = y
        buf = ppermute(y, mesh, axis)
    # results live on the last stage only; replicate across stages
    return all_reduce(outputs, "sum", mesh, axis)

"""The serving mesh of the port: ranks in a ``torch.distributed`` world.

The reference builds a JAX device mesh (``repro/launch/mesh.py``); the
port has one process a rank, and each axis is a set of process groups.
Ranks are laid out stage-major, then data, then model
(``sharding.rules.AXIS_ORDER``): with S stages, D data replicas and a
model axis of M, rank ``(s * D + d) * M + m`` sits at stage ``s``, data
replica ``d`` and model coordinate ``m``.  So:
  * a model group is a run of M consecutive ranks (the model axis is
    minor, as in the reference's ``make_mesh((n // model, model))``);
  * a data group is the D ranks of one stage with one model coordinate,
    ``{s * D * M + m + k * M}`` (over which the batch and FSDP's leaves
    are split);
  * a stage group is the S ranks with one (data, model) coordinate,
    ``{d * M + m + k * D * M}`` (over which a GPipe pipeline,
    ``sharding.pipeline``, moves activations).
:func:`spawn_world` starts an N-rank world and :func:`make_host_mesh`
lays the axes over it.

Backend rule (printed in every mesh line): ``nccl`` where every rank has
a card of its own, ``gloo`` otherwise, so several ranks can share one
card (gloo moves CUDA tensors through the host for ``broadcast`` and
``all_reduce``, the only two collectives the port calls) or run on the
CPU.  The host clock the engines share travels as a CPU tensor over
gloo whatever the backend (``Mesh.host_group``).

:func:`abstract_mesh` is one rank's view of a mesh of any shape, the
reference's production ``{"data": 16, "model": 16}`` and ``{"pod": 2,
"data": 16, "model": 16}`` included (``make_production_mesh``), at given
coordinates, on device ``meta``, with no process group: the counterpart
of the reference's 512 placeholder host devices in its dry-run.  Its
collectives count their bytes and return meta tensors
(``sharding.collectives``).  The reference's ``ensure_host_devices`` and
``HW`` (XLA flags and TPU peaks) have no counterpart; the dry-run's
peaks are the H100's (``launch.roofline``).
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.roofline import CollectiveStats
from repro_torch.sharding.rules import (AXIS_ORDER, global_rank,
                                        rank_coords)

#: how long a world may run, and a collective wait, before it is stopped
WORLD_TIMEOUT_S = 900.0

_RECIPE = ("start N ranks first: repro_torch.launch.mesh.spawn_world(fn, "
           "N) (or python -m repro_torch.launch.serve --model-parallel N), "
           "each rank then calling make_host_mesh(model=...)")


@dataclass
class Mesh:
    """This rank's view of the mesh: the axis sizes, its index on each
    axis, its model, data and stage groups (``None`` where the axis has
    one rank) with each group's global ranks in axis order, its device
    and the world's backend.  ``stats`` accumulates every collective the
    rank makes, by kind and axis.  ``abstract`` marks an
    :func:`abstract_mesh` (meta tensors, no process group)."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    group: Any = None
    ranks: Sequence[int] = (0,)
    backend: str = "none"
    stats: CollectiveStats = field(default_factory=CollectiveStats)
    data_group: Any = None
    data_ranks: Sequence[int] = (0,)
    stage_group: Any = None
    stage_ranks: Sequence[int] = (0,)
    abstract: bool = False
    #: a gloo group over the model group's ranks, for host values sent as
    #: CPU tensors (``collectives.broadcast_clock``): ``group`` itself
    #: under gloo, a group of its own under nccl
    host_group: Any = None

    @property
    def model(self) -> int:
        return self.shape.get("model", 1)

    @property
    def data(self) -> int:
        return self.shape.get("data", 1)

    @property
    def stage(self) -> int:
        return self.shape.get("stage", 1)

    @property
    def world(self) -> int:
        n = 1
        for size in self.shape.values():
            n *= size
        return n

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    @property
    def data_rank(self) -> int:
        return self.coords.get("data", 0)

    @property
    def stage_rank(self) -> int:
        return self.coords.get("stage", 0)

    @property
    def rank(self) -> int:
        return global_rank(self.coords, self.shape)

    def describe(self) -> str:
        if self.abstract:
            return (f"abstract mesh {dict(self.shape)} of {self.world} rank"
                    f"{'s' if self.world != 1 else ''}, the view of rank "
                    f"{dict(self.coords)} (meta; no process group)")
        return (f"mesh {dict(self.shape)} over {self.world} rank"
                f"{'s' if self.world != 1 else ''} ({self.backend}, "
                f"{self.device})")


def abstract_mesh(shape: Dict[str, int],
                  coords: Optional[Dict[str, int]] = None) -> Mesh:
    """One rank's view of a mesh of ``shape`` (axes among
    :data:`~repro_torch.sharding.rules.AXIS_ORDER`; ``"data"`` and
    ``"model"`` default to 1) at ``coords`` (default: every axis 0), on
    device ``meta``: no process group and no backend.  Nothing runs on
    it but meta tensors; its collectives add their kind and rank-local
    operand bytes to ``stats`` and return meta results."""
    unknown = set(shape) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"abstract_mesh: unknown axes {sorted(unknown)}; "
                         f"axes are {AXIS_ORDER}")
    full = {a: int(shape[a]) for a in AXIS_ORDER if a in shape}
    full.setdefault("data", 1)
    full.setdefault("model", 1)
    full = {a: full[a] for a in AXIS_ORDER if a in full}
    at = {a: 0 for a in full}
    at.update(coords or {})
    for a, i in at.items():
        if a not in full or not 0 <= i < full[a]:
            raise ValueError(f"abstract_mesh: coordinate {a}={i} outside "
                             f"{full}")
    return Mesh(shape=full, coords=at, device=torch.device("meta"),
                abstract=True)


def backend_for(device: torch.device, world: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    if device.type == "cuda" and torch.cuda.device_count() >= world > 1:
        return "nccl"
    return "gloo"


def _rank_device(device, rank: int, world: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the ranks on the CPU")
    own = torch.cuda.device_count() >= world
    return torch.device("cuda", rank if own else 0)


def make_host_mesh(*, model: int = 1, stage: int = 1,
                   device="cuda") -> Mesh:
    """The mesh over the initialized world (a world of one when no
    process group is up): ``{"data": world // (stage * model), "model":
    model}``, with ``"stage": stage`` ahead of them when ``stage`` > 1.
    Every rank must call it: it creates every model group (and, where
    the world's backend is not gloo, a gloo group over each for host
    values: ``Mesh.host_group``), then every data group, then every
    stage group, in one order on every rank (an axis of one rank has no
    group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model < 1 or stage < 1 or world % (model * stage):
        raise ValueError(
            f"make_host_mesh(model={model}, stage={stage}): {world} rank"
            f"{'s' if world != 1 else ''} not divisible by the model and "
            "stage axes; " + _RECIPE)
    data = world // (model * stage)
    shape = {"data": data, "model": model}
    if stage > 1:
        shape = {"stage": stage, **shape}
    coords = rank_coords(rank, shape)
    plane = data * model                  # the ranks of one stage
    backend = dist.get_backend() if dist.is_initialized() else "none"

    def groups(members_of, count, mine, backend=None):
        """Create ``count`` groups (every rank, in one order) and return
        this rank's (group, its members)."""
        out = (None, (rank,))
        for i in range(count):
            members = members_of(i)
            g = dist.new_group(members, backend=backend)
            if i == mine:
                out = (g, tuple(members))
        return out

    group, ranks, host_group = None, (rank,), None
    if model > 1:
        model_args = (lambda i: list(range(i * model, (i + 1) * model)),
                      stage * data,
                      coords.get("stage", 0) * data + coords["data"])
        group, ranks = groups(*model_args)
        host_group = group
        if backend != "gloo":
            # nccl takes no CPU tensor: the host clock gets gloo groups
            host_group, _ = groups(*model_args, backend="gloo")
    data_group, data_ranks = None, (rank,)
    if data > 1:
        data_group, data_ranks = groups(
            lambda i: [(i // model) * plane + i % model + k * model
                       for k in range(data)],
            stage * model, coords.get("stage", 0) * model + coords["model"])
    stage_group, stage_ranks = None, (rank,)
    if stage > 1:
        stage_group, stage_ranks = groups(
            lambda i: [i + k * plane for k in range(stage)],
            plane, coords["data"] * model + coords["model"])
    return Mesh(shape=shape, coords=coords,
                device=_rank_device(device, rank, world), group=group,
                ranks=ranks, backend=backend, data_group=data_group,
                data_ranks=data_ranks, stage_group=stage_group,
                stage_ranks=stage_ranks, host_group=host_group)


def _rank_main(fn, rank: int, world: int, init: str, backend: str,
               device: str, threads: Optional[int], out_dir: str,
               timeout_s: float, args: tuple) -> None:
    # the ranks talk over the loopback device only
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    dev = _rank_device(device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    result = fn(rank, *args)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, *args, device="cuda",
                threads: Optional[int] = None,
                timeout_s: float = WORLD_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` in ``world`` new processes joined in one
    process group, and return their results in rank order (``fn`` is
    importable and its result picklable).

    The processes are started with ``spawn`` (the caller may already hold
    a CUDA context, which ``fork`` would copy) and meet through a
    ``file://`` rendezvous in a fresh temporary directory, so concurrent
    worlds never compete for a port.  The backend follows
    :func:`backend_for`; ``threads`` sets each rank's torch thread
    count.  ``timeout_s`` bounds both the world's run and each
    collective's wait (a rank left waiting in a collective whose peers
    went another way raises there).  A rank that fails stops the world:
    its traceback is on stderr and this raises; every process is gone on
    return."""
    import multiprocessing as mp
    dev = torch.device(device)
    backend = backend_for(dev, world)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_world_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, backend, str(dev),
                                   threads, tmp, timeout_s, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout_s
            pending = set(range(world))
            while pending:
                for r in sorted(pending):
                    procs[r].join(timeout=0.05)
                    code = procs[r].exitcode
                    if code is None:
                        continue
                    pending.discard(r)
                    if code != 0:
                        raise RuntimeError(
                            f"rank {r} of {world} exited with code {code} "
                            "(its traceback is above, on stderr)")
                if pending and time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(pending)} of {world} "
                                       f"still running after "
                                       f"{timeout_s}s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results

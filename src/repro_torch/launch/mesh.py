"""The serving mesh of the port: ranks in a ``torch.distributed`` world.

The reference builds a JAX device mesh (``repro/launch/mesh.py``); the
port has one process a rank, and each axis is a set of process groups:
ranks ``d * model .. d * model + model - 1`` form data replica ``d``'s
model group (the model axis is minor, as in the reference's
``make_mesh((n // model, model))``), and the ranks with one model
coordinate ``m``, ``{m, m + model, ...}``, form its data group (over
which the batch and FSDP's leaves are split).  :func:`spawn_world` starts
an N-rank world and :func:`make_host_mesh` lays the axes over it.

Backend rule (printed in every mesh line): ``nccl`` where every rank has
a card of its own, ``gloo`` otherwise, so several ranks can share one
card (gloo moves CUDA tensors through the host for ``broadcast`` and
``all_reduce``, the only two collectives the port calls) or run on the
CPU.  The reference's ``ensure_host_devices``, ``make_production_mesh``
and ``HW`` (XLA flags, TPU pods and peaks) have no counterpart.
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
from repro_torch.sharding.rules import rank_coords

#: how long a world may run, and a collective wait, before it is stopped
WORLD_TIMEOUT_S = 900.0

_RECIPE = ("start N ranks first: repro_torch.launch.mesh.spawn_world(fn, "
           "N) (or python -m repro_torch.launch.serve --model-parallel N), "
           "each rank then calling make_host_mesh(model=...)")


@dataclass
class Mesh:
    """This rank's view of the mesh: the axis sizes, its index on each
    axis, its model group and its data group (``None`` where the axis
    has one rank) with each group's global ranks in axis order, its
    device and the world's backend.  ``stats`` accumulates every
    collective the rank makes, by kind and axis."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    group: Any = None
    ranks: Sequence[int] = (0,)
    backend: str = "none"
    stats: CollectiveStats = field(default_factory=CollectiveStats)
    data_group: Any = None
    data_ranks: Sequence[int] = (0,)

    @property
    def model(self) -> int:
        return self.shape.get("model", 1)

    @property
    def data(self) -> int:
        return self.shape.get("data", 1)

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    @property
    def data_rank(self) -> int:
        return self.coords.get("data", 0)

    @property
    def rank(self) -> int:
        return self.data_rank * self.model + self.model_rank

    def describe(self) -> str:
        return (f"mesh {dict(self.shape)} over {self.world} rank"
                f"{'s' if self.world != 1 else ''} ({self.backend}, "
                f"{self.device})")


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


def make_host_mesh(*, model: int = 1, device="cuda") -> Mesh:
    """The mesh over the initialized world (a world of one when no
    process group is up): ``{"data": world // model, "model": model}``.
    Every rank must call it: it creates every model group, then every
    data group, in one order on every rank (an axis of one rank has no
    group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model < 1 or world % model:
        raise ValueError(
            f"make_host_mesh(model={model}): {world} rank"
            f"{'s' if world != 1 else ''} not divisible by the model axis; "
            + _RECIPE)
    shape = {"data": world // model, "model": model}
    coords = rank_coords(rank, shape)
    data = shape["data"]
    group, ranks = None, (rank,)
    if model > 1:
        for d in range(data):
            members = list(range(d * model, (d + 1) * model))
            g = dist.new_group(members)
            if d == coords["data"]:
                group, ranks = g, tuple(members)
    data_group, data_ranks = None, (rank,)
    if data > 1:
        for m in range(model):
            members = list(range(m, world, model))
            g = dist.new_group(members)
            if m == coords["model"]:
                data_group, data_ranks = g, tuple(members)
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return Mesh(shape=shape, coords=coords,
                device=_rank_device(device, rank, world), group=group,
                ranks=ranks, backend=backend, data_group=data_group,
                data_ranks=data_ranks)


def _rank_main(fn, rank: int, world: int, init: str, backend: str,
               device: str, threads: Optional[int], out_dir: str,
               args: tuple) -> None:
    # the ranks talk over the loopback device only
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    dev = _rank_device(device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(
                                seconds=WORLD_TIMEOUT_S))
    result = fn(rank, *args)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, *args, device="cuda",
                threads: Optional[int] = None) -> list:
    """Run ``fn(rank, *args)`` in ``world`` new processes joined in one
    process group, and return their results in rank order (``fn`` is
    importable and its result picklable).

    The processes are started with ``spawn`` (the caller may already hold
    a CUDA context, which ``fork`` would copy) and meet through a
    ``file://`` rendezvous in a fresh temporary directory, so concurrent
    worlds never compete for a port.  The backend follows
    :func:`backend_for`; ``threads`` sets each rank's torch thread
    count.  A rank that fails stops the world: its traceback is on
    stderr and this raises; every process is gone on return."""
    import multiprocessing as mp
    dev = torch.device(device)
    backend = backend_for(dev, world)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_world_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, backend, str(dev),
                                   threads, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + WORLD_TIMEOUT_S
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
                                       f"{WORLD_TIMEOUT_S}s")
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

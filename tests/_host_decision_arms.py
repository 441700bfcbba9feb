"""The drives of ``test_torch_host_decisions.py``: each arm serves its
requests through one engine of the float32 smoke qwen2, in every rank
of a 2-rank gloo world (under the rank's mesh) and, with ``mesh=None``,
in the test process for the single-rank side.

In the world, rank 1's host clock (``serve.engine.host_clock``, the
reading every decision of an engine takes) is skewed: an hour ahead and
running 1.5x as fast.  Rank 0's clock is recorded, reading by reading;
the single-rank side replays those readings in order (:class:`Replay`),
so that it sees the clock rank 0 sent.  This module imports no JAX: the
ranks import it."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import LM
from repro_torch.resil import FaultInjector
from repro_torch.sched import SchedEngine
from repro_torch.serve import engine as serve_engine
from repro_torch.serve.engine import PagedEngine, run_open_loop
from repro_torch.spec import SpecEngine

#: rank 1's clock: this far ahead of its own, and this many times as fast
SKEW_S = 3600.0
SKEW_RATE = 1.5
#: the world's join deadline and collective timeout: a divergent drive
#: stops the world in this long instead of the default 900 s
WORLD_TIMEOUT_S = 120.0

ENGINES = {"paged": PagedEngine, "sched": SchedEngine, "spec": SpecEngine}


def config():
    return get_smoke_config("qwen2-1.5b").with_(dtype="float32")


class Skewed:
    """A clock ``SKEW_S`` ahead of ``clock`` that runs ``SKEW_RATE`` as
    fast."""

    def __init__(self, clock):
        self.clock, self.t0 = clock, clock()

    def __call__(self) -> float:
        return SKEW_S + self.t0 + SKEW_RATE * (self.clock() - self.t0)


class Recorder:
    """``clock``, every reading kept in order."""

    def __init__(self, clock):
        self.clock, self.readings = clock, []

    def __call__(self) -> float:
        t = self.clock()
        self.readings.append(t)
        return t


class Replay:
    """The readings of a :class:`Recorder`, in order; reading once more
    than they hold fails the drive."""

    def __init__(self, readings):
        self.readings, self.used = list(readings), 0

    def __call__(self) -> float:
        if self.used >= len(self.readings):
            raise AssertionError(f"the replay read the clock more than the "
                                 f"{len(self.readings)} times rank 0 did")
        self.used += 1
        return self.readings[self.used - 1]


def cost_prompts(vocab: int, name: str) -> list:
    """``test_sched.py``'s cold and preempt prompts, from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = (8, 5, 12, 8, 3) if name == "cold" else (8, 5)
    return [rng.integers(0, vocab, (n,)).tolist() for n in lens]


def chaos_prompts(vocab: int, n: int = 6, seed: int = 0) -> list:
    """``test_resil.py``'s prompts: 10-39 tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(k),)).tolist()
            for k in rng.integers(10, 40, n)]


def repetitive_prompts(vocab: int, n: int) -> list:
    """``test_spec.py``'s prompts: a 6-token pattern three times and 3
    random tokens, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        pat = rng.integers(0, vocab, (6,)).tolist()
        out.append(pat * 3 + rng.integers(0, vocab, (3,)).tolist())
    return out


#: the scheduler settings every arm starts from (a pool of 25 pages of 8)
BASE = dict(n_slots=2, max_len=96, seed=0, page_size=8, decode_block=4,
            prefill_chunk=16)


def _schedule(arm: dict, vocab: int) -> list:
    """(tick, prompt, submit kwargs) of every request of ``arm``, in rid
    order: ``arm["requests"]`` is a list of (tick, prompt source, submit
    kwargs) where a source is ``("cost", name, i)``, ``("chaos", i)``,
    ``("rep", i)`` or ``("rand", length, seed)``."""
    out = []
    for tick, src, kw in arm["requests"]:
        if src[0] == "cost":
            p = cost_prompts(vocab, src[1])[src[2]]
        elif src[0] == "chaos":
            p = chaos_prompts(vocab)[src[1]]
        elif src[0] == "rep":
            p = repetitive_prompts(vocab, src[1] + 1)[src[1]]
        else:
            p = np.random.default_rng(src[2]).integers(
                0, vocab, (src[1],)).tolist()
        out.append((tick, p, kw))
    return out


def build(arm: dict, weights, mesh=None):
    cfg = config()
    lm = LM(cfg, device="cpu")
    params = params_from_numpy(weights, cfg, device="cpu")
    kw = dict(BASE, **arm.get("kw", {}))
    if arm["engine"] == "paged":
        del kw["prefill_chunk"]
    if "chaos" in arm:
        kw["injector"] = FaultInjector.from_spec(arm["chaos"])
    eng = ENGINES[arm["engine"]](lm, params, mesh=mesh, **kw)
    if "aging" in arm:
        eng.policy.aging = arm["aging"]
    return eng


def drive(arm: dict, weights, mesh=None) -> dict:
    """Serve ``arm``'s requests (at their ticks, or open loop at
    ``arm["arrival_rate"]``); the streams, outcomes, host syncs, the
    order of admissions, the ladder's rung after every tick, the
    engine's counters (wall-clock series dropped) and its stats."""
    eng = build(arm, weights, mesh)
    sched = _schedule(arm, eng.lm.cfg.vocab_size)
    admits, rungs, trace = [], [], []
    if hasattr(eng, "_admit_one"):
        admit_one = eng._admit_one

        def counted_admit(req, now):
            ok = admit_one(req, now)
            if ok:
                admits.append(req.rid)
            return ok
        eng._admit_one = counted_admit
    step = eng.step

    def traced_step():
        queued = bool(eng.queue)
        out = step()
        if getattr(eng, "ladder", None) is not None:
            rungs.append(eng.ladder.rung)
        if arm["engine"] == "spec":
            trace.append((queued, eng.spec_stats.verify_steps))
        return out
    eng.step = traced_step
    if "arrival_rate" in arm:
        # one set of submit kwargs for every arrival
        offsets = np.cumsum(np.random.default_rng(7).exponential(
            1.0 / arm["arrival_rate"], len(sched)))
        ids = run_open_loop(eng, [p for _, p, _ in sched], offsets,
                            **sched[0][2])
    else:
        ids, tick = [], 0
        pending = list(sched)
        while pending or serve_engine.engine_busy(eng):
            while pending and pending[0][0] <= tick:
                _, p, kw = pending.pop(0)
                ids.append(eng.submit(p, **kw))
            if serve_engine.engine_busy(eng):
                eng.step()
            tick += 1
    reqs = [eng.registry[i] for i in ids]
    counters = {k: v for k, v in eng.metrics.snapshot()["counters"].items()
                if "seconds" not in k and not k.startswith("tp_")}
    out = {"streams": [list(r.out_tokens) for r in reqs],
           "outcomes": [r.outcome for r in reqs],
           "rejected": [r.rejected for r in reqs],
           "preemptions": [r.preemptions for r in reqs],
           "late_admits": sum(r.t_admit is not None and r.slo_ttft is not None
                              and r.t_admit > r.t_submit + r.slo_ttft
                              for r in reqs),
           "syncs": eng.sync_count, "admits": admits, "rungs": rungs,
           "spec_trace": trace, "counters": counters,
           "free": sorted(int(p) for p in eng.alloc.free),
           "held": len(eng.prefix.nodes) if getattr(eng, "prefix", None)
           else 0}
    if hasattr(eng, "stats"):
        out["stats"] = dict(vars(eng.stats))
    if hasattr(eng, "spec_stats"):
        out["spec_stats"] = dict(vars(eng.spec_stats))
    if eng.injector is not None:
        out["injected"] = dict(eng.injector.counts)
    return out


def run_arm(arm: dict, weights, mesh=None, clock=None) -> dict:
    """:func:`drive` with ``serve.engine.host_clock`` set to ``clock``
    (restored after)."""
    real = serve_engine.host_clock
    if clock is not None:
        serve_engine.host_clock = clock
    try:
        return drive(arm, weights, mesh)
    finally:
        serve_engine.host_clock = real


def world(rank: int, arms: dict, weights) -> dict:
    """Every arm in one rank of a 2-rank world: rank 0 records its clock,
    rank 1 runs skewed.  Each result also holds the clock readings this
    rank broadcast or received (``broadcast/clock``) and, on rank 0, the
    readings themselves."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(model=2, device="cpu")
    out = {}
    for name, arm in arms.items():
        real = serve_engine.host_clock
        clock = Recorder(real) if rank == 0 else Skewed(real)
        before = mesh.stats.copy()
        res = run_arm(arm, weights, mesh, clock)
        res["shared_readings"] = mesh.stats.since(before).count_by_op.get(
            "broadcast/clock", 0)
        res["collectives"] = sorted(op for op, n in mesh.stats.since(
            before).count_by_op.items() if n)
        if rank == 0:
            res["readings"] = clock.readings
        out[name] = res
    return out

"""Roofline terms of a dry-run cell, and the collective accounting of
the sharded paths: the port's copy of ``repro/launch/roofline.py``.

Three terms per (arch x shape x mesh), in seconds, per rank:

    compute    = FLOPs            / peak bf16 FLOP/s
    memory     = bytes accessed   / HBM bandwidth
    collective = collective bytes / one link's bandwidth

The peaks are the H100's, the port's ``h100-1`` cost-model tier
(``core/costmodel.py``): 989.4 TFLOP/s bf16, 3.35 TB/s of HBM3, 80 GB,
and one 50 GB/s NVLink as the conservative floor (the reference's rule
for its ICI links).  :func:`roofline_from_trace` derives them from one
rank's step run on meta tensors under an abstract mesh (the counterpart
of the reference's ``roofline_from_compiled`` over ``lower().compile()``):
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step
    (backward and recomputation included);
  * bytes: every aten op's operand and result bytes
    (:class:`ByteCounter`), the unfused count, as the reference's CPU
    "bytes accessed" is; :func:`analytic_hbm_bytes` is the fused
    estimate, and the dry-run reports both;
  * collectives: the step's calls on the mesh, from the port's
    collective layer (``sharding.collectives``), which adds every call's
    kind and rank-local operand bytes to the mesh's
    :class:`CollectiveStats` as it makes it (an all-gather's bytes are
    the rank's own piece);
  * memory: the rank-local argument and output bytes (outputs that are
    arguments updated in place counted once).
The reference's ``resolve_cost_analysis`` and ``parse_collectives`` have
no counterpart: there is no compiled HLO to read.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())

    def add(self, op: str, nbytes: float) -> None:
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + nbytes
        self.count_by_op[op] = self.count_by_op.get(op, 0) + 1

    def merge(self, other: "CollectiveStats") -> None:
        """Add ``other``'s calls and bytes; an op it holds no call of
        (a :meth:`since` of a window that made none) adds no key."""
        for op, n in other.count_by_op.items():
            if n:
                self.count_by_op[op] = self.count_by_op.get(op, 0) + n
                self.bytes_by_op[op] = (self.bytes_by_op.get(op, 0.0)
                                        + other.bytes_by_op.get(op, 0.0))

    def copy(self) -> "CollectiveStats":
        return CollectiveStats(dict(self.bytes_by_op), dict(self.count_by_op))

    def since(self, before: "CollectiveStats") -> "CollectiveStats":
        """What was added after ``before`` (a :meth:`copy`)."""
        return CollectiveStats(
            {op: b - before.bytes_by_op.get(op, 0.0)
             for op, b in self.bytes_by_op.items()},
            {op: n - before.count_by_op.get(op, 0)
             for op, n in self.count_by_op.items()})

    def to_dict(self, steps: int = 1):
        """Dict form for reports / JSON.  ``steps`` divides the totals
        into a per-step breakdown (e.g. a decode dispatch covering
        ``decode_block`` steps): per collective op, bytes moved per step,
        plus the per-step total."""
        out = asdict(self)
        out["total_bytes"] = self.total_bytes
        if steps != 1:
            out["steps"] = steps
            out["bytes_per_step_by_op"] = {
                op: b / steps for op, b in self.bytes_by_op.items()}
            out["total_bytes_per_step"] = self.total_bytes / steps
        return out

    def register_metrics(self, registry, *, steps: int = 1) -> None:
        """Fold the accounting into a metrics registry snapshot: per-op
        byte / count gauges (labelled ``op=``) plus the per-step total."""
        gb = registry.gauge("roofline_collective_bytes",
                            "per-rank collective bytes")
        gc = registry.gauge("roofline_collective_count",
                            "collective call count")
        for op, b in self.bytes_by_op.items():
            gb.set(b, op=op)
        for op, n in self.count_by_op.items():
            gc.set(n, op=op)
        registry.gauge("roofline_collective_bytes_per_step",
                       "per-rank collective bytes per decode step").set(
            self.total_bytes / max(steps, 1))


# ---------------------------------------------------------------------------


def h100_peaks() -> dict:
    """The roofline's peaks, from the port's ``h100-1`` tier: bf16 FLOP/s,
    HBM bytes/s, one link's bytes/s and the card's memory."""
    from repro_torch.core.costmodel import TIERS
    t = TIERS["h100-1"]
    return {"peak_flops_bf16": t.peak_flops_bf16, "hbm_bw": t.hbm_bw,
            "link_bw": t.link_bw, "hbm_bytes": t.mem_cap}


@dataclass
class RooflineTerms:
    flops: float                      # per-rank FLOPs
    hbm_bytes: float                  # per-rank bytes accessed (unfused)
    collective_bytes: float           # per-rank collective operand bytes
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float                # 6·N(_active)·D analytic
    useful_ratio: float               # model_flops / (flops × ranks)
    collectives: Dict[str, float]
    collective_counts: Dict[str, int]
    memory_per_device: Optional[dict] = None

    def to_dict(self):
        return asdict(self)

    @property
    def t_max(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the binding roof the useful model FLOPs occupy =
        (model-FLOPs time at the peak) / (time the dominant term costs)."""
        if self.t_max <= 0:
            return 0.0
        return min(1.0, (self.useful_ratio * self.t_compute) / self.t_max)


def _terms(flops: float, hbm: float, coll: float, colls: dict,
           counts: dict, *, n_chips: int, model_flops: float, hw: dict,
           mem: Optional[dict] = None) -> RooflineTerms:
    t_compute = flops / hw["peak_flops_bf16"]
    t_memory = hbm / hw["hbm_bw"]
    # per-rank bytes over one link (the conservative floor)
    t_collective = coll / hw["link_bw"]
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    bottleneck = max(terms, key=terms.get)
    useful = (model_flops / n_chips) / flops if flops else 0.0
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm, collective_bytes=coll,
        t_compute=t_compute, t_memory=t_memory, t_collective=t_collective,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=useful, collectives=colls, collective_counts=counts,
        memory_per_device=mem)


def extrapolate_terms(ra: RooflineTerms, rb: RooflineTerms, num_groups: int,
                      *, n_chips: int, model_flops: float,
                      hw: Optional[dict] = None) -> RooflineTerms:
    """Whole-model accounting from 1-group (A) and 2-group (B) traces:
    every group is structurally identical, so ``total = A + (G-1)·(B-A)``
    for flops / bytes / collective bytes and counts.  The port's stack is
    a list, so a full-depth trace counts every group itself; this is the
    reference's shortcut, held to a full trace by the tests."""
    hw = hw or h100_peaks()
    k = num_groups - 1

    def ext(a, b):
        return a + k * (b - a)

    colls = {op: ext(ra.collectives.get(op, 0.0), rb.collectives.get(op, 0.0))
             for op in set(ra.collectives) | set(rb.collectives)}
    counts = {op: int(round(ext(ra.collective_counts.get(op, 0),
                                rb.collective_counts.get(op, 0))))
              for op in set(ra.collective_counts) | set(rb.collective_counts)}
    return _terms(ext(ra.flops, rb.flops), ext(ra.hbm_bytes, rb.hbm_bytes),
                  ext(ra.collective_bytes, rb.collective_bytes), colls,
                  counts, n_chips=n_chips, model_flops=model_flops, hw=hw)


def analytic_hbm_bytes(cfg, shape, *, n_chips: int = 256,
                       model_axis: int = 16) -> float:
    """Per-rank HBM traffic under fusion (the optimistic roofline; the
    traced unfused bytes are the pessimistic one — both are reported).

    Counts: weight-shard reads (fwd/bwd), optimizer state r/w, layer
    boundary + projection activations (fwd, bwd, one remat recompute),
    CE logit chunks, KV-cache traffic.  Attention probabilities are NOT
    counted — a flash kernel keeps them on chip.  The port has no
    ``seq_parallel`` placement (ROADMAP C), so activations are whole on
    every model rank."""
    dp = n_chips // model_axis
    w_shard = cfg.param_count() * 2.0 / n_chips \
        if cfg.param_count() * 2.0 / model_axis > 2 * 2**30 \
        else cfg.param_count() * 2.0 / model_axis
    v_shard = cfg.padded_vocab / model_axis \
        if cfg.padded_vocab % model_axis == 0 else cfg.padded_vocab
    if shape.mode == "train":
        tokens_chip = shape.global_batch * shape.seq_len / dp
        acts = cfg.num_layers * tokens_chip * cfg.d_model * 2.0 * 12 * 3
        ce = tokens_chip * v_shard * 4.0 * 4
        opt = w_shard * 10.0
        return opt + 2 * w_shard + acts + ce
    if shape.mode == "prefill":
        tokens_chip = shape.global_batch * shape.seq_len / dp
        acts = cfg.num_layers * tokens_chip * cfg.d_model * 2.0 * 8
        kv = _kv_total_bytes(cfg, shape) / n_chips
        return w_shard + acts + kv
    # decode: weights + KV read per step
    kv = _kv_total_bytes(cfg, shape) / n_chips
    return w_shard + kv


def _kv_total_bytes(cfg, shape) -> float:
    a = cfg.attention
    n_attn = sum(1 for b in cfg.block_pattern if b == "attn") \
        * (cfg.num_layers // max(len(cfg.block_pattern), 1)) \
        if a is not None else 0
    if a is None or n_attn == 0:
        return 1e6
    kvh = a.kv_heads_effective()
    return (shape.global_batch * shape.seq_len * kvh * a.head_dim
            * 2 * 2.0 * n_attn)


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for the
    whole step (D = tokens processed; decode: D = batch, ×2 not ×6)."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence, forward only
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# Tracing one rank's step


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: ops that move no bytes: fresh uninitialized results
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


class ByteCounter(TorchDispatchMode):
    """Adds every aten op's operand and result bytes (views and fresh
    ``empty`` results excluded): the traffic of running each op alone,
    unfused.  ``by_op`` splits the total by op."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in _NO_TRAFFIC:
            return out
        n = sum(_nbytes(t) for t in _tensors((args, kwargs or {})))
        n += sum(_nbytes(t) for t in _tensors(out))
        self.total += n
        self.by_op[str(func.overloadpacket)] += n
        return out


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (dicts, lists, tuples), each
    tensor object once."""
    seen, n = set(), 0
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            n += _nbytes(t)
    return n


def roofline_from_trace(fn, args: tuple, *, mesh, n_chips: int,
                        model_flops: float,
                        hw: Optional[dict] = None) -> RooflineTerms:
    """Run ``fn(*args)`` (one rank's step on ``mesh``, meta tensors under
    an abstract mesh) under the FLOP and byte counters and read its
    collectives from ``mesh.stats`` -> the roofline terms at the H100's
    peaks (``hw``, default :func:`h100_peaks`)."""
    from torch.utils.flop_counter import FlopCounterMode
    hw = hw or h100_peaks()
    before = mesh.stats.copy()
    arg_ids = {id(t) for t in _tensors(args)}
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
        out = fn(*args)
    coll = mesh.stats.since(before)
    colls = {op: b for op, b in coll.bytes_by_op.items() if b}
    counts = {op: n for op, n in coll.count_by_op.items() if n}
    arg_b = tree_bytes(args)
    out_b = tree_bytes(out)
    alias = sum(_nbytes(t) for t in {id(t): t for t in _tensors(out)
                                    if id(t) in arg_ids}.values())
    mem = {"argument_bytes": arg_b, "output_bytes": out_b,
           "alias_bytes": alias, "live_bytes": arg_b + out_b - alias}
    mem["fits_hbm"] = mem["live_bytes"] <= hw["hbm_bytes"]
    return _terms(float(fc.get_total_flops()), float(bc.total),
                  coll.total_bytes, colls, counts, n_chips=n_chips,
                  model_flops=model_flops, hw=hw, mem=mem)

"""Collective accounting for the sharded paths.

The port's copy of ``CollectiveStats`` from ``repro/launch/roofline.py``
(the rest of that module, the dry-run's roofline terms, is not ported
yet).  The reference sums the collectives of compiled HLO text; the port
has no HLO, so its collective layer (``repro_torch.sharding.collectives``)
adds every call's operand bytes and kind here as it makes the call:
bytes are per rank, an all-gather's are the rank's own piece.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict


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
        for op, b in other.bytes_by_op.items():
            self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + b
        for op, n in other.count_by_op.items():
            self.count_by_op[op] = self.count_by_op.get(op, 0) + n

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

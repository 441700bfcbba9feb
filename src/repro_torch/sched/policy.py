"""Admission-ordering / preemption-victim policies for the scheduler.

The port's copy of ``repro/sched/policy.py``.  A policy answers two
questions with one comparable key each:

* ``priority(req, now)``  — who is admitted next (SMALLEST first);
* ``victim(req, now)``    — who is preempted first when pages run out
                            (LARGEST first; default: the inverse of
                            admission priority, i.e. evict whoever you
                            would admit last).

``FCFS`` reproduces the base engine's arrival order.  ``EDF`` (earliest
deadline first) converts each request's TTFT SLO into a deadline and
admits the most urgent request first; its preemption victim is the
request with the most slack.

The reference's ``SJF`` and EDF's cost-model admission check price a job
through ``core.costmodel.service_estimate``, whose peaks are a TPU's; the
port carries no TPU numbers, so both wait for an H100 tier of the cost
model (ROADMAP A5) and raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

from typing import Optional

#: EDF's deadline fallback (seconds) when neither the request nor the
#: engine supplies a TTFT target
DEFAULT_TTFT_S = 0.5

COST_MODEL_TODO = ("needs the cost model's H100 tier (ROADMAP A5); the "
                   "reference prices jobs with TPU peaks")


class Policy:
    """FCFS: admission by arrival; preempt the latest arrival."""

    name = "fcfs"

    def priority(self, req, now: float):
        return (req.t_submit, req.rid)

    def victim(self, req, now: float):
        return self.priority(req, now)

    def admit_drop(self, req, now: float) -> bool:
        """Admission-time SLO feasibility: True when the request should
        be DROPPED instead of admitted because its SLO is already
        unmeetable.  Base policies never drop."""
        return False


class FCFS(Policy):
    pass


class EDF(Policy):
    """Earliest-deadline-first on the TTFT SLO: deadline = submit time +
    the request's TTFT target (engine/policy default when unset).  The
    preemption victim is the request with the LATEST deadline — the one
    that can best afford a recompute."""

    name = "edf"

    def __init__(self, slo_ttft: Optional[float] = None):
        self.slo_ttft = slo_ttft if slo_ttft is not None else DEFAULT_TTFT_S

    def deadline(self, req) -> float:
        slo = req.slo_ttft if req.slo_ttft is not None else self.slo_ttft
        return req.t_submit + slo

    def priority(self, req, now: float):
        return (self.deadline(req), req.rid)

    def admit_drop(self, req, now: float) -> bool:
        """A request whose deadline passed while it queued can only miss
        its SLO.  (The reference also drops requests whose cost-model
        prefill estimate overruns the deadline; see the module
        docstring.)"""
        return now >= self.deadline(req)


def make_policy(name: str, *, slo_ttft: Optional[float] = None) -> Policy:
    name = name.lower()
    if name == "fcfs":
        return FCFS()
    if name == "edf":
        return EDF(slo_ttft)
    if name == "sjf":
        raise NotImplementedError(f"policy 'sjf' {COST_MODEL_TODO}")
    raise ValueError(f"unknown policy {name!r} (fcfs | edf)")

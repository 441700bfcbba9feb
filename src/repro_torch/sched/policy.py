"""Admission-ordering / preemption-victim policies for the scheduler.

The port's copy of ``repro/sched/policy.py``.  A policy answers two
questions with one comparable key each:

* ``priority(req, now)``  — who is admitted next (SMALLEST first);
* ``victim(req, now)``    — who is preempted first when pages run out
                            (LARGEST first; default: the inverse of
                            admission priority, i.e. evict whoever you
                            would admit last).

``FCFS`` reproduces the base engine's arrival order.  ``SJF`` ranks by
the cost model's predicted remaining service time
(``core.costmodel.service_estimate`` on an H100 tier).  ``EDF``
(earliest deadline first) converts each request's TTFT SLO into a
deadline and admits the most urgent request first; its preemption victim
is the request with the most slack.  The cost-model policies price KV
bytes at the engine's ``layout`` (the scheduler passes ``"paged"``).
"""
from __future__ import annotations

from typing import Optional

#: EDF's deadline fallback (seconds) when neither the request nor the
#: engine supplies a TTFT target; tier-relative like every latency here
DEFAULT_TTFT_S = 0.5

#: SJF starvation aging: every second a request waits in the queue
#: discounts this many (estimated-service) seconds off its rank, so a
#: long job's rank eventually drops below any stream of fresh short jobs
#: — pure SJF would starve it forever.  Subtractive aging makes the
#: discount unbounded, which is the admission guarantee.
DEFAULT_SJF_AGING = 0.05

#: retry-after quantum (seconds) per queued request ahead of a shed one
DEFAULT_RETRY_AFTER_S = 0.1


def _gen_len(req) -> int:
    return len(req.out_tokens)


def _remaining_prefill(req) -> int:
    """Prompt (+ recompute-on-readmit) tokens not yet cached."""
    total = len(req.prompt) + max(_gen_len(req) - 1, 0)
    return max(total - req.progress, 0)


def _tier(tier):
    from repro_torch.core.costmodel import TIERS
    return TIERS[tier] if isinstance(tier, str) else tier


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
        unmeetable (goodput-optimal dropping).  Base policies never
        drop; deadline-EDF overrides with a cost-model check."""
        return False

    def retry_after(self, req, now: float, depth: int) -> float:
        """Client-facing retry-after hint (seconds) when ``req`` is shed
        under overload (the degradation ladder's shed rung): one quantum
        per queued request ahead of it.  Cost-model policies refine the
        quantum with their own service estimates."""
        return max(depth, 1) * DEFAULT_RETRY_AFTER_S


class FCFS(Policy):
    pass


class SJF(Policy):
    """Cost-model-predicted shortest-job-first: rank by estimated
    remaining service seconds (prefill roofline for uncached tokens +
    per-token decode for the ungenerated budget), DISCOUNTED by queue
    wait (starvation aging): rank = remaining_s - aging * wait.  With
    ``aging = 0`` this is pure SJF, under which one long request starves
    forever behind a steady stream of short arrivals; any positive rate
    bounds the wait because the discount grows without limit."""

    name = "sjf"

    def __init__(self, cfg, tier="h100-1",
                 aging: float = DEFAULT_SJF_AGING,
                 prefill_chunk: Optional[int] = None, *,
                 layout: str = "contiguous"):
        self.cfg = cfg
        self.tier = _tier(tier)
        self.aging = aging
        # the engine's chunk size: remaining prefill is priced at the
        # prefix-extend kernel's streamed-page bytes per chunk, not one
        # shot
        self.prefill_chunk = prefill_chunk
        self.layout = layout

    def remaining_s(self, req) -> float:
        from repro_torch.core.costmodel import service_estimate
        rem_gen = max(req.max_new_tokens - _gen_len(req), 0)
        est = service_estimate(self.cfg, self.tier,
                               prompt=max(_remaining_prefill(req), 1),
                               gen=rem_gen, chunk=self.prefill_chunk,
                               layout=self.layout)
        return est["t_total_s"]

    def priority(self, req, now: float):
        wait = max(now - req.t_submit, 0.0)
        return (self.remaining_s(req) - self.aging * wait, req.rid)

    def victim(self, req, now: float):
        # preemption stays pure longest-remaining-first: aging exists to
        # get a starved job ADMITTED, not to evict whoever waited least
        return (self.remaining_s(req), req.rid)

    def retry_after(self, req, now: float, depth: int) -> float:
        # the backlog drains at roughly the modeled service rate, so the
        # hint is the shed request's own estimate times its queue rank
        return max(depth, 1) * max(self.remaining_s(req),
                                   DEFAULT_RETRY_AFTER_S)


class EDF(Policy):
    """Earliest-deadline-first on the TTFT SLO: deadline = submit time +
    the request's TTFT target (engine/policy default when unset).  The
    preemption victim is the request with the LATEST deadline — the one
    that can best afford a recompute.

    With a model config attached, :meth:`admit_drop` additionally flags
    requests whose cost-model prefill estimate already overruns their
    deadline at admission time: serving them can only miss their SLO
    while burning prefill the in-SLO requests needed — dropping them is
    goodput-optimal.  The scheduler applies this only when its
    ``admission_control`` flag is on."""

    name = "edf"

    def __init__(self, slo_ttft: Optional[float] = None, *, cfg=None,
                 tier="h100-1", prefill_chunk: Optional[int] = None,
                 layout: str = "contiguous"):
        self.slo_ttft = slo_ttft if slo_ttft is not None else DEFAULT_TTFT_S
        self.cfg = cfg
        self.tier = _tier(tier)
        self.prefill_chunk = prefill_chunk
        self.layout = layout

    def deadline(self, req) -> float:
        slo = req.slo_ttft if req.slo_ttft is not None else self.slo_ttft
        return req.t_submit + slo

    def priority(self, req, now: float):
        return (self.deadline(req), req.rid)

    def admit_drop(self, req, now: float) -> bool:
        dl = self.deadline(req)
        if now >= dl:                 # deadline already passed in queue
            return True
        if self.cfg is None:
            return False
        from repro_torch.core.costmodel import service_estimate
        est = service_estimate(self.cfg, self.tier,
                               prompt=max(_remaining_prefill(req), 1),
                               gen=0, chunk=self.prefill_chunk,
                               layout=self.layout)
        return now + est["t_prefill_s"] > dl

    def retry_after(self, req, now: float, depth: int) -> float:
        # a shed EDF request's deadline is already blown; suggest coming
        # back after the backlog ahead of it has plausibly drained
        slack = max(self.deadline(req) - now, 0.0)
        return slack + max(depth, 1) * DEFAULT_RETRY_AFTER_S


def make_policy(name: str, *, cfg=None, tier="h100-1",
                slo_ttft: Optional[float] = None,
                prefill_chunk: Optional[int] = None,
                layout: str = "contiguous") -> Policy:
    name = name.lower()
    if name == "fcfs":
        return FCFS()
    if name == "sjf":
        if cfg is None:
            raise ValueError("sjf needs the model config for cost estimates")
        return SJF(cfg, tier, prefill_chunk=prefill_chunk, layout=layout)
    if name == "edf":
        return EDF(slo_ttft, cfg=cfg, tier=tier, prefill_chunk=prefill_chunk,
                   layout=layout)
    raise ValueError(f"unknown policy {name!r} (fcfs | sjf | edf)")

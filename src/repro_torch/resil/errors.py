"""Structured error taxonomy for overload-resilient serving (the port's
copy of ``repro/resil/errors.py``).

The scheduler's recovery logic keys on WHICH class of failure it sees,
not on string matching:

* :class:`TransientDispatchError` — a dispatch-boundary failure that is
  expected to succeed on retry (injected chaos faults).  ``SchedEngine``
  preempts-and-requeues the affected slots with bounded exponential
  backoff instead of propagating.
* :class:`InjectedFault` / :class:`InjectedPageFault` — the seeded
  fault-injection harness (``repro_torch.resil.inject``) raises these so
  recovery code (and tests) can tell a synthetic fault from a real one.
  ``InjectedPageFault`` subclasses
  :class:`~repro_torch.serve.paged.OutOfPagesError` so it rides the
  scheduler's evict-retry admission path.

Anything outside the taxonomy keeps propagating — a kernel fault on the
card above all: after an illegal address or a launch failure the CUDA
context is unusable, and a retry would run on corrupt state.

Every request retires with exactly one recorded outcome from
:data:`OUTCOMES`, surfaced through the ``resil_requests_total{outcome=}``
metric family and the trace ``request``-span end args.
"""
from __future__ import annotations

import torch

from repro_torch.serve.paged import OutOfPagesError

#: Request retirement outcomes (``Request.outcome``): normal completion,
#: load-shed (admission rejection with retry-after), wall-clock deadline
#: cancellation, and retries-exhausted / unservable failure.
OUTCOMES = ("ok", "shed", "timed_out", "failed")


class ResilienceError(RuntimeError):
    """Base class of the resilience taxonomy."""


class TransientDispatchError(ResilienceError):
    """A dispatch failed in a way that is expected to be recoverable:
    the scheduler preempts-and-requeues the affected slots (recompute-
    on-readmit makes that exact) and retries after backoff."""

    def __init__(self, msg: str = "", kind: str = "dispatch"):
        super().__init__(msg or f"transient {kind} failure")
        self.kind = kind


class InjectedFault(TransientDispatchError):
    """A fault raised by the seeded injection harness at an engine
    dispatch boundary (``repro_torch.resil.inject.FaultInjector``)."""


class InjectedPageFault(OutOfPagesError):
    """An injected spurious allocation failure.  Subclasses
    ``OutOfPagesError`` so the allocator's callers handle it through
    their existing evict/retry/wait paths; recovery code checks the
    subclass to avoid cancelling a feasible request over a synthetic
    fault."""


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` should be recovered via preempt-and-requeue: the
    taxonomy's transient errors, and device memory running out (torch's
    counterpart of XLA's RESOURCE_EXHAUSTED: the allocator raised before
    the launch, and the context stays usable).  A sticky CUDA error (an
    illegal address, a launch failure) arrives as a plain RuntimeError
    and is never transient."""
    return isinstance(exc, (TransientDispatchError, torch.OutOfMemoryError))

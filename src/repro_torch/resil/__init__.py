"""Overload-resilient serving of the port (the reference's
``repro.resil``): fault injection, graceful degradation, request-level
recovery.

* ``errors``  — the taxonomy recovery keys on:
  :class:`TransientDispatchError` (preempt-and-requeue with backoff),
  injected-fault markers, and the request outcome vocabulary
  (:data:`OUTCOMES` — ``ok | shed | timed_out | failed``; every request
  retires with exactly one).
* ``inject``  — :class:`FaultInjector`: a deterministic, seeded chaos
  harness hooked into the allocator (forced pool shrinkage, spurious
  page faults), every engine dispatch boundary (latency spikes,
  transient dispatch exceptions) and the spec drafter (degenerate
  proposals).  Disabled injection is sync-count- and token-identical to
  no injection at all.
* ``degrade`` — :class:`DegradationLadder`: monotone service rungs with
  asymmetric hysteresis (spec off -> smaller prefill chunks -> KV-int8
  hint -> load shedding with retry-after), driven by pressure signals
  already in the metrics registry.  Its cost-model pricing waits for
  ROADMAP A5.

``SchedEngine(injector=, ladder=, max_request_s=)`` wires all three in
(``PagedEngine`` takes the injector), and ``launch/serve --chaos
--degrade --max-request-s`` drives them end to end.
"""
from repro_torch.resil.degrade import RUNG_NAMES, DegradationLadder
from repro_torch.resil.errors import (OUTCOMES, InjectedFault,
                                      InjectedPageFault, ResilienceError,
                                      TransientDispatchError, is_transient)
from repro_torch.resil.inject import FAULT_KINDS, FaultInjector

__all__ = [
    "OUTCOMES", "ResilienceError", "TransientDispatchError",
    "InjectedFault", "InjectedPageFault", "is_transient",
    "FaultInjector", "FAULT_KINDS",
    "DegradationLadder", "RUNG_NAMES",
]

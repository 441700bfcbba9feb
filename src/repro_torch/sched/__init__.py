"""Serving scheduler of the port, layered over ``serve.PagedEngine``
(the port of ``repro/sched``):

* ``prefix``    — hash-chain prefix cache over the paged KV pools, backed
                  by the refcounted ``PageAllocator`` (full pages are
                  immutable, so shared prompt prefixes map several
                  block-table rows at the same physical pages and skip
                  their prefill entirely).
* ``policy``    — admission ordering / preemption-victim selection: FCFS
                  and deadline-EDF over per-request TTFT SLOs (SJF waits
                  for the cost model's H100 tier).
* ``scheduler`` — ``SchedEngine``: chunked prefill interleaved with
                  decode blocks, lazy page growth, preemption with
                  recompute-on-readmit, and telemetry.
"""
from repro_torch.sched.policy import (DEFAULT_TTFT_S, EDF, FCFS, Policy,
                                      make_policy)
from repro_torch.sched.prefix import PrefixCache
from repro_torch.sched.scheduler import SchedEngine, SchedStats

__all__ = ["DEFAULT_TTFT_S", "Policy", "FCFS", "EDF", "make_policy",
           "PrefixCache", "SchedEngine", "SchedStats"]

"""Serving scheduler of the port, layered over ``serve.PagedEngine``
(the port of ``repro/sched``):

* ``prefix``    — hash-chain prefix cache over the paged KV pools, backed
                  by the refcounted ``PageAllocator`` (full pages are
                  immutable, so shared prompt prefixes map several
                  block-table rows at the same physical pages and skip
                  their prefill entirely).
* ``policy``    — admission ordering / preemption-victim selection: FCFS,
                  cost-model SJF and deadline-EDF over per-request TTFT
                  SLOs (with admission control against the cost model's
                  prefill estimate).
* ``scheduler`` — ``SchedEngine``: chunked prefill interleaved with
                  decode blocks, lazy page growth, preemption with
                  recompute-on-readmit, and telemetry.
"""
from repro_torch.sched.policy import (DEFAULT_SJF_AGING, DEFAULT_TTFT_S,
                                      EDF, FCFS, SJF, Policy, make_policy)
from repro_torch.sched.prefix import PrefixCache
from repro_torch.sched.scheduler import SchedEngine, SchedStats

__all__ = ["DEFAULT_SJF_AGING", "DEFAULT_TTFT_S", "Policy", "FCFS", "SJF",
           "EDF", "make_policy",
           "PrefixCache", "SchedEngine", "SchedStats"]

"""Speculative decoding over the paged scheduler (the port of
``repro/spec``).

Speculative decoding is AE-LLM's canonical adaptive inference technique:
its win (draft acceptance) depends on the workload, so it is both a
``c_inf`` arm of the search space and an online loop (``controller``)
tuning each slot's draft length at run time.

* ``drafter``    — proposers: model-free n-gram prompt lookup, and a
                   small draft LM sharing the vocabulary, teacher-forced
                   on the confirmed stream over a contiguous bf16 cache.
* ``engine``     — ``SpecEngine(SchedEngine)``: draft -> one batched
                   multi-query paged verify (one dispatch, one host sync)
                   -> exact accept / reject -> commit of the accepted
                   tokens only.
* ``controller`` — acceptance EMA -> the cost model's best draft length.
* ``rollback``   — rollback / copy-on-write invariants: rejected drafts
                   never touch a live page; shared or prefix-cache pages
                   are copy-on-written before any speculative commit.

Greedy speculative output is token-identical to plain greedy decode (the
verify scores the same conditionals, and the commit replays the decode
path's writes, bf16 and quantized pools alike); sampled output follows
the exact rejection rule for deterministic proposals, so its
distribution is the target model's.
"""
from repro_torch.spec.controller import AdaptiveDraftController
from repro_torch.spec.drafter import (DraftLMDrafter, NgramDrafter,
                                      draft_config_of)
from repro_torch.spec.engine import SpecEngine, SpecStats, spec_accept
from repro_torch.spec.rollback import (copy_page_device,
                                       ensure_exclusive_tail,
                                       rollback_length, span_pages)

__all__ = [
    "AdaptiveDraftController",
    "NgramDrafter", "DraftLMDrafter", "draft_config_of",
    "SpecEngine", "SpecStats", "spec_accept",
    "ensure_exclusive_tail", "rollback_length", "copy_page_device",
    "span_pages",
]

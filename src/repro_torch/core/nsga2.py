"""NSGA-II with the paper's enhancements (§3.3.2).

The port's copy of ``repro/core/nsga2.py`` (numpy only; the same
generator calls in the same order, so a seed gives the reference's
populations).

* constraint-aware initialization (Eq. 6): rejection-sample configs whose
  *predicted* memory/power fit the hardware tier;
* hierarchical crossover (Eq. 7): stage-wise recombination — each of
  (arch, ft, inf) is inherited atomically from either parent;
* stage-specific mutation rates (Eq. 8): p_arch=0.1, p_ft=0.2, p_inf=0.15;
* crowding-distance diversity preservation.

Objectives are 4-vectors [acc, lat, mem, energy] from a user-supplied
``evaluate_fn`` (surrogate predictions during search; Algorithm 1 swaps in
real evaluations for refinement).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.pareto import (ParetoArchive, crowding_distance,
                                     non_dominated_sort, to_min)
from repro_torch.core.space import (ATTENTION_KINDS, FT_ALPHA_MULT,
                                    FT_METHODS, FT_RANKS, KV_STYLES,
                                    MOE_EXPERTS, MOE_TOPK, QUANT_METHODS,
                                    QUANTS, SPEC_ARMS, SPEC_DRAFT_KS,
                                    ArchChoice, EfficiencyConfig, FtChoice,
                                    InfChoice, SpaceMask, sample_config)

P_MUT = {"arch": 0.1, "ft": 0.2, "inf": 0.15}      # Eq. 8
P_CROSS = 0.9


def _mutate_arch(a: ArchChoice, rng, mask: SpaceMask) -> ArchChoice:
    field = rng.integers(0, 3)
    if field == 0 and mask.attention_arms:
        a = dataclasses.replace(a, attention=str(rng.choice(ATTENTION_KINDS)))
    elif field == 1 and mask.moe_arms:
        e = int(rng.choice(MOE_EXPERTS))
        a = dataclasses.replace(a, moe_experts=e,
                                moe_top_k=1 if e == 0 else
                                min(a.moe_top_k, e))
    else:
        if a.moe_experts > 0:
            a = dataclasses.replace(
                a, moe_top_k=int(rng.choice(
                    [k for k in MOE_TOPK if k <= a.moe_experts])))
    return a


def _mutate_ft(f: FtChoice, rng) -> FtChoice:
    field = rng.integers(0, 3)
    if field == 0:
        m = str(rng.choice(FT_METHODS))
        if m == "full":
            return FtChoice("full", 0, 1)
        return FtChoice(m, f.rank or 16, f.alpha_mult)
    if f.method == "full":
        return f
    if field == 1:
        return dataclasses.replace(f, rank=int(rng.choice(FT_RANKS)))
    return dataclasses.replace(f, alpha_mult=int(rng.choice(FT_ALPHA_MULT)))


def _mutate_inf(i: InfChoice, rng, mask: SpaceMask) -> InfChoice:
    field = rng.integers(0, 4)
    if field == 0:
        return dataclasses.replace(i, quant=str(rng.choice(QUANTS)))
    if field == 1:
        return dataclasses.replace(i,
                                   quant_method=str(rng.choice(QUANT_METHODS)))
    if field == 2:
        if mask.kv_arms:
            return dataclasses.replace(i, kv_style=str(rng.choice(KV_STYLES)))
        return i
    # spec arm rides the paged (attention) serving path; same mask as kv
    if not mask.kv_arms:
        return i
    sp = str(rng.choice(SPEC_ARMS))
    # canonicalize the none arm's draft_k (matches enumerate/sample) so
    # semantically identical configs dedupe in the tuner/archive
    return dataclasses.replace(
        i, spec=sp, draft_k=SPEC_DRAFT_KS[1] if sp == "none"
        else int(rng.choice(SPEC_DRAFT_KS)))


def mutate(c: EfficiencyConfig, rng,
           mask: SpaceMask = SpaceMask()) -> EfficiencyConfig:
    arch, ft, inf = c.arch, c.ft, c.inf
    if rng.random() < P_MUT["arch"]:
        arch = _mutate_arch(arch, rng, mask)
    if rng.random() < P_MUT["ft"]:
        ft = _mutate_ft(ft, rng)
    if rng.random() < P_MUT["inf"]:
        inf = _mutate_inf(inf, rng, mask)
    return EfficiencyConfig(arch, ft, inf)


def hierarchical_crossover(c1: EfficiencyConfig, c2: EfficiencyConfig,
                           rng) -> EfficiencyConfig:
    """Eq. 7: stage-wise recombination."""
    return EfficiencyConfig(
        arch=c1.arch if rng.random() < 0.5 else c2.arch,
        ft=c1.ft if rng.random() < 0.5 else c2.ft,
        inf=c1.inf if rng.random() < 0.5 else c2.inf)


def constrained_init(pop_size: int, rng, feasible_fn,
                     mask: SpaceMask = SpaceMask(),
                     max_tries: int = 50) -> List[EfficiencyConfig]:
    """Eq. 6: population seeded with predicted-feasible configs."""
    pop = []
    tries = 0
    while len(pop) < pop_size and tries < max_tries * pop_size:
        c = sample_config(rng, mask)
        tries += 1
        if feasible_fn(c):
            pop.append(c)
    while len(pop) < pop_size:                     # fallback: relax
        pop.append(sample_config(rng, mask))
    return pop


def _tournament(rng, ranks, crowd, k: int = 3) -> int:
    cands = rng.integers(0, len(ranks), k)
    best = cands[0]
    for c in cands[1:]:
        if (ranks[c] < ranks[best]) or (
                ranks[c] == ranks[best] and crowd[c] > crowd[best]):
            best = c
    return int(best)


def nsga2_search(evaluate_fn: Callable, feasible_fn: Callable, *,
                 pop_size: int = 64, generations: int = 30,
                 mask: SpaceMask = SpaceMask(), seed: int = 0,
                 archive: Optional[ParetoArchive] = None,
                 use_crossover: bool = True,
                 use_constrained_init: bool = True,
                 ) -> Tuple[ParetoArchive, list]:
    """evaluate_fn(list[config]) -> (n,4) objectives [acc,lat,mem,en].
    ``use_crossover`` / ``use_constrained_init`` exist for the paper's
    Table-3 component ablations."""
    rng = np.random.default_rng(seed)
    archive = archive or ParetoArchive()
    if use_constrained_init:
        pop = constrained_init(pop_size, rng, feasible_fn, mask)
    else:
        pop = [sample_config(rng, mask) for _ in range(pop_size)]
    objs = np.asarray(evaluate_fn(pop), np.float64)
    history = []

    for gen in range(generations):
        m = to_min(objs)
        fronts = non_dominated_sort(m)
        ranks = np.zeros(len(pop), int)
        crowd = np.zeros(len(pop))
        for r, fr in enumerate(fronts):
            ranks[fr] = r
            crowd[fr] = crowding_distance(m[fr])
        for i in fronts[0]:
            archive.add(pop[i], objs[i])
        history.append({"gen": gen,
                        "front_size": len(fronts[0]),
                        "best_acc": float(objs[:, 0].max()),
                        "best_lat": float(objs[:, 1].min())})

        # offspring
        children = []
        while len(children) < pop_size:
            p1 = pop[_tournament(rng, ranks, crowd)]
            p2 = pop[_tournament(rng, ranks, crowd)]
            child = hierarchical_crossover(p1, p2, rng) \
                if (use_crossover and rng.random() < P_CROSS) else p1
            child = mutate(child, rng, mask)
            children.append(child)
        child_objs = np.asarray(evaluate_fn(children), np.float64)

        # environmental selection over parents+children
        all_pop = pop + children
        all_objs = np.concatenate([objs, child_objs])
        feas = np.array([feasible_fn(c) for c in all_pop])
        # infeasible solutions are demoted (constraint domination)
        m = to_min(all_objs)
        m[~feas] += 1e6
        fronts = non_dominated_sort(m)
        new_idx: list = []
        for fr in fronts:
            if len(new_idx) + len(fr) <= pop_size:
                new_idx.extend(fr.tolist())
            else:
                cd = crowding_distance(m[fr])
                order = np.argsort(-cd, kind="stable")
                need = pop_size - len(new_idx)
                new_idx.extend(fr[order[:need]].tolist())
                break
        pop = [all_pop[i] for i in new_idx]
        objs = all_objs[new_idx]

    for i, c in enumerate(pop):
        archive.add(c, objs[i])
    return archive, history

"""Table 3 — ablations on LLaMA-2-7B: search-algorithm components,
configuration-space components, refinement iterations."""
from __future__ import annotations

import numpy as np

from repro_torch.core.pareto import efficiency_score
from repro_torch.core.space import SpaceMask, sample_config, space_for_family
from repro_torch.core.tuner import AutoTuner, recommend_efficient
from repro_torch.tables.common import (LM_TASKS, best_single_stage,
                                       default_config, dump, evaluator)

MODEL = "llama2-7b"
TASKS = LM_TASKS[:5]


class _MT:
    def __init__(self, evs):
        self.evs = evs
        self.cfg = evs[0].cfg
        self.n = 0

    def evaluate(self, eff):
        self.n += 1
        return np.mean([e.evaluate(eff) for e in self.evs], axis=0)

    def feasible(self, eff):
        return self.evs[0].feasible(eff)


def _mt(seed=0):
    return _MT([evaluator(MODEL, t, seed=seed) for t in TASKS])


def _score(eff, base, mt):
    if eff is None:
        return 0.0
    o = mt.evaluate(eff)
    return efficiency_score(o, base)


def _run_tuner(mt, *, mask=None, refine_iters=3, use_crossover=True,
               use_constrained_init=True, seed=0):
    import repro_torch.core.tuner as tuner_mod
    from repro_torch.core.nsga2 import nsga2_search as real_search

    def patched(eval_fn, feas_fn, **kw):
        kw.setdefault("use_crossover", use_crossover)
        kw.setdefault("use_constrained_init", use_constrained_init)
        return real_search(eval_fn, feas_fn, **kw)

    old = tuner_mod.nsga2_search
    tuner_mod.nsga2_search = patched
    try:
        t = AutoTuner(mt, mask=mask or space_for_family("dense"),
                      n0=64, refine_iters=refine_iters, k_per_iter=8,
                      pop_size=32, generations=12, seed=seed)
        report = t.run()
    finally:
        tuner_mod.nsga2_search = old
    base = mt.evaluate(default_config())
    eff, _ = recommend_efficient(report.archive, base)
    return eff, base


def _random_search(mt, budget, seed=0):
    """- Predictive Models ablation: same real-eval budget, no surrogates."""
    rng = np.random.default_rng(seed)
    base = mt.evaluate(default_config())
    best, best_s = None, -1.0
    for _ in range(budget):
        c = sample_config(rng, space_for_family("dense"))
        o = mt.evaluate(c)
        if o[0] < base[0] - 1.2:
            continue
        s = efficiency_score(o, base)
        if s > best_s:
            best, best_s = c, s
    return best, base


def run(seed: int = 0) -> dict:
    rows = {}

    # --- search-algorithm components -----------------------------------
    mt = _mt(seed)
    eff, base = _run_tuner(mt, seed=seed)
    full_budget = mt.n
    rows["Full AdaptiveEfficientLLM"] = _score(eff, base, mt)

    mt = _mt(seed)
    eff, base = _random_search(mt, full_budget, seed=seed)
    rows["- Predictive Models (random search)"] = _score(eff, base, mt)

    mt = _mt(seed)
    eff, base = _run_tuner(mt, use_constrained_init=False, seed=seed)
    rows["- Constraint-Aware Pruning"] = _score(eff, base, mt)

    mt = _mt(seed)
    eff, base = _run_tuner(mt, use_crossover=False, seed=seed)
    rows["- Hierarchical Crossover"] = _score(eff, base, mt)

    mt = _mt(seed)
    eff, base = _run_tuner(mt, refine_iters=0, seed=seed)
    rows["- Refinement Iterations"] = _score(eff, base, mt)

    # --- configuration-space components ---------------------------------
    def masked(**kw):
        mt = _mt(seed)
        eff, base = _run_tuner(mt, mask=SpaceMask(**kw), seed=seed)
        return _score(eff, base, mt)

    rows["- Architecture Options"] = masked(attention_arms=False,
                                            moe_arms=False)
    rows["- MoE Configurations"] = masked(moe_arms=False)

    # stage-restricted spaces (single-stage searches)
    mt = _mt(seed)
    base = mt.evaluate(default_config())
    arch_only = best_single_stage(MODEL, TASKS, seed=seed)
    rows["Best arch-only (single stage)"] = _score(arch_only, base, mt)

    # --- refinement iterations sweep -------------------------------------
    for r in (0, 1, 2, 3):
        mt = _mt(seed)
        eff, base = _run_tuner(mt, refine_iters=r, seed=seed)
        rows[f"{r} refinement iterations"] = _score(eff, base, mt)

    rows = {k: round(float(v), 3) for k, v in rows.items()}
    checks = {
        "random_worse_than_full": rows["- Predictive Models (random search)"]
        <= rows["Full AdaptiveEfficientLLM"] + 0.05,
        "no_refine_worse": rows["- Refinement Iterations"]
        <= rows["Full AdaptiveEfficientLLM"] + 0.05,
        "restricted_space_worse": rows["- Architecture Options"]
        <= rows["Full AdaptiveEfficientLLM"] + 0.05,
        "refine_monotone-ish": rows["3 refinement iterations"]
        >= rows["0 refinement iterations"] - 0.05,
    }
    payload = {"rows": rows, "checks": checks}
    dump("table3_ablations", payload)
    print("\n== Table 3: ablations (LLaMA-2-7B) ==")
    for k, v in rows.items():
        print(f"  {k:42s} {v:6.3f}")
    print(f"[table3] checks: {checks}")
    return payload


if __name__ == "__main__":
    run()

"""Table 6 — per-task accuracy detail for selected models: AE-LLM's
task-specific configs keep accuracy within ~0.5 pts of Default on every
task while the static baselines drop more."""
from __future__ import annotations

import numpy as np

from repro_torch.tables.common import (LM_TASKS, aellm_select,
                                       best_single_stage, default_config,
                                       dump, efficientllm_recommendation,
                                       evaluator, manual_selection)

MODELS = ["llama2-7b", "mistral-7b", "llama2-70b"]


def run(seed: int = 0) -> dict:
    out = {}
    for m in MODELS:
        methods = {
            "Default": lambda t: default_config(),
            "Best Single-Stage":
                (lambda c: (lambda t: c))(best_single_stage(
                    m, LM_TASKS, seed=seed)),
            "Manual Selection": (lambda t: manual_selection(m)),
            "EfficientLLM Rec.":
                (lambda c: (lambda t: c))(efficientllm_recommendation(
                    m, seed=seed)),
            # AE-LLM is task-specific: one search per task
            "AdaptiveEfficientLLM":
                (lambda t: aellm_select(m, [t], seed=seed)),
        }
        table = {}
        for name, pick in methods.items():
            row = {}
            for t in LM_TASKS:
                eff = pick(t)
                acc = float(evaluator(m, t, seed=seed).evaluate(eff)[0])
                row[t] = round(acc, 2)
            row["avg"] = round(float(np.mean(list(row.values()))), 2)
            table[name] = row
        out[m] = table
        print(f"[table6] {m}: default avg {table['Default']['avg']} "
              f"aellm avg {table['AdaptiveEfficientLLM']['avg']}")

    checks = {}
    for m in MODELS:
        d = out[m]["Default"]["avg"]
        a = out[m]["AdaptiveEfficientLLM"]["avg"]
        checks[m] = {"delta": round(a - d, 3), "within_1p2": a >= d - 1.2,
                     "aellm_best_nondefault": a >= max(
                         out[m][k]["avg"] for k in out[m]
                         if k not in ("Default",)) - 1e-9}
    payload = {"rows": out, "checks": checks}
    dump("table6_tasks", payload)
    print(f"[table6] checks: {checks}")
    return payload


if __name__ == "__main__":
    run()

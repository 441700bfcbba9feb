"""Table 4 — cross-modal generalization: AE-LLM on vision-language
models (VQAv2 / COCO-Caption / TextVQA), vs Default + EfficientLLM."""
from __future__ import annotations

import numpy as np

from repro_torch.core.pareto import efficiency_score
from repro_torch.tables.common import (VLM_TASKS, aellm_select, avg_objs,
                                       default_config, dump,
                                       efficientllm_recommendation,
                                       print_table)

MODELS = ["llava-1.5-7b", "llama-3.2-vision-11b"]


def run(seed: int = 0) -> dict:
    out = {}
    for m in MODELS:
        per_task = {}
        for t in VLM_TASKS:
            base = avg_objs(m, default_config(), [t], seed=seed)
            rows = {}
            for name, eff in (
                    ("Default", default_config()),
                    ("EfficientLLM Rec.",
                     efficientllm_recommendation(m, seed=seed)),
                    ("AdaptiveEfficientLLM",
                     aellm_select(m, [t], seed=seed))):
                o = avg_objs(m, eff, [t], seed=seed)
                rows[name] = {
                    "acc": round(float(o[0]), 2),
                    "lat_ms": round(float(o[1]), 2),
                    "mem_gb": round(float(o[2]), 2),
                    "energy_j": round(float(o[3]), 4),
                    "eff_score": round(efficiency_score(o, base), 3),
                    "config": str(eff),
                }
            per_task[t] = rows
        out[m] = per_task

    scores = [out[m][t]["AdaptiveEfficientLLM"]["eff_score"]
              for m in MODELS for t in VLM_TASKS]
    accd = [out[m][t]["AdaptiveEfficientLLM"]["acc"]
            - out[m][t]["Default"]["acc"]
            for m in MODELS for t in VLM_TASKS]
    summary = {
        "vlm_mean_score": round(float(np.mean(scores)), 3),
        "vlm_mean_acc_delta": round(float(np.mean(accd)), 3),
        "generalizes": bool(np.mean(scores) > 1.3),
    }
    payload = {"rows": out, "summary": summary}
    dump("table4_vlm", payload)
    print("\n== Table 4: VLM generalization ==")
    for m in MODELS:
        for t in VLM_TASKS:
            print_table(f"{m} / {t}", {f"{m}:{t}": out[m][t]})
    print(f"[table4] summary: {summary}")
    return payload


if __name__ == "__main__":
    run()

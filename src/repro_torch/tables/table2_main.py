"""Table 2 — main results: 5 methods × model roster, averaged over the
10 LM tasks.  Reproduced claims: AE-LLM efficiency score ≈ 1.7–2.2×
(avg ~1.98 in the paper, growing with scale), accuracy within 1.2% of
Default, Best-Single-Stage/Manual/EfficientLLM ordered between."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.tables.common import (LARGE, LM_TASKS, MEDIUM, SMALL, dump,
                                       method_rows, print_table)


def run(models=None, tasks=None, *, seed: int = 0) -> dict:
    models = models or (SMALL[:2] + MEDIUM[:2] + LARGE[:2])
    tasks = tasks or LM_TASKS
    out = {}
    for m in models:
        t0 = time.time()
        out[m] = method_rows(m, tasks, seed=seed)
        print(f"[table2] {m} done in {time.time()-t0:.1f}s "
              f"(AE-LLM score {out[m]['AdaptiveEfficientLLM']['eff_score']})")
    # paper-claim validation
    scores = [out[m]["AdaptiveEfficientLLM"]["eff_score"] for m in models]
    accs = [out[m]["AdaptiveEfficientLLM"]["acc"] - out[m]["Default"]["acc"]
            for m in models]
    summary = {
        "aellm_mean_score": round(float(np.mean(scores)), 3),
        "aellm_mean_acc_delta": round(float(np.mean(accs)), 3),
        "all_within_1p2": bool(all(a >= -1.2 for a in accs)),
        "beats_all_baselines": bool(all(
            out[m]["AdaptiveEfficientLLM"]["eff_score"]
            >= max(out[m][k]["eff_score"]
                   for k in ("Best Single-Stage", "Manual Selection",
                             "EfficientLLM Rec.")) - 0.05
            for m in models)),
    }
    payload = {"rows": out, "summary": summary}
    dump("table2_main", payload)
    print_table("Table 2: main results (5 methods)", out)
    print(f"[table2] summary: {summary}")
    return payload


if __name__ == "__main__":
    run()

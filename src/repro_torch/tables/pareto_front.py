"""Figure 2 — Pareto fronts (accuracy–latency trade-off) per model, and
Figure 1 — distribution of optimal configuration choices across tasks
and hardware tiers."""
from __future__ import annotations

import collections

from repro_torch.tables.common import dump, evaluator
from repro_torch.core.space import space_for_family
from repro_torch.core.tuner import AutoTuner
from repro_torch.core.features import TASKS
from repro_torch.core.costmodel import TIERS
from repro_torch.core.evaluator import Evaluator
from repro_torch.configs import get_config

MODELS = ["llama2-7b", "llama2-70b"]


def front_for(model: str, task: str, *, seed=0):
    ev = evaluator(model, task, seed=seed)
    tuner = AutoTuner(ev, mask=space_for_family(ev.cfg.family), n0=64,
                      refine_iters=1, k_per_iter=8, pop_size=32,
                      generations=12, seed=seed)
    report = tuner.run()
    pts = [{"config": str(c), "acc": float(o[0]), "lat_ms": float(o[1]),
            "mem_gb": float(o[2]), "energy_j": float(o[3])}
           for c, o in report.archive.front()]
    pts.sort(key=lambda p: p["lat_ms"])
    return pts


def config_distribution(*, seed=0):
    """Figure 1: optimal-config choice frequencies across tasks × tiers."""
    counts = {"attention": collections.Counter(),
              "quant": collections.Counter(),
              "ft": collections.Counter(),
              "by_tier_quant": collections.defaultdict(collections.Counter)}
    from repro_torch.core.tuner import recommend_efficient
    from repro_torch.core.space import EfficiencyConfig
    for task in ("mmlu", "gsm8k", "longbench"):
        for tier in ("consumer", "datacenter", "high_perf"):
            cfg = get_config("llama2-7b")
            ev = Evaluator(cfg, TASKS[task], TIERS[tier], seed=seed)
            tuner = AutoTuner(ev, mask=space_for_family(cfg.family), n0=48,
                              refine_iters=1, k_per_iter=6, pop_size=24,
                              generations=10, seed=seed)
            report = tuner.run()
            base = ev.evaluate(EfficiencyConfig.default())
            eff, _ = recommend_efficient(report.archive, base)
            if eff is None:
                continue
            counts["attention"][eff.arch.attention] += 1
            counts["quant"][eff.inf.quant] += 1
            counts["ft"][eff.ft.method] += 1
            counts["by_tier_quant"][tier][eff.inf.quant] += 1
    return {k: (dict(v) if not isinstance(v, collections.defaultdict)
                else {kk: dict(vv) for kk, vv in v.items()})
            for k, v in counts.items()}


def run(seed: int = 0) -> dict:
    fronts = {}
    for m in MODELS:
        pts = front_for(m, "mmlu", seed=seed)
        fronts[m] = pts
        lats = [p["lat_ms"] for p in pts]
        accs = [p["acc"] for p in pts]
        print(f"[pareto] {m}: {len(pts)} points, lat "
              f"{min(lats):.0f}–{max(lats):.0f}ms, acc "
              f"{min(accs):.1f}–{max(accs):.1f}")
    dist = config_distribution(seed=seed)
    payload = {"fronts": fronts, "config_distribution": dist}
    dump("pareto_fronts", payload)
    print(f"[fig1] config distribution: { {k: v for k, v in dist.items() if k != 'by_tier_quant'} }")
    # consumer tier must lean harder on low-bit quantization (paper §5.1)
    return payload


if __name__ == "__main__":
    run()

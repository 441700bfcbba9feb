"""Entry point of the paper's tables on the port's H100 tiers — one module
per paper table/figure (the port's copy of ``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.tables.run [--only table2,table3,...]

Numpy only: the search and the cost model run on the CPU.  Artifacts land
in experiments/bench_torch/*.json (analytic estimates at data-sheet H100
tiers, not card measurements); a summary is printed and the paper-claim
checks are aggregated at the end.
"""
from __future__ import annotations

import argparse
import sys
import time


def _from_artifacts() -> int:
    """Print every table + paper-claim summary from the JSON artifacts
    of the last full run (experiments/bench_torch/*.json) without re-running
    the searches — used on slow/1-core containers."""
    import json
    from repro_torch.tables.common import OUT_DIR, print_table
    results = {}
    for name in ("table2_main", "table3_ablations", "table4_vlm",
                 "table6_tasks", "pareto_fronts"):
        p = OUT_DIR / f"{name}.json"
        if not p.exists():
            print(f"[tables] missing artifact {p}")
            continue
        d = json.loads(p.read_text())
        import datetime
        ts = datetime.datetime.fromtimestamp(p.stat().st_mtime)
        print(f"\n### {name} (artifact written {ts:%Y-%m-%d %H:%M}) ###")
        if name == "table2_main":
            print_table("Table 2: main results (5 methods)", d["rows"])
            results[name] = d["summary"]
        elif name == "table3_ablations":
            for k, v in d["rows"].items():
                print(f"  {k:42s} {v:6.3f}")
            results[name] = d["checks"]
        elif name == "table4_vlm":
            for m, per_task in d["rows"].items():
                for t, rows in per_task.items():
                    print_table(f"{m} / {t}", {f"{m}:{t}": rows})
            results[name] = d["summary"]
        elif name == "table6_tasks":
            for m, table in d["rows"].items():
                print(f"  {m}: " + "  ".join(
                    f"{meth}={row['avg']}" for meth, row in table.items()))
            results[name] = d["checks"]
        else:
            for m, pts in d["fronts"].items():
                lats = [p_["lat_ms"] for p_ in pts]
                accs = [p_["acc"] for p_ in pts]
                print(f"  {m}: {len(pts)} Pareto points, lat "
                      f"{min(lats):.0f}-{max(lats):.0f}ms, acc "
                      f"{min(accs):.1f}-{max(accs):.1f}")
            results[name] = d.get("config_distribution")
    print("\n== table summary (from artifacts) ==")
    ok = True
    for k, v in results.items():
        print(f"  {k}: {v}")
        if isinstance(v, dict):
            for cv in v.values():
                if isinstance(cv, bool):
                    ok &= cv
                elif isinstance(cv, dict):
                    ok &= all(x for x in cv.values()
                              if isinstance(x, bool))
    print(f"[tables] paper-claim checks: "
          f"{'ALL PASS' if ok else 'SEE ABOVE'}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", default=None,
                    help="comma list: table2,table3,table4,table6,pareto")
    ap.add_argument("--from-artifacts", action="store_true",
                    help="summarize the existing experiments/bench_torch JSONs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.from_artifacts:
        return _from_artifacts()
    want = set(args.only.split(",")) if args.only else \
        {"table2", "table3", "table4", "table6", "pareto"}

    results = {}
    t00 = time.time()
    if "table2" in want:
        from repro_torch.tables import table2_main
        results["table2"] = table2_main.run(seed=args.seed)["summary"]
    if "table3" in want:
        from repro_torch.tables import table3_ablations
        results["table3"] = table3_ablations.run(seed=args.seed)["checks"]
    if "table4" in want:
        from repro_torch.tables import table4_vlm
        results["table4"] = table4_vlm.run(seed=args.seed)["summary"]
    if "table6" in want:
        from repro_torch.tables import table6_tasks
        results["table6"] = table6_tasks.run(seed=args.seed)["checks"]
    if "pareto" in want:
        from repro_torch.tables import pareto_front
        pareto_front.run(seed=args.seed)
        results["pareto"] = "experiments/bench_torch/pareto_fronts.json"

    print(f"\n== table summary ({time.time()-t00:.0f}s) ==")
    ok = True
    for k, v in results.items():
        print(f"  {k}: {v}")
        if isinstance(v, dict):
            for ck, cv in v.items():
                if isinstance(cv, bool):
                    ok &= cv
    print(f"[tables] paper-claim checks: {'ALL PASS' if ok else 'SEE ABOVE'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

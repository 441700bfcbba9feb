"""Read the idle card's power draw, the ``idle_watts`` of the cost model's
H100 tier (``repro_torch.core.costmodel``).

    python -m repro_torch.launch.idle_power [--samples 10 --interval 1]

Samples ``nvidia-smi --query-gpu=name,power.limit,power.draw`` on card 0
before this process touches CUDA, and prints each sample, then one JSON
line with the card's name, its power limit and the median draw.  Exits
non-zero when ``nvidia-smi`` is missing or reads no card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time


def _read() -> tuple:
    out = subprocess.run(
        ["nvidia-smi", "--id=0",
         "--query-gpu=name,power.limit,power.draw",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.strip()
    name, limit, draw = (x.strip() for x in out.split(","))
    return name, float(limit), float(draw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between samples")
    args = ap.parse_args(argv)
    draws = []
    for i in range(args.samples):
        if i:
            time.sleep(args.interval)
        name, limit, draw = _read()
        draws.append(draw)
        print(f"[idle_power] {name}, limit {limit} W: draw {draw} W")
    print(json.dumps({"name": name, "power_limit_w": limit,
                      "idle_draw_w": statistics.median(draws),
                      "min_w": min(draws), "max_w": max(draws),
                      "samples": len(draws)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

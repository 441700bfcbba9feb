"""Where the time of the port's paged serving goes, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve

Builds qwen2-1.5b at full width (random weights from seed 0) on the main
path's engine settings (8 slots, page 256, ``decode_block`` 8), admits
8 requests of 512 tokens in one batched prefill, then runs 4 fused
decode blocks — each phase once untraced (host wall clock) and
once under ``torch.profiler`` (device time of every kernel).  Prints,
per phase, wall time, device busy time (the sum of kernel times: one
stream, so kernels do not overlap), the device's idle share, and the
kernels that take the most device time; the last line is the same as
JSON, with the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import LM
from repro_torch.serve.engine import PagedEngine

SLOTS, PROMPT, BLOCKS, DECODE_BLOCK, SEED, TOP = 8, 512, 4, 8, 0, 8


def _device_kernels(prof) -> dict:
    """{kernel name: total device ms} over the profiled window."""
    out: dict = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key] = out.get(ev.key, 0.0) + t / 1e3
    return out


def _phase(name: str, run) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    busy = sum(kernels.values())
    if busy <= 0:
        raise RuntimeError(f"{name}: the profiler saw no device time")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    res = {"phase": name, "wall_ms": wall, "device_busy_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall),
           "top_kernels_ms": {k[:80]: v for k, v in ranked}}
    print(f"[{name}] wall {wall:.3f} ms (untraced), device busy "
          f"{busy:.3f} ms, idle share {res['idle_share']:.3f}")
    for k, v in ranked:
        print(f"    {v:9.3f} ms  {k[:100]}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-1.5b")
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    rng = np.random.default_rng(SEED)
    budget = DECODE_BLOCK * BLOCKS * 3 + 2      # covers 2 x BLOCKS + 1 blocks

    def fresh_engine():
        eng = PagedEngine(lm, params, n_slots=SLOTS,
                          max_len=PROMPT + budget + 1, page_size=256,
                          decode_block=DECODE_BLOCK, seed=SEED)
        for _ in range(SLOTS):
            eng.submit(rng.integers(0, cfg.vocab_size, (PROMPT,)),
                       max_new_tokens=budget)
        return eng

    warm = fresh_engine()                      # first launches, cuBLAS
    warm.step()
    engines = [fresh_engine(), fresh_engine()]  # one per admission run

    def admit():
        e = engines.pop()
        e._dispatch_admit(e._try_admit(), [])

    results = [
        _phase(f"admit {SLOTS}x{PROMPT}", admit),
        _phase(f"decode {BLOCKS}x{DECODE_BLOCK} steps, {SLOTS} slots",
               lambda: [warm._dispatch_decode([]) for _ in range(BLOCKS)])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "config": cfg.name,
                      "phases": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

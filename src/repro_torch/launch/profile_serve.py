"""Where the time of the port's serving goes, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--quant int8|fp8|int4] [--kv-dtype int8|fp8]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch rwkv6-1.6b

Builds qwen2-1.5b at full width (random weights from seed 0) on the main
path's engine settings (8 slots, page 256, ``decode_block`` 8), admits
8 requests of 512 tokens in one batched prefill, then runs 4 fused
decode blocks, then one continuation-chunk dispatch of the scheduler
(``LM.prefill_paged``: 8 rows of 512 tokens over prefixes of 512-3072
tokens, the shapes of ``chip_smoke.py`` phase 7) — each phase once
untraced (host wall clock) and once under ``torch.profiler`` (device
time of every kernel).  Prints,
per phase, wall time, device busy time (the sum of kernel times: one
stream, so kernels do not overlap), the device's idle share, the number
of kernels the device ran, and the kernels that take the most device
time; the last line is the same as
JSON, with the card's name and power limit.  ``--quant`` quantizes the
weights after ``LM.init`` and ``--kv-dtype`` stores the page pools in
int8 / fp8 (the quantized serving drive of ``chip_smoke.py``); without
them the drive is bf16 throughout.

``--arch rwkv6-1.6b`` profiles the eager ``Engine`` on rwkv6-1.6b at full
width instead (24 layers, random weights from seed 0; ``chip_smoke.py``
phase 13's settings, 8 slots): one admission of 2,048 tokens (the WKV-6
kernel in every layer), then 32 decode steps with that request active.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kvcache import normalize_dtype
from repro_torch.models.model import LM
from repro_torch.quant import quantize_tree
from repro_torch.serve.engine import Engine, PagedEngine

SLOTS, PROMPT, BLOCKS, DECODE_BLOCK, SEED, TOP = 8, 512, 4, 8, 0, 8
RWKV_PROMPT, RWKV_STEPS = 2048, 32
#: the continuation chunk's prefixes, one per row (page-aligned)
CONT_STARTS = (512, 1024, 1536, 2048, 2560, 3072, 1024, 2048)


def _device_kernels(prof) -> tuple[dict, int]:
    """({kernel name: total device ms}, number of kernel runs) over the
    profiled window."""
    out: dict = {}
    runs = 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key] = out.get(ev.key, 0.0) + t / 1e3
            runs += ev.count
    return out, runs


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
    kernels, runs = _device_kernels(prof)
    busy = sum(kernels.values())
    if busy <= 0:
        raise RuntimeError(f"{name}: the profiler saw no device time")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    res = {"phase": name, "wall_ms": wall, "device_busy_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall),
           "kernel_runs": runs,
           "top_kernels_ms": {k[:80]: v for k, v in ranked}}
    print(f"[{name}] wall {wall:.3f} ms (untraced), device busy "
          f"{busy:.3f} ms, idle share {res['idle_share']:.3f}, "
          f"{runs} kernel runs")
    for k, v in ranked:
        print(f"    {v:9.3f} ms  {k[:100]}")
    return res


def _rwkv_phases() -> tuple:
    """rwkv6-1.6b through the eager ``Engine``: one admission of
    RWKV_PROMPT tokens, then RWKV_STEPS decode steps."""
    cfg = get_config("rwkv6-1.6b")
    lm = LM(cfg, device="cuda")
    rng = np.random.default_rng(SEED)
    eng = Engine(lm, lm.init(SEED), n_slots=SLOTS, max_len=4096, seed=SEED)
    prompt = rng.integers(0, cfg.vocab_size, (RWKV_PROMPT,))
    # warm-up (first launches, cuBLAS), and one request that stays active
    # through every decode step below
    eng.submit(prompt, max_new_tokens=4 * RWKV_STEPS)
    eng.step()
    results = [
        _phase(f"admit 1x{RWKV_PROMPT}",
               lambda: eng._prefill_slot(prompt, SLOTS - 1).cpu()),
        _phase(f"decode {RWKV_STEPS} steps, {SLOTS} slots (1 active)",
               lambda: [eng.step() for _ in range(RWKV_STEPS)])]
    return cfg, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=["qwen2-1.5b", "rwkv6-1.6b"])
    ap.add_argument("--quant", default="bf16",
                    choices=["bf16", "fp8", "int8", "int4"])
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=["bf16", "bfloat16", "int8", "fp8"])
    args = ap.parse_args(argv)
    if args.arch == "rwkv6-1.6b" and (args.quant != "bf16"
                                      or args.kv_dtype != "bf16"):
        ap.error("--quant and --kv-dtype apply to qwen2-1.5b only")
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.arch == "rwkv6-1.6b":
        cfg, results = _rwkv_phases()
        _report(cfg, results)
        return 0
    cfg = get_config("qwen2-1.5b").with_(
        quant=args.quant, kv_cache_dtype=normalize_dtype(args.kv_dtype))
    lm = LM(cfg, device="cuda")
    params = quantize_tree(lm.init(SEED), quant=args.quant)
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

    # a continuation chunk over a paged cache of 16 pages a slot: the
    # time does not depend on the values, so the pools stay as allocated
    page, pps = 256, 16
    cache = lm.init_paged_cache(SLOTS, SLOTS * pps + 1, pps, page_size=page)
    cache[0]["blk0"]["kv"]["block_table"].copy_(
        torch.arange(1, SLOTS * pps + 1, dtype=torch.int32).reshape(SLOTS,
                                                                    pps))
    dev = torch.device("cuda")
    chunk = (torch.as_tensor(rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT)),
                             device=dev),
             cache, torch.arange(SLOTS, device=dev),
             torch.tensor(CONT_STARTS, dtype=torch.int32, device=dev),
             torch.full((SLOTS,), PROMPT, dtype=torch.int32, device=dev))
    prepared = warm.params

    def cont():
        lm.prefill_paged(prepared, *chunk, max_pages=pps)

    cont()                                     # first launch, build
    results = [
        _phase(f"admit {SLOTS}x{PROMPT}", admit),
        _phase(f"decode {BLOCKS}x{DECODE_BLOCK} steps, {SLOTS} slots",
               lambda: [warm._dispatch_decode([]) for _ in range(BLOCKS)]),
        _phase(f"continuation chunk {SLOTS}x{PROMPT}, prefixes "
               f"{min(CONT_STARTS)}-{max(CONT_STARTS)}", cont)]
    _report(cfg, results)
    return 0


def _report(cfg, results: list) -> None:
    """The last line: the phases as JSON, with the card's name and power
    limit."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "config": cfg.name,
                      "quant": cfg.quant, "kv_dtype": cfg.kv_cache_dtype,
                      "phases": results}))


if __name__ == "__main__":
    raise SystemExit(main())

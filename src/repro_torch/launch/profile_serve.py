"""Where the time of the port's serving goes, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--quant int8|fp8|int4] [--kv-dtype int8|fp8]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --engine eager [--quant int8|fp8 --kv-dtype int8|fp8]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --spec ngram [--kv-dtype int8]

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

``--engine eager`` profiles the eager ``Engine`` instead, on qwen2-1.5b
at full width over a contiguous cache (``chip_smoke.py`` phase 15's
settings: 8 slots, ``max_len`` 4,096): one admission of 2,048 tokens (the
flash kernel in every layer), then 32 decode steps with that request
active (every step runs all 8 slots, and its plain attention reads all
4,096 positions of each).  ``--arch rwkv6-1.6b`` (eager only) does the
same on rwkv6-1.6b at full width (24 layers; phase 13's settings; the
WKV-6 kernel in every layer of the admission).

``--spec ngram`` profiles one speculative verify round of the
``SpecEngine`` instead (qwen2-1.5b at full width, ``chip_smoke.py`` phase
14's settings: 8 slots, page 256, chunk 512, n-gram drafts of k = 4, not
adaptive), with 8 requests of repeated passages of 512-3,072 tokens all
decoding: the round's wall, device busy, idle share and kernel runs and
the share of its device time in the prefix-extend kernel (B2, W = 5);
then the commit alone (``commit_spec_cache``: its masked page writes
run whatever was accepted), whose busy time over the round's is the
commit's share; then one fused decode block of the same slots (8 steps,
the scheduler's plain decode of phase 7).
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
from repro_torch.sched import SchedEngine
from repro_torch.serve.engine import Engine, PagedEngine

SLOTS, PROMPT, BLOCKS, DECODE_BLOCK, SEED, TOP = 8, 512, 4, 8, 0, 8
EAGER_PROMPT, EAGER_STEPS = 2048, 32
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


def _phase(name: str, run, extra=None) -> dict:
    """Time ``run()`` untraced (host wall), then trace one more run;
    ``extra(kernels, busy)`` adds keys to the result."""
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
    if extra is not None:
        res.update(extra(kernels, busy))
    print(f"[{name}] wall {wall:.3f} ms (untraced), device busy "
          f"{busy:.3f} ms, idle share {res['idle_share']:.3f}, "
          f"{runs} kernel runs"
          + "".join(f", {k} {v:.3f}" for k, v in res.items()
                    if k.endswith("_share") and k != "idle_share"))
    for k, v in ranked:
        print(f"    {v:9.3f} ms  {k[:100]}")
    return res


def _eager_phases(cfg) -> tuple:
    """``cfg`` through the eager ``Engine``: one admission of
    EAGER_PROMPT tokens, then EAGER_STEPS decode steps."""
    lm = LM(cfg, device="cuda")
    rng = np.random.default_rng(SEED)
    params = quantize_tree(lm.init(SEED), quant=cfg.quant)
    eng = Engine(lm, params, n_slots=SLOTS, max_len=4096, seed=SEED)
    prompt = rng.integers(0, cfg.vocab_size, (EAGER_PROMPT,))
    # warm-up (first launches, cuBLAS), and one request that stays active
    # through every decode step below
    eng.submit(prompt, max_new_tokens=4 * EAGER_STEPS)
    eng.step()
    results = [
        _phase(f"admit 1x{EAGER_PROMPT}",
               lambda: eng._prefill_slot(prompt, SLOTS - 1).cpu()),
        _phase(f"decode {EAGER_STEPS} steps, {SLOTS} slots (1 active)",
               lambda: [eng.step() for _ in range(EAGER_STEPS)])]
    return cfg, results


def passage_prompt(rng, vocab: int, n: int):
    """An ``n``-token prompt of one 64-256-token passage repeated, each
    copy with 2 tokens changed: what retrieval and code-editing users
    send, and what prompt-lookup drafting serves (also ``chip_smoke.py``
    phase 14's prompts)."""
    passage = rng.integers(0, vocab, int(rng.integers(64, 257)))
    out = []
    while sum(len(c) for c in out) < n:
        c = passage.copy()
        c[rng.integers(0, len(c), 2)] = rng.integers(0, vocab, 2)
        out.append(c)
    return np.concatenate(out)[:n]


def _spec_phases(kv_dtype: str) -> tuple:
    """One verify round of the n-gram ``SpecEngine`` with 8 slots
    decoding, its commit alone, and one plain decode block of the same
    slots."""
    from repro_torch.serve.paged import commit_spec_cache
    from repro_torch.spec import SpecEngine
    cfg = get_config("qwen2-1.5b").with_(kv_cache_dtype=kv_dtype)
    lm = LM(cfg, device="cuda")
    rng = np.random.default_rng(SEED)
    eng = SpecEngine(lm, lm.init(SEED), spec="ngram", draft_k=4,
                     adaptive=False, n_slots=SLOTS, max_len=4096,
                     page_size=256, prefill_chunk=PROMPT, decode_block=8,
                     prefix_cache=False, seed=SEED)
    for n in CONT_STARTS:
        eng.submit(passage_prompt(rng, cfg.vocab_size, n),
                   max_new_tokens=512)
    while eng.queue or eng._prefilling:        # admit, prefill, warm up
        eng.step()
    eng.step()

    def b2_share(kernels, busy):
        b2 = sum(v for k, v in kernels.items() if "prefix_extend" in k)
        return {"b2_ms": b2, "b2_share": b2 / busy}

    def verify_round():
        before = eng.spec_stats.verify_steps
        eng._dispatch_decode([])
        if eng.spec_stats.verify_steps != before + 1:
            raise RuntimeError("the round fell back to plain decode "
                               "(no drafts)")

    rounds = _phase(f"verify round, {SLOTS} slots x W 5 (n-gram, k 4)",
                    verify_round, b2_share)
    dev = torch.device("cuda")
    w = eng.w_max
    stage = lm.init_cache(SLOTS, w, kv_dtype="bfloat16")
    for group in stage:                        # values of K/V's magnitude
        for blk in group.values():
            for t in blk["kv"].values():
                t.normal_()
    lengths = torch.as_tensor(eng.lengths, device=dev)
    n_write = torch.full((SLOTS,), w, dtype=torch.int32, device=dev)
    commit = _phase(f"commit alone, {SLOTS} slots x W {w} accepted",
                    lambda: commit_spec_cache(eng.cache, stage, lengths,
                                              n_write))
    rounds["commit_share"] = commit["device_busy_ms"] \
        / rounds["device_busy_ms"]
    print(f"[verify round] the commit's share of its device time "
          f"{rounds['commit_share']:.3f}")
    return cfg, [rounds, commit,
                 _phase(f"decode block, {SLOTS} slots x {eng.decode_block} "
                        "steps (plain decode)",
                        lambda: SchedEngine._dispatch_decode(eng, []))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=["qwen2-1.5b", "rwkv6-1.6b"])
    ap.add_argument("--quant", default="bf16",
                    choices=["bf16", "fp8", "int8", "int4"])
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=["bf16", "bfloat16", "int8", "fp8"])
    ap.add_argument("--spec", default="none", choices=["none", "ngram"],
                    help="profile one speculative verify round instead")
    ap.add_argument("--engine", default="paged", choices=["paged", "eager"],
                    help="profile the eager Engine over a contiguous cache "
                         "instead (rwkv6-1.6b is eager only)")
    args = ap.parse_args(argv)
    if args.spec != "none" and (args.arch != "qwen2-1.5b"
                                or args.quant != "bf16"
                                or args.engine != "paged"):
        ap.error("--spec profiles qwen2-1.5b with bf16 weights")
    if args.arch == "rwkv6-1.6b" and (args.quant != "bf16"
                                      or args.kv_dtype != "bf16"):
        ap.error("--quant and --kv-dtype apply to qwen2-1.5b only")
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.spec != "none":
        cfg, results = _spec_phases(normalize_dtype(args.kv_dtype))
        _report(cfg, results)
        return 0
    if args.arch == "rwkv6-1.6b" or args.engine == "eager":
        cfg, results = _eager_phases(get_config(args.arch).with_(
            quant=args.quant, kv_cache_dtype=normalize_dtype(args.kv_dtype)))
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

"""Serving entry point of the port: the eager engine, the paged
continuous-batching engine and the scheduler over it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        [--smoke] [--requests 8 --prompt-len 32 --max-new 32 --slots 4 \
        --max-len 256] [--quant int8|fp8|int4 --kv-dtype int8|fp8] \
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        [--smoke] [--requests 8 --prompt-len 32 --max-new 32 --slots 4] \
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --smoke --device cpu [--quant int8]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --paged [--smoke] [--requests 8 --prompt-len 32 --max-new 32 \
        --slots 4 --max-len 256 --page-size 64 --decode-block 8] \
        [--policy fcfs|edf --prefill-chunk 512 --no-prefix-cache \
         --slo-ttft 2000 --slo-tpot 50] [--quant int8|fp8|int4 \
        --quant-impl fused|ref --kv-dtype int8|fp8] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --prefill-chunk 512 --spec ngram|draft [--draft-k 4 \
        --draft-config auto|self|<arch> --no-spec-adaptive --spec-slack 50]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --policy fcfs [--chaos seed=0,oom=0.05,fault=0.1,shrink=4] \
        [--degrade] [--max-request-s 30]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --policy sjf|edf [--admission-control --slo-ttft 50] \
        [--arrival-rate 40] [--kv-style full|gqa|mqa] [--profile \
        --calibration-out c.json --calibration-in c.json] \
        [--metrics m.json|m.prom] [--trace-out t.json]

Runs on the GPU unless ``--device cpu`` is given.  Without ``--paged``,
``--policy`` or ``--spec`` the eager ``Engine`` serves: batch-1 prefill
of each admission into its slot of a contiguous cache (bf16, or int8 /
fp8 with per-position scales from ``--kv-dtype``), one decode step for
every slot a tick and one host sync a token.  On the GPU an attention
arch's admission runs the flash-attention kernel in each layer (windowed
configs too) and its decode plain torch over the cache, as the reference
does; an attention-free arch (rwkv6-1.6b) runs the WKV-6 kernel at
admission and the one-token recurrence in plain torch, and a Mamba
hybrid (jamba-1.5-large-398b; one H100 holds only its first five layers,
so on the card it runs from ``chip_smoke.py`` phase 22 or ``--smoke``)
its Mamba blocks in plain torch and its attention block as an attention
arch's.  RWKV-6 and Mamba archs take the eager ``Engine`` only:
``--paged``, ``--policy`` and ``--spec`` refuse them.  With ``--paged``
the admission prefill goes through the flash-attention kernel, every
decode step through the paged-attention kernel and, with ``--policy``,
every continuation chunk of a chunked prefill through the prefix-extend
kernel.
``--quant`` quantizes the weights after ``LM.init``: int8 linears run the
W8A8 decode kernel at M <= 128 rows and the tiled W8A8 kernel above,
fp8 linears the fp8 decode kernel at M <= 128 (plain torch above, as in
the reference), int4 plain torch.  ``--kv-dtype`` stores the page pools
in int8 or fp8 with per-page scales.  ``--spec`` serves through the
speculative ``SpecEngine`` (it implies the scheduler, FCFS unless
``--policy`` says otherwise): every verify round runs the prefix-extend
kernel at W = draft_k + 1 rows a slot; ``--spec draft`` drafts with a
shrunk random-weight copy of the target (``draft_config_of``), or with the
target itself (``--draft-config self``).  ``--chaos`` arms the seeded
fault injector (``repro_torch.resil``) on the paged and scheduler
engines, and ``--degrade`` / ``--max-request-s`` the degradation ladder
and per-request deadlines on the scheduler engines, which then recover
from injected faults instead of failing; the report adds every request's
outcome, the injected faults and the ladder's rung.  ``--policy sjf``
ranks admissions by the cost model's remaining-service estimate (H100
tier), and ``--admission-control`` drops EDF requests whose estimated
prefill already overruns their TTFT deadline.  ``--arrival-rate``
submits open loop (Poisson arrivals) instead of all at once.
Under ``--model-parallel`` every rank runs the drive, and each decision
that reads the clock (``--policy sjf|edf``, ``--admission-control``,
``--degrade``, ``--max-request-s``, ``--chaos``, ``--spec-slack``,
``--arrival-rate``) reads rank 0's, sent to the group.
``--profile`` times every dispatch (no extra host sync) and, with
``--calibration-out`` / ``--calibration-in``, fits the cost model's
per-dispatch corrections and writes / seeds them; ``--metrics`` writes
the metrics registry after the drive (Prometheus text for .prom / .txt,
JSON otherwise) with the cost model's ``costmodel_*`` estimates at the
drive's shape and, when profiling, the drift and attainment gauges;
``--trace-out`` writes the request trace as Chrome / Perfetto JSON.  The
artifacts are written in the drive's ``finally``, so a failed drive
still leaves them.  Flags and defaults are the reference's
(``repro.launch.serve``) for these paths.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.costmodel import (TIERS, CalibratedCostModel,
                                        service_estimate)
from repro_torch.kvcache import normalize_dtype
from repro_torch.launch.mesh import make_host_mesh, spawn_world
from repro_torch.models.model import LM, resolve_device
from repro_torch.obs import DispatchProfiler, Tracer
from repro_torch.quant import quantize_tree
from repro_torch.resil import OUTCOMES, FaultInjector
from repro_torch.sched import SchedEngine
from repro_torch.serve.engine import Engine, PagedEngine, run_open_loop
from repro_torch.spec import SpecEngine, draft_config_of


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV + paged-attention decode kernel + fused "
                         "multi-token decode loop (PagedEngine)")
    ap.add_argument("--decode-block", type=int, default=8,
                    help="tokens per host sync in the paged engine")
    ap.add_argument("--page-size", type=int, default=64,
                    help="KV page size for --paged (tokens per page)")
    ap.add_argument("--policy", default=None,
                    choices=["fcfs", "sjf", "edf"],
                    help="serve through the scheduler (SchedEngine) with "
                         "this admission policy (sjf: the cost model's "
                         "shortest remaining service first); implies the "
                         "paged engine")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="refcounted prefix caching over the paged pools "
                         "(--policy only)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="scheduler prefill chunk in tokens (multiple of "
                         "--page-size; default 8 pages)")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="TTFT SLO target in ms (EDF deadlines + "
                         "telemetry)")
    ap.add_argument("--slo-tpot", type=float, default=None,
                    help="TPOT SLO target in ms (telemetry)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrivals, requests/sec "
                         "(0: submit everything upfront)")
    ap.add_argument("--admission-control", action="store_true",
                    help="drop requests whose cost-model prefill estimate "
                         "already overruns their TTFT deadline at "
                         "admission (EDF; goodput-optimal dropping)")
    ap.add_argument("--spec", default="none",
                    choices=["none", "ngram", "draft"],
                    help="speculative decoding (SpecEngine, implies the "
                         "scheduler): n-gram prompt-lookup drafts or a "
                         "small draft LM sharing the vocabulary; greedy "
                         "output is token-identical to plain decode")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="max draft tokens per verify round (the adaptive "
                         "controller tunes each slot's k below this)")
    ap.add_argument("--draft-config", default="auto",
                    help="--spec draft: arch id of the draft model, 'auto' "
                         "for a shrunk copy of the target config (random "
                         "weights) or 'self' (self-speculation)")
    ap.add_argument("--spec-adaptive", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="adapt each slot's draft length to its measured "
                         "acceptance through the cost model")
    ap.add_argument("--spec-slack", type=float, default=None,
                    help="turn speculation off for a tick when a queued "
                         "EDF deadline is closer than this many ms")
    ap.add_argument("--kv-style", default="full",
                    choices=["full", "gqa", "mqa"],
                    help="stored KV heads: the model's (full), at most 8 "
                         "(gqa) or one (mqa), mean-merged before the write")
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=["bf16", "bfloat16", "int8", "fp8"],
                    help="KV page-pool storage dtype: int8/fp8 pools carry "
                         "per-page amax scales")
    ap.add_argument("--quant", default="bf16",
                    choices=["bf16", "fp8", "int8", "int4"],
                    help="weight quantization of every linear "
                         "(quant.qops.quantize_tree)")
    ap.add_argument("--quant-impl", default="fused",
                    choices=["fused", "ref"],
                    help="quantized-matmul execution on the CPU: 'fused' "
                         "runs the kernels' plain versions, 'ref' the "
                         "oracles; on the GPU the kernels always run")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="serve over this many ranks on the model axis "
                         "(kv-head-sharded paged attention and split "
                         "weights, MoE experts, --quant weights and "
                         "adapters included; implies the paged engine): N "
                         "processes "
                         "on --device, gloo where they share a card or run "
                         "on the CPU, nccl where each has its own card")
    ap.add_argument("--tp-attn-impl", default="kv_shard",
                    choices=["kv_shard", "gather"],
                    help="sharded paged attention: 'kv_shard' keeps each "
                         "rank's KV local; 'gather' is the naive baseline "
                         "that all-gathers q and the pools into every rank "
                         "(collective-byte A/B only)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="seeded fault injection (--paged / --policy / "
                         "--spec engines): e.g. 'seed=1,oom=0.1,fault=0.1,"
                         "spike=0.05,draft=0.3,shrink=2' — forced page "
                         "exhaustion, transient dispatch faults, latency "
                         "spikes, degenerate draft proposals, pool "
                         "shrinkage")
    ap.add_argument("--degrade", action="store_true",
                    help="graceful-degradation ladder (--policy / --spec): "
                         "under metrics pressure turn spec off, shrink "
                         "prefill chunks, then shed load with policy "
                         "retry-after hints; monotone rungs with "
                         "hysteresis")
    ap.add_argument("--max-request-s", type=float, default=None,
                    help="per-request wall-clock deadline (--policy / "
                         "--spec): requests past it are cancelled, pages "
                         "freed, outcome 'timed_out'")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the engine's metrics-registry snapshot "
                         "here after the drive: Prometheus text for "
                         ".prom/.txt, JSON otherwise (includes the cost "
                         "model's estimates at the drive's prompt/gen "
                         "shape)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record per-request lifecycle spans and write "
                         "Chrome/Perfetto trace-event JSON here (open in "
                         "ui.perfetto.dev); adds zero host syncs")
    ap.add_argument("--profile", action="store_true",
                    help="per-dispatch wall-clock profiling "
                         "(repro_torch.obs.profile): attribute measured "
                         "wall-clock to every admit / prefill-chunk / "
                         "decode-block / spec-round dispatch by config "
                         "arm and fold drift + roofline-attainment "
                         "gauges into --metrics; adds zero host syncs")
    ap.add_argument("--calibration-out", default=None, metavar="PATH",
                    help="fit a CalibratedCostModel from the profiled "
                         "dispatches (implies --profile) and write the "
                         "JSON calibration artifact here")
    ap.add_argument("--calibration-in", default=None, metavar="PATH",
                    help="seed the calibration from a previous "
                         "--calibration-out artifact (corrections keep "
                         "updating online from this drive's samples)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    sched = bool(args.policy) or args.spec != "none"
    # --model-parallel N > 1 implies the paged engine, as in the reference
    eager = not (args.paged or sched or args.model_parallel > 1)
    if eager and args.chaos:
        ap.error("--chaos needs --paged, --policy or --spec")
    if not sched and (args.degrade or args.max_request_s is not None):
        ap.error("--degrade / --max-request-s need --policy or --spec")
    if not eager and any(k != "attn" for k in cfg.block_pattern):
        ap.error(f"{cfg.name} has {'/'.join(sorted(set(cfg.block_pattern)))}"
                 " blocks: the paged engines (--paged, --policy, --spec) "
                 "serve attention-only decoders; drop them to serve through "
                 "the eager Engine")
    if args.model_parallel < 1:
        ap.error("--model-parallel must be >= 1")
    device = resolve_device(args.device)
    if args.model_parallel > 1:
        return _serve_sharded(args, device)
    _serve(args, device)
    return 0


def _serve_sharded(args, device) -> int:
    """Start ``--model-parallel`` ranks on ``device``, each serving the
    same drive on its slice (:func:`_serve_rank`; every decision that
    reads the clock reads rank 0's); print rank 0's report and fail if
    any rank's streams or outcomes differ from rank 0's."""
    n = args.model_parallel
    threads = max(1, torch.get_num_threads() // n) \
        if device.type == "cpu" else None
    results = spawn_world(_serve_rank, n, args, device=device,
                          threads=threads)
    print(results[0]["out"], end="")
    for rank, r in enumerate(results[1:], 1):
        for key in ("streams", "outcomes"):
            if r["drive"][key] != results[0]["drive"][key]:
                raise RuntimeError(f"rank {rank}'s {key} differ from rank "
                                   "0's")
    print(f"[serve] {n} ranks, every rank's streams equal, every rank's "
          "outcomes equal")
    return 0


def _serve_rank(rank: int, args) -> dict:
    mesh = make_host_mesh(model=args.model_parallel, device=args.device
                          or "cuda")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print(f"[serve] {mesh.describe()}")
        drive = _serve(args, mesh.device, mesh, artifacts=rank == 0)
    return {"out": out.getvalue(), "drive": drive}


def _serve(args, device, mesh=None, artifacts: bool = True) -> dict:
    """One drive on ``device`` (one rank's, under ``mesh``): returns the
    requests' token streams and outcomes."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    sched = bool(args.policy) or args.spec != "none"
    eager = not (args.paged or sched or mesh is not None)
    cfg = cfg.with_(kv_cache_style=args.kv_style
                    if cfg.attention is not None else "full",
                    kv_cache_dtype=normalize_dtype(args.kv_dtype),
                    quant=args.quant, quant_matmul_impl=args.quant_impl,
                    tp_attn_impl=args.tp_attn_impl)
    lm = LM(cfg, device=device)
    params = lm.init(args.seed)
    if args.quant != "bf16":
        params = quantize_tree(params, quant=args.quant)
        print(f"[serve] weights quantized to {args.quant} "
              f"({args.quant_impl} matmuls), kv {cfg.kv_cache_dtype}")
    injector = FaultInjector.from_spec(args.chaos)
    if injector is not None:
        print(f"[serve] chaos armed: {injector.describe()}")
    tracer = Tracer(enabled=args.trace_out is not None)
    profiler = DispatchProfiler(enabled=args.profile
                                or args.calibration_out is not None
                                or args.calibration_in is not None)
    obs = dict(tracer=tracer, profiler=profiler)
    kw = dict(n_slots=args.slots, max_len=args.max_len, seed=args.seed,
              page_size=args.page_size, decode_block=args.decode_block,
              injector=injector, mesh=mesh, **obs)
    if eager:
        eng = Engine(lm, params, n_slots=args.slots, max_len=args.max_len,
                     seed=args.seed, **obs)
    elif sched:
        sched_kw = dict(policy=args.policy or "fcfs",
                        prefix_cache=args.prefix_cache,
                        prefill_chunk=args.prefill_chunk,
                        admission_control=args.admission_control,
                        slo_ttft=None if args.slo_ttft is None
                        else args.slo_ttft / 1e3,
                        slo_tpot=None if args.slo_tpot is None
                        else args.slo_tpot / 1e3,
                        ladder=True if args.degrade else None,
                        max_request_s=args.max_request_s, **kw)
        if args.spec == "none":
            eng = SchedEngine(lm, params, **sched_kw)
        else:
            draft_lm, draft_params = _draft_model(args, cfg, lm, params,
                                                  device)
            eng = SpecEngine(lm, params, spec=args.spec,
                             draft_k=args.draft_k, draft_lm=draft_lm,
                             draft_params=draft_params,
                             adaptive=args.spec_adaptive,
                             spec_slack_s=None if args.spec_slack is None
                             else args.spec_slack / 1e3, **sched_kw)
    else:
        eng = PagedEngine(lm, params, **kw)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, (args.prompt_len,)).tolist()
               for _ in range(args.requests)]
    # the drive runs under try/finally: a mid-drive exception still
    # flushes whatever telemetry exists (partial metrics / trace /
    # calibration), then propagates
    try:
        t0 = time.perf_counter()
        if args.arrival_rate > 0:
            offsets = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                                args.requests))
            ids = run_open_loop(eng, prompts, offsets,
                                max_new_tokens=args.max_new,
                                temperature=args.temperature)
            done = dict(eng.registry)
        else:
            ids = [eng.submit(p, max_new_tokens=args.max_new,
                              temperature=args.temperature) for p in prompts]
            done = eng.run_to_completion()
        dt = time.perf_counter() - t0
        n_tok = sum(len(done[i].out_tokens) for i in ids)
        label = ("eager" if eager else "paged" if not sched else
                 f"sched/{args.policy or 'fcfs'}"
                 + (f" + spec/{args.spec}" if args.spec != "none" else ""))
        print(f"[serve] {cfg.name}: {len(ids)} requests, {n_tok} tokens in "
              f"{dt:.1f}s ({n_tok/dt:.1f} tok/s, continuous batching over "
              f"{args.slots} slots, {label}, {eng.sync_count} host syncs)")
        if sched:
            print(f"[serve] sched telemetry: {eng.telemetry()}")
        outcomes = {o: sum(done[i].outcome == o for i in ids)
                    for o in OUTCOMES}
        print(f"[serve] outcomes: {outcomes}")
        if injector is not None:
            print(f"[serve] injected faults: {dict(injector.counts)}")
        if args.degrade:
            lad = eng.ladder
            print(f"[serve] degrade ladder: rung={lad.name} "
                  f"spec_off={lad.spec_off} "
                  f"chunk={lad.chunk_for(eng.prefill_chunk, eng.page_size)} "
                  f"kv_dtype_hint={lad.kv_dtype_hint or 'unchanged'}")
        for i in ids[:3]:
            print(f"  req {i}: {len(done[i].out_tokens)} tokens "
                  f"{done[i].out_tokens[:8]}…")
    finally:
        if artifacts:
            _write_artifacts(args, cfg, eng, tracer, profiler)
    return {"streams": [list(done[i].out_tokens) for i in ids],
            "outcomes": [done[i].outcome for i in ids]}


def _write_artifacts(args, cfg, eng, tracer, profiler):
    """Flush --calibration-out / --metrics / --trace-out.  Runs in the
    drive's ``finally`` so a mid-drive exception still leaves partial
    telemetry on disk."""
    tier = TIERS["h100-1"]
    calib = None
    if profiler.enabled:
        calib = (CalibratedCostModel.load(args.calibration_in)
                 if args.calibration_in else CalibratedCostModel())
        records = calib.fit_profile(profiler, eng.lm.cfg, tier,
                                    layout=eng.kv_layout)
        calib.register_metrics(eng.metrics)
        profiler.export_gauges(eng.metrics, tier)
        print(f"[serve] profiled {len(records)} dispatches across "
              f"{len(calib.factors)} (kind × arm) calibration series")
    if args.calibration_out and calib is not None:
        calib.save(args.calibration_out)
        print(f"[serve] calibration -> {args.calibration_out}")
    if args.metrics:
        # the cost model's estimate at the drive's prompt / gen shape, for
        # the CLI's config (the contiguous layout, as the reference's
        # config prices it)
        est = service_estimate(cfg, tier, prompt=args.prompt_len,
                               gen=args.max_new, chunk=args.prefill_chunk)
        eng.metrics.set_gauges(
            {f"costmodel_{k}": v for k, v in est.items()},
            help="cost-model roofline estimate at the drive's "
                 "prompt/gen shape")
        if str(args.metrics).endswith((".prom", ".txt")):
            body = eng.metrics.to_prometheus_text()
        else:
            body = eng.metrics.to_json(arch=cfg.name,
                                       engine=type(eng).__name__)
        with open(args.metrics, "w") as f:
            f.write(body)
        print(f"[serve] metrics snapshot -> {args.metrics}")
    if args.trace_out:
        tracer.write(args.trace_out)
        print(f"[serve] trace ({len(tracer.events)} events) -> "
              f"{args.trace_out} (open in ui.perfetto.dev)")


def _draft_model(args, cfg, lm, params, device):
    """The draft arm's (LM, params): none for n-gram drafting, the target
    itself for ``--draft-config self``, else a random-weight model of
    ``draft_config_of(cfg)`` or of the named arch, seeded with ``seed + 1``
    and quantized like the target."""
    if args.spec != "draft":
        return None, None
    if args.draft_config == "self":
        return lm, params
    dcfg = (draft_config_of(cfg) if args.draft_config == "auto"
            else get_smoke_config(args.draft_config) if args.smoke
            else get_config(args.draft_config))
    dcfg = dcfg.with_(quant=args.quant, quant_matmul_impl=args.quant_impl)
    draft_lm = LM(dcfg, device=device)
    draft_params = draft_lm.init(args.seed + 1)
    if args.quant != "bf16":
        draft_params = quantize_tree(draft_params, quant=args.quant)
    print(f"[serve] draft model {dcfg.name}: {dcfg.num_layers}L "
          f"d={dcfg.d_model} quant={args.quant}")
    return draft_lm, draft_params


if __name__ == "__main__":
    raise SystemExit(main())

"""Serving entry point of the port: the paged continuous-batching engine,
the scheduler over it, and the eager engine for attention-free models.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        [--smoke] [--requests 8 --prompt-len 32 --max-new 32 --slots 4] \
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --paged [--smoke] [--requests 8 --prompt-len 32 --max-new 32 \
        --slots 4 --max-len 256 --page-size 64 --decode-block 8] \
        [--policy fcfs|edf --prefill-chunk 512 --no-prefix-cache \
         --slo-ttft 2000 --slo-tpot 50] [--quant int8|fp8|int4 \
        --quant-impl fused|ref --kv-dtype int8|fp8] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --prefill-chunk 512 --spec ngram|draft [--draft-k 4 \
        --draft-config auto|self|<arch> --no-spec-adaptive --spec-slack 50]

Runs on the GPU unless ``--device cpu`` is given.  Without ``--paged`` or
``--policy`` an attention-free arch (rwkv6-1.6b) is served by the eager
``Engine``: on the GPU every admission's prefill runs the WKV-6 kernel in
each layer, and decode runs the reference's one-token recurrence in plain
torch.  Attention archs need ``--paged`` or ``--policy`` (their eager
engine over contiguous caches waits for ROADMAP A1).  On the GPU the
admission prefill goes through the flash-attention kernel, every decode
step through the paged-attention kernel and, with ``--policy``, every
continuation chunk of a chunked prefill through the prefix-extend kernel.
``--quant`` quantizes the weights after ``LM.init``: int8 linears run the
W8A8 decode kernel at M <= 128 rows and the tiled W8A8 kernel above,
fp8 linears the fp8 decode kernel at M <= 128 (plain torch above, as in
the reference), int4 plain torch.  ``--kv-dtype`` stores the page pools
in int8 or fp8 with per-page scales.  ``--spec`` serves through the
speculative ``SpecEngine`` (it implies the scheduler, FCFS unless
``--policy`` says otherwise): every verify round runs the prefix-extend
kernel at W = draft_k + 1 rows a slot; ``--spec draft`` drafts with a
shrunk random-weight copy of the target (``draft_config_of``), or with the
target itself (``--draft-config self``).  Flags and defaults are the
reference's (``repro.launch.serve``) for these paths.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kvcache import normalize_dtype
from repro_torch.models.model import LM, resolve_device
from repro_torch.quant import quantize_tree
from repro_torch.sched import SchedEngine
from repro_torch.serve.engine import Engine, PagedEngine
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
    ap.add_argument("--policy", default=None, choices=["fcfs", "edf"],
                    help="serve through the scheduler (SchedEngine) with "
                         "this admission policy; implies the paged engine")
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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    sched = bool(args.policy) or args.spec != "none"
    eager = not (args.paged or sched)
    if eager and cfg.attention is not None:
        ap.error("attention archs are served by the paged engine or the "
                 "scheduler: pass --paged or --policy (the eager engine over "
                 "contiguous caches waits for ROADMAP A1)")

    device = resolve_device(args.device)
    cfg = cfg.with_(kv_cache_dtype=normalize_dtype(args.kv_dtype),
                    quant=args.quant, quant_matmul_impl=args.quant_impl)
    lm = LM(cfg, device=device)
    params = lm.init(args.seed)
    if args.quant != "bf16":
        params = quantize_tree(params, quant=args.quant)
        print(f"[serve] weights quantized to {args.quant} "
              f"({args.quant_impl} matmuls), kv {cfg.kv_cache_dtype}")
    kw = dict(n_slots=args.slots, max_len=args.max_len, seed=args.seed,
              page_size=args.page_size, decode_block=args.decode_block)
    if eager:
        eng = Engine(lm, params, n_slots=args.slots, max_len=args.max_len,
                     seed=args.seed)
    elif sched:
        sched_kw = dict(policy=args.policy or "fcfs",
                        prefix_cache=args.prefix_cache,
                        prefill_chunk=args.prefill_chunk,
                        slo_ttft=None if args.slo_ttft is None
                        else args.slo_ttft / 1e3,
                        slo_tpot=None if args.slo_tpot is None
                        else args.slo_tpot / 1e3, **kw)
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
    t0 = time.perf_counter()
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
    for i in ids[:3]:
        print(f"  req {i}: {len(done[i].out_tokens)} tokens "
              f"{done[i].out_tokens[:8]}…")
    return 0


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

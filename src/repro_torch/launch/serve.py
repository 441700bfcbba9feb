"""Serving driver of the port: the paged continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --paged [--smoke] [--requests 8 --prompt-len 32 --max-new 32 \
        --slots 4 --max-len 256 --page-size 64 --decode-block 8] \
        [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; on the GPU the
admission prefill goes through the flash-attention kernel and every
decode step through the paged-attention kernel.  Flags and defaults are
the reference's (``repro.launch.serve``) for this path; only the paged
engine is ported so far.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.model import LM, resolve_device
from repro_torch.serve.engine import PagedEngine


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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if not args.paged:
        ap.error("only the paged engine is ported: pass --paged")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    lm = LM(cfg, device=device)
    params = lm.init(args.seed)
    eng = PagedEngine(lm, params, n_slots=args.slots, max_len=args.max_len,
                      seed=args.seed, page_size=args.page_size,
                      decode_block=args.decode_block)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, (args.prompt_len,)).tolist()
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=args.max_new,
                      temperature=args.temperature) for p in prompts]
    done = eng.run_to_completion()
    dt = time.perf_counter() - t0
    n_tok = sum(len(done[i].out_tokens) for i in ids)
    print(f"[serve] {cfg.name}: {len(ids)} requests, {n_tok} tokens in "
          f"{dt:.1f}s ({n_tok/dt:.1f} tok/s, continuous batching over "
          f"{args.slots} slots, paged, {eng.sync_count} host syncs)")
    for i in ids[:3]:
        print(f"  req {i}: {len(done[i].out_tokens)} tokens "
              f"{done[i].out_tokens[:8]}…")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end training driver of the port (``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        [--smoke --device cpu] --steps 50 [--autotune] [--ckpt-dir DIR]

Runs on the GPU unless ``--device cpu`` is given (without a GPU and
without it, it raises).  ``--smoke`` selects the reduced config of the
same family.  ``--autotune`` first runs the port's AE-LLM search
(Algorithm 1) at the paper's ``datacenter`` tier (``h100-8``), then
applies the recommended configuration c*: ``apply_efficiency_config`` to
the model, ``apply_to_params`` (quantized base, adapters) to the weights,
and the trainable mask of its fine-tuning arm.  ``--model-parallel`` above
1 is refused: sharding is ROADMAP A8.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.apply import apply_efficiency_config, apply_to_params
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model import LM, resolve_device
from repro_torch.optim.adamw import cosine_schedule
from repro_torch.peft.lora import trainable_mask
from repro_torch.train.loop import Trainer
from repro_torch.tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--autotune", action="store_true",
                    help="run AE-LLM (Algorithm 1) and apply c*")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps between log lines and history entries")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "CPU)")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        ap.error("--model-parallel > 1: sharded training is not ported yet "
                 "(ROADMAP A8.2: sharded training with FSDP; sharded "
                 "serving is launch.serve --model-parallel)")
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.with_(max_seq_len=max(cfg.max_seq_len, args.seq_len))

    if args.autotune:
        from repro_torch.core.costmodel import TIERS
        from repro_torch.core.evaluator import Evaluator
        from repro_torch.core.features import TaskSpec
        from repro_torch.core.space import space_for_family
        from repro_torch.core.tuner import AutoTuner, recommend
        task = TaskSpec("lm", "understanding", 0.5, args.seq_len)
        ev = Evaluator(cfg, task, TIERS["datacenter"], seed=args.seed)
        tuner = AutoTuner(ev, mask=space_for_family(cfg.family),
                          generations=8, pop_size=24, refine_iters=1,
                          seed=args.seed)
        report = tuner.run()
        eff, obj = recommend(report.archive)
        print(f"[train] AE-LLM selected: {eff} (predicted obj {obj})")
        cfg = apply_efficiency_config(cfg, eff)

    lm = LM(cfg, device=device)
    pipe = SyntheticLMData(cfg.vocab_size, args.seq_len, args.global_batch,
                           seed=args.seed)
    lr = cosine_schedule(args.lr, args.warmup, args.steps)
    trainer = Trainer(lm, pipe, lr=lr, ckpt_dir=args.ckpt_dir,
                      num_microbatches=args.microbatches,
                      compress=args.compress, ckpt_every=args.ckpt_every,
                      log_every=args.log_every)
    params = trainer.init_or_resume(args.seed)
    if args.autotune:
        params = apply_to_params(params, eff, args.seed + 1)
        mask = trainable_mask(params, eff.ft.method) \
            if eff.ft.method != "full" else None
        trainer.set_params(params, mask=mask,
                           num_microbatches=args.microbatches)
    n = sum(p.numel() for p in leaves(params))
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.global_batch}×{args.seq_len} "
          f"on {device}")
    history = trainer.run(args.steps)
    first = history[0]["loss"] if history else float("nan")
    last = history[-1]["loss"] if history else float("nan")
    print(f"[train] done: loss {first:.4f} -> {last:.4f} "
          f"({len(trainer.watchdog.events)} straggler events)")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end training driver of the port (``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        [--smoke --device cpu] --steps 50 [--autotune] [--ckpt-dir DIR]

Runs on the GPU unless ``--device cpu`` is given (without a GPU and
without it, it raises).  ``--smoke`` selects the reduced config of the
same family.  ``--autotune`` first runs the port's AE-LLM search
(Algorithm 1) at the paper's ``datacenter`` tier (``h100-8``), then
applies the recommended configuration c*: ``apply_efficiency_config`` to
the model, ``apply_to_params`` (quantized base, adapters) to the weights,
and the trainable mask of its fine-tuning arm.  ``--model-parallel N``
above 1 trains on N ranks (``launch.mesh.spawn_world``; world = model
axis, data 1): every rank trains its tensor-parallel slice
(``Trainer(mesh=)``), and rank 0 prints the mesh line and the log and
writes ``--history-out``.  On the card the ranks share it over gloo (or
take one card each over NCCL, ``launch.mesh.backend_for``); with
``--device cpu`` they run on the CPU.  ``--autotune`` searches once, in
the launching process, before the ranks start.  A data axis is reached
through ``Trainer(mesh=)`` in a world larger than the model axis.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.apply import apply_efficiency_config, apply_to_params
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import launch_counts
from repro_torch.launch.mesh import make_host_mesh, spawn_world
from repro_torch.models.model import LM, resolve_device
from repro_torch.optim.adamw import cosine_schedule
from repro_torch.peft.lora import trainable_mask
from repro_torch.sharding.tp import LATER, check_trainable
from repro_torch.train.loop import Trainer


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
    if args.model_parallel < 1:
        ap.error("--model-parallel must be >= 1")
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.with_(max_seq_len=max(cfg.max_seq_len, args.seq_len))

    eff = None
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

    if args.model_parallel > 1:
        try:
            check_trainable(cfg.with_(model_parallel=args.model_parallel),
                            {})
            if eff is not None and (eff.ft.method != "full"
                                    or eff.inf.quant != "bf16"):
                raise ValueError(
                    f"c* (fine-tuning {eff.ft.method}, weights "
                    f"{eff.inf.quant}): PEFT adapters and quantized bases "
                    f"under a model axis > 1 are not sharded yet: {LATER}")
        except ValueError as e:
            ap.error(str(e))
        n = args.model_parallel
        threads = max(1, torch.get_num_threads() // n) \
            if device.type == "cpu" else None
        results = spawn_world(_train_rank, n, args, cfg, eff, str(device),
                              device=device, threads=threads)
        print(results[0][0], end="")
        for rank, (_, summary) in enumerate(results):
            print(f"[train] rank {rank} report {json.dumps(summary)}")
        return 0
    _train(args, cfg, eff, device)
    return 0


def _train_rank(rank: int, args, cfg, eff, device: str) -> tuple:
    """One rank of ``--model-parallel``: its mesh, its slice's training.
    Returns (rank 0's log, or "" elsewhere; this rank's summary) for the
    launcher to print."""
    mesh = make_host_mesh(model=args.model_parallel, device=device)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print(f"[train] {mesh.describe()}")
        summary = _train(args, cfg, eff, mesh.device, mesh,
                         report=rank == 0)
    return out.getvalue() if rank == 0 else "", summary


def _summary(trainer, args, device) -> dict:
    """A rank's figures: step wall p50, tokens a second of the global
    batch, peak device memory (``None`` off the card), kernel launches
    (training launches none: its forward is the differentiable plain
    one) and the collectives a step by kind (calls, bytes)."""
    p50 = statistics.median(trainer.step_times)
    n = max(trainer.steps_run, 1)
    st = trainer.step_collectives
    return {"step_p50_s": p50,
            "tokens_per_s": args.global_batch * args.seq_len / p50,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None,
            "kernel_launches": sum(launch_counts().values()),
            "collectives_a_step": {k: [st.count_by_op[k] / n,
                                       st.bytes_by_op[k] / n]
                                   for k in sorted(st.count_by_op)
                                   if st.count_by_op[k]}}


def _train(args, cfg, eff, device, mesh=None, report: bool = True):
    """The training run on ``device`` (one rank's, under ``mesh``, which
    returns its :func:`_summary`)."""
    lm = LM(cfg, device=device)
    pipe = SyntheticLMData(cfg.vocab_size, args.seq_len, args.global_batch,
                           seed=args.seed)
    lr = cosine_schedule(args.lr, args.warmup, args.steps)
    trainer = Trainer(lm, pipe, lr=lr, ckpt_dir=args.ckpt_dir, mesh=mesh,
                      num_microbatches=args.microbatches,
                      compress=args.compress, ckpt_every=args.ckpt_every,
                      log_every=args.log_every,
                      log_fn=print if report else _quiet)
    trainer.init_or_resume(args.seed)
    if eff is not None:
        whole, _ = trainer.whole_state()
        params = apply_to_params(whole, eff, args.seed + 1)
        mask = trainable_mask(params, eff.ft.method) \
            if eff.ft.method != "full" else None
        trainer.set_params(params, mask=mask,
                           num_microbatches=args.microbatches)
    if report:
        print(f"[train] {cfg.name}: {trainer.param_count()/1e6:.1f}M "
              f"params, {args.steps} steps, batch "
              f"{args.global_batch}×{args.seq_len} on {device}")
    history = trainer.run(args.steps)
    summary = None if mesh is None else _summary(trainer, args, device)
    if not report:
        return summary
    first = history[0]["loss"] if history else float("nan")
    last = history[-1]["loss"] if history else float("nan")
    print(f"[train] done: loss {first:.4f} -> {last:.4f} "
          f"({len(trainer.watchdog.events)} straggler events)")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    return summary


def _quiet(_msg) -> None:
    pass


if __name__ == "__main__":
    raise SystemExit(main())

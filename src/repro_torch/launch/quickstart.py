"""Quickstart — AE-LLM on one page: the port's copy of
``examples/quickstart.py`` as an entry point.

    PYTHONPATH=src python -m repro_torch.launch.quickstart \\
        [--budget full|tiny] [--steps 30] [--device cpu]

1. Pick a deployment scenario: llama2-7b, the gsm8k task, and the paper's
   ``datacenter`` tier, which the port prices as ``h100-8`` (an HGX
   board; ``core/costmodel.py``).
2. Run the AE-LLM search (Algorithm 1) and take c* by
   ``recommend_efficient`` against Default.
3. Apply c* to llama3.2-1b's smoke config (``apply_efficiency_config``,
   then ``apply_to_params`` on the trainer's weights and the trainable
   mask of its fine-tuning arm) and train it for ``--steps`` steps on
   synthetic data.

``--budget full`` is the reference's budget (n0 64, one refinement of 8,
NSGA-II 32 x 12 generations); ``tiny`` is the smallest that runs every
step of Algorithm 1 (n0 8, one refinement of 2, 6 x 2, one tree a
surrogate).  The search is numpy on the host; training runs on the GPU
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.apply import apply_efficiency_config, apply_to_params
from repro_torch.core.costmodel import TIERS
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.features import TASKS
from repro_torch.core.pareto import efficiency_score
from repro_torch.core.space import EfficiencyConfig, space_for_family
from repro_torch.core.tuner import AutoTuner, recommend_efficient
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model import LM, resolve_device
from repro_torch.peft.lora import trainable_mask
from repro_torch.train.loop import Trainer

#: the deployment scenario, as the reference's quickstart fixes it
MODEL = get_config("llama2-7b")
TASK = TASKS["gsm8k"]
TIER = TIERS["h100-8"]

BUDGETS = {
    "full": dict(n0=64, refine_iters=1, k_per_iter=8, pop_size=32,
                 generations=12),
    "tiny": dict(n0=8, refine_iters=1, k_per_iter=2, pop_size=6,
                 generations=2, ensemble_k=1),
}


def search(*, budget: str = "full", log_fn=lambda *a: None):
    """Step 2 on ``MODEL`` / ``TASK`` / ``TIER``: ``(c*, its objectives,
    Default's objectives, report)``."""
    ev = Evaluator(MODEL, TASK, TIER, seed=0)
    tuner = AutoTuner(ev, mask=space_for_family(MODEL.family), seed=0,
                      log_fn=log_fn, **BUDGETS[budget])
    report = tuner.run()
    base = ev.evaluate(EfficiencyConfig.default())
    eff, obj = recommend_efficient(report.archive, base)
    return eff, obj, base, report


def train_with(eff, *, steps: int, device, log_fn=print):
    """Step 3: llama3.2-1b's smoke config with ``eff`` applied, trained
    ``steps`` steps (batch 4 x 64, lr 1e-3) -> the trainer's history."""
    cfg = apply_efficiency_config(get_smoke_config("llama3.2-1b"), eff)
    lm = LM(cfg, device=device)
    pipe = SyntheticLMData(cfg.vocab_size, 64, 4, seed=0)
    trainer = Trainer(lm, pipe, lr=1e-3, log_every=10, log_fn=log_fn)
    params = trainer.init_or_resume(0)
    params = apply_to_params(params, eff, 1)
    mask = (trainable_mask(params, eff.ft.method)
            if eff.ft.method != "full" else None)
    trainer.set_params(params, mask=mask)
    return trainer.run(steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--budget", default="full", choices=sorted(BUDGETS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device of the training step (default: "
                         "cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    eff, obj, base, report = search(budget=args.budget, log_fn=print)
    print(f"\nPareto front: {len(report.archive.front())} configs "
          f"({report.n_real_evals} real evaluations, "
          f"surrogate R² {report.surrogate_r2})")
    print(f"Default   acc={base[0]:.1f} lat={base[1]:.1f}ms "
          f"mem={base[2]:.1f}GB energy={base[3]:.2f}J")
    print(f"AE-LLM c* acc={obj[0]:.1f} lat={obj[1]:.1f}ms "
          f"mem={obj[2]:.1f}GB energy={obj[3]:.2f}J "
          f"-> efficiency score {efficiency_score(obj, base):.2f}×")
    print(f"selected config: {eff}")

    hist = train_with(eff, steps=args.steps, device=device)
    print(f"\ntrained {args.steps} steps with c*: loss "
          f"{hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

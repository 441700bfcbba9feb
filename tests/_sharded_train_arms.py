"""The drives of ``test_torch_sharded_training.py``: every rank of a gloo
world trains the same variants through ``Trainer(mesh=)`` on the same
weights and the same global batches, and reports its metrics, the whole
trained tree and its collectives.  The single-rank side runs in the test
process.  This module imports no JAX: the ranks import it."""
from __future__ import annotations

import os
import shutil

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import LM, chunked_cross_entropy
from repro_torch.optim.adamw import cosine_schedule
from repro_torch.peft.lora import trainable_mask
from repro_torch.sharding.collectives import copy_to_model
from repro_torch.sharding.rules import make_param_specs
from repro_torch.train.loop import Trainer

ARCH = "qwen2-1.5b"
BATCH, SEQ, SEED, STEPS, LR = 4, 128, 3, 3, 1e-2
#: name -> (fine-tuning method, microbatches, compression, remat policy)
VARIANTS = {"full": ("full", 1, "none", "full"),
            "microbatch2": ("full", 2, "none", "full"),
            "topk": ("full", 1, "topk", "full"),
            "int8": ("full", 1, "int8", "full"),
            "lora": ("lora", 1, "none", "full"),
            "dots": ("full", 1, "none", "dots")}
#: the vocab-parallel CE check: V 512, ids from 500 on are padding
CE_VOCAB, CE_VALID, CE_B, CE_S, CE_CHUNK = 512, 500, 2, 128, 64


def config(**kw):
    return get_smoke_config(ARCH).with_(dtype="float32", **kw)


def pipeline():
    return SyntheticLMData(config().vocab_size, SEQ, BATCH, seed=SEED)


def _quiet(_msg) -> None:
    pass


def trainer(mesh, weights, variant: str = "full", fsdp_min_size=None,
            ckpt_dir=None) -> Trainer:
    """A Trainer of ``variant`` on ``weights`` (a reference-layout numpy
    tree, adapters included for LoRA); with ``fsdp_min_size`` the
    placement adds FSDP at that size, else the default rules.  With no
    ``weights`` it resumes from ``ckpt_dir``."""
    method, n_mb, comp, remat = VARIANTS[variant]
    cfg = config(remat_policy=remat)
    tr = Trainer(LM(cfg, device="cpu"), pipeline(),
                 lr=cosine_schedule(LR, 1, STEPS), mesh=mesh, compress=comp,
                 log_every=1, log_fn=_quiet, ckpt_dir=ckpt_dir,
                 ckpt_every=1000)
    tr.init_or_resume(SEED)
    if weights is not None:
        params = params_from_numpy(weights, cfg, device="cpu")
        mask = trainable_mask(params, method) if method != "full" else None
        specs = None
        if mesh is not None and fsdp_min_size is not None:
            specs = make_param_specs(params, mesh, fsdp=True,
                                     fsdp_min_size=fsdp_min_size)
        tr.set_params(params, mask=mask, num_microbatches=n_mb,
                      param_specs=specs)
    return tr


def result(tr: Trainer, history: list) -> dict:
    """Metrics a step, the whole trained tree and the collectives a
    step (kind -> calls, bytes)."""
    params, _ = tr.whole_state()
    per = tr.step_collectives
    n = max(tr.steps_run, 1)
    return {"history": history, "params": params,
            "calls": {k: v / n for k, v in per.count_by_op.items() if v},
            "bytes": {k: v / n for k, v in per.bytes_by_op.items() if v}}


def first_grads(tr: Trainer):
    """This rank's pieces of the first batch's gradients (the step's
    ``compute_grads``), a tree shaped like the parameters."""
    batch = {k: torch.from_numpy(v).long()
             for k, v in pipeline().next_batch().items()}
    grads, _ = tr._step_fn.compute_grads(tr.params, batch)
    return grads


class _Shapes(TorchDispatchMode):
    """Records the shape of every op's output."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def ce_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((CE_B, CE_S, 64), generator=g)
    head = torch.randn((64, CE_VOCAB), generator=g)
    labels = torch.randint(0, CE_VALID, (CE_B, CE_S), generator=g)
    mask = (torch.rand((CE_B, CE_S), generator=g) < 0.7).float()
    return x, head, labels, mask


def vocab_parallel_ce(mesh) -> dict:
    """The CE, accuracy and the gradients of x (whole) and of this rank's
    head slice, vocab-parallel, and the widest last dim of any tensor
    made on the way."""
    x, head, labels, mask = ce_inputs()
    v = CE_VOCAB // mesh.model
    x = x.requires_grad_()
    piece = head[:, mesh.model_rank * v:(mesh.model_rank + 1) * v] \
        .clone().requires_grad_()
    with _Shapes() as rec:
        ce, acc = chunked_cross_entropy(copy_to_model(x, mesh), piece,
                                        labels, mask=mask, chunk=CE_CHUNK,
                                        n_valid=CE_VALID, mesh=mesh)
        gx, gh = torch.autograd.grad(ce, [x, piece])
    return {"ce": ce.detach(), "acc": acc, "gx": gx, "ghead": gh,
            "widest": max(s[-1] for s in rec.shapes if s)}


def world(rank: int, model: int, weights: dict, variants: list,
          fsdp_min_size, extras: dict) -> dict:
    """Every variant in one rank of a world whose model axis is
    ``model``; ``extras`` asks for the model-axis checks (replicated
    gradients, the vocab-parallel CE, a resume from ``ckpt_dir``)."""
    mesh = make_host_mesh(model=model, device="cpu")
    out = {"mesh": mesh.describe(), "ranks": {"model": mesh.ranks,
                                              "data": mesh.data_ranks}}
    for name in variants:
        w = weights["lora" if name == "lora" else "base"]
        tr = trainer(mesh, w, name, fsdp_min_size)
        if name == "full" and extras.get("grads"):
            out["grads"] = first_grads(tr)
            out["specs"] = tr.specs
        steps = 1 if name == "dots" else STEPS
        out[name] = result(tr, tr.run(steps))
    if extras.get("ce"):
        out["ce"] = vocab_parallel_ce(mesh)
    if extras.get("ckpt_dir"):
        # two steps and a checkpoint (rank 0 keeps a copy of it for the
        # single-rank resume), then a new Trainer resumes and runs the
        # third
        base = extras["ckpt_dir"]
        tr = trainer(mesh, weights["base"], "full",
                     ckpt_dir=os.path.join(base, "world"))
        tr.run(2)
        if mesh.rank == 0:
            shutil.copytree(os.path.join(base, "world"),
                            os.path.join(base, "step2"))
        tr = trainer(mesh, None, "full", ckpt_dir=os.path.join(base, "world"))
        out["resumed"] = result(tr, tr.run(STEPS))
        out["resumed"]["from_step"] = 2
    return out

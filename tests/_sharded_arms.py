"""The drives of ``test_torch_sharded_serving.py``: each arm serves the
same requests through one engine, in every rank of a gloo world (under
the rank's mesh) and, with ``mesh=None``, in the test process for the
single-rank side.  This module imports no JAX: the ranks import it."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import LM
from repro_torch.quant import quantize_tree
from repro_torch.sched import SchedEngine
from repro_torch.serve.engine import PagedEngine
from repro_torch.spec import SpecEngine

ENGINES = {"paged": (PagedEngine, {}),
           "sched": (SchedEngine, {"policy": "fcfs", "prefix_cache": True}),
           "spec": (SpecEngine, {"spec": "ngram", "draft_k": 4,
                                 "policy": "fcfs"})}


def widened(cfg):
    """The reference's 4-way smoke config: 8 heads over 4 kv heads."""
    return cfg.with_(attention=dataclasses.replace(
        cfg.attention, num_heads=8, num_kv_heads=4))


def config(arm: dict):
    cfg = get_smoke_config("qwen2-1.5b")
    if arm.get("widened"):
        cfg = widened(cfg)
    return cfg.with_(**arm.get("cfg", {}))


def prompts(vocab: int, n: int = 4, length: int = 16, seed: int = 0):
    """Tiled patterns (the n-gram drafter proposes) of one length, the
    second half of them behind the first prompt's first half (a shared
    prefix for the prefix cache)."""
    rng = np.random.default_rng(seed)
    pats = [rng.integers(0, vocab, (4,)).tolist() for _ in range(n)]
    out = [(p * (length // len(p) + 1))[:length] for p in pats]
    half = length // 2
    return out[:n // 2] + [out[0][:half] + p[:length - half]
                           for p in out[n // 2:]]


def drive(arm: dict, mesh=None) -> dict:
    """Serve ``arm``'s requests; streams, host syncs, the engine's
    counters (wall-clock series dropped) and, under a mesh, the decode
    steps' collectives."""
    cfg = config(arm)
    lm = LM(cfg, device="cpu")
    params = (params_from_numpy(arm["weights"], cfg, device="cpu")
              if "weights" in arm else lm.init(0))
    if arm.get("quant"):
        params = quantize_tree(params, quant=arm["quant"])
    cls, kw = ENGINES[arm["engine"]]
    if arm.get("draft") == "self":
        kw = dict(kw, spec="draft", draft_lm=lm, draft_params=params)
    eng = cls(lm, params, n_slots=2, max_len=64, seed=0, page_size=8,
              decode_block=4, mesh=mesh, **kw)
    ids = [eng.submit(p, max_new_tokens=8)
           for p in prompts(cfg.vocab_size)]
    done = eng.run_to_completion()
    counters = {k: v for k, v in eng.metrics.snapshot()["counters"].items()
                if "seconds" not in k and not k.startswith("tp_")}
    return {"streams": [list(done[i].out_tokens) for i in ids],
            "syncs": eng.sync_count, "counters": counters,
            "decode_collectives": eng.decode_collectives.to_dict(
                steps=max(eng.steps_run, 1))}


def world_arms(rank: int, arms: dict, model: int) -> dict:
    """Every arm in one rank of a world whose model axis is ``model``."""
    mesh = make_host_mesh(model=model, device="cpu")
    out = {}
    for name, arm in arms.items():
        out[name] = drive(arm, mesh)
    out["_mesh"] = {"shape": mesh.shape, "backend": mesh.backend,
                    "threads": torch.get_num_threads()}
    return out

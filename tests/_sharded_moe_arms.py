"""The drives of ``test_torch_sharded_moe.py``: each rank of a gloo world
(and, with ``mesh=None``, the test process for the single-rank side)
computes float32 logits, the loss's metrics and the first-step
gradients of three MoE smoke trees in both dispatches, and serves
granite's through ``PagedEngine`` (and, in the einsum dispatch, through
``SchedEngine`` and the n-gram ``SpecEngine``).  This module imports no JAX: the
ranks import it."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import LM
from repro_torch.sched import SchedEngine
from repro_torch.serve.engine import PagedEngine
from repro_torch.sharding.rules import make_param_specs
from repro_torch.sharding.tp import shard_model
from repro_torch.spec import SpecEngine
from repro_torch.train.loop import loss_and_grads, sharded_grads

#: name -> (arch, expert_pad_multiple): granite's 5 experts split over
#: neither 2 nor 4 ranks (the TP fallback); padded to 6 they split over
#: 2 (EP, one never-routed pad expert) but not 4; llama4-scout's 4
#: experts and its shared expert split over both (EP)
TREES = {"granite": ("granite-moe-3b-a800m", 1),
         "granite_pad2": ("granite-moe-3b-a800m", 2),
         "llama4": ("llama4-scout-17b-a16e", 1)}
DISPATCHES = ("einsum", "gather")
CASES = [(t, d) for t in TREES for d in DISPATCHES]
B, S = 2, 24
#: granite's smoke config with an odd vocabulary: the embedding and the
#: head stay whole under a model axis of 2 (``rules._sanitize``), as
#: granite's 49,155 rows do at full width
ODD_VOCAB = 511


def config(tree: str, dispatch: str, get=get_smoke_config):
    """The float32 smoke config of ``tree`` with 8 query heads over 4 kv
    heads (the reference's 4-way smoke widening: the heads split over 2
    and 4 ranks) and the dispatch ``dispatch``; ``get`` is either
    package's ``get_smoke_config``."""
    arch, pad = TREES[tree]
    cfg = get(arch)
    return cfg.with_(dtype="float32", moe_impl=dispatch,
                     attention=dataclasses.replace(cfg.attention,
                                                   num_heads=8,
                                                   num_kv_heads=4),
                     moe=dataclasses.replace(cfg.moe,
                                             expert_pad_multiple=pad))


def batch(vocab: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tbatch(b: dict) -> dict:
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def forward(cfg, params, mesh=None) -> dict:
    """Logits of the batch, the loss's metrics (the aux losses among
    them) and the first-step gradients (this rank's pieces under
    ``mesh``, with their placements)."""
    lm = LM(cfg, device="cpu")
    b = _tbatch(batch(cfg.vocab_size))
    specs = None
    if mesh is not None:
        specs = make_param_specs(params, mesh)
        lm, params = shard_model(lm, params, mesh)
    with torch.no_grad():
        logits = lm.logits(params, b["tokens"])
    if mesh is None:
        _, metrics, grads = loss_and_grads(lm, params, b)
    else:
        grads, metrics = sharded_grads(lm, params, b, mesh, specs)
    return {"logits": logits, "grads": grads, "specs": specs,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def prompts(vocab: int, n: int = 4, length: int = 12, seed: int = 1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (length - i,)).tolist() for i in range(n)]


#: the engines granite is served through: the paged engine, the FCFS
#: scheduler with its prefix cache and the n-gram speculative engine
ENGINES = {"paged": (PagedEngine, {}),
           "sched": (SchedEngine, {"policy": "fcfs", "prefix_cache": True,
                                   "prefill_chunk": 8}),
           "spec": (SpecEngine, {"spec": "ngram", "draft_k": 3,
                                 "policy": "fcfs", "prefill_chunk": 8})}


def serve(cfg, params, engine: str, mesh=None) -> dict:
    """Greedy streams, host syncs and counters of one engine over
    granite's tree (two slots, so capacity groups hold idle slots and
    padding)."""
    cls, kw = ENGINES[engine]
    eng = cls(LM(cfg, device="cpu"), params, n_slots=2, max_len=48, seed=0,
              page_size=8, decode_block=4, mesh=mesh, **kw)
    ids = [eng.submit(p, max_new_tokens=6) for p in prompts(cfg.vocab_size)]
    done = eng.run_to_completion()
    counters = {k: v for k, v in eng.metrics.snapshot()["counters"].items()
                if "seconds" not in k and not k.startswith("tp_")}
    return {"streams": [list(done[i].out_tokens) for i in ids],
            "syncs": eng.sync_count, "counters": counters}


def odd_vocab(mesh=None) -> dict:
    """Logits of granite's smoke config with an odd vocabulary (weights
    from one seed), whose embedding and head stay whole."""
    cfg = get_smoke_config("granite-moe-3b-a800m").with_(
        dtype="float32", vocab_size=ODD_VOCAB)
    lm = LM(cfg, device="cpu")
    params = lm.init(0)
    out = {}
    if mesh is not None:
        out["embed_rows"] = make_param_specs(params, mesh)["embed"]["w"]
        lm, params = shard_model(lm, params, mesh)
    with torch.no_grad():
        out["logits"] = lm.logits(params, _tbatch(batch(ODD_VOCAB))["tokens"])
    return out


def weights() -> dict:
    """tree -> the port's ``LM.init(0)`` of its config in the reference's
    layout (numpy): the one set of weights both packages and every rank
    load (the dispatch does not change the tree)."""
    from repro_torch.bridge import params_to_numpy
    out = {}
    for tree in TREES:
        cfg = config(tree, "einsum")
        out[tree] = params_to_numpy(LM(cfg, device="cpu").init(0), cfg)
    return out


def run_all(weights: dict, mesh=None) -> dict:
    """Every case on ``weights`` (tree -> reference-layout numpy tree)."""
    out = {}
    for tree, dispatch in CASES:
        cfg = config(tree, dispatch)
        params = params_from_numpy(weights[tree], cfg, device="cpu")
        out[tree, dispatch] = forward(cfg, params, mesh)
        if tree == "granite":
            out[tree, dispatch]["served"] = {
                e: serve(cfg, params, e, mesh)
                for e in (ENGINES if dispatch == "einsum" else ["paged"])}
    if mesh is None or mesh.model == 2:      # granite's smoke heads: 4 / 2
        out["odd_vocab"] = odd_vocab(mesh)
    return out


def world(rank: int, model: int, weights: dict) -> dict:
    mesh = make_host_mesh(model=model, device="cpu")
    out = run_all(weights, mesh)
    out["_mesh"] = mesh.shape
    return out

"""The drives of ``test_torch_whole_heads.py``: every rank of a 4-rank
gloo world runs the whole-heads arm (head counts the model axis does not
divide: the projections gathered whole, attention over every head, the
rank's rows of ``wo``) on the same numpy inputs, and reports what it
computed and the collectives it made.  This module imports no JAX: the
ranks import it."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy, state_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import LM
from repro_torch.sharding.rules import make_param_specs, shard_params
from repro_torch.train.loop import sharded_grads

RANKS = 4
#: the prefill / loss batch, and the whisper cache's length
B, S, T = 2, 32, 64
#: qwen2 smoke cases: (query heads, kv heads); 4 over 2: the query heads
#: divide over 4 ranks and the kv heads do not; 6 over 2: neither does,
#: and wq's 96 columns split 24 a rank, cutting a head of 16
QWEN2 = {"4x2": (4, 2), "6x2": (6, 2)}
#: whisper smoke with 6 heads over 6, which 4 does not divide
WHISPER = (6, 6)


def _heads(cfg, h: int, kvh: int):
    return cfg.with_(attention=dataclasses.replace(
        cfg.attention, num_heads=h, num_kv_heads=kvh))


def qwen2_config(case: str):
    return _heads(get_smoke_config("qwen2-1.5b").with_(dtype="float32"),
                  *QWEN2[case])


def whisper_config():
    """The port's whisper case: its decode takes the context-parallel
    step (the eager decode refuses kv heads the axis does not divide)."""
    return _heads(get_smoke_config("whisper-base").with_(
        dtype="float32", decode_attn_impl="cp"), *WHISPER)


def inputs(vocab: int, d_model: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": (rng.random((B, S)) < 0.7).astype(np.float32),
            "source": rng.standard_normal((B, T, d_model))
            .astype(np.float32),
            "next": rng.integers(0, vocab, (B,)).astype(np.int32)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _calls(mesh, before) -> dict:
    calls = mesh.stats.since(before)
    return {"calls": {k: v for k, v in calls.count_by_op.items() if v},
            "bytes": {k: v for k, v in calls.bytes_by_op.items() if v}}


def _rank_lm(cfg, weights, mesh):
    whole = params_from_numpy(weights, cfg, "cpu")
    specs = make_param_specs(whole, mesh)
    return (LM(cfg.with_(model_parallel=mesh.model), device="cpu",
               mesh=mesh), shard_params(whole, specs, mesh), specs)


def qwen2_case(mesh, case: str, weights, inp: dict) -> dict:
    """Prefill logits and cache, then the loss and this rank's pieces of
    every gradient leaf (``train.loop.sharded_grads``)."""
    lm, params, specs = _rank_lm(qwen2_config(case), weights, mesh)
    before = mesh.stats.copy()
    logits, cache = lm.prefill(params, _t(inp["tokens"]).long(),
                               lm.init_cache(B, S))
    out = {"logits": logits, "cache": cache, "prefill": _calls(mesh, before),
           "specs": specs}
    batch = {k: _t(inp[k]).long() if k != "mask" else _t(inp[k])
             for k in ("tokens", "labels", "mask")}
    before = mesh.stats.copy()
    grads, metrics = sharded_grads(lm, params, batch, mesh, specs)
    out.update(grads=grads, loss=float(metrics["loss"]),
               train=_calls(mesh, before))
    return out


def whisper_case(mesh, weights, inp: dict, ref_cache) -> dict:
    """Prefill with the source, and one decode step from the reference's
    prefilled cache (bridged): this rank's quarter of the self-attention
    cache's positions (the context-parallel step), the source's K / V
    whole (the cross-attention's whole-heads arm)."""
    cfg = whisper_config()
    lm, params, _ = _rank_lm(cfg, weights, mesh)
    before = mesh.stats.copy()
    logits, cache = lm.prefill(params, _t(inp["tokens"]).long(),
                               lm.init_cache(B, T),
                               modality_input=_t(inp["source"]))
    out = {"logits": logits, "cache": cache, "prefill": _calls(mesh, before)}
    n = T // mesh.model
    lo = mesh.model_rank * n
    mine = []
    for group in state_from_numpy(ref_cache, cfg, "cpu"):
        mine.append({blk: {**node, "kv": {k: v[:, lo:lo + n].clone()
                                          for k, v in node["kv"].items()}}
                     for blk, node in group.items()})
    before = mesh.stats.copy()
    out["decode"], _ = lm.decode_step(params, _t(inp["next"]).int(), mine,
                                      torch.tensor(S))
    out["decode_calls"] = _calls(mesh, before)
    return out


def world(rank: int, weights: dict, inps: dict, ref_cache) -> dict:
    torch.manual_seed(0)
    mesh = make_host_mesh(model=RANKS, device="cpu")
    out = {"mesh": mesh.describe()}
    for case in QWEN2:
        out[case] = qwen2_case(mesh, case, weights[case], inps[case])
    out["whisper"] = whisper_case(mesh, weights["whisper"], inps["whisper"],
                                  ref_cache)
    return out

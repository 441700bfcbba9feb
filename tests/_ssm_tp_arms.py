"""The drives of ``test_torch_ssm_tp.py``: every rank of a gloo world runs
RWKV-6 blocks over its heads, Mamba blocks over its channels (the jamba
hybrid) and the encoder / cross-attention models in training, on the
same numpy weights and inputs, and reports what it computed and the
collectives it made.  This module imports no JAX: the ranks import it.

The two worlds (2 and 4 ranks) each run a plan of cases:
  * ``serve``: ``LM.prefill`` over a fresh ``init_cache`` (the rank's
    pieces of the recurrent state), then ``DECODE_STEPS`` decode steps;
  * ``train``: the loss and this rank's pieces of every gradient leaf
    (``train.loop.sharded_grads``), with ``modality_input`` for the
    encoder and cross-attention models;
  * ``engine``: the eager ``Engine`` over ``sharding.tp.shard_model``'s
    rank model, ENGINE_PROMPTS greedy requests on ENGINE_SLOTS slots (a
    slot is zeroed and refilled with the rank's state pieces)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.specs import modality_spec
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import LM
from repro_torch.sharding.rules import make_param_specs, shard_params
from repro_torch.train.loop import sharded_grads

#: prompts and batches: B x S (the reference's chunked WKV takes S <= 64
#: or a multiple of 64: its fault 2)
B, S = 2, 32
DECODE_STEPS = 2
#: the engine drive: prompt lengths (three requests on two slots, so the
#: third reuses a slot) and new tokens a request
ENGINE_PROMPTS, ENGINE_SLOTS, ENGINE_NEW = (9, 32, 20), 2, 4
#: whisper smoke with 6 heads over 6, which 4 does not divide
WHISPER_4 = (6, 6)
#: what each world runs: (case, kind); a case names a config below
PLANS = {2: (("jamba", "serve"), ("jamba", "train"), ("jamba", "engine"),
             ("rwkv6", "serve"), ("rwkv6", "train"), ("rwkv6", "engine"),
             ("whisper", "train"), ("vision", "train")),
         4: (("jamba", "train"), ("rwkv6", "serve"), ("rwkv6", "train"),
             ("whisper6", "train"))}


def config(case: str):
    """The float32 smoke config of ``case``."""
    arch = {"jamba": "jamba-1.5-large-398b", "rwkv6": "rwkv6-1.6b",
            "whisper": "whisper-base", "whisper6": "whisper-base",
            "vision": "llama-3.2-vision-11b"}[case]
    cfg = get_smoke_config(arch).with_(dtype="float32")
    if case == "whisper6":
        cfg = cfg.with_(attention=dataclasses.replace(
            cfg.attention, num_heads=WHISPER_4[0],
            num_kv_heads=WHISPER_4[1]))
    return cfg


def inputs(cfg, seed: int) -> dict:
    """Tokens, labels, a loss mask, the decode steps' tokens and (for the
    encoder and cross-attention models) the source, from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
           "mask": (rng.random((B, S)) < 0.7).astype(np.float32),
           "next": rng.integers(0, cfg.vocab_size, (DECODE_STEPS, B))
           .astype(np.int32),
           "prompts": [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                       for n in ENGINE_PROMPTS]}
    spec = modality_spec(cfg, B)
    if spec is not None:
        out["modality_input"] = rng.standard_normal(spec.shape) \
            .astype(np.float32)
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _calls(mesh, before) -> dict:
    calls = mesh.stats.since(before)
    return {k: (calls.count_by_op[k], calls.bytes_by_op[k])
            for k in sorted(calls.count_by_op) if calls.count_by_op[k]}


def _rank_lm(cfg, weights, mesh):
    whole = params_from_numpy(weights, cfg, "cpu")
    specs = make_param_specs(whole, mesh)
    return (LM(cfg.with_(model_parallel=mesh.model), device="cpu",
               mesh=mesh), shard_params(whole, specs, mesh), specs)


def _states(cache) -> list:
    """The recurrent state leaves of a cache, group by group."""
    return [{blk: node["state"] for blk, node in g.items()
             if "state" in node} for g in cache]


def serve(mesh, cfg, weights, inp: dict) -> dict:
    """Prefill, then DECODE_STEPS decode steps, each rank on its pieces:
    the logits, the state after each, and the collectives of each."""
    lm, params, _ = _rank_lm(cfg, weights, mesh)
    cache = lm.init_cache(B, S + DECODE_STEPS)
    before = mesh.stats.copy()
    logits, cache = lm.prefill(params, _t(inp["tokens"]).long(), cache)
    out = {"logits": logits, "states": [_states(cache)],
           "calls": [_calls(mesh, before)]}
    for i in range(DECODE_STEPS):
        before = mesh.stats.copy()
        step, cache = lm.decode_step(params, _t(inp["next"][i]).int(),
                                     cache, torch.tensor(S + i))
        out["logits_decode"] = out.get("logits_decode", []) + [step]
        out["states"].append(_states(cache))
        out["calls"].append(_calls(mesh, before))
    return out


def engine(mesh, cfg, weights, inp: dict) -> dict:
    """The eager ``Engine``'s greedy token streams: over this rank's
    model (``shard_model``) in a world, over the whole model on one rank
    (``mesh`` of one)."""
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding.tp import shard_model
    lm = LM(cfg, device="cpu")
    params = params_from_numpy(weights, cfg, "cpu")
    if mesh.model > 1:
        lm, params = shard_model(lm, params, mesh)
    eng = Engine(lm, params, n_slots=ENGINE_SLOTS,
                 max_len=max(ENGINE_PROMPTS) + ENGINE_NEW + 1)
    ids = [eng.submit(p, max_new_tokens=ENGINE_NEW) for p in inp["prompts"]]
    done = eng.run_to_completion()
    return {"streams": [list(done[i].out_tokens) for i in ids],
            "state_shapes": {k: tuple(v.shape) for k, v in next(
                node["state"] for node in eng.cache[0].values()
                if "state" in node).items()}}


def train(mesh, cfg, weights, inp: dict) -> dict:
    """The loss and this rank's pieces of every gradient leaf."""
    lm, params, specs = _rank_lm(cfg, weights, mesh)
    batch = {k: _t(inp[k]).long() for k in ("tokens", "labels")}
    batch["mask"] = _t(inp["mask"])
    if "modality_input" in inp:
        batch["modality_input"] = _t(inp["modality_input"])
    before = mesh.stats.copy()
    grads, metrics = sharded_grads(lm, params, batch, mesh, specs)
    return {"grads": grads, "loss": float(metrics["loss"]),
            "calls": _calls(mesh, before), "specs": specs}


def world(rank: int, ranks: int, weights: dict, inps: dict) -> dict:
    torch.manual_seed(0)
    mesh = make_host_mesh(model=ranks, device="cpu")
    out = {"mesh": mesh.describe(), "model_rank": mesh.model_rank}
    for case, kind in PLANS[ranks]:
        fn = {"serve": serve, "train": train, "engine": engine}[kind]
        out[case, kind] = fn(mesh, config(case), weights[case], inps[case])
    return out

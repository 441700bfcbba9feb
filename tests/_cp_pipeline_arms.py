"""The drives of ``test_torch_cp_pipeline.py``: every rank of a gloo world
runs the context-parallel decode (``serve.decode_attn``,
``models.attention.attention_decode_cp``, a decode cell with cp) over its
shard of the cache, and the GPipe pipeline (``sharding.pipeline``) as one
stage, on the same numpy inputs, and reports what it computed and the
collectives it made.  This module imports no JAX: the ranks import it."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import AttentionConfig, ShapeConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models.attention import attention_decode_cp
from repro_torch.serve.decode_attn import context_parallel_decode
from repro_torch.sharding.collectives import tensor_parallel
from repro_torch.sharding.pipeline import pipeline_forward
from repro_torch.sharding.rules import make_param_specs, shard_params

B, S, D_MODEL = 4, 64, 32
#: per-row positions: the last of shard 0 and the first of shard 1 on 4
#: ranks (16 positions a shard), one inside and the last position
POS = (15, 16, 40, 63)
#: raw-decode cases: (heads, kv heads, head dim, position, window)
RAW = [(4, 2, 16, 31, None), (4, 2, 16, 32, None), (8, 2, 16, 40, 24),
       (4, 1, 16, 0, None)]
ATTN = {"gqa": AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                               head_dim=16, rope_theta=10_000.0,
                               qkv_bias=True),
        "window": AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                                  head_dim=16, rope_theta=10_000.0,
                                  window=20)}
#: the pipeline: a stage is a tanh layer on (MB, PD) activations
PD, MB, MAX_M = 8, 3, 5
CELL_SHAPE = ShapeConfig("cp_smoke", S, B, "decode")
#: the cell's two decode steps: each row's position (the first step on
#: and around the shard boundaries of 4 ranks)
CELL_POS = ((10, 16, 31, 47), (11, 17, 32, 48))


def raw_inputs(case: int) -> dict:
    h, kh, hd, _, _ = RAW[case]
    rng = np.random.default_rng(case)
    return {"q": rng.standard_normal((B, h, hd)).astype(np.float32),
            "k": rng.standard_normal((B, S, kh, hd)).astype(np.float32),
            "v": rng.standard_normal((B, S, kh, hd)).astype(np.float32)}


def attn_inputs(name: str) -> dict:
    """Attention weights (the reference's ``init_attention`` layout) with
    non-zero biases, a token per row and a cache filled up to each row's
    position."""
    a = ATTN[name]
    rng = np.random.default_rng(7)
    kvh, hd, h = a.num_kv_heads, a.head_dim, a.num_heads

    def lin(din, dout, bias):
        p = {"w": (rng.standard_normal((din, dout)) / din ** 0.5)
             .astype(np.float32)}
        if bias:
            p["b"] = (0.1 * rng.standard_normal(dout)).astype(np.float32)
        return p
    p = {"wq": lin(D_MODEL, h * hd, a.qkv_bias),
         "wk": lin(D_MODEL, kvh * hd, a.qkv_bias),
         "wv": lin(D_MODEL, kvh * hd, a.qkv_bias),
         "wo": lin(h * hd, D_MODEL, False)}
    k = rng.standard_normal((B, S, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kvh, hd)).astype(np.float32)
    for b, pos in enumerate(POS):
        k[b, pos:] = 0
        v[b, pos:] = 0
    x = rng.standard_normal((B, 1, D_MODEL)).astype(np.float32)
    return {"p": p, "x": x, "k": k, "v": v,
            "pos": np.asarray(POS, np.int32)}


def pipe_inputs(n_stages: int) -> dict:
    rng = np.random.default_rng(n_stages)
    return {"w": (rng.standard_normal((n_stages, PD, PD)) / PD ** 0.5)
            .astype(np.float32),
            "b": (0.1 * rng.standard_normal((n_stages, PD)))
            .astype(np.float32),
            "x": rng.standard_normal((MAX_M, MB, PD)).astype(np.float32)}


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def cell_config():
    return get_smoke_config("qwen2-1.5b").with_(dtype="float32",
                                                decode_attn_impl="cp")


def _shard(t: torch.Tensor, mesh) -> torch.Tensor:
    n = t.shape[1] // mesh.model
    return t[:, mesh.model_rank * n:(mesh.model_rank + 1) * n].contiguous()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def cp_cases(mesh) -> dict:
    out = {"raw": [], "attn": {}}
    for case, (_, _, _, pos, window) in enumerate(RAW):
        inp = raw_inputs(case)
        out["raw"].append(context_parallel_decode(
            _t(inp["q"]), _shard(_t(inp["k"]), mesh),
            _shard(_t(inp["v"]), mesh), pos, mesh, window=window))
    for name, a in ATTN.items():
        inp = attn_inputs(name)
        p = {k: {n: _t(v) for n, v in lin.items()}
             for k, lin in inp["p"].items()}
        specs = make_param_specs({"blk0": {"attn": p}}, mesh)["blk0"]["attn"]
        local = shard_params(p, specs, mesh)
        cache = {"k": _shard(_t(inp["k"]), mesh),
                 "v": _shard(_t(inp["v"]), mesh)}
        before = mesh.stats.copy()
        with tensor_parallel(mesh):
            y, cache = attention_decode_cp(local, _t(inp["x"]), a, cache,
                                           _t(inp["pos"]).long(), mesh)
        calls = mesh.stats.since(before)
        out["attn"][name] = {"y": y, "k": cache["k"], "v": cache["v"],
                             "calls": dict(calls.count_by_op),
                             "bytes": dict(calls.bytes_by_op)}
    return out


def cell_case(mesh, weights, tokens, positions, cache_np) -> dict:
    """A qwen2 smoke decode cell with cp on this world: logits of two
    steps from the whole arguments cut to this rank's pieces."""
    cfg = cell_config()
    cell = build_cell(cfg, CELL_SHAPE, mesh)
    params = params_from_numpy(weights, cfg, "cpu")
    cache = [{blk: {"kv": {k: _t(v).clone() for k, v in node["kv"].items()}}
              for blk, node in grp.items()} for grp in cache_np]
    logits = []
    for tok, pos in zip(tokens, positions):
        args = cell.local((params, _t(tok).int(), cache, _t(pos).int()))
        out, local_cache = cell.fn(*args)
        logits.append(out)
        # write this rank's shard back into its whole copy
        n = S // mesh.model
        for grp, lgrp in zip(cache, local_cache):
            for blk in grp:
                for k in ("k", "v"):
                    grp[blk]["kv"][k][:, mesh.model_rank * n:
                                      (mesh.model_rank + 1) * n] = \
                        lgrp[blk]["kv"][k]
    return {"logits": logits, "cell": cell.name}


def pipe_cases(mesh) -> dict:
    n = mesh.stage
    inp = pipe_inputs(n)
    params = {"w": _t(inp["w"]), "b": _t(inp["b"])}
    local = {k: v[mesh.stage_rank:mesh.stage_rank + 1] for k, v in
             params.items()}
    out = {}
    for m in range(1, MAX_M + 1):
        before = mesh.stats.copy()
        y = pipeline_forward(stage_fn, local, _t(inp["x"][:m]), mesh)
        calls = mesh.stats.since(before)
        out[m] = {"y": y, "calls": dict(calls.count_by_op),
                  "bytes": dict(calls.bytes_by_op)}
    return out


def world(rank: int, n: int, cell_inputs) -> dict:
    """Every case of a world of ``n`` ranks: the cp cases over a model
    axis of n, the pipeline over a stage axis of n."""
    torch.manual_seed(0)
    cp_mesh = make_host_mesh(model=n, device="cpu")
    out = {"cp": cp_cases(cp_mesh), "mesh": cp_mesh.describe()}
    if cell_inputs is not None:
        out["cell"] = cell_case(cp_mesh, *cell_inputs)
    pipe_mesh = make_host_mesh(stage=n, device="cpu")
    out["pipe"] = pipe_cases(pipe_mesh)
    out["pipe_mesh"] = pipe_mesh.describe()
    return out

"""The drives of ``test_torch_sharded_quant_peft.py``: each rank of a gloo
world (and, with ``mesh=None``, the test process for the single-rank
side) serves and trains qwen2-1.5b's float32 smoke config with int8 /
fp8 / int4 weights and with LoRA / DoRA / rsLoRA / QLoRA adapters,
unmerged, through ``LM`` and ``PagedEngine``.  This module imports no JAX: the ranks import it."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import LM
from repro_torch.optim.adamw import cosine_schedule
from repro_torch.peft.lora import merge_lora, trainable_mask
from repro_torch.serve.engine import PagedEngine
from repro_torch.sharding.rules import local_leaf, make_param_specs
from repro_torch.sharding.tp import shard_model
from repro_torch.train.loop import Trainer, loss_and_grads, sharded_grads
from repro_torch.tree import leaves_with_path

#: variant -> (weight quantization, PEFT method)
VARIANTS = {"int8": ("int8", "full"), "fp8": ("fp8", "full"),
            "int4": ("int4", "full"), "lora": (None, "lora"),
            "dora": (None, "dora"), "rslora": (None, "rslora"),
            "qlora": ("int4", "qlora")}
#: the variants trained for a few steps through ``Trainer(mesh=, mask=)``
TRAINED = ("lora", "qlora")
#: the variants served through ``PagedEngine`` (int8 weights are served
#: under the axis since slice 17)
SERVED = ("fp8", "int4", "lora", "qlora")
B, S, STEPS, LR, SEED = 2, 24, 2, 1e-2, 3


def config(**kw):
    """qwen2-1.5b's float32 smoke config with 8 query heads over 4 kv
    heads (the heads split over 2 and 4 ranks)."""
    cfg = get_smoke_config("qwen2-1.5b")
    return cfg.with_(dtype="float32", quant_matmul_impl="fused",
                     attention=dataclasses.replace(cfg.attention,
                                                   num_heads=8,
                                                   num_kv_heads=4), **kw)


def batch(vocab: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tbatch(b: dict) -> dict:
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _wide(t):
    """fp8 tensors widened to float32 (exactly) for the pipe back."""
    if isinstance(t, torch.Tensor) and t.dtype == torch.float8_e4m3fn:
        return t.float()
    return t


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def forward(variant: str, weights, mesh=None) -> dict:
    """Prefill-sized (M 48) and decode-sized (M 2) logits, the loss's
    metrics and the first-step gradients (this rank's pieces and their
    placements under ``mesh``) of one variant's tree."""
    cfg = config()
    lm = LM(cfg, device="cpu")
    params = params_from_numpy(weights, cfg, device="cpu")
    b = _tbatch(batch(cfg.vocab_size))
    specs = None
    if mesh is not None:
        specs = make_param_specs(params, mesh)
        lm, params = shard_model(lm, params, mesh)
    with torch.no_grad():
        logits = lm.logits(params, b["tokens"])
        step = lm.logits(params, b["tokens"][:, :1])
    if mesh is None:
        _, metrics, grads = loss_and_grads(lm, params, b)
    else:
        grads, metrics = sharded_grads(lm, params, b, mesh, specs)
    return {"logits": logits, "step_logits": step, "specs": specs,
            "grads": _map(_wide, grads),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def serve(variant: str, weights, mesh=None) -> dict:
    """Greedy streams, host syncs and counters of ``PagedEngine`` over the
    variant's tree (decode steps take the row-split fp8 partial's B6
    plain version at M 2)."""
    cfg = config()
    eng = PagedEngine(LM(cfg, device="cpu"),
                      params_from_numpy(weights, cfg, device="cpu"),
                      n_slots=2, max_len=48, seed=0, page_size=8,
                      decode_block=4, mesh=mesh)
    rng = np.random.default_rng(1)
    ids = [eng.submit(rng.integers(0, cfg.vocab_size, (12 - i,)).tolist(),
                      max_new_tokens=6) for i in range(4)]
    done = eng.run_to_completion()
    counters = {k: v for k, v in eng.metrics.snapshot()["counters"].items()
                if "seconds" not in k and not k.startswith("tp_")}
    return {"streams": [list(done[i].out_tokens) for i in ids],
            "syncs": eng.sync_count, "counters": counters}


def train(variant: str, weights, mesh=None) -> dict:
    """``STEPS`` steps of ``Trainer`` with the variant's trainable mask:
    the history and the whole trained adapters."""
    cfg = config()
    pipe = SyntheticLMData(cfg.vocab_size, S, B, seed=SEED)
    tr = Trainer(LM(cfg, device="cpu"), pipe, mesh=mesh, log_every=1,
                 lr=cosine_schedule(LR, 1, STEPS), log_fn=lambda _m: None)
    tr.init_or_resume(SEED)
    params = params_from_numpy(weights, cfg, device="cpu")
    mask = trainable_mask(params, VARIANTS[variant][1])
    tr.set_params(params, mask=mask)
    hist = tr.run(STEPS)
    whole, opt = tr.whole_state()
    return {"history": [{k: v for k, v in h.items() if k != "dt"}
                        for h in hist],
            "adapters": {p: t for p, t in leaves_with_path(whole)
                         if "/lora/" in p},
            "moments": sum(t.numel() for t in
                           [v for _, v in leaves_with_path(opt.mu)])}


def merged(weights, mesh) -> dict:
    """The LoRA tree merged on this rank's pieces (``merge_lora(mesh=)``)
    against this rank's piece of the whole tree merged: the largest
    difference of each leaf."""
    cfg = config()
    params = params_from_numpy(weights, cfg, device="cpu")
    _, local = shard_model(LM(cfg, device="cpu"), params, mesh)
    got = dict(leaves_with_path(merge_lora(local, mesh)))
    whole = merge_lora(params)
    return {p: float((got[p] - local_leaf(t, s, mesh)).abs().max())
            for (p, t), (_, s) in zip(
                leaves_with_path(whole),
                leaves_with_path(make_param_specs(whole, mesh)))}


def int8_ties(model: int, mesh=None) -> dict:
    """The gradients of x and of the weight scale through one int8 linear
    in a training forward (impl ``"train"``), row-split over ``mesh`` (the
    rank's slice of K; ``mesh=None``: the whole linear on one rank), on
    rows whose absolute maximum is planted to tie: across the first and
    last rank's slices, within one slice, on every slice, and nowhere."""
    from repro_torch.quant.qops import quantized_matmul, row_partial
    from repro_torch.sharding.collectives import tensor_parallel
    from repro_torch.sharding.tp import row_linear
    k, n = 4 * model, 8
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (4, k)).astype(np.float32)
    x[0, 1], x[0, k - 2] = 3.0, -3.0
    x[1, 0], x[1, 2] = -2.0, 2.0
    x[2, ::4] = 2.5
    qw = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.from_numpy(
        rng.uniform(0.5, 1.5, n).astype(np.float32)).requires_grad_()
    w_out = torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32))
    if mesh is None:
        xt = torch.from_numpy(x).requires_grad_()
        y = quantized_matmul(xt, {"qw": qw, "scale": scale}, impl="train")
    else:
        rows = slice(mesh.model_rank * 4, (mesh.model_rank + 1) * 4)
        xt = torch.from_numpy(x[:, rows].copy()).requires_grad_()
        with tensor_parallel(mesh):
            y = row_linear(row_partial(xt, {"qw": qw[rows], "scale": scale},
                                       "train", mesh), torch.float32, None,
                           mesh)
    (y * w_out).sum().backward()
    return {"y": y.detach(), "x": xt.grad, "scale": scale.grad}


def run_all(weights: dict, mesh=None) -> dict:
    out = {v: forward(v, weights[v], mesh) for v in VARIANTS}
    for v in TRAINED:
        out[v]["train"] = train(v, weights[v], mesh)
    for v in SERVED:
        out[v]["served"] = serve(v, weights[v], mesh)
    if mesh is not None:
        out["merged"] = merged(weights["lora"], mesh)
    return out


def world(rank: int, model: int, weights: dict) -> dict:
    mesh = make_host_mesh(model=model, device="cpu")
    out = run_all(weights, mesh)
    out["int8_ties"] = int8_ties(model, mesh)
    return out

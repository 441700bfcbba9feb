"""RWKV-6 blocks split by heads, Mamba blocks split by channels (the jamba
hybrid), and the encoder and cross-attention models in training, under a
model axis, over gloo worlds of 2 and 4 ranks on the CPU, held to the
reference's one-device functions (``models.ssm``'s tensor-parallel step).

Two worlds are started once for the module, together
(``_ssm_tp_arms.py``); meanwhile this process runs the reference's jitted
``LM.prefill`` / ``decode_step`` and ``jax.grad`` of its ``LM.loss`` on
the same numpy weights and inputs, each program compiled once.  Float32
throughout:
* jamba smoke on 2 ranks (Mamba + attention, 4 experts), serving:
  prefill and 2 decode steps, each rank's ``ssm`` / ``conv`` pieces
  within 1e-5 of the reference's state sliced, the logits within 1e-5
  of the port's one rank and within 1e-4 of the reference's (the bar of
  ``test_torch_jamba.py``: one rank of the port is as far); a Mamba
  layer makes 1 all-gather and 2 all-reduces (ROADMAP C.5: on the parent
  tree this prefill raised);
* rwkv6 smoke (4 heads of 16) on 2 and 4 ranks, serving: states within
  1e-5, logits within trap 6's 1e-2 (the gate is rounded to bf16 before
  ``wout``, in float32 too);
* the eager ``Engine`` over ``sharding.tp.shard_model``'s rank model,
  jamba and rwkv6 smoke on 2 ranks: three greedy requests on two slots,
  token for token the streams of the port's one rank;
* training, jamba on 2 and 4 ranks (on 4 its 4 over 2 heads take the
  whole-heads arm), rwkv6 on 2 and 4, whisper and vision smoke on 2,
  whisper with 6 heads over 6 on 4: the loss within 1e-5 and every
  gradient leaf, reassembled from the ranks' pieces, within 1e-4
  relative L2 of ``jax.grad``.  rwkv6's leaves are held each to the
  larger of 1e-3 and 3x a floor measured on one rank of the port (trap
  9, as phase 29 (b) holds the card): the gate is rounded to bf16 before
  ``wout`` (trap 6), so an fp32 ulp upstream moves a gradient by a bf16
  ulp's share.  A leaf's floor is the larger of the one-rank port's
  distance from ``jax.grad`` and the distance the mask-weighted mean of
  two half batches' gradients puts from the whole batch's (``u``: 6.1e-3
  and 1.0e-2; the block's other leaves 2.4e-3 to 5.9e-3).  ``final_norm``
  and ``lm_head`` have floors under 3.3e-5 and read up to 3.9x theirs
  (1.1e-4 on two ranks): the row-split sums reorder the forward, which
  neither witness does, so 1e-3 is their bar;
* what still refuses, with A8.8's label: RWKV-6 heads and a d_inner the
  axis does not divide;
* ``launch.train --arch jamba-1.5-large-398b --smoke --model-parallel 2``.
The file's budget is 60 s of worker time (the two worlds beside the
reference's compiles, and the CLI's world; about 45 s alone)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _ssm_tp_arms as arms  # noqa: E402
from _train_pairs import assert_trees_close, flat, rel_l2  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch.bridge import (params_from_numpy,  # noqa: E402
                                params_to_numpy, state_from_numpy)
from repro_torch.launch.mesh import make_host_mesh, spawn_world  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.sharding.rules import unshard  # noqa: E402
from repro_torch.sharding.tp import (check_servable,  # noqa: E402
                                     check_trainable)
from repro_torch.train.loop import loss_and_grads  # noqa: E402

TOL, GRAD_TOL = 1e-5, 1e-4
RWKV_LOGIT_TOL = 1e-2           # trap 6
#: rwkv6's gradients: a leaf within the larger of RWKV_GRAD_TOL and
#: RWKV_FLOOR_FACTOR x its one-rank floor (trap 9)
RWKV_GRAD_TOL, RWKV_FLOOR_FACTOR = 1e-3, 3.0
JAMBA_LOGIT_TOL = 1e-4          # one rank of the port (test_torch_jamba)
#: the train cases: (case, ranks)
TRAIN = [("jamba", 2), ("jamba", 4), ("rwkv6", 2), ("rwkv6", 4),
         ("whisper", 2), ("vision", 2), ("whisper6", 4)]
CASES = ("jamba", "rwkv6", "whisper", "whisper6", "vision")


def _jconfig(case: str):
    tcfg = arms.config(case)
    jcfg = jconfigs.get_smoke_config(tcfg.name).with_(dtype="float32")
    return jcfg.with_(attention=tcfg.attention)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _serve_reference(jlm, jp, inp) -> dict:
    """The reference's prefill into a fresh cache and DECODE_STEPS decode
    steps: logits and the cache after each."""
    cache = jlm.init_cache(arms.B, arms.S + arms.DECODE_STEPS)
    logits, cache = jax.jit(jlm.prefill)(jp, jnp.asarray(inp["tokens"]),
                                         cache)
    out = {"logits": np.asarray(logits), "caches": [cache], "decode": []}
    step = jax.jit(jlm.decode_step)
    for i in range(arms.DECODE_STEPS):
        dec, cache = step(jp, jnp.asarray(inp["next"][i]), cache,
                          arms.S + i)
        out["decode"].append(np.asarray(dec))
        out["caches"].append(cache)
    out["caches"] = [jax.tree.map(np.asarray, c) for c in out["caches"]]
    return out


def _train_reference(jlm, jp, inp) -> dict:
    batch = {k: jnp.asarray(v) for k, v in inp.items()
             if k not in ("next", "prompts")}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jlm.loss, has_aux=True, allow_int=True))(jp, batch)
    return {"loss": float(loss), "grads": grads}


def _grad_floors(case: str, weights, inp) -> dict:
    """One rank of the port's gradients (flat, the reference's layout):
    of the whole batch (``whole``) and the mask-weighted mean of two half
    batches' (``halves``), the two that a leaf's floor compares."""
    cfg = arms.config(case)
    lm = LM(cfg, device="cpu")
    params = params_from_numpy(weights, cfg, "cpu")
    batch = {k: torch.from_numpy(inp[k]).long() for k in ("tokens",
                                                          "labels")}
    batch["mask"] = torch.from_numpy(inp["mask"])
    half = arms.B // 2
    n = batch["mask"].sum(1)
    share = float(n[:half].sum() / n.sum())
    whole = flat(params_to_numpy(loss_and_grads(lm, params, batch)[2], cfg))
    halves = [flat(params_to_numpy(loss_and_grads(
        lm, params, {k: v[i * half:(i + 1) * half]
                     for k, v in batch.items()})[2], cfg)) for i in range(2)]
    return {"whole": whole,
            "halves": {k: share * halves[0][k] + (1 - share) * halves[1][k]
                       for k in whole}}


@pytest.fixture(scope="module")
def runs():
    """Both worlds' results and the reference's.  The weights are the
    port's ``LM.init`` trees in the reference's layout, so the worlds
    start before the reference compiles anything."""
    from concurrent.futures import ThreadPoolExecutor
    weights, inps = {}, {}
    for seed, case in enumerate(CASES):
        cfg = arms.config(case)
        weights[case] = params_to_numpy(LM(cfg, device="cpu").init(seed),
                                        cfg)
        inps[case] = arms.inputs(cfg, seed)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(2) as pool:
            worlds = {n: pool.submit(spawn_world, arms.world, n, n, weights,
                                     inps, device="cpu", threads=1)
                      for n in arms.PLANS}
            refs = {}
            for case in CASES:
                jlm = JLM(_jconfig(case))
                jp = jax.tree.map(jnp.asarray, weights[case])
                kinds = {k for plan in arms.PLANS.values()
                         for c, k in plan if c == case}
                refs[case] = {k: (_serve_reference if k == "serve"
                                  else _train_reference)(jlm, jp,
                                                         inps[case])
                              for k in kinds & {"serve", "train"}}
            # the port's one rank, serving
            one = make_host_mesh(device="cpu")
            for case in ("jamba", "rwkv6"):
                refs[case]["one_rank"] = arms.serve(
                    one, arms.config(case), weights[case], inps[case])
                refs[case]["engine"] = arms.engine(
                    one, arms.config(case), weights[case], inps[case])
            refs["rwkv6"]["floors"] = _grad_floors(
                "rwkv6", weights["rwkv6"], inps["rwkv6"])
            ranks = {n: w.result() for n, w in worlds.items()}
    finally:
        torch.set_num_threads(threads)
    return ranks, refs


def _assert_state_pieces(rank: dict, states: list, want: list, m: int):
    """A rank's recurrent state leaves against whole ones (``want``, the
    port's layout, group by group), sliced where the rank holds a piece
    (the dim whose size differs; RWKV-6's ``x_prev`` is whole on every
    rank), within 1e-5."""
    seen = 0
    for g, wg in zip(states, want):
        for blk, st in g.items():
            for name, leaf in st.items():
                w = wg[blk][name]
                dims = [i for i in range(w.ndim) if leaf.shape[i]
                        != w.shape[i]]
                assert len(dims) == (name != "x_prev"), (blk, name,
                                                          leaf.shape,
                                                          w.shape)
                for d in dims:
                    n = leaf.shape[d]
                    assert n * m == w.shape[d]
                    w = w.narrow(d, rank["model_rank"] * n, n)
                _close(leaf, w)
                seen += 1
    assert seen


def _predicted(cfg, kind_counts: dict) -> dict:
    """A rank's model collectives a serving forward: an all-gather a
    Mamba layer (``in_proj``) and the logits'; an all-reduce a Mamba
    layer's ``x_proj`` and ``out_proj``, an RWKV-6 layer's ``wout``, an
    attention layer's ``wo``, every layer's MLP or MoE, and the
    embedding's."""
    n = {k: kind_counts.get(k, 0) for k in ("mamba", "rwkv6", "attn")}
    return {"all-gather/model": n["mamba"] + 1,
            "all-reduce/model": 2 * n["mamba"] + n["rwkv6"] + n["attn"]
            + cfg.num_layers + 1}


def _kinds(cfg) -> dict:
    out = {}
    for k in cfg.block_pattern * cfg.num_groups:
        out[k] = out.get(k, 0) + 1
    return out


def _assert_serving(runs, case: str, n: int, ref_tol: float,
                    one_tol: float):
    """Each rank's logits (prefill, then each decode step) within
    ``ref_tol`` of the reference's and ``one_tol`` of the port's one
    rank, its state pieces within 1e-5 of both, and its collectives a
    call the predicted count."""
    ranks, refs = runs
    cfg = arms.config(case)
    ref, one = refs[case]["serve"], refs[case]["one_rank"]
    jstates = [[{blk: node["state"] for blk, node in g.items()
                 if "state" in node}
                for g in state_from_numpy(c, cfg, "cpu")]
               for c in ref["caches"]]
    want = _predicted(cfg, _kinds(cfg))
    for r in ranks[n]:
        got = r[case, "serve"]
        for mine, j, o in zip([got["logits"], *got["logits_decode"]],
                              [ref["logits"], *ref["decode"]],
                              [one["logits"], *one["logits_decode"]]):
            _close(mine, j, ref_tol)
            _close(mine, o, one_tol)
        for states, js, os_ in zip(got["states"], jstates, one["states"]):
            _assert_state_pieces(r, states, js, n)
            _assert_state_pieces(r, states, os_, n)
        for calls in got["calls"]:
            assert {k: c for k, (c, _) in calls.items()} == want


def test_jamba_serving_on_two_ranks_matches_reference(runs):
    """ROADMAP C.5: jamba smoke's prefill on two ranks (each with its own
    ``init_cache``: the rank's channels of every Mamba state) gives the
    reference's logits within 1e-5 and each rank's ``ssm`` / ``conv``
    pieces within 1e-5 of its state sliced, and so do 2 decode steps.  A
    Mamba layer makes 1 all-gather (``in_proj``) and 2 all-reduces
    (``x_proj``, ``out_proj``) a call.  The logits are within 1e-5 of the
    port's one rank and within 1e-4 of the reference's (one rank of the
    port is as far: ``test_torch_jamba.py``).  On the parent tree the
    prefill raised ("Sizes of tensors must match")."""
    _assert_serving(runs, "jamba", 2, JAMBA_LOGIT_TOL, TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_rwkv6_serving_over_heads_matches_reference(runs, n):
    """rwkv6 smoke's 4 heads over n ranks (2 or 1 a rank): every rank's
    ``wkv`` heads and its whole ``x_prev`` within 1e-5 of the reference's
    state after prefill and after each of 2 decode steps (and of the
    port's one rank's), the logits within trap 6's 1e-2 of both; a layer
    makes no all-gather and 1 all-reduce (``wout``) beside its MLP's."""
    _assert_serving(runs, "rwkv6", n, RWKV_LOGIT_TOL, RWKV_LOGIT_TOL)


@pytest.mark.parametrize("case", ["jamba", "rwkv6"])
def test_engine_over_rank_model_matches_one_rank(runs, case):
    """The eager ``Engine`` over ``shard_model``'s rank model on two
    ranks (the servable check passes RWKV-6 and Mamba blocks): each
    rank's cache holds its pieces of the recurrent state (``wkv``'s
    heads, Mamba's channels; ``x_prev`` whole), a slot is zeroed and
    refilled for the third request, and the greedy streams equal the
    port's one rank's token for token."""
    ranks, refs = runs
    one = refs[case]["engine"]
    for r in ranks[2]:
        got = r[case, "engine"]
        assert got["streams"] == one["streams"]
        assert [len(s) for s in got["streams"]] == \
            [arms.ENGINE_NEW] * len(arms.ENGINE_PROMPTS)
        for name, shape in got["state_shapes"].items():
            whole = one["state_shapes"][name]
            split = [i for i, (a, b) in enumerate(zip(shape, whole))
                     if a != b]
            assert split == ([] if name == "x_prev" else
                             [1 if name in ("wkv", "ssm") else 2]), name
            for i in split:
                assert shape[i] * 2 == whole[i]


@pytest.mark.parametrize("case,n", TRAIN)
def test_training_matches_reference_gradients(runs, case, n):
    """The loss on each rank within 1e-5 of the reference's, and every
    gradient leaf reassembled from the ranks' pieces within 1e-4 relative
    L2 of ``jax.grad`` of its ``LM.loss`` (rwkv6: each leaf within the
    larger of 1e-3 and 3x its one-rank floor, trap 9).  The whole leaves
    a rank
    reads only in part (RWKV-6's ``u``, ``ln_x``, the decay and the mix
    through ``logw``'s slice; Mamba's ``x_proj`` output; the encoder's
    output under the cross-attention's column split) get their gradients
    summed over the axis."""
    ranks, refs = runs
    cfg = arms.config(case)
    ref = refs[case]["train"]
    for r in ranks[n]:
        np.testing.assert_allclose(r[case, "train"]["loss"], ref["loss"],
                                   rtol=TOL)
    got = ranks[n][0][case, "train"]
    grads = unshard([r[case, "train"]["grads"] for r in ranks[n]],
                    got["specs"], {"data": 1, "model": n})
    if case != "rwkv6":
        assert_trees_close(grads, ref["grads"], cfg, GRAD_TOL, "grads")
        return
    got, want = flat(params_to_numpy(grads, cfg)), flat(ref["grads"])
    floors = refs[case]["floors"]
    assert got.keys() == want.keys()
    bad = {}
    for k, w in want.items():
        floor = max(rel_l2(floors["whole"][k], w),
                    rel_l2(floors["halves"][k], floors["whole"][k]))
        limit = max(RWKV_GRAD_TOL, RWKV_FLOOR_FACTOR * floor)
        if not rel_l2(got[k], w) <= limit:
            bad[k] = (rel_l2(got[k], w), limit)
    assert not bad, bad


def test_what_still_refuses_names_a88():
    """RWKV-6 heads the axis does not divide (4 on 8) and a Mamba d_inner
    it does not divide (128 on 3) are refused in serving and training,
    each with A8.8's label."""
    rwkv = arms.config("rwkv6").with_(model_parallel=8)
    jamba = arms.config("jamba")
    mamba = jamba.with_(block_pattern=("mamba",), attention=None, moe=None,
                        d_ff=96, num_layers=2, model_parallel=3)
    for cfg, what in ((rwkv, "4 RWKV-6 heads"), (mamba, "d_inner 128")):
        for check in (check_trainable, lambda c, p: check_servable(
                c, p, cell="prefill")):
            with pytest.raises(ValueError, match=f"{what}.*A8.8"):
                check(cfg, {})


def test_train_cli_trains_jamba_on_two_ranks(tmp_path):
    """``python -m repro_torch.launch.train --arch jamba-1.5-large-398b
    --smoke --device cpu --model-parallel 2`` trains (it exited on A8.6's
    refusal before): exit 0, rank 0's mesh line, two reports whose
    collectives a step carry one reduce-scatter a Mamba layer (the
    ``in_proj`` gather's backward), finite losses."""
    import contextlib
    import io
    import json
    from repro_torch.launch.train import main
    hist = tmp_path / "history.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--arch", "jamba-1.5-large-398b", "--smoke", "--device",
                   "cpu", "--steps", "2", "--model-parallel", "2",
                   "--global-batch", "2", "--seq-len", "32",
                   "--log-every", "1", "--history-out", str(hist)])
    out = buf.getvalue()
    assert rc == 0
    assert "mesh {'data': 1, 'model': 2} over 2 ranks (gloo, cpu)" in out
    reports = [json.loads(ln.split(" report ", 1)[1])
               for ln in out.splitlines() if ln.startswith("[train] rank ")]
    assert len(reports) == 2
    mamba = _kinds(arms.config("jamba"))["mamba"]
    for r in reports:
        assert r["collectives_a_step"]["reduce-scatter/model"][0] == mamba
    losses = [h["loss"] for h in json.loads(hist.read_text())]
    assert len(losses) == 2 and np.isfinite(losses).all()

"""Sharded training of the port over gloo worlds on the CPU, held to the
reference's single-device step.

The reference's sharded step computes the function of its single-device
step (GSPMD keeps the semantics; ``repro/train/loop.py`` runs the same
jitted step under its mesh), and JAX cannot give a second CPU device in
this process, so each world is held to JAX's single-device
``make_train_step``.  Three worlds are started once for the module and
run at the same time (``_sharded_train_arms.py``): a model axis of 2; a
data axis of 2 with FSDP at ``fsdp_min_size=1`` (every leaf the rule can
split, split); and 2 x 2 with FSDP.  Meanwhile this process runs the JAX
steps, the CLI and the single-rank checks.  qwen2-1.5b's float32 smoke
config (4 query heads over 2 kv heads, QKV bias), batch 4 x 128, two CE
chunks of 64, three steps of the cosine schedule from 1e-2."""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _sharded_train_arms as arms  # noqa: E402
from _train_pairs import flat, pair, rel_l2  # noqa: E402
from repro.core import apply as japply  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.peft import lora as jlora  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.models.model import chunked_cross_entropy  # noqa: E402
from repro_torch.sharding.rules import unshard  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

#: world -> (model axis, world size, FSDP's minimum size, variants)
WORLDS = {"model2": (2, 2, None, ["full", "microbatch2", "topk", "int8",
                                  "dots"]),
          "data2_fsdp": (1, 2, 1, ["full", "microbatch2", "lora"]),
          "2x2_fsdp": (2, 4, 1, ["full"])}
CASES = [(w, v) for w, (*_, vs) in WORLDS.items() for v in vs
         if v != "dots"]
TOL = 1e-4


def _jax_run(jlm, p, name: str) -> dict:
    """Three steps of JAX's single-device step for ``name``: the metrics
    of every step and the final tree."""
    method, n_mb, comp, _ = arms.VARIANTS[name]
    mask = None if method == "full" else jlora.trainable_mask(p, method)
    step = jax.jit(jloop.make_train_step(
        jlm, lr=jadamw.cosine_schedule(arms.LR, 1, arms.STEPS),
        mask=mask, num_microbatches=n_mb, compress=comp))
    opt = jadamw.init_adamw(p, mask)
    err = opt.mu if comp == "none" else jcompress.init_error_feedback(p)
    pipe = jdata.SyntheticLMData(512, arms.SEQ, arms.BATCH, seed=arms.SEED)
    hist = []
    for _ in range(arms.STEPS):
        b = {k: jnp.asarray(v) for k, v in pipe.next_batch().items()}
        p, opt, err, m = step(p, opt, b, err)
        hist.append({k: float(v) for k, v in m.items()})
    return {"history": hist, "params": p}


def _jax_runs(jlm, jp, jp_lora) -> dict:
    """:func:`_jax_run` for every variant, compiled side by side, and the
    gradient of the first batch on the base weights."""
    from concurrent.futures import ThreadPoolExecutor
    names = [n for n in arms.VARIANTS if n != "dots"]
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(_jax_run, jlm, jp_lora if arms.VARIANTS[
            n][0] == "lora" else jp, n) for n in names}
        b = {k: jnp.asarray(v) for k, v in jdata.SyntheticLMData(
            512, arms.SEQ, arms.BATCH, seed=arms.SEED).next_batch().items()}
        grads = jax.jit(jax.grad(lambda q: jlm.loss(q, b)[0]))(jp)
        out = {n: f.result() for n, f in futures.items()}
    out["grads"] = grads
    return out


def _one_rank_runs(weights) -> dict:
    """The port's single-rank Trainer on the same variants: the trained
    tree of each."""
    out = {}
    for name, (method, *_) in arms.VARIANTS.items():
        if name != "dots":
            tr = arms.trainer(None, weights[method if method == "lora"
                                            else "base"], name)
            tr.run(arms.STEPS)
            out[name] = tr.params
    return out


def _cli_runs(tmp) -> list:
    """(exit code, stdout, history) of ``launch.train`` on one rank and
    on two (nothing else in this process prints while they run; the two
    ranks start first)."""
    from repro_torch.launch.train import main
    out = []
    for n in (2, 1):
        hist = tmp / f"history{n}.json"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--model-parallel", str(n),
                       "--global-batch", "4", "--seq-len", "64",
                       "--log-every", "1", "--history-out", str(hist)])
        out.append((rc, buf.getvalue(), json.loads(hist.read_text())))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor
    jlm, _, jp, _ = pair("qwen2-1.5b")
    eff = jspace.EfficiencyConfig(jspace.ArchChoice(),
                                  jspace.FtChoice("lora", 4, 2),
                                  jspace.InfChoice())
    jp_lora = japply.apply_to_params(jp, eff, jax.random.PRNGKey(1))
    weights = {"base": jax.tree.map(np.asarray, jp),
               "lora": jax.tree.map(np.asarray, jp_lora)}
    ckpt = tmp_path_factory.mktemp("world_ckpt")
    extras = {"model2": {"grads": True, "ce": True, "ckpt_dir": str(ckpt)},
              "data2_fsdp": {"grads": True}, "2x2_fsdp": {"grads": True}}
    # this process's torch work is tiny: one thread, beside the ranks
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(len(WORLDS) + 1) as pool:
            worlds = {name: pool.submit(spawn_world, arms.world, n, model,
                                        weights, variants, min_size,
                                        extras[name], device="cpu",
                                        threads=1)
                      for name, (model, n, min_size, variants)
                      in WORLDS.items()}
            cli = pool.submit(_cli_runs, tmp_path_factory.mktemp("cli"))
            jax_runs = _jax_runs(jlm, jp, jp_lora)
            one_rank = _one_rank_runs(weights)
            return {"worlds": {k: f.result() for k, f in worlds.items()},
                    "jax": jax_runs, "one_rank": one_rank,
                    "cli": cli.result(), "ckpt": ckpt}
    finally:
        torch.set_num_threads(threads)


def _flat(t_tree) -> dict:
    return flat(params_to_numpy(t_tree, arms.config()))


#: an element of a leaf is well conditioned where its first-step gradient
#: is at least this share of the leaf's largest
WELL_CONDITIONED = 1e-3


def _assert_tree_matches(t_tree, runs, variant, what):
    """Every float leaf of ``t_tree`` (whole) within TOL relative L2 of
    JAX's.  Where the port's own single-rank step is already farther than
    TOL from JAX, the leaf holds elements whose gradient is a near
    cancellation (the key bias's slow RoPE pairs: a rotation almost
    constant over the positions, so softmax almost cancels it), computed
    to a few 1e-4 relative by either side; AdamW divides each element's
    step by its own gradient scale and carries that error into the step.
    There the leaf is held within TOL on its well-conditioned elements
    (first-step gradient at least WELL_CONDITIONED of the leaf's
    largest), or, for a leaf the base tree has no gradient for (the LoRA
    adapters), within TOL of the single-rank step."""
    got, want = _flat(t_tree), flat(runs["jax"][variant]["params"])
    one = _flat(runs["one_rank"][variant])
    grads = flat(runs["jax"]["grads"])
    assert got.keys() == want.keys() == one.keys(), what
    bad = {}
    for k in want:
        if want[k].dtype.kind != "f":
            continue
        if rel_l2(one[k], want[k]) <= TOL:
            err = rel_l2(got[k], want[k])
        elif k in grads:
            g = np.abs(grads[k])
            keep = g >= WELL_CONDITIONED * g.max()
            err = rel_l2(got[k][keep], want[k][keep])
        else:
            err = rel_l2(got[k], one[k])
        if not err <= TOL:
            bad[k] = err
    assert not bad, (what, bad)


def _metrics(row: dict) -> dict:
    return {k: v for k, v in row.items() if k != "dt"}


@pytest.mark.parametrize("world,variant", CASES)
def test_world_matches_jax_single_device_step(runs, world, variant):
    """Every step's loss, CE and gradient norm within 1e-4 of JAX's
    single-device step on every rank (so every rank reports the same
    metrics), and every leaf of the trained tree, unsharded, within 1e-4
    relative L2 (see ``_assert_tree_matches``)."""
    want = runs["jax"][variant]
    ranks = runs["worlds"][world]
    for r, res in enumerate(ranks):
        got = res[variant]["history"]
        assert len(got) == arms.STEPS
        for g, w in zip(got, want["history"]):
            for k in ("loss", "ce_loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=TOL,
                                           err_msg=f"{world} rank {r} {k}")
        assert [_metrics(h) for h in got] == \
            [_metrics(h) for h in ranks[0][variant]["history"]]
    _assert_tree_matches(ranks[0][variant]["params"], runs, variant,
                         f"{world} {variant}")


@pytest.mark.parametrize("world", list(WORLDS))
def test_first_step_gradients_match_jax(runs, world):
    """The first batch's gradient of every leaf, joined from the ranks'
    pieces, within 1e-4 relative L2 of JAX's single-device gradient."""
    ranks = runs["worlds"][world]
    model, n, _, _ = WORLDS[world]
    grads = unshard([r["grads"] for r in ranks], ranks[0]["specs"],
                    {"data": n // model, "model": model})
    got, want = _flat(grads), flat(runs["jax"]["grads"])
    assert got.keys() == want.keys()
    bad = {k: rel_l2(got[k], want[k]) for k in want
           if not rel_l2(got[k], want[k]) <= TOL}
    assert not bad, bad


def test_replicated_leaves_get_equal_gradients_on_every_model_rank(runs):
    """Leaves whole over the model axis (the norms) get the same gradient
    on both model ranks, bit for bit: the f / g pairs make them equal."""
    r0, r1 = runs["worlds"]["model2"]
    specs = dict(leaves_with_path(r0["specs"]))
    g0, g1 = (dict(leaves_with_path(r["grads"])) for r in (r0, r1))
    whole = [p for p, s in specs.items() if all(e is None for e in s)]
    assert whole and all("norm" in p for p in whole)
    for p in whole:
        assert torch.equal(g0[p], g1[p]), p
    split = [p for p, s in specs.items() if "model" in s]
    assert any(not torch.equal(g0[p], g1[p]) for p in split)


def test_vocab_parallel_ce_with_padded_vocab_matches_one_rank(runs):
    """V 512 with ids from 500 on masked: each rank's vocab-parallel CE,
    accuracy and the gradients of x and of its head slice within 1e-6 of
    the single-rank chunked CE (the loss relative, the gradients relative
    L2: the vocabulary's sums are split over the ranks and added in
    another order), and no tensor on the way as wide as the
    vocabulary."""
    x, head, labels, mask = arms.ce_inputs()
    x.requires_grad_()
    head.requires_grad_()
    ce, acc = chunked_cross_entropy(x, head, labels, mask=mask,
                                    chunk=arms.CE_CHUNK,
                                    n_valid=arms.CE_VALID)
    gx, gh = torch.autograd.grad(ce, [x, head])
    v = arms.CE_VOCAB // 2
    for r, res in enumerate(runs["worlds"]["model2"]):
        got = res["ce"]
        assert got["widest"] <= v
        np.testing.assert_allclose(float(got["ce"]), float(ce.detach()),
                                   rtol=1e-6)
        assert float(got["acc"]) == float(acc)
        assert rel_l2(got["gx"].numpy(), gx.numpy()) <= 1e-6
        assert rel_l2(got["ghead"].numpy(),
                      gh[:, r * v:(r + 1) * v].numpy()) <= 1e-6


def _formula(world: str, variant: str = "full") -> dict:
    """Collectives a step of qwen2-1.5b's smoke config (L 2, S 128,
    ce_chunk 64 -> 2 chunks, remat "full"), kind -> calls.

    Model axis, per microbatch: forward 1 (embedding) + 2L (wo, down) +
    4 a CE chunk (max, exp sum, label logit, argmax); the recompute of a
    checkpointed group stops after its last saved tensor (torch's early
    stop), so it redoes wo's reduce and not down's (L), and a CE chunk's
    first three (3 a chunk); backward 2L column-split inputs + 1 (the
    head's input).  Under "dots" a group's recompute makes none (the CE
    chunks are checkpointed whatever the policy).  Data axis:
    one gather and one reduce-scatter a split leaf, the mask count a
    microbatch, the gradients of leaves whole over the axis and the
    metrics once each.  One world all-reduce (the norm)."""
    L, chunks = 2, 2
    model, _, _, _ = WORLDS[world]
    n_mb = arms.VARIANTS[variant][1]
    out = {"all-reduce/world": 1}
    if model > 1:
        fwd = 1 + 2 * L + 4 * chunks
        rec = (0 if variant == "dots" else L) + 3 * chunks
        out["all-reduce/model"] = n_mb * (fwd + rec + 2 * L + 1)
    if world != "model2":
        # 26 float leaves; wq / wk / wv biases stay whole over "data"
        # (their one dim carries the model rule's entry)
        split = 26 - 3 * L
        out["all-gather/data"] = split
        out["reduce-scatter/data"] = n_mb * split
        out["all-reduce/data"] = n_mb + 2
    return out


@pytest.mark.parametrize("world,variant", [("model2", "full"),
                                           ("model2", "microbatch2"),
                                           ("model2", "dots"),
                                           ("data2_fsdp", "full"),
                                           ("data2_fsdp", "microbatch2"),
                                           ("2x2_fsdp", "full")])
def test_collectives_a_step_match_the_formula(runs, world, variant):
    for res in runs["worlds"][world]:
        assert res[variant]["calls"] == _formula(world, variant)


def test_dots_step_matches_jax_and_recomputes_no_collective(runs):
    """One step under ``remat_policy="dots"``: the selective checkpoint
    keeps the collectives' outputs, so a recompute makes none (the
    formula above), and the step equals JAX's first."""
    want = runs["jax"]["full"]["history"][0]
    for res in runs["worlds"]["model2"]:
        got = res["dots"]["history"]
        assert len(got) == 1
        for k in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(got[0][k], want[k], rtol=TOL)


def test_resume_inside_a_world_is_bit_exact(runs):
    """Two steps, a checkpoint, a new Trainer in the same world: step 3's
    metrics and every leaf equal the uninterrupted run's bit for bit."""
    for res in runs["worlds"]["model2"]:
        a, b = res["full"], res["resumed"]
        assert _metrics(b["history"][-1]) == _metrics(a["history"][-1])
        assert b["history"][-1]["step"] == arms.STEPS
        for (pa, ta), (pb, tb) in zip(
                sorted(flat(params_to_numpy(a["params"],
                                            arms.config())).items()),
                sorted(flat(params_to_numpy(b["params"],
                                            arms.config())).items())):
            assert pa == pb
            np.testing.assert_array_equal(ta, tb, err_msg=pa)


def test_world_checkpoint_resumes_on_one_rank(runs):
    """The world's step-2 checkpoint (whole, written by rank 0) resumes
    in a single-rank Trainer here: its third step's loss within 1e-5 of
    the world's."""
    tr = arms.trainer(None, None, "full",
                      ckpt_dir=str(runs["ckpt"] / "step2"))
    assert tr.step == 2
    hist = tr.run(arms.STEPS)
    want = runs["worlds"]["model2"][0]["full"]["history"][-1]["loss"]
    np.testing.assert_allclose(hist[-1]["loss"], want, rtol=1e-5)


def test_check_trainable_refusals_name_a83():
    """Under a model axis > 1 training refuses MoE, PEFT adapters,
    int8 / int4 / fp8 bases, non-attention blocks and heads the axis does
    not divide, each with its message; a data axis alone refuses
    nothing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import LM
    from repro_torch.peft.lora import apply_peft
    from repro_torch.quant import quantize_tree
    from repro_torch.sharding.tp import check_trainable
    cfg = get_smoke_config("qwen2-1.5b")
    m2 = cfg.with_(model_parallel=2)
    params = LM(cfg, device="cpu").init(0)
    check_trainable(m2, params)
    check_trainable(cfg, apply_peft(params, 0, method="lora"))
    with pytest.raises(ValueError, match="MoE.*A8.3"):
        check_trainable(get_smoke_config("granite-moe-3b-a800m").with_(
            model_parallel=2), {})
    with pytest.raises(ValueError, match="PEFT adapters.*A8.3"):
        check_trainable(m2, apply_peft(params, 0, method="lora"))
    for quant in ("int8", "int4", "fp8"):
        with pytest.raises(ValueError, match=f"{quant} bases.*A8.3"):
            check_trainable(m2, quantize_tree(params, quant=quant))
    with pytest.raises(ValueError, match="A8.3"):
        check_trainable(get_smoke_config("rwkv6-1.6b").with_(
            model_parallel=2), {})
    odd = m2.with_(attention=dataclasses.replace(
        cfg.attention, num_heads=6, num_kv_heads=3))
    with pytest.raises(ValueError, match="6 query heads.*3 kv heads"):
        check_trainable(odd, {})


def test_train_cli_model_parallel_trains(runs):
    """``launch.train --smoke --device cpu --steps 2 --model-parallel 2
    --arch qwen2-1.5b`` (batch 4 x 64) exits 0, prints rank 0's mesh line and each
    rank's report (no kernel launch, the model axis's all-reduces), and
    its losses are within 1e-2 of one rank's."""
    (rc2, out, h2), (rc1, _, h1) = runs["cli"]
    assert rc1 == rc2 == 0
    assert "mesh {'data': 1, 'model': 2} over 2 ranks (gloo, cpu)" in out
    reports = [json.loads(ln.split(" report ", 1)[1])
               for ln in out.splitlines() if ln.startswith("[train] rank ")]
    assert len(reports) == 2
    for rep in reports:
        assert rep["kernel_launches"] == 0 and rep["peak_gb"] is None
        assert rep["collectives_a_step"]["all-reduce/model"][0] > 0
    assert len(h1) == len(h2) == 2
    for a, b in zip(h1, h2):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-2)


def test_world_meshes_and_data_groups(runs):
    """Each world's mesh line, and the 2 x 2 world's groups: the model
    groups are runs of consecutive ranks, the data groups the ranks with
    one model coordinate."""
    assert runs["worlds"]["2x2_fsdp"][0]["mesh"].startswith(
        "mesh {'data': 2, 'model': 2} over 4 ranks (gloo, cpu)")
    groups = [r["ranks"] for r in runs["worlds"]["2x2_fsdp"]]
    assert [tuple(g["model"]) for g in groups] == [(0, 1), (0, 1), (2, 3),
                                                   (2, 3)]
    assert [tuple(g["data"]) for g in groups] == [(0, 2), (1, 3), (0, 2),
                                                  (1, 3)]

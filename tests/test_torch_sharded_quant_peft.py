"""Quantized bases and PEFT adapters under a model axis, on gloo worlds
of 2 and 4 ranks on the CPU, held to JAX's single-device ``LM`` and to
one rank of the port.

qwen2-1.5b's float32 smoke config (8 query heads over 4 kv heads) with
int8 / fp8 / int4 weights and with LoRA / DoRA / rsLoRA / QLoRA (an int4
base) adapters, unmerged, their ``b`` drawn away from zero so that the
update shows.  The trees are built once by the reference's
``quantize_tree`` / ``apply_peft`` on the port's ``LM.init(0)`` and
loaded as numpy by both packages and every rank.  A rank's logits
(prefill- and decode-sized: the row-split fp8 partial takes B6's plain
version at M <= 128), the loss's metrics and every leaf's first-step
gradient must equal JAX's and one rank's; ``PagedEngine`` serves fp8 /
int4 / LoRA / QLoRA trees with one rank's streams; LoRA and QLoRA train two
steps through ``Trainer(mesh=, mask=)`` as one rank does; a sharded
tree merges to the pieces of the merged whole tree; an int8 row
maximum tied across ranks passes one rank's gradient; a K/m that splits
an int4 pair is refused; and ``launch.train --autotune --smoke
--model-parallel 2`` trains the c* its search picks."""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _sharded_quant_peft_arms as arms  # noqa: E402
from _train_pairs import flat, rel_l2  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.peft import lora as jlora  # noqa: E402
from repro.quant import qops as jqops  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.sharding.rules import unshard  # noqa: E402

LOGIT_TOL, GRAD_TOL = 1e-5, 1e-4
WORLDS = (2, 4)
#: fp8 gradients are rounded to e4m3 (3 mantissa bits) on both sides:
#: held within one of its ulps
FP8_ULP = 2.0 ** -3


def _jax_config():
    import dataclasses
    cfg = j_smoke("qwen2-1.5b")
    return cfg.with_(dtype="float32", quant_matmul_impl="ref",
                     attention=dataclasses.replace(cfg.attention,
                                                   num_heads=8,
                                                   num_kv_heads=4))


def _weights() -> dict:
    """variant -> its reference-layout numpy tree: the reference's
    ``quantize_tree`` / ``apply_peft`` (rank 4) on the port's
    ``LM.init(0)``, each adapter's ``b`` drawn from a seeded normal."""
    cfg = arms.config()
    base = jax.tree.map(jnp.asarray, params_to_numpy(
        LM(cfg, device="cpu").init(0), cfg))
    rng = np.random.default_rng(7)
    out = {}
    for name, (quant, method) in arms.VARIANTS.items():
        tree = base if quant is None else jqops.quantize_tree(base,
                                                              quant=quant)
        if method != "full":
            tree = jlora.apply_peft(tree, jax.random.PRNGKey(1),
                                    method=method, rank=4)
        tree = jax.tree.map(np.asarray, tree)

        def draw(node):
            if isinstance(node, dict):
                if "lora" in node:
                    b = node["lora"]["b"]
                    node["lora"]["b"] = (rng.normal(size=b.shape)
                                         * 0.05).astype(np.float32)
                for v in node.values():
                    draw(v)
        draw(tree)
        out[name] = tree
    return out


def _jax_variant(jlm, weights) -> dict:
    b = {k: jnp.asarray(v) for k, v in arms.batch(
        jlm.cfg.vocab_size).items()}

    def f(p):
        (_, metrics), g = jax.value_and_grad(jlm.loss, has_aux=True,
                                             allow_int=True)(p, b)
        return (jlm.logits(p, b["tokens"]), jlm.logits(p, b["tokens"][:, :1]),
                metrics, g)
    logits, step, metrics, grads = jax.jit(f)(jax.tree.map(jnp.asarray,
                                                           weights))
    return {"logits": np.asarray(logits), "step_logits": np.asarray(step),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flat(grads)}


#: ``launch.train --autotune`` on two ranks at smoke size
CLI = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--steps", "2",
       "--autotune", "--model-parallel", "2", "--global-batch", "4",
       "--seq-len", "32", "--log-every", "1"]


def _cli_run(tmp) -> tuple:
    """(exit code, stdout, history) of the CLI, its search at the small
    budget of ``test_torch_train_loop.py``'s CLI test (the search runs in
    this process, before the ranks start)."""
    from repro_torch.core import tuner
    from repro_torch.launch.train import main
    full = tuner.AutoTuner

    def small(ev, **kw):
        return full(ev, **{**kw, "generations": 2, "pop_size": 8, "n0": 12,
                           "k_per_iter": 4, "ensemble_k": 1})
    hist = tmp / "history.json"
    buf = io.StringIO()
    tuner.AutoTuner = small
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(CLI + ["--history-out", str(hist)])
    finally:
        tuner.AutoTuner = full
    return rc, buf.getvalue(), json.loads(hist.read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor
    weights = _weights()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(4) as pool:
            worlds = {n: pool.submit(spawn_world, arms.world, n, n, weights,
                                     device="cpu", threads=1)
                      for n in WORLDS}
            cli = pool.submit(_cli_run, tmp_path_factory.mktemp("cli"))
            jlm = JLM(_jax_config())
            jax_runs = {v: _jax_variant(jlm, weights[v])
                        for v in arms.VARIANTS}
            single = arms.run_all(weights)
            return {"worlds": {n: f.result() for n, f in worlds.items()},
                    "cli": cli.result(), "jax": jax_runs, "single": single}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", list(arms.VARIANTS))
def test_served_logits_match_jax_and_one_rank(runs, world, variant):
    """Prefill- and decode-sized float32 logits of every rank within 1e-5
    relative L2 of JAX's single-device LM and of one rank's."""
    for key in ("logits", "step_logits"):
        want = runs["jax"][variant][key]
        one = runs["single"][variant][key].numpy()
        assert rel_l2(one, want) <= LOGIT_TOL, key
        for r, res in enumerate(runs["worlds"][world]):
            got = res[variant][key].numpy()
            assert rel_l2(got, want) <= LOGIT_TOL, (key, r)
            assert rel_l2(got, one) <= LOGIT_TOL, (key, r)


def _close(got, want) -> bool:
    if want.dtype.name == "float8_e4m3fn":
        w = np.asarray(want, np.float64)
        return bool(np.all(np.abs(np.asarray(got, np.float64) - w)
                           <= FP8_ULP * np.abs(w) + 1e-30))
    return rel_l2(got, want) <= GRAD_TOL


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", list(arms.VARIANTS))
def test_first_step_gradients_match_jax_and_one_rank(runs, world, variant):
    """Every float leaf's first-step gradient (the frozen bases' scales,
    the adapters' ``a`` / ``b`` / ``scaling``), joined from the ranks'
    pieces, within 1e-4 relative L2 of JAX's and of one rank's (an fp8
    ``qw``'s within one e4m3 ulp); the integer bases get none; the loss
    equals JAX's and one rank's."""
    ranks = runs["worlds"][world]
    cfg = arms.config()
    grads = unshard([r[variant]["grads"] for r in ranks],
                    ranks[0][variant]["specs"], {"data": 1, "model": world})
    got = flat(params_to_numpy(grads, cfg))
    one = flat(params_to_numpy(runs["single"][variant]["grads"], cfg))
    want = {k: v for k, v in runs["jax"][variant]["grads"].items()
            if v.dtype.kind == "f" or v.dtype.name == "float8_e4m3fn"}
    assert got.keys() == want.keys() == one.keys()
    bad = {k: rel_l2(got[k], want[k]) for k in want
           if not (_close(got[k], want[k]) and _close(got[k], one[k]))}
    assert not bad, bad
    for res in ranks:
        np.testing.assert_allclose(res[variant]["metrics"]["loss"],
                                   runs["jax"][variant]["metrics"]["loss"],
                                   rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", arms.SERVED)
def test_paged_engine_serves_the_trees_as_one_rank(runs, world, variant):
    """fp8 / int4 weights and LoRA / QLoRA adapters, unmerged, through
    ``PagedEngine`` under the axis: streams, host syncs and counters equal
    one rank's on every rank."""
    base = runs["single"][variant]["served"]
    assert all(len(s) == 6 for s in base["streams"])
    for r, res in enumerate(runs["worlds"][world]):
        assert res[variant]["served"] == base, (world, r)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", arms.TRAINED)
def test_adapters_train_under_the_axis_as_on_one_rank(runs, world, variant):
    """Two steps of ``Trainer(mesh=, mask=)``: each step's loss and
    gradient norm within 1e-5 of one rank's on every rank, the trained
    adapters (gathered whole) within 1e-4, and AdamW moments only for the
    adapters."""
    one = runs["single"][variant]["train"]
    for res in runs["worlds"][world]:
        got = res[variant]["train"]
        assert len(got["history"]) == arms.STEPS
        for g, w in zip(got["history"], one["history"]):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        assert got["adapters"].keys() == one["adapters"].keys()
        for p, t in one["adapters"].items():
            assert rel_l2(got["adapters"][p].numpy(), t.numpy()) <= GRAD_TOL
        assert got["moments"] == one["moments"] == sum(
            t.numel() for t in one["adapters"].values())


@pytest.mark.parametrize("world", WORLDS)
def test_merge_lora_of_a_sharded_tree(runs, world):
    """``merge_lora(pieces, mesh)`` gives each rank its piece of the
    merged whole tree (row-split linears gather ``b``), within 1e-6."""
    for res in runs["worlds"][world]:
        worst = res["merged"]
        assert worst and max(worst.values()) <= 1e-6, worst


@pytest.mark.parametrize("world", WORLDS)
def test_int8_row_maximum_ties_split_the_gradient_as_one_rank(runs, world):
    """A row-split int8 linear in a training forward, on rows whose
    absolute maximum ties across ranks, within one rank, on every rank
    and nowhere: the output and the gradients of x (joined from the
    ranks' slices) and of the weight scale equal one rank's, so a tie
    across ranks is not counted once a rank."""
    one = arms.int8_ties(world)
    ranks = [r["int8_ties"] for r in runs["worlds"][world]]
    x_grad = torch.cat([r["x"] for r in ranks], dim=1)
    assert one["x"][0].count_nonzero() == 2
    # the gradient through a maximum is a sum over the ranks' partials
    # (another order than one rank's): within fp32 rounding of it, where
    # a tie counted once a rank would double it
    torch.testing.assert_close(x_grad, one["x"], rtol=1e-5, atol=0)
    for r in ranks:
        torch.testing.assert_close(r["y"], one["y"], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(r["scale"], one["scale"], rtol=1e-5,
                                   atol=0)


def test_int4_refuses_a_k_slice_that_splits_a_packed_pair():
    """An int4 row-split linear whose K/m is odd is refused, naming its
    ROADMAP item, up front by ``check_servable`` / ``check_trainable`` and
    by the row partial itself."""
    from repro_torch.quant.qops import row_partial
    from repro_torch.sharding.tp import check_servable, check_trainable
    cfg = arms.config(model_parallel=2)
    tree = {"layers": [{"blk0": {"mlp": {"down": {
        "qw": torch.zeros((3, 8), dtype=torch.uint8),
        "scale": torch.ones(8)}}}}]}
    for check in (check_servable, check_trainable):
        with pytest.raises(ValueError, match="K/m even.*A8.8"):
            check(cfg, tree)
    p = tree["layers"][0]["blk0"]["mlp"]["down"]
    with pytest.raises(ValueError, match="K/m even.*A8.8"):
        row_partial(torch.zeros((2, 3)), p, "ref", None)


def test_train_cli_autotune_trains_its_c_star_on_two_ranks(runs):
    """``launch.train --autotune --smoke --device cpu --model-parallel 2``
    searches, applies whatever c* it picks (adapters or a quantized base
    included) and trains it on two ranks: exit 0, rank 0's mesh line,
    both ranks' reports, finite losses."""
    rc, out, hist = runs["cli"]
    assert rc == 0
    assert "AE-LLM selected:" in out
    assert "mesh {'data': 1, 'model': 2} over 2 ranks (gloo, cpu)" in out
    reports = [json.loads(ln.split(" report ", 1)[1])
               for ln in out.splitlines() if ln.startswith("[train] rank ")]
    assert len(reports) == 2
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)

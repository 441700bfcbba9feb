"""MoE layers under a model axis, on gloo worlds of 2 and 4 ranks on the
CPU, held to JAX's single-device ``LM`` and to one rank of the port.

Three float32 smoke trees (``_sharded_moe_arms.TREES``), each in both
dispatches: granite's 5 experts (the TP fallback: every expert over its
f/m slice), granite's padded to 6 (EP over 2 ranks with a never-routed
pad expert, the fallback over 4) and llama4-scout's 4 experts with a
shared expert (EP over both).  A rank's logits, the loss's metrics (the
aux losses) and the first-step gradients of every leaf, the router's
included, must equal JAX's and one rank's; granite's ``PagedEngine``
(and, in the einsum dispatch, SchedEngine and SpecEngine) streams,
syncs and counters must equal one rank's; an odd vocabulary
keeps the embedding whole; the serving CLI serves granite on two ranks.
The two worlds and the CLI's start together in the background while
this process runs the six JAX programs (one jitted program a case: its
logits, metrics and gradients) and the single-rank side."""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _sharded_moe_arms as arms  # noqa: E402
from _train_pairs import flat, rel_l2  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.sharding.rules import unshard  # noqa: E402

LOGIT_TOL, GRAD_TOL = 1e-5, 1e-4
WORLDS = (2, 4)
AUX = ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac")


def _jax_case(tree: str, dispatch: str, weights) -> dict:
    """JAX's logits, loss metrics and gradients of one case, one jitted
    program."""
    jlm = JLM(arms.config(tree, dispatch, j_smoke))
    b = {k: jnp.asarray(v) for k, v in arms.batch(
        jlm.cfg.vocab_size).items()}

    def f(p):
        (_, metrics), g = jax.value_and_grad(jlm.loss, has_aux=True)(p, b)
        return jlm.logits(p, b["tokens"]), metrics, g
    logits, metrics, grads = jax.jit(f)(jax.tree.map(jnp.asarray, weights))
    return {"logits": np.asarray(logits),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flat(grads)}


#: the serving CLI's drive: ``--paged`` on one rank, then two ranks
CLI = ["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu",
       "--requests", "3", "--max-new", "5"]


def _cli_runs() -> list:
    from repro_torch.launch.serve import main
    out = []
    for extra in (["--paged"], ["--model-parallel", "2"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(CLI + extra)
        out.append((rc, buf.getvalue()))
    return out


@pytest.fixture(scope="module")
def runs():
    from concurrent.futures import ThreadPoolExecutor
    weights = arms.weights()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(4) as pool:
            worlds = {n: pool.submit(spawn_world, arms.world, n, n, weights,
                                     device="cpu", threads=1)
                      for n in WORLDS}
            cli = pool.submit(_cli_runs)
            jax_runs = {c: _jax_case(*c, weights[c[0]]) for c in arms.CASES}
            single = arms.run_all(weights)
            return {"worlds": {n: f.result() for n, f in worlds.items()},
                    "cli": cli.result(), "jax": jax_runs, "single": single}
    finally:
        torch.set_num_threads(threads)


def _ids(cases):
    return [f"{t}-{d}" for t, d in cases]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", arms.CASES, ids=_ids(arms.CASES))
def test_logits_match_jax_and_one_rank(runs, world, case):
    """Every rank's float32 logits within 1e-5 relative L2 of JAX's
    single-device LM and of one rank's."""
    want = runs["jax"][case]["logits"]
    one = runs["single"][case]["logits"].numpy()
    assert rel_l2(one, want) <= LOGIT_TOL
    for r, res in enumerate(runs["worlds"][world]):
        got = res[case]["logits"].numpy()
        assert got.shape == want.shape
        assert rel_l2(got, want) <= LOGIT_TOL, (world, r)
        assert rel_l2(got, one) <= LOGIT_TOL, (world, r)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", arms.CASES, ids=_ids(arms.CASES))
def test_aux_losses_and_metrics_match(runs, world, case):
    """The loss, CE and the aux losses are whole on every rank and count
    once: equal on every rank, within 1e-6 of one rank's and 1e-5 of
    JAX's; the dropped fraction exactly one rank's."""
    want, one = runs["jax"][case]["metrics"], runs["single"][case]["metrics"]
    ranks = runs["worlds"][world]
    for res in ranks:
        got = res[case]["metrics"]
        assert got == ranks[0][case]["metrics"]
        for k in ("loss", "ce_loss") + AUX:
            np.testing.assert_allclose(got[k], one[k], rtol=1e-6, atol=1e-9,
                                       err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-9, err_msg=k)
        assert got["moe_dropped_frac"] == one["moe_dropped_frac"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", arms.CASES, ids=_ids(arms.CASES))
def test_first_step_gradients_match_jax_and_one_rank(runs, world, case):
    """Every leaf's first-step gradient, joined from the ranks' pieces
    (the router's, read partially through the gates on each rank,
    included), within 1e-4 relative L2 of JAX's ``jax.grad`` and of one
    rank's."""
    ranks = runs["worlds"][world]
    cfg = arms.config(*case)
    grads = unshard([r[case]["grads"] for r in ranks], ranks[0][case]["specs"],
                    {"data": 1, "model": world})
    got = flat(params_to_numpy(grads, cfg))
    want = runs["jax"][case]["grads"]
    one = flat(params_to_numpy(runs["single"][case]["grads"], cfg))
    assert got.keys() == want.keys() == one.keys()
    assert any("router" in k for k in got)
    bad = {k: (rel_l2(got[k], want[k]), rel_l2(got[k], one[k]))
           for k in want if not (rel_l2(got[k], want[k]) <= GRAD_TOL
                                 and rel_l2(got[k], one[k]) <= GRAD_TOL)}
    assert not bad, bad


SERVED = [("einsum", e) for e in arms.ENGINES] + [("gather", "paged")]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dispatch,engine", SERVED,
                         ids=[f"{d}-{e}" for d, e in SERVED])
def test_granite_paged_streams_equal_one_rank(runs, world, dispatch,
                                              engine):
    """granite under the axis through PagedEngine (both dispatches),
    SchedEngine and the n-gram SpecEngine: streams, host syncs and
    counters equal one rank's on every rank (the capacity groups see the
    same idle slots and padding everywhere)."""
    base = runs["single"]["granite", dispatch]["served"][engine]
    assert all(len(s) == 6 for s in base["streams"])
    for r, res in enumerate(runs["worlds"][world]):
        assert res["granite", dispatch]["served"][engine] == base, \
            (world, r)


def test_placements_take_ep_where_the_axis_divides_the_experts(runs):
    """The expert stacks split on E where the axis divides the padded
    expert count (EP), else on the experts' hidden width (the TP
    fallback), as the reference's rules place them."""
    for world in WORLDS:
        specs = {t: runs["worlds"][world][0][t, "einsum"]["specs"]
                 ["layers"][0]["blk0"]["moe"] for t in arms.TREES}
        ep = {t: s["gate_e"] == ("model", None, None)
              for t, s in specs.items()}
        assert ep == {"granite": False, "granite_pad2": world == 2,
                      "llama4": True}, world
        assert specs["granite"]["down_e"] == (None, "model", None)
        assert specs["llama4"]["shared"]["down"]["w"] == ("model", None)


def test_odd_vocabulary_keeps_the_embedding_whole(runs):
    """granite's smoke config with a 511-row vocabulary under a model axis
    of 2: the embedding is placed whole and the logits equal one rank's
    within 1e-5."""
    one = runs["single"]["odd_vocab"]["logits"].numpy()
    assert one.shape[-1] == arms.ODD_VOCAB
    for res in runs["worlds"][2]:
        assert res["odd_vocab"]["embed_rows"] == (None, None)
        assert rel_l2(res["odd_vocab"]["logits"].numpy(), one) <= LOGIT_TOL


def test_serve_cli_model_parallel_serves_granite(runs):
    """``launch.serve --arch granite-moe-3b-a800m --smoke --model-parallel
    2 --device cpu`` exits 0 and prints the one-rank ``--paged``
    streams."""
    (rc1, paged), (rc2, out) = runs["cli"]
    assert rc1 == rc2 == 0
    want = [ln for ln in paged.splitlines() if ln.strip().startswith("req ")]
    assert "mesh {'data': 1, 'model': 2} over 2 ranks (gloo, cpu)" in out
    assert [ln for ln in out.splitlines()
            if ln.strip().startswith("req ")] == want and len(want) == 3
    assert "every rank's streams equal" in out

"""Context-parallel decode and the GPipe pipeline of the port over gloo
worlds on the CPU, held to the reference's functions.

Two worlds (2 and 4 ranks) are started once for the module, at the same
time (``_cp_pipeline_arms.py``); each rank runs every case: the raw
``context_parallel_decode`` and ``attention_decode_cp`` over its shard of
the cache's sequence (a position on a shard boundary, a window, per-row
positions), a decode cell with cp (4 ranks: qwen2-1.5b smoke, whose 2 kv
heads 4 does not divide), and ``pipeline_forward`` as one stage of 2 or
4, M from 1 to 5.  Meanwhile this process runs the reference's
``attention_decode`` on the whole cache, its ``context_parallel_decode``
/ ``attention_decode_cp`` / ``pipeline_forward`` on a 1-device mesh
(JAX gives no second CPU device in this process), and the port on one
rank.  Float32 throughout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _cp_pipeline_arms as arms  # noqa: E402
from _train_pairs import pair  # noqa: E402
from repro.configs.base import AttentionConfig as JAttn  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.serve.decode_attn import \
    context_parallel_decode as j_cp_decode  # noqa: E402
from repro.sharding.ctx import use_mesh  # noqa: E402
from repro.sharding.pipeline import \
    pipeline_forward as j_pipeline  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, spawn_world  # noqa: E402
from repro_torch.models.attention import attention_decode_cp  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve.decode_attn import \
    context_parallel_decode  # noqa: E402
from repro_torch.sharding.pipeline import pipeline_forward  # noqa: E402

TOL = 1e-5
WORLDS = (2, 4)


def _jattn(a):
    return JAttn(**{f: getattr(a, f) for f in a.__dataclass_fields__})


def _jp(p):
    return {k: {n: jnp.asarray(v) for n, v in lin.items()}
            for k, lin in p.items()}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _cell_inputs():
    """Reference-layout weights, each step's tokens and positions, and a
    random cache (the port's list layout) for the decode cell."""
    _, _, jp, _ = pair("qwen2-1.5b")
    weights = jax.tree.map(np.asarray, jp)
    cfg = arms.cell_config()
    rng = np.random.default_rng(3)
    a = cfg.attention
    shape = (arms.B, arms.S, a.num_kv_heads, a.head_dim)
    cache = [{"blk0": {"kv": {
        "k": rng.standard_normal(shape).astype(np.float32),
        "v": rng.standard_normal(shape).astype(np.float32)}}}
        for _ in range(cfg.num_groups)]
    tokens = [rng.integers(0, cfg.vocab_size, arms.B).astype(np.int32)
              for _ in arms.CELL_POS]
    pos = [np.asarray(p, np.int32) for p in arms.CELL_POS]
    return weights, tokens, pos, cache


@pytest.fixture(scope="module")
def runs():
    from concurrent.futures import ThreadPoolExecutor
    cell_inputs = _cell_inputs()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(len(WORLDS)) as pool:
            worlds = {n: pool.submit(spawn_world, arms.world, n, n,
                                     cell_inputs if n == 4 else None,
                                     device="cpu", threads=1)
                      for n in WORLDS}
            ref = _reference(cell_inputs)
            out = {n: f.result() for n, f in worlds.items()}
    finally:
        torch.set_num_threads(threads)
    return out, ref


def _reference(cell_inputs) -> dict:
    """The reference's functions on the whole inputs (1-device meshes),
    and the port's one-rank decode steps of the cell."""
    import functools
    mesh11 = jax.make_mesh((1, 1), ("data", "model"))
    raw = []
    for case, (_, _, _, pos, window) in enumerate(arms.RAW):
        inp = arms.raw_inputs(case)
        fn = jax.jit(functools.partial(j_cp_decode, pos=pos, mesh=mesh11,
                                       window=window))
        raw.append(np.asarray(fn(jnp.asarray(inp["q"]),
                                 jnp.asarray(inp["k"]),
                                 jnp.asarray(inp["v"]))))
    attn = {}
    for name, a in arms.ATTN.items():
        inp = arms.attn_inputs(name)
        ja, jp = _jattn(a), _jp(inp["p"])
        cache = {"k": jnp.asarray(inp["k"]), "v": jnp.asarray(inp["v"])}
        x, pos = jnp.asarray(inp["x"]), jnp.asarray(inp["pos"])
        # eager: its cache writes are held bit for bit
        y, c = jattn.attention_decode(jp, x, ja, cache, pos)
        with use_mesh(mesh11):
            y_cp, _ = jax.jit(functools.partial(
                jattn.attention_decode_cp, a=ja, mesh=mesh11))(
                jp, x, cache=cache, pos=pos)
        attn[name] = {"y": np.asarray(y), "k": np.asarray(c["k"]),
                      "v": np.asarray(c["v"]), "y_cp": np.asarray(y_cp)}
    pipe = {}
    stage_mesh = jax.make_mesh((1,), ("stage",))

    def jstage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])
    # one compile a microbatch count: every stage's call has its shapes
    one_stage = jax.jit(lambda p, x: j_pipeline(jstage, p, x, stage_mesh))
    for n in WORLDS:
        inp = arms.pipe_inputs(n)
        for m in range(1, arms.MAX_M + 1):
            x = jnp.asarray(inp["x"][:m])
            for s in range(n):
                x = one_stage({"w": jnp.asarray(inp["w"][s:s + 1]),
                               "b": jnp.asarray(inp["b"][s:s + 1])}, x)
            seq = inp["x"][:m]
            for s in range(n):
                seq = np.tanh(seq @ inp["w"][s] + inp["b"][s])
            pipe[n, m] = (np.asarray(x), seq)
    weights, tokens, positions, cache_np = cell_inputs
    cfg = arms.cell_config().with_(decode_attn_impl="eager")
    lm = LM(cfg, device="cpu")
    from repro_torch.bridge import params_from_numpy
    params = params_from_numpy(weights, cfg, "cpu")
    cache = [{blk: {"kv": {k: torch.from_numpy(v).clone()
                           for k, v in node["kv"].items()}}
              for blk, node in grp.items()} for grp in cache_np]
    one_rank = []
    for tok, pos in zip(tokens, positions):
        logits, cache = lm.decode_step(params, torch.from_numpy(tok).int(),
                                       cache, torch.from_numpy(pos).int())
        one_rank.append(logits)
    return {"raw": raw, "attn": attn, "pipe": pipe, "cell": one_rank}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", range(len(arms.RAW)))
def test_context_parallel_decode_matches_reference(runs, n, case):
    """Each rank's ``context_parallel_decode`` over its shard equals the
    reference's over the whole cache (a 1 x 1 mesh), the same on every
    rank: positions either side of a shard boundary, a window, one kv
    head."""
    out, ref = runs
    for r in out[n]:
        _close(r["cp"]["raw"][case], ref["raw"][case])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", sorted(arms.ATTN))
def test_attention_decode_cp_matches_reference_decode(runs, n, name):
    """``attention_decode_cp`` with the weights placed by the rules
    (column-split q / k / v, biases included, row-split wo) and the
    cache's sequence split over the ranks: the output equals the
    reference's ``attention_decode`` over the whole cache within 1e-5 on
    every rank (and its ``attention_decode_cp`` on a 1 x 1 mesh), and the
    ranks' shards joined equal the reference's updated cache exactly.
    The collectives of the step: the q / k / v gathers, then one max and
    two sum all-reduces of the combine and wo's sum."""
    out, ref = runs
    want = ref["attn"][name]
    _close(want["y_cp"], want["y"])
    for r in out[n]:
        got = r["cp"]["attn"][name]
        _close(got["y"], want["y"])
        assert got["calls"] == {"all-gather/model": 3,
                                "all-reduce/model": 4}
    for key in ("k", "v"):
        whole = torch.cat([r["cp"]["attn"][name][key] for r in out[n]], 1)
        np.testing.assert_array_equal(whole.numpy(), want[key])
    a = arms.ATTN[name]
    g = a.num_heads // a.num_kv_heads
    ml = arms.B * a.num_kv_heads * g * 4
    wo = arms.B * arms.D_MODEL * 4
    assert out[n][0]["cp"]["attn"][name]["bytes"]["all-reduce/model"] == \
        2 * ml + ml * a.head_dim + wo


def test_cp_on_one_rank_matches_reference_on_a_1x1_mesh(runs):
    """On a world of one, ``context_parallel_decode`` and
    ``attention_decode_cp`` are the reference's on a 1 x 1 mesh (the case
    of the reference's ``test_cp_decode_matches_eager``)."""
    _, ref = runs
    mesh = make_host_mesh(device="cpu")
    for case, (_, _, _, pos, window) in enumerate(arms.RAW):
        inp = arms.raw_inputs(case)
        got = context_parallel_decode(
            *(torch.from_numpy(inp[k]) for k in "qkv"), pos, mesh,
            window=window)
        _close(got, ref["raw"][case])
    for name, a in arms.ATTN.items():
        inp = arms.attn_inputs(name)
        p = {k: {n: torch.from_numpy(v) for n, v in lin.items()}
             for k, lin in inp["p"].items()}
        cache = {"k": torch.from_numpy(inp["k"]).clone(),
                 "v": torch.from_numpy(inp["v"]).clone()}
        y, cache = attention_decode_cp(p, torch.from_numpy(inp["x"]), a,
                                       cache,
                                       torch.from_numpy(inp["pos"]).long(),
                                       mesh)
        _close(y, ref["attn"][name]["y_cp"])
        for key in ("k", "v"):
            np.testing.assert_array_equal(cache[key].numpy(),
                                          ref["attn"][name][key])


def test_decode_cell_with_cp_on_four_ranks_gives_one_ranks_logits(runs):
    """qwen2-1.5b smoke (4 query heads over 2 kv heads) as a decode cell
    with ``decode_attn_impl="cp"`` on 4 ranks: each rank holds 16 of the
    cache's 64 positions, and two decode steps (rows on and around the
    shard boundaries) give one rank's ``LM.decode_step`` logits over the
    whole cache, within 1e-5."""
    out, ref = runs
    for r in out[4]:
        assert r["cell"]["cell"] == "qwen2-1.5b:cp_smoke"
        for got, want in zip(r["cell"]["logits"], ref["cell"]):
            _close(got, want, 1e-5)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("m", range(1, arms.MAX_M + 1))
def test_pipeline_forward_matches_reference(runs, n, m):
    """``pipeline_forward`` with one stage a rank equals the reference's
    ``pipeline_forward`` on a 1-device "stage" mesh applied stage by stage
    and the sequential composition, on every rank; it makes S + M - 1
    permutes of one microbatch and one sum of the outputs."""
    out, ref = runs
    want, seq = ref["pipe"][n, m]
    _close(want, seq)
    mb = arms.MB * arms.PD * 4
    for r in out[n]:
        got = r["pipe"][m]
        _close(got["y"], want)
        assert got["calls"] == {"collective-permute/stage": n + m - 1,
                                "all-reduce/stage": 1}
        assert got["bytes"] == {"collective-permute/stage":
                                float((n + m - 1) * mb),
                                "all-reduce/stage": float(m * mb)}
    assert out[n][0]["pipe_mesh"].startswith(f"mesh {{'stage': {n}")


def test_pipeline_on_one_stage_is_the_stage_function():
    """A world of one: no permute moves anything, and the output is the
    stage function of each microbatch."""
    mesh = make_host_mesh(device="cpu")
    inp = arms.pipe_inputs(1)
    p = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
    x = torch.from_numpy(inp["x"])
    y = pipeline_forward(arms.stage_fn, p, x, mesh)
    _close(y, np.tanh(inp["x"] @ inp["w"][0] + inp["b"][0]))
    assert not mesh.stats.count_by_op

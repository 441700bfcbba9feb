"""Head counts the model axis does not divide, in prefill and training
(the whole-heads arm of ``models.attention``), over a gloo world of 4
ranks on the CPU, held to the reference's one-device functions.

One world is started once for the module (``_whole_heads_arms.py``);
meanwhile this process runs the reference's jitted ``LM.prefill``,
``jax.grad`` of its ``LM.loss`` and whisper's prefill and decode step on
the same numpy inputs.  Float32 throughout:
* qwen2 smoke with 4 query heads over 2 kv heads (the query heads divide
  over 4, the kv heads do not) and with 6 over 2 (neither divides, and
  ``wq``'s column split cuts a head): prefill logits within 1e-5 and the
  bf16 cache within one bf16 ulp, the loss within 1e-5 and every gradient leaf, reassembled from
  the ranks' pieces, within 1e-4 relative L2 of ``jax.grad``;
* whisper smoke with 6 heads over 6: prefill with the source (the
  encoder's self-attention and the cross-attention over every head)
  and one decode step (context-parallel self-attention, whole-heads
  cross-attention), logits within 1e-5;
* what still refuses these heads: the engines (``shard_model``, A8.8);
  the train cell of a hybrid (jamba: Mamba blocks and heads 4 does not
  divide) builds;
* ``launch.train --model-parallel 4`` on the smoke config.
The file's budget is 60 s of worker time (one world of 4 ranks for the
parity cases, each case's reference compiled once, and the CLI's world;
about 40 s alone)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _whole_heads_arms as arms  # noqa: E402
from _train_pairs import assert_trees_close  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch.bridge import state_from_numpy  # noqa: E402
from repro_torch.configs import ShapeConfig, get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh, spawn_world  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.sharding.rules import unshard  # noqa: E402
from repro_torch.sharding.tp import shard_model  # noqa: E402

TOL, GRAD_TOL = 1e-5, 1e-4


def _jconfig(arch: str, h: int, kvh: int):
    cfg = jconfigs.get_smoke_config(arch).with_(dtype="float32")
    return cfg.with_(attention=dataclasses.replace(
        cfg.attention, num_heads=h, num_kv_heads=kvh))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _qwen2_reference(case: str, seed: int) -> tuple:
    jlm = JLM(_jconfig("qwen2-1.5b", *arms.QWEN2[case]))
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(seed))
    inp = arms.inputs(jlm.cfg.vocab_size, jlm.cfg.d_model, seed)
    logits, cache = jax.jit(jlm.prefill)(
        jp, jnp.asarray(inp["tokens"]), jlm.init_cache(arms.B, arms.S))
    batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "labels", "mask")}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, batch)[0]))(jp)
    return jax.tree.map(np.asarray, jp), inp, {
        "logits": np.asarray(logits), "cache": jax.tree.map(np.asarray,
                                                            cache),
        "loss": float(loss), "grads": grads}


def _whisper_reference(seed: int) -> tuple:
    jlm = JLM(_jconfig("whisper-base", *arms.WHISPER))
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(seed))
    inp = arms.inputs(jlm.cfg.vocab_size, jlm.cfg.d_model, seed)
    prefill = jax.jit(lambda p, t, c, m: jlm.prefill(p, t, c,
                                                     modality_input=m))
    logits, cache = prefill(jp, jnp.asarray(inp["tokens"]),
                            jlm.init_cache(arms.B, arms.T),
                            jnp.asarray(inp["source"]))
    dec, _ = jax.jit(jlm.decode_step)(jp, jnp.asarray(inp["next"]), cache,
                                      arms.S)
    return jax.tree.map(np.asarray, jp), inp, {
        "logits": np.asarray(logits),
        "cache": jax.tree.map(np.asarray, cache), "decode": np.asarray(dec)}


@pytest.fixture(scope="module")
def runs():
    """The world's results and the reference's (the world starts from the
    reference's weights, inputs and whisper's prefilled cache)."""
    refs = {case: _qwen2_reference(case, seed)
            for seed, case in enumerate(arms.QWEN2)}
    refs["whisper"] = _whisper_reference(7)
    weights = {k: v[0] for k, v in refs.items()}
    inps = {k: v[1] for k, v in refs.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = spawn_world(arms.world, arms.RANKS, weights, inps,
                            refs["whisper"][2]["cache"], device="cpu",
                            threads=1)
    finally:
        torch.set_num_threads(threads)
    return ranks, {k: v[2] for k, v in refs.items()}


def _assert_cache_close(tcache, jcache, cfg):
    """The port's cache against the reference's (bridged), leaf by leaf.
    Both caches are bf16 (the reference's only unquantized cache dtype),
    so values that agree within 1e-5 before rounding may round to
    neighbouring bf16 values: each element within one bf16 ulp
    (relative 2^-7)."""
    want = state_from_numpy(jcache, cfg, "cpu")
    for g, wg in zip(tcache, want):
        assert g.keys() == wg.keys()
        for blk in g:
            assert g[blk].keys() == wg[blk].keys()
            got = {**g[blk]["kv"], **{k: g[blk][k] for k in ("xk", "xv")
                                      if k in g[blk]}}
            exp = {**wg[blk]["kv"], **{k: wg[blk][k] for k in ("xk", "xv")
                                       if k in wg[blk]}}
            assert got.keys() == exp.keys()
            for k in got:
                assert got[k].dtype == torch.bfloat16
                np.testing.assert_allclose(_np(got[k]), _np(exp[k]),
                                           rtol=2.0 ** -7, atol=TOL,
                                           err_msg=k)


@pytest.mark.parametrize("case", sorted(arms.QWEN2))
def test_prefill_over_every_head_matches_reference(runs, case):
    """Each rank's ``LM.prefill`` logits equal the reference's one-device
    prefill within 1e-5, and its bf16 cache (every kv head, whole on each
    rank) the reference's within one bf16 ulp; a prefill makes a rank's 3 gathers a layer (q / k / v) and the
    logits' gather, and 2 all-reduces a layer (``wo``, ``down``) and the
    embedding's."""
    ranks, ref = runs
    cfg = arms.qwen2_config(case)
    layers = cfg.num_layers
    for r in ranks:
        got = r[case]
        _close(got["logits"], ref[case]["logits"])
        _assert_cache_close(got["cache"], ref[case]["cache"], cfg)
        assert got["prefill"]["calls"] == {
            "all-gather/model": 3 * layers + 1,
            "all-reduce/model": 2 * layers + 1}


@pytest.mark.parametrize("case", sorted(arms.QWEN2))
def test_training_over_every_head_matches_reference_gradients(runs, case):
    """The loss on each rank equals the reference's within 1e-5, and every
    gradient leaf reassembled from the 4 ranks' pieces equals ``jax.grad``
    of its ``LM.loss`` within 1e-4 relative L2.  Each rank's ``wo`` reads
    only its rows of the whole attention output, so the gradient of the
    gathered q / k / v is a partial on every rank: the gather's backward
    sums it over the axis before keeping the rank's columns (one
    reduce-scatter a gather)."""
    ranks, ref = runs
    cfg = arms.qwen2_config(case)
    for r in ranks:
        np.testing.assert_allclose(r[case]["loss"], ref[case]["loss"],
                                   rtol=TOL)
        calls = r[case]["train"]["calls"]
        assert calls["reduce-scatter/model"] == 3 * cfg.num_layers
    grads = unshard([r[case]["grads"] for r in ranks], ranks[0][case]["specs"],
                    {"data": 1, "model": arms.RANKS})
    assert_trees_close(grads, ref[case]["grads"], cfg, GRAD_TOL, "grads")


def test_whisper_prefill_and_decode_over_every_head(runs):
    """whisper smoke at 6 heads over 6 on 4 ranks: prefill with the source
    (the encoder's self-attention, the decoder's and the cross-attention
    over every head) gives the reference's logits within 1e-5 and its
    bf16 cache within one ulp, and a decode step from the
    reference's prefilled cache (each rank a quarter of the positions,
    the source's K / V whole) its logits within 1e-5."""
    ranks, ref = runs
    cfg = arms.whisper_config()
    for r in ranks:
        got = r["whisper"]
        _close(got["logits"], ref["whisper"]["logits"])
        _assert_cache_close(got["cache"], ref["whisper"]["cache"], cfg)
        _close(got["decode"], ref["whisper"]["decode"])
        assert got["decode_calls"]["calls"]["all-gather/model"] \
            == cfg.num_layers * (3 + 1) + 1


def test_engines_and_hybrid_training_still_refuse():
    """``shard_model`` (what every engine calls) refuses heads the axis
    does not divide with A8.8's message: its page pools split kv heads.
    The train cell of jamba (Mamba blocks over the rank's channels, its
    4 over 2 heads on 4 ranks over every head) is no longer refused: it
    builds, and its step traces on the abstract mesh with one
    reduce-scatter a Mamba layer and a whole-heads attention projection
    (the gathers' backward)."""
    for case in arms.QWEN2:
        cfg = arms.qwen2_config(case)
        lm = LM(cfg, device="cpu")
        with pytest.raises(ValueError, match="kv heads.*A8.8"):
            shard_model(lm, lm.init(0), abstract_mesh({"model": arms.RANKS}))
    jamba = get_smoke_config("jamba-1.5-large-398b")
    cell = build_cell(jamba, ShapeConfig("t", 32, 4, "train"),
                      abstract_mesh({"model": arms.RANKS}))
    counts = cell.trace().collective_counts
    kinds = jamba.block_pattern * jamba.num_groups
    assert counts["reduce-scatter/model"] == kinds.count("mamba") \
        + 3 * kinds.count("attn")



def test_train_cli_trains_qwen2_on_four_ranks(tmp_path):
    """``python -m repro_torch.launch.train --arch qwen2-1.5b --smoke
    --device cpu --model-parallel 4`` trains (it exited on the heads'
    refusal before): exit 0, rank 0's mesh line, four reports whose
    collectives a step carry the gathers' reduce-scatters, finite
    losses."""
    import contextlib
    import io
    import json
    from repro_torch.launch.train import main
    hist = tmp_path / "history.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                   "--steps", "2", "--model-parallel", "4",
                   "--global-batch", "4", "--seq-len", "64",
                   "--log-every", "1", "--history-out", str(hist)])
    out = buf.getvalue()
    assert rc == 0
    assert "mesh {'data': 1, 'model': 4} over 4 ranks (gloo, cpu)" in out
    reports = [json.loads(ln.split(" report ", 1)[1])
               for ln in out.splitlines() if ln.startswith("[train] rank ")]
    assert len(reports) == 4
    layers = arms.qwen2_config("4x2").num_layers
    for r in reports:
        assert r["collectives_a_step"]["reduce-scatter/model"][0] \
            == 3 * layers
    losses = [h["loss"] for h in json.loads(hist.read_text())]
    assert len(losses) == 2 and np.isfinite(losses).all()

"""Port parity of the jamba hybrid (Mamba blocks and an attention block
in one group, MoE on every other block) against the reference, on
jamba-1.5-large-398b's smoke config (``("mamba", "attn")``, 4 layers) in
float32: the reference's ``LM.init`` pytree bridged to torch and the
same numpy tokens on both sides.  The weights are the port's ``LM.init``
tree in the reference's layout (``params_to_numpy``), handed to both
sides.  Every reference function is jitted once in this module
(``_jfns``) and shared by its tests.

* ``LM.logits``, ``prefill`` (logits and every cache leaf: Mamba ``ssm``
  / ``conv`` beside the attention block's K / V) and a ``decode_step``
  from the bridged reference cache to 1e-4; the port's teacher-forced
  decode against its full-context logits at ``tests/test_archs.py``'s
  2e-2.
* ``LM.loss`` to 1e-5 and every gradient leaf to 1e-4 relative L2.
* The full config cut to ``block_pattern[:5]`` (4 Mamba blocks and the
  attention block, the cut served on the H100) builds in both packages
  at a small width with equal logits, and counts 33.1 B parameters at
  full width.
* The eager ``Engine``: greedy streams, host syncs and counters equal
  JAX's ``Engine`` on fresh slots, with bf16 and with int8 weights; a
  reused slot gives the fresh stream (the reference's does not: its
  fault 1); ``PagedEngine`` (and the scheduler over it) refuses jamba
  with a message, as the reference asserts.
* ``quantize_tree`` quantizes what the reference's quantizes (Mamba
  ``in_proj`` / ``out_proj``, attention and dense MLP linears; never
  the expert stacks); calibration captures the Mamba linears.
* ``launch.serve --arch jamba-1.5-large-398b --smoke --device cpu``
  serves; ``--paged`` is refused.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _train_pairs import (assert_trees_close,  # noqa: E402,F401
                          one_intraop_thread, tbatch)
from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.quant.qops import quantize_tree as j_quantize  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.bridge import (params_from_numpy,  # noqa: E402
                                params_to_numpy, state_from_numpy)
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.quant import quantize_tree as t_quantize  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import PagedEngine  # noqa: E402
from repro_torch.train.loop import loss_and_grads  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_intraop_thread")

ARCH = "jamba-1.5-large-398b"
#: batch and cache of the LM tests: the engines' slots and max_len, so
#: the reference's decode program is the 4-slot engine's, compiled once
B, S, MAX_LEN = 4, 64, 256
#: counters both engines must agree on (wall-clock series excluded)
COUNTERS = ("serve_requests_submitted_total", "serve_requests_retired_total",
            "serve_tokens_emitted_total", 'resil_requests_total{outcome="ok"}')
#: engine prompt length: one of the reference's scan chunks, two of the
#: port's (128 + 2); one length, so one prefill compile an engine
PLEN = 130


def _same_weights(jlm, tlm, seed):
    """(the port's ``LM.init(seed)``, the same tree as JAX arrays in the
    reference's layout)."""
    tp = tlm.init(seed)
    return tp, jax.tree.map(jnp.asarray, params_to_numpy(tp, tlm.cfg))


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX LM, port LM, JAX params, port params); the port's tree is
    shared by the tests, which only read it."""
    jcfg = jconfigs.get_smoke_config(ARCH).with_(dtype="float32")
    tcfg = tconfigs.get_smoke_config(ARCH).with_(dtype="float32")
    jlm, tlm = JLM(jcfg), TLM(tcfg, device="cpu")
    tp, jp = _same_weights(jlm, tlm, 1)
    return jlm, tlm, jp, tp


@functools.lru_cache(maxsize=None)
def _jfns():
    """The reference's programs, jitted once for the module: ``forward``
    (``logits`` and ``prefill`` into a fresh cache, one program),
    ``decode`` (the 4-slot bf16 engine's) and ``grad`` (``value_and_grad``
    of ``loss``)."""
    jlm = _pair()[0]

    def forward(p, tokens):
        cache = jlm.init_cache(tokens.shape[0], MAX_LEN)
        return jlm.logits(p, tokens), jlm.prefill(p, tokens, cache)
    return {"forward": jax.jit(forward), "decode": _jax_programs("bf16")[2],
            "grad": jax.jit(jax.value_and_grad(jlm.loss, has_aux=True,
                                               allow_int=True))}


def _tokens(seed=3, s=S):
    return np.random.default_rng(seed).integers(0, 512, (B, s)).astype(
        np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x).astype(np.float32)


def _assert_caches_close(tcache, jcache, cfg, tol):
    want = state_from_numpy(jax.tree.map(np.asarray, jcache), cfg, "cpu")
    kinds = set()
    for g, wg in zip(tcache, want):
        assert g.keys() == wg.keys()
        for blk in g:
            assert g[blk].keys() == wg[blk].keys()
            for node in g[blk]:
                kinds.add(node)
                assert g[blk][node].keys() == wg[blk][node].keys()
                for name, leaf in g[blk][node].items():
                    # bf16 K / V: one ulp where float32 rounding ties differ
                    np.testing.assert_allclose(
                        _np(leaf), _np(wg[blk][node][name]), atol=tol,
                        rtol=1e-2 if node == "kv" else tol,
                        err_msg=f"{blk}/{node}/{name}")
    assert kinds == {"kv", "state"}


def test_block_kinds_and_init_match_jax():
    """The hybrid group's block kinds and every Mamba leaf's shape and
    dtype equal the reference's; the port's own init builds them, and the
    bridge carries them in both of the reference's layouts."""
    jlm, tlm, _, tp = _pair()
    kinds = ttr.block_kinds(tlm.cfg)
    assert kinds == jtr.block_kinds(jlm.cfg)
    assert [k["kind"] for k in kinds] == ["mamba", "attn"]
    assert [k["moe"] for k in kinds] == [True, False]
    want = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))["layers"]
    for i, g in enumerate(tp["layers"]):
        assert set(g["blk0"]) == {"norm1", "mamba", "norm2", "moe"}
        for name, leaf in want["blk0"]["mamba"].items():
            got = g["blk0"]["mamba"][name]
            if isinstance(leaf, dict):
                got, leaf = got["w"], leaf["w"]
            assert got.shape == leaf.shape[1:], name
            assert str(got.dtype).split(".")[1] == leaf.dtype.name, name
    state = tlm.init_cache(3, 16)[0]["blk0"]["state"]
    assert state["ssm"].shape == (3, 128, 8) and state["conv"].shape == \
        (3, 3, 128)
    # the bridge carries the Mamba leaves in both of the reference's
    # layouts: stacked on a group axis and under g{i} keys
    for scan in (True, False):
        cfg = tlm.cfg.with_(scan_layers=scan)
        back = params_from_numpy(params_to_numpy(tp, cfg), cfg, "cpu")
        for g, want in zip(back["layers"], tp["layers"]):
            for name, leaf in want["blk0"]["mamba"].items():
                got = g["blk0"]["mamba"][name]
                if isinstance(leaf, dict):
                    got, leaf = got["w"], leaf["w"]
                assert torch.equal(got, leaf), (scan, name)


def test_logits_prefill_and_decode_match_jax():
    jlm, tlm, jp, tp = _pair()
    f = _jfns()
    toks = _tokens()
    j_logits, (jl, jc) = f["forward"](jp, jnp.asarray(toks))
    np.testing.assert_allclose(
        _np(tlm.logits(tp, torch.from_numpy(toks).long())),
        _np(j_logits), atol=1e-4, rtol=1e-4)
    tl, tc = tlm.prefill(tp, torch.from_numpy(toks).long(),
                         tlm.init_cache(B, MAX_LEN))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_caches_close(tc, jc, tlm.cfg, 1e-4)
    # one decode step from the reference's cache, bridged
    tcache = state_from_numpy(jax.tree.map(np.asarray, jc), tlm.cfg, "cpu")
    tok = toks[:, 0]
    jl, jc2 = f["decode"](jp, jnp.asarray(tok), jc,
                          jnp.asarray(np.full((B,), S, np.int32)))
    tl, tc2 = tlm.decode_step(tp, torch.from_numpy(tok).long(), tcache,
                              torch.full((B,), S))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_caches_close(tc2, jc2, tlm.cfg, 1e-4)


def test_decode_matches_full_context():
    """A prefill of 8 tokens then teacher-forced decode steps give the
    full-sequence logits (2e-2, as tests/test_archs.py)."""
    _, tlm, _, tp = _pair()
    toks = torch.from_numpy(_tokens(seed=4, s=16)).long()
    full = _np(tlm.logits(tp, toks))
    _, tc = tlm.prefill(tp, toks[:, :8], tlm.init_cache(B, 32))
    for i in range(8, 16):
        tl, tc = tlm.decode_step(tp, toks[:, i], tc, torch.full((B,), i))
        np.testing.assert_allclose(_np(tl), full[:, i], atol=2e-2,
                                   rtol=2e-2)


def test_loss_and_grads_match_jax():
    """The training forward (Mamba chunk steps checkpointed inside each
    group's remat): loss and metrics to 1e-5, every gradient leaf (the
    Mamba block's ``A_log``, ``D``, ``dt_bias``, conv and linears, the
    experts, the attention block) to 1e-4 relative L2."""
    jlm, tlm, jp, tp = _pair()
    rng = np.random.default_rng(5)
    nb = {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
          "labels": rng.integers(0, 512, (B, S)).astype(np.int32)}
    (jloss, jm), jg = _jfns()["grad"](
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    tloss, tm, tg = loss_and_grads(tlm, tp, tbatch(nb))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert_trees_close(tg, jg, tlm.cfg, 1e-4, "grads")
    mamba = tg["layers"][0]["blk0"]["mamba"]
    for name in ("A_log", "D", "dt_bias", "conv_w"):
        assert float(mamba[name].abs().sum()) > 0, name


def _cut(registry, mod):
    """The full config cut to its first five blocks (4 Mamba, the
    attention block; MoE on 0, 2, 4) at a small width."""
    cfg = registry.get_config(ARCH)
    return cfg.with_(
        num_layers=5, block_pattern=cfg.block_pattern[:5], d_model=64,
        d_ff=128, vocab_size=512, dtype="float32",
        attention=mod.AttentionConfig(kind="gqa", num_heads=8,
                                      num_kv_heads=2, head_dim=16),
        ssm=mod.SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
        moe=mod.MoEConfig(num_experts=4, top_k=2, d_ff=64))


def test_five_layer_cut_builds_and_matches_jax():
    full = tconfigs.get_config(ARCH)
    cut = tconfigs.first_layers(full, 5)
    assert cut.block_pattern == full.block_pattern[:5] and \
        cut.num_groups == 1
    assert tconfigs.first_layers(full, 16).num_groups == 2
    assert cut.param_count() == jconfigs.get_config(ARCH).with_(
        num_layers=5, block_pattern=full.block_pattern[:5]).param_count()
    assert round(cut.param_count() / 1e9, 1) == 33.1
    jcfg, tcfg = _cut(jconfigs, jbase), _cut(tconfigs, tbase)
    assert [k["moe"] for k in ttr.block_kinds(tcfg)] == \
        [True, False, True, False, True]
    jlm, tlm = JLM(jcfg), TLM(tcfg, device="cpu")
    tp, jp = _same_weights(jlm, tlm, 2)
    toks = _tokens(seed=6, s=32)
    np.testing.assert_allclose(
        _np(tlm.logits(tp, torch.from_numpy(toks).long())),
        _np(jax.jit(jlm.logits)(jp, jnp.asarray(toks))), atol=1e-4,
        rtol=1e-4)


# ---------------------------------------------------------------------------
# Engines


@functools.lru_cache(maxsize=None)
def _weights(quant: str):
    """(port params, the same as JAX arrays in the reference's layout):
    the float32 tree, or the port's ``quantize_tree`` of it (held to the
    reference's quantization in ``tests/test_torch_quant.py``)."""
    _, tlm, jp, tp = _pair()
    if quant == "bf16":
        return tp, jp
    qp = t_quantize(tp, quant=quant)
    return qp, jax.tree.map(jnp.asarray, params_to_numpy(qp, tlm.cfg))


@functools.lru_cache(maxsize=None)
def _jax_programs(quant: str):
    """One 4-slot reference Engine's jitted prefill / decode per weight
    format, shared by every engine of this module built through
    :func:`_jax_engine` (a prefill compiles once a prompt length)."""
    jp = _weights(quant)[1]
    eng = JEngine(_pair()[0], jp, n_slots=4, max_len=MAX_LEN, seed=0)
    return jp, eng._prefill_one, eng._decode


def _jax_engine(quant: str):
    params, prefill, decode = _jax_programs(quant)
    eng = JEngine(_pair()[0], params, n_slots=4, max_len=MAX_LEN, seed=0)
    n = {"syncs": 0}

    def counted(fn):
        def call(*a):
            n["syncs"] += 1
            return fn(*a)
        return call
    eng._prefill_one, eng._decode = counted(prefill), counted(decode)
    return eng, n


def _prompts(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (PLEN,)).tolist() for _ in range(n)]


def _serve(eng, prompts, max_new=6):
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = eng.run_to_completion()
    return [done[i].out_tokens for i in ids]


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_engine_matches_jax_engine(quant):
    """Greedy streams, host syncs and ``serve_*`` counters equal JAX's
    ``Engine`` with every slot used once; int8 weights through the
    port's fused and plain matmuls alike."""
    tlm = _pair()[1]
    prompts = _prompts()
    jeng, syncs = _jax_engine(quant)
    jstreams = _serve(jeng, prompts)
    lms = [tlm] if quant == "bf16" else [
        TLM(tlm.cfg.with_(quant="int8", quant_matmul_impl=impl),
            device="cpu") for impl in ("fused", "ref")]
    for lm in lms:
        teng = TEngine(lm, _weights(quant)[0], n_slots=4, max_len=MAX_LEN,
                       seed=0)
        assert _serve(teng, prompts) == jstreams
        assert teng.sync_count == syncs["syncs"] == len(prompts) + 5
        jc, tc = (e.metrics.snapshot()["counters"] for e in (jeng, teng))
        assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}


def test_reused_slot_gives_the_fresh_stream():
    """Five requests through one slot: each stream equals its prompt
    served in a fresh engine, because the port zeroes a Mamba slot's
    ``ssm`` and ``conv`` at admission.  The reference's ``Engine``
    prefills from whatever state the slot holds (its fault 1): served one
    request at a time on its 4 slots, only the first stream is sure to be
    the fresh one (each decode step also steps the idle slots' states),
    and the later ones are not all fresh."""
    _, tlm, _, tp = _pair()
    prompts = _prompts(5, seed=1)
    reused = _serve(TEngine(tlm, tp, n_slots=1, max_len=MAX_LEN, seed=0),
                    prompts)
    fresh = _serve(TEngine(tlm, tp, n_slots=4, max_len=MAX_LEN, seed=0),
                   prompts)
    assert reused == fresh
    jeng = _jax_engine("bf16")[0]
    j_one_by_one = [_serve(jeng, [p])[0] for p in prompts]
    assert j_one_by_one[0] == fresh[0]
    assert j_one_by_one[1:] != fresh[1:]


def test_paged_engines_refuse_jamba_with_a_message():
    from repro_torch.sched import SchedEngine
    _, tlm, _, tp = _pair()
    for cls in (PagedEngine, SchedEngine):
        with pytest.raises(ValueError, match="Mamba.*eager Engine"):
            cls(tlm, tp, n_slots=1, max_len=64)


def test_quantize_tree_and_calibration_reach_the_mamba_linears():
    """int8 ``quantize_tree`` quantizes what the reference's does, each
    leaf of the reference's shape and dtype (the Mamba ``in_proj`` /
    ``out_proj`` and the attention / dense-MLP linears; not ``x_proj``,
    ``dt_proj`` or the expert stacks; the values are held bit for bit in
    ``tests/test_torch_quant.py``); ``collect_linear_inputs`` hands the
    Mamba linears their inputs (the reference's capture sees none of
    them: R8)."""
    from repro_torch.quant.calibrate import collect_linear_inputs
    _, tlm, jp, tp = _pair()
    got = _weights("int8")[0]
    blk0, blk1 = got["layers"][0]["blk0"], got["layers"][0]["blk1"]
    assert {k for k, v in blk0["mamba"].items()
            if isinstance(v, dict) and "qw" in v} == {"in_proj", "out_proj"}
    assert "qw" in blk1["attn"]["wq"] and "qw" in blk1["mlp"]["gate"]
    assert blk0["moe"]["gate_e"].dtype == torch.float32
    want = jax.eval_shape(functools.partial(j_quantize, quant="int8"), jp)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(got, tlm.cfg)))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for path, leaf in flat_want.items():
        assert flat_got[path].shape == leaf.shape, path
        assert flat_got[path].dtype.name == leaf.dtype.name, path
    caps = collect_linear_inputs(
        tlm, tp, torch.from_numpy(_tokens(s=16)).long(),
        targets=("in_proj", "x_proj", "out_proj"))
    assert set(caps) == {f"/layers/g{g}/blk0/mamba/{n}" for g in (0, 1)
                         for n in ("in_proj", "x_proj", "out_proj")}
    assert caps["/layers/g0/blk0/mamba/out_proj"].shape == (B * 16, 128)


def test_launch_serve_jamba_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "40", "--max-new",
                 "4"]) == 0
    out = capsys.readouterr().out
    assert "eager" in out and "2 requests, 8 tokens" in out
    for flags in (["--paged"], ["--policy", "fcfs"], ["--spec", "ngram"]):
        with pytest.raises(SystemExit):
            main(["--arch", ARCH, "--smoke", "--device", "cpu", *flags])
        assert "attention-only" in capsys.readouterr().err

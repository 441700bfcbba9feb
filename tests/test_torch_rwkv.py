"""Port parity: RWKV-6 blocks, the ``LM`` over them and the eager
``Engine`` against ``repro.models`` / ``repro.serve.engine.Engine`` on the
rwkv6-1.6b smoke config.  Both sides use the reference's ``LM.init``
pytree, bridged to torch (both ``scan_layers`` layouts), and the same
numpy tokens.

Tolerances.  The reference rounds the gated group-norm output to bf16
before ``wout`` (``_rwkv6_out``), in float32 configs too.  A one-ulp
float32 difference upstream (any matmul summed in another order) flips
that rounding on a few of the B·S·d elements: a 2^-8 step.  So a block's
output is held to 1e-4 or one bf16 ulp, its state to 1e-4, and float32
logits to 1e-2 (flips move them by a few 1e-3 at B 2, S 128; where
nothing flips they agree to float32 rounding).  bf16 logits are held to
3e-2 against the reference's unrolled forward: its scanned bf16 forward
differs from its own unrolled one by more than that on these inputs, so
the scanned tree is bridged and held to the unrolled forward of the same
weights.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch.bridge import (_tree, params_from_numpy,  # noqa: E402
                                state_from_numpy)
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402

torch.manual_seed(0)

ARCH = "rwkv6-1.6b"
#: counters both engines must agree on (wall-clock series excluded)
COUNTERS = ("serve_requests_submitted_total", "serve_requests_retired_total",
            "serve_tokens_emitted_total", 'resil_requests_total{outcome="ok"}')
#: prompt lengths of the engine drives: one and two chunks, with a
#: partial chunk and none
PLENS = (16, 32, 64, 128)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _models(dtype="float32", scan_layers=True, seed=0):
    jcfg = j_smoke(ARCH).with_(dtype=dtype, scan_layers=scan_layers)
    tcfg = t_smoke(ARCH).with_(dtype=dtype)
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(seed))
    tlm = TLM(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return (jlm, jparams), (tlm, tparams)


@pytest.fixture(scope="module")
def f32_models():
    return _models()


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (n,)).tolist() for n in PLENS]


def _assert_bf16_close(a, b, tol=1e-4):
    """Within ``tol`` (abs + rel), or one bf16 ulp of ``b`` apart (a
    rounding the two sides' float32 values fell on either side of)."""
    a, b = _np(a), _np(b)
    _, e = np.frexp(b)
    ulp = np.ldexp(np.ones_like(b), e - 8)
    ok = (np.abs(a - b) <= tol + tol * np.abs(b)) | (np.abs(a - b) <= ulp)
    assert ok.all(), f"{(~ok).sum()} elements apart, max {np.abs(a - b).max()}"


# ---------------------------------------------------------------------------
# blocks


def _block(seed=0):
    """A reference RWKV-6 block with its lerp offsets drawn non-zero, the
    same on both sides, and a non-zero state."""
    cfg = j_smoke(ARCH)
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jssm.init_rwkv6(jax.random.PRNGKey(seed),
                                                 64, cfg.ssm, jnp.float32))
    p["tmix"]["x_maa"] = rng.normal(size=(64,)).astype(np.float32) * 0.3
    p["tmix"]["maas"] = rng.normal(size=(5, 64)).astype(np.float32) * 0.3
    state = {"wkv": rng.normal(size=(2, 4, 16, 16)).astype(np.float32) * 0.2,
             "x_prev": rng.normal(size=(2, 64)).astype(np.float32)}
    return cfg.ssm, p, state, rng


def test_rwkv6_forward_matches_jax():
    s, p, state, rng = _block()
    x = rng.normal(size=(2, 100, 64)).astype(np.float32)
    # the reference's chunked form takes multiples of 64; 100 tokens run
    # through the port in one call and through the reference as 64 + 36
    jst = jax.tree.map(jnp.asarray, state)
    ys = []
    for sl in (slice(0, 64), slice(64, 100)):
        y, jst = jssm.rwkv6_forward(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x[:, sl]), s, jst)
        ys.append(np.asarray(y, np.float32))
    ty, tst = tssm.rwkv6_forward(_tree(p, None), torch.from_numpy(x), s,
                                 _tree(state, None))
    assert ty.dtype == torch.bfloat16
    _assert_bf16_close(ty, np.concatenate(ys, 1))
    for k in ("wkv", "x_prev"):
        np.testing.assert_allclose(_np(tst[k]), np.asarray(jst[k]),
                                   atol=1e-4, rtol=1e-4)


def test_rwkv6_decode_matches_jax():
    s, p, state, rng = _block(seed=1)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    jp, jst = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, state)
    tp, tst = _tree(p, None), _tree(state, None)
    for _ in range(3):                     # three steps on the carried state
        jy, jst = jssm.rwkv6_decode(jp, jnp.asarray(x), s, jst)
        ty, tst = tssm.rwkv6_decode(tp, torch.from_numpy(x), s, tst)
        _assert_bf16_close(ty, jy)
        for k in ("wkv", "x_prev"):
            np.testing.assert_allclose(_np(tst[k]), np.asarray(jst[k]),
                                       atol=1e-4, rtol=1e-4)
        x = np.asarray(jy, np.float32)


# ---------------------------------------------------------------------------
# LM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan_layers", [True, False])
def test_lm_logits_match_jax(dtype, scan_layers):
    (jlm, jparams), (tlm, tparams) = _models(dtype, scan_layers)
    toks = np.random.default_rng(0).integers(0, 512, (2, 128))
    got = tlm.logits(tparams, torch.as_tensor(toks))
    if dtype == "bfloat16":
        jlm = JLM(jlm.cfg.with_(scan_layers=False))
        if scan_layers:                    # the same weights, unrolled
            jparams = {**jparams, "layers": {
                f"g{i}": jax.tree.map(lambda a: a[i], jparams["layers"])
                for i in range(jlm.cfg.num_groups)}}
    want = jlm.logits(jparams, jnp.asarray(toks))
    tol = 1e-2 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_decode_after_prefill_matches_full_logits(f32_models):
    """Teacher-forced decode from a prefill's state equals the
    full-sequence logits (the port's counterpart of ``test_archs.py``
    ``test_decode_matches_prefill``, at its 2e-2)."""
    _, (tlm, tparams) = f32_models
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 512, (1, 16)))
    full = tlm.logits(tparams, toks)
    logits, cache = tlm.prefill(tparams, toks[:, :8], tlm.init_cache(1, 32))
    torch.testing.assert_close(logits, full[:, 7], atol=2e-2, rtol=2e-2)
    for i in range(8, 16):
        logits, cache = tlm.decode_step(tparams, toks[:, i], cache,
                                        torch.full((1,), i))
        torch.testing.assert_close(logits, full[:, i], atol=2e-2, rtol=2e-2)


def test_decode_from_bridged_state_matches_jax(f32_models):
    """The reference's prefill state, bridged with ``state_from_numpy``,
    decodes in the port as it decodes in the reference."""
    (jlm, jparams), (tlm, tparams) = f32_models
    toks = np.random.default_rng(4).integers(0, 512, (2, 64))
    _, jcache = jlm.prefill(jparams, jnp.asarray(toks),
                            jlm.init_cache(2, 128))
    tcache = state_from_numpy(jax.tree.map(np.asarray, jcache), tlm.cfg)
    assert tcache[0]["blk0"]["state"]["wkv"].shape == (2, 4, 16, 16)
    tok = np.asarray([5, 77], np.int32)
    jl, _ = jlm.decode_step(jparams, jnp.asarray(tok), jcache,
                            jnp.full((2,), 64, jnp.int32))
    tl, _ = tlm.decode_step(tparams, torch.as_tensor(tok).long(), tcache,
                            torch.full((2,), 64))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# Engine


def _drive(cls, lm, params, prompts, n_slots, max_new=8, **kw):
    eng = cls(lm, params, n_slots=n_slots, max_len=256, seed=0, **kw)
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = eng.run_to_completion()
    return eng, [done[i].out_tokens for i in ids]


def _count_jax_syncs(eng):
    """Wrap JAX Engine's two device programs: each call's result is read
    on the host once (the admission's logits, the decode step's)."""
    n = {"syncs": 0}
    for name in ("_prefill_one", "_decode"):
        fn = getattr(eng, name)

        def counted(*a, _fn=fn):
            n["syncs"] += 1
            return _fn(*a)
        setattr(eng, name, counted)
    return n


def test_engine_matches_jax_engine(f32_models):
    """Greedy streams, host syncs and ``serve_*`` counters equal JAX's
    ``Engine`` in float32, each slot used once."""
    (jlm, jparams), (tlm, tparams) = f32_models
    prompts = _prompts()
    jeng = JEngine(jlm, jparams, n_slots=4, max_len=256, seed=0)
    syncs = _count_jax_syncs(jeng)
    ids = [jeng.submit(p, max_new_tokens=8) for p in prompts]
    done = jeng.run_to_completion()
    jstreams = [done[i].out_tokens for i in ids]
    teng, tstreams = _drive(TEngine, tlm, tparams, prompts, 4)
    assert tstreams == jstreams
    assert teng.sync_count == syncs["syncs"] == len(prompts) + 7
    jc, tc = (e.metrics.snapshot()["counters"] for e in (jeng, teng))
    assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    assert tc["serve_host_syncs_total"] == teng.sync_count


def test_reused_slot_gives_the_fresh_stream(f32_models):
    """Four requests through one slot: each stream equals its prompt
    served alone in a fresh engine, because the port zeroes the slot's
    state at admission.  The reference's ``Engine`` prefills from the
    previous occupant's state and fails this (ROADMAP C)."""
    (jlm, jparams), (tlm, tparams) = f32_models
    prompts = _prompts()
    _, reused = _drive(TEngine, tlm, tparams, prompts, 1)
    alone = [_drive(TEngine, tlm, tparams, [p], 1)[1][0] for p in prompts]
    assert reused == alone
    _, j_reused = _drive(JEngine, jlm, jparams, prompts, 1)
    j_alone = [_drive(JEngine, jlm, jparams, [p], 1)[1][0] for p in prompts]
    assert j_reused[0] == j_alone[0] == alone[0]
    assert j_reused[1:] != j_alone[1:]


def test_engine_serves_a_prompt_of_any_length(f32_models):
    """A 100-token prompt, which the reference's chunked WKV refuses: its
    admission logits equal the reference's 64-token prefill followed by 36
    decode steps (float32, 1e-2: see the module docstring)."""
    (jlm, jparams), (tlm, tparams) = f32_models
    prompt = np.random.default_rng(5).integers(0, 512, (100,))
    with pytest.raises(AssertionError, match="not divisible"):
        jlm.prefill(jparams, jnp.asarray(prompt)[None],
                    jlm.init_cache(1, 128))
    jl, jcache = jlm.prefill(jparams, jnp.asarray(prompt[:64])[None],
                             jlm.init_cache(1, 128))
    for i in range(64, 100):
        jl, jcache = jlm.decode_step(jparams, jnp.asarray(prompt[i:i + 1]),
                                     jcache, jnp.full((1,), i, jnp.int32))
    eng = TEngine(tlm, tparams, n_slots=2, max_len=256, seed=0)
    tl = eng._prefill_slot(prompt, 1)
    np.testing.assert_allclose(_np(tl), _np(jl[0]), atol=1e-2, rtol=1e-2)
    rid = eng.submit(prompt, max_new_tokens=6)
    out = eng.run_to_completion()[rid].out_tokens
    assert len(out) == 6 and all(0 <= t < 512 for t in out)


def test_engine_temperature_sampling_matches_jax(f32_models):
    """Host sampling draws from ``np.random.default_rng(seed)`` as the
    reference's ``_sample`` does, so equal logits give equal samples."""
    (jlm, jparams), (tlm, tparams) = f32_models
    prompts = _prompts(seed=1)[:2]
    jeng = JEngine(jlm, jparams, n_slots=2, max_len=256, seed=3)
    teng = TEngine(tlm, tparams, n_slots=2, max_len=256, seed=3)
    streams = []
    for eng in (jeng, teng):
        ids = [eng.submit(p, max_new_tokens=6, temperature=0.8)
               for p in prompts]
        done = eng.run_to_completion()
        streams.append([done[i].out_tokens for i in ids])
    assert streams[0] == streams[1]


def test_engine_refuses_attention_decoders():
    """The eager Engine serves attention and RWKV-6 blocks; a Mamba block
    is refused, naming its queue entry (ROADMAP A6)."""
    cfg = t_smoke(ARCH).with_(block_pattern=("rwkv6", "mamba"))
    with pytest.raises(NotImplementedError, match="mamba.*ROADMAP A6"):
        TEngine(TLM(cfg, device="cpu"), {}, n_slots=1, max_len=16)


def test_launch_serve_rwkv_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "70", "--max-new",
                 "4"]) == 0
    out = capsys.readouterr().out
    assert "eager" in out and "2 requests, 8 tokens" in out

"""Port parity: the eager ``Engine`` for attention decoders over contiguous
caches, and what it runs, against ``repro`` on the same numpy inputs.

* ``chunked_attention`` (online softmax over kv blocks) against the
  reference's rolled form: blocks that divide and blocks that fall back
  to one, causal with and without a window and non-causal, GQA groups of
  1, 3 and all heads; float32 to 1e-5, bf16 to 2e-2.
* ``attention_forward`` on each side of ``attn_chunk_min`` (set small)
  for every ``attn_impl``, float32 to 1e-5.
* Contiguous int8 / fp8 caches: allocation, ``prefill_write`` and
  ``decode_write`` bit-equal to the eager JAX ops (values and scales),
  and the fused-scale ``attention_decode`` to 1e-5 in float32.
* ``Engine``: greedy streams, host syncs and ``serve_*`` counters equal
  JAX's ``Engine`` in float32 on bf16 / int8 / fp8 caches, kv styles
  gqa and mqa, a windowed config, prompts past ``attn_chunk_min`` and
  more requests than slots (slots reused after longer prompts); int8
  weights with "fused" equal to "ref" and to JAX.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kvcache as jkv  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import AttentionConfig as JAttn  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.quant.qops import quantize_tree as j_quantize  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import kvcache as tkv  # noqa: E402
from repro_torch.bridge import _tree, params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import AttentionConfig as TAttn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402

torch.manual_seed(0)

#: counters both engines must agree on (wall-clock series excluded)
COUNTERS = ("serve_requests_submitted_total", "serve_requests_retired_total",
            "serve_tokens_emitted_total",
            'resil_requests_total{outcome="ok"}')
#: chunk knobs of the engine drives: prompts of 33 and 40 tokens take
#: chunked attention (33 falls back to one block), 8 and 12 the sdpa
CHUNK = dict(attn_chunk_min=32, attn_q_block=16, attn_kv_block=16)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _bits(x) -> np.ndarray:
    """Raw bits of an array / tensor of any 1-, 2- or 4-byte dtype."""
    if isinstance(x, torch.Tensor):
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
        return x.view(width[x.element_size()]).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.itemsize])


# ---------------------------------------------------------------------------
# chunked attention


@pytest.mark.parametrize("kh,g", [(4, 1), (2, 3), (1, 6)])
@pytest.mark.parametrize("mask", ["causal", "window", "none"])
@pytest.mark.parametrize("blocks", ["divide", "fallback"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_jax(kh, g, mask, blocks, dtype):
    """S = T = 64 in blocks of 16 (a window of 10 gives later q blocks a
    lower kv-block bound above 0), or q blocks of 24 that do not divide
    64: the single-block fallback."""
    rng = np.random.default_rng(kh * 10 + g)
    b, s, d = 2, 64, 16
    qg = rng.normal(size=(b, s, kh, g, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    causal = mask != "none"
    window = 10 if mask == "window" else None
    qb = 16 if blocks == "divide" else 24
    scale = np.float32(1.0 / np.sqrt(d))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    jo = jattn.chunked_attention(
        jnp.asarray(qg, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        causal=causal, window=window, scale=jnp.float32(scale), q_block=qb,
        kv_block=16)
    to = tattn.chunked_attention(
        torch.from_numpy(qg).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), causal=causal, window=window,
        scale=torch.tensor(scale), q_block=qb, kv_block=16)
    assert to.dtype == td and tuple(to.shape) == (b, s, kh, g, d)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(to), _np(jo), atol=tol, rtol=tol)


@pytest.mark.parametrize("s,window", [(24, None), (48, None), (48, 20)])
@pytest.mark.parametrize("impl", ["auto", "chunked", "eager"])
def test_attention_forward_across_chunk_min(impl, s, window):
    """attn_chunk_min 32 with blocks of 16: below it "auto" is the sdpa,
    at or above it chunked attention, as in the reference."""
    d_model = 64
    ja = JAttn(num_heads=4, num_kv_heads=2, head_dim=16, qkv_bias=True,
               window=window)
    ta = TAttn(num_heads=4, num_kv_heads=2, head_dim=16, qkv_bias=True,
               window=window)
    jp = jattn.init_attention(jax.random.PRNGKey(1), d_model, ja,
                              dtype=jnp.float32)
    tp = _tree(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(s).normal(size=(2, s, d_model)).astype(
        np.float32)
    kw = dict(attn_impl=impl, q_block=16, kv_block=16, chunk_min=32)
    jy = jattn.attention_forward(jp, jnp.asarray(x), ja, **kw)
    ty = tattn.attention_forward(tp, torch.from_numpy(x), ta, **kw)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# contiguous quantized caches


@pytest.mark.parametrize("style", ["full", "mqa"])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_contiguous_quantized_writes_bit_equal(kv, style):
    """Allocation (k_scale / v_scale of (B, S, KH) fp32), a prefill write
    of bf16 rows with outliers, then decode writes at per-row positions
    (one past the slab: clamped): values and scales bit-equal to the
    eager JAX ops."""
    rng = np.random.default_rng(7)
    ja = JAttn(num_heads=4, num_kv_heads=2, head_dim=16)
    ta = TAttn(num_heads=4, num_kv_heads=2, head_dim=16)
    jspec = jkv.CacheSpec(dtype=kv, style=style)
    tspec = tkv.CacheSpec(dtype=kv, style=style)
    jc = jkv.alloc_contiguous(jspec, ja, 2, 12)
    tc = tkv.alloc_contiguous(tspec, ta, 2, 12)
    assert set(jc) == set(tc) == {"k", "v", "k_scale", "v_scale"}
    for name in jc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
    kvh = tspec.stored_kv_heads(ta)
    rows = rng.normal(size=(2, 2, 9, kvh, 16)).astype(np.float32) * 3
    rows[0, 1, 4, 0, 3] = 40.0                    # one outlier position
    rows[1, 0, 2] = 0.0                           # an all-zero position
    upd = {n: jnp.asarray(r, jnp.bfloat16) for n, r in zip("kv", rows)}
    jc = jkv.prefill_write(jc, upd)
    tkv.prefill_write(tc, {n: torch.from_numpy(r).bfloat16()
                           for n, r in zip("kv", rows)})
    for step, pos in enumerate(([9, 3], [10, 11], [11, 14])):
        new = rng.normal(size=(2, 2, 1, kvh, 16)).astype(np.float32)
        new *= 1 + 5 * step
        jc = jkv.decode_write(jc, {n: jnp.asarray(r) for n, r in
                                   zip("kv", new)},
                              jnp.asarray(pos, jnp.int32))
        tkv.decode_write(tc, {n: torch.from_numpy(r) for n, r in
                              zip("kv", new)}, torch.as_tensor(pos))
    for name in jc:
        np.testing.assert_array_equal(_bits(tc[name]), _bits(jc[name]),
                                      err_msg=name)
    k, v, ks, vs = tkv.kv_views(tc)
    assert ks is tc["k_scale"] and vs is tc["v_scale"]


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_fused_scale_decode_matches_jax(kv, window):
    """Prefill 12 positions into an int8 / fp8 cache, then two decode
    steps at per-row positions: outputs to 1e-5 in float32 and the
    caches (values and scales) bit-equal."""
    d_model = 64
    ja = JAttn(num_heads=6, num_kv_heads=2, head_dim=16, qkv_bias=True,
               window=window)
    ta = TAttn(num_heads=6, num_kv_heads=2, head_dim=16, qkv_bias=True,
               window=window)
    jp = jattn.init_attention(jax.random.PRNGKey(2), d_model, ja,
                              dtype=jnp.float32)
    tp = _tree(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 12, d_model)).astype(np.float32)
    jc = jkv.alloc_contiguous(jkv.CacheSpec(dtype=kv), ja, 2, 20)
    tc = tkv.alloc_contiguous(tkv.CacheSpec(dtype=kv), ta, 2, 20)
    jy, jc = jattn.attention_prefill(jp, jnp.asarray(x), ja, jc)
    ty, tc = tattn.attention_prefill(tp, torch.from_numpy(x), ta, tc)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    for pos in ([12, 7], [13, 8]):
        xt = rng.normal(size=(2, 1, d_model)).astype(np.float32)
        jy, jc = jattn.attention_decode(jp, jnp.asarray(xt), ja, jc,
                                        jnp.asarray(pos, jnp.int32))
        ty, tc = tattn.attention_decode(tp, torch.from_numpy(xt), ta, tc,
                                        torch.as_tensor(pos))
        np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    for name in jc:
        np.testing.assert_array_equal(_bits(tc[name]), _bits(jc[name]),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# Engine


@pytest.fixture(scope="module")
def base_params():
    """The smoke qwen2 in float32: one reference parameter tree (numpy)."""
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32")
    return jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))


def _prompts(vocab):
    """More requests than the 2 slots; the 8- and 12-token prompts land
    in slots a longer prompt used before them (stale rows past their
    length); 33 and 40 tokens are past attn_chunk_min."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).tolist() for n in (40, 33, 8, 12)]


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


def _serve(eng, prompts, max_new=6):
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = eng.run_to_completion()
    return [done[i].out_tokens for i in ids]


def _pair(base_params, **over):
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32", **CHUNK, **over)
    tcfg = t_smoke("qwen2-1.5b").with_(dtype="float32", **CHUNK, **over)
    jp = jax.tree.map(jnp.asarray, base_params)
    tp = params_from_numpy(base_params, tcfg, device="cpu")
    return (JLM(jcfg), jp), (TLM(tcfg, device="cpu"), tp)


@pytest.mark.parametrize("kv,style,window", [
    ("bfloat16", "full", None), ("int8", "full", None),
    ("fp8", "full", None), ("bfloat16", "gqa", None),
    ("int8", "mqa", None), ("bfloat16", "full", 16)])
def test_engine_matches_jax_engine(base_params, kv, style, window):
    over = dict(kv_cache_dtype=kv, kv_cache_style=style)
    (jlm, jp), (tlm, tp) = _pair(base_params, **over)
    if window is not None:
        jlm = JLM(jlm.cfg.with_(attention=dataclasses.replace(
            jlm.cfg.attention, window=window)))
        tlm = TLM(tlm.cfg.with_(attention=dataclasses.replace(
            tlm.cfg.attention, window=window)), device="cpu")
    prompts = _prompts(jlm.cfg.vocab_size)
    jeng = JEngine(jlm, jp, n_slots=2, max_len=64, seed=0)
    syncs = _count_jax_syncs(jeng)
    teng = TEngine(tlm, tp, n_slots=2, max_len=64, seed=0)
    jstreams, tstreams = _serve(jeng, prompts), _serve(teng, prompts)
    assert tstreams == jstreams
    assert all(len(t) == 6 for t in tstreams)
    assert teng.sync_count == syncs["syncs"]
    jc, tc = (e.metrics.snapshot()["counters"] for e in (jeng, teng))
    assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    assert tc["serve_host_syncs_total"] == teng.sync_count
    node = teng.cache[0]["blk0"]["kv"]
    assert ("k_scale" in node) == (kv != "bfloat16")


def test_int8_weight_engine_fused_equals_ref_and_jax(base_params):
    """int8 weights (W8A8) over an int8 contiguous cache: the port's
    "fused" and "ref" matmuls and JAX give the same greedy streams."""
    (jlm, _), (tlm, _) = _pair(base_params, kv_cache_dtype="int8",
                               quant="int8")
    jq = j_quantize(jax.tree.map(jnp.asarray, base_params), quant="int8")
    prompts = _prompts(jlm.cfg.vocab_size)
    streams = [_serve(JEngine(jlm, jq, n_slots=2, max_len=64, seed=0),
                      prompts)]
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), tlm.cfg,
                           device="cpu")
    for impl in ("fused", "ref"):
        lm = TLM(tlm.cfg.with_(quant_matmul_impl=impl), device="cpu")
        streams.append(_serve(TEngine(lm, tq, n_slots=2, max_len=64,
                                      seed=0), prompts))
    assert streams[1] == streams[2] == streams[0]

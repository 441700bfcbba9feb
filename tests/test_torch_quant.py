"""Port parity, model and cache level: weight quantization
(``quantize_tree`` for int8 / fp8 / int4 on the smoke LM, both
``scan_layers`` layouts, and the bridge of JAX's quantized tree), the
M = 128 split of ``quantized_matmul``, the LM's logits with quantized
weights, and int8 / fp8 paged KV writes, against ``repro`` on the same
numpy inputs.  The JAX side runs eagerly (``repro.kvcache`` writes and
``quantize_tree`` are not jitted), so pools, scales and quantized weights
are held bit for bit; logits to 1e-4 in float32 (int8 W8A8: 1e-2, see
its test) and 3e-2 in bfloat16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kvcache as jkv  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import AttentionConfig as JAttn  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.quant.qops import quantize_tree as j_quantize_tree  # noqa: E402
from repro_torch import kvcache as tkv  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import AttentionConfig as TAttn  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as tops  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.quant import qops  # noqa: E402

torch.manual_seed(0)

QUANTS = ["int8", "fp8", "int4"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _bits(x) -> np.ndarray:
    """Raw bits of an array or tensor, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.view({1: torch.uint8, 2: torch.int16,
                    4: torch.int32}[x.element_size()]).numpy()
    a = np.asarray(x)
    return a.view(f"u{a.itemsize}")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _jax_pair(dtype="bfloat16", scan_layers=True, **kw):
    jcfg = j_smoke("qwen2-1.5b").with_(dtype=dtype, scan_layers=scan_layers,
                                      **kw)
    tcfg = t_smoke("qwen2-1.5b").with_(dtype=dtype, **kw)
    return jcfg, JLM(jcfg).init(jax.random.PRNGKey(0)), tcfg


# ---------------------------------------------------------------------------
# weights


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("scan_layers", [True, False])
def test_quantize_tree_matches_jax_bit_for_bit(quant, scan_layers):
    """The bridge of JAX's quantized tree == the port's ``quantize_tree``
    of the bridged bf16 tree, leaf for leaf and bit for bit; embedding,
    norms and biases stay as they were."""
    jcfg, jp, tcfg = _jax_pair(scan_layers=scan_layers)
    jq = params_from_numpy(jax.tree.map(
        np.asarray, j_quantize_tree(jp, quant=quant)), tcfg, device="cpu")
    tq = qops.quantize_tree(params_from_numpy(jax.tree.map(np.asarray, jp),
                                              tcfg, device="cpu"),
                            quant=quant)
    jl, tl = dict(_leaves(jq)), dict(_leaves(tq))
    assert sorted(jl) == sorted(tl)
    n_q = 0
    for path, t in tl.items():
        j = jl[path]
        assert t.dtype == j.dtype and t.shape == j.shape, path
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=path)
        n_q += path.endswith("/qw")
    assert n_q == 7 * tcfg.num_layers           # wq wk wv wo gate up down
    assert "/embed/w" in tl and not any("embed/qw" in p for p in tl)
    want = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
            "int4": torch.uint8}[quant]
    assert tq["layers"][0]["blk0"]["mlp"]["down"]["qw"].dtype == want
    assert qops.memory_bytes(tq) < qops.memory_bytes(
        params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu"))


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_matmul_splits_at_128_rows(quant, monkeypatch):
    """M = the product of x's leading dims: 128 rows take the decode
    kernel's plain version, 129 the tiled one (fp8: plain torch)."""
    rng = np.random.default_rng(0)
    p = qops.quantize_linear({"w": torch.from_numpy(
        rng.standard_normal((64, 48)).astype(np.float32))}, quant=quant)
    calls = []
    for name in ("w8a8_decode_ref", "int8_matmul_ref", "fp8_decode_ref"):
        fn = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    decode = "w8a8_decode_ref" if quant == "int8" else "fp8_decode_ref"
    for rows, want in (((2, 64), [decode]),
                       ((129,), [] if quant == "fp8"
                        else ["int8_matmul_ref"])):
        calls.clear()
        x = torch.from_numpy(rng.standard_normal(rows + (64,)).astype(
            np.float32))
        y = qops.quantized_matmul(x, p, impl="fused")
        assert tuple(y.shape) == rows + (48,)
        assert calls == want, (rows, calls)
    calls.clear()                                # "ref": the oracles only
    qops.quantized_matmul(torch.zeros((8, 64)), p, impl="ref")
    assert calls == ([] if quant == "fp8" else ["int8_matmul_ref"])
    with pytest.raises(ValueError, match="quant impl"):
        qops.quantized_matmul(torch.zeros((8, 64)), p, impl="pallas")


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [(2, 16), (2, 72)])
def test_lm_logits_with_quantized_weights_match_jax(quant, dtype, rows):
    """Every position's logits with quantized weights (fused matmuls) at
    M = 32 (decode kernels, bias folded) and M = 144 (tiled int8).

    int8 in float32 is held to 1e-2, not 1e-4: W8A8 rounds every
    activation to one of 255 steps, so a one-ulp difference upstream (the
    two frameworks sum rmsnorm's squares in another order) that crosses a
    rounding boundary moves that value by a whole step.  Measured on this
    model: nudging the port's own embedding by one ulp moves its int8
    logits by up to 5.1e-3 (bf16 weights: 1e-6), and port vs JAX differ
    by at most 5.8e-3, with the median element within 1e-5.  The kernels
    themselves are bit-equal to JAX's (test_torch_int8_matmul.py)."""
    jcfg, jp, tcfg = _jax_pair(dtype, quant=quant,
                               quant_matmul_impl="fused")
    jq = j_quantize_tree(jp, quant=quant)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, rows)
    j = np.asarray(JLM(jcfg).logits(jq, jnp.asarray(toks)), np.float32)
    t = TLM(tcfg, device="cpu").logits(tq, torch.from_numpy(toks)).numpy()
    tol = 1e-2 if (quant, dtype) == ("int8", "float32") else TOL[dtype]
    np.testing.assert_allclose(t, j, atol=tol, rtol=tol)
    assert np.median(np.abs(t - j)) < TOL[dtype] / 10


# ---------------------------------------------------------------------------
# KV writes


def _write_sequence(store: str):
    """The same paged writes on both sides, compared after every one:
    an admission scatter with a padding row and an empty row, decode
    writes whose amax grows (requantizing live pages) across a page
    boundary (an offset-0 reset), a second admission into reused pages,
    a page-aligned chunk scatter (``starts``), more decode writes."""
    rng = np.random.default_rng(7)
    n_slots, kvh, d, pps, page = 3, 2, 16, 3, 4
    n_pages = n_slots * pps + 1
    j = jkv.alloc_paged(jkv.CacheSpec(layout="paged", dtype=store,
                                      page_size=page),
                        JAttn(num_heads=4, num_kv_heads=kvh, head_dim=d),
                        n_slots, n_pages, pps)
    t = tkv.alloc_paged(tkv.CacheSpec(layout="paged", dtype=store,
                                      page_size=page),
                        TAttn(num_heads=4, num_kv_heads=kvh, head_dim=d),
                        n_slots, n_pages, pps)
    bt = (rng.permutation(n_pages - 1) + 1).reshape(n_slots, pps)
    j["block_table"] = jnp.asarray(bt, jnp.int32)
    t["block_table"].copy_(torch.from_numpy(bt.astype(np.int32)))
    events = {"grew": 0, "reset": 0}

    def rows(*shape, scale=1.0):
        a = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
        return a, torch.from_numpy(np.asarray(a, np.float32)).bfloat16()

    def check(tag):
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            # page 0 is the null page: duplicate writes land there in an
            # order neither side defines, and no read reaches it
            np.testing.assert_array_equal(_bits(t[name])[1:],
                                          _bits(j[name])[1:],
                                          err_msg=f"{tag}: {name}")

    def scatter(slots, lens, scale, starts=None):
        nonlocal j
        (jk, tk), (jv, tv) = (rows(len(slots), 8, kvh, d, scale=scale)
                              for _ in range(2))
        sl, ln = np.asarray(slots, np.int32), np.asarray(lens, np.int32)
        st = None if starts is None else np.asarray(starts, np.int32)
        j = jkv.paged_scatter_prefill(
            j, jnp.asarray(sl), jnp.asarray(ln), jk, jv,
            None if st is None else jnp.asarray(st))
        tkv.paged_scatter_prefill(
            t, torch.from_numpy(sl), torch.from_numpy(ln), tk, tv,
            None if st is None else torch.from_numpy(st))
        check(f"scatter {slots} {lens} {starts}")

    def decode(pos, scale):
        nonlocal j
        (jk, tk), (jv, tv) = (rows(n_slots, kvh, d, scale=scale)
                              for _ in range(2))
        pos = np.asarray(pos, np.int32)
        before = t["k_scales"].clone()
        j = jkv.paged_write_batch(j, jnp.asarray(pos), jk, jv)
        tkv.paged_write_batch(t, torch.from_numpy(pos), tk, tv)
        pidx = torch.from_numpy(bt[np.arange(n_slots),
                                   np.minimum(pos // page, pps - 1)])
        off = torch.from_numpy(pos % page)
        grew = (t["k_scales"][pidx] > before[pidx]) & (before[pidx] > 0)
        events["grew"] += int((grew & (off != 0)[:, None]).any())
        events["reset"] += int((off == 0).any())
        check(f"decode {pos.tolist()}")

    scatter([0, 2, 1], [6, 0, 3], 1.0)            # slot 2: an empty row
    for step in range(6):                         # growing amax
        decode([6 + step, step, 3 + step], 1.0 + 0.5 * step)
    scatter([0], [5], 0.5)                        # reused pages, shorter
    scatter([1], [4], 2.0, starts=[4])            # a page-aligned chunk
    for step in range(4):
        decode([5 + step, 6 + step, 8 + step], 3.0 + step)
    return events


@pytest.mark.parametrize("store", ["int8", "fp8"])
def test_quantized_kv_writes_bit_equal(store):
    events = _write_sequence(store)
    assert events["grew"] > 0 and events["reset"] > 0


@pytest.mark.parametrize("store", ["int8", "fp8"])
def test_kv_quant_primitives_bit_equal(store):
    """quantize / quantize_with_scale / dequantize / requantize (factor
    <= 1, a zero scale, and a factor > 1 that overflows, as a rescaled
    reused page can) against ``repro.kvcache.quant``."""
    from repro.kvcache import quant as jq
    from repro_torch.kvcache import quant as tq
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 2, 16)) * 3).astype(np.float32)
    x[0] = 0.0                                  # a zero vector: scale 0
    jdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[store]
    tdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[store]
    jqv, jsc = jq.quantize(jnp.asarray(x), jdt)
    tqv, tsc = tq.quantize(torch.from_numpy(x), tdt)
    np.testing.assert_array_equal(_bits(tqv), _bits(jqv))
    np.testing.assert_array_equal(_bits(tsc), _bits(jsc))
    big = np.abs(rng.standard_normal((6, 2)) * 5).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(tq.quantize_with_scale(torch.from_numpy(x),
                                     torch.from_numpy(big), tdt)),
        _bits(jq.quantize_with_scale(jnp.asarray(x), jnp.asarray(big),
                                     jdt)))
    np.testing.assert_array_equal(
        tq.dequantize(tqv, tsc).numpy(),
        np.asarray(jq.dequantize(jqv, jsc)))
    for new in (np.asarray(jsc) * 2, np.zeros_like(big),
                np.asarray(jsc) / 9):
        np.testing.assert_array_equal(
            _bits(tq.requantize(tqv, tsc, torch.from_numpy(new))),
            _bits(jq.requantize(jqv, jsc, jnp.asarray(new))))


def test_pool_bytes_and_refused_contiguous_cache():
    a = TAttn(num_heads=4, num_kv_heads=2, head_dim=16)
    bf = tkv.alloc_paged(tkv.CacheSpec(layout="paged"), a, 2, 5, 2)
    i8 = tkv.alloc_paged(tkv.CacheSpec(layout="paged", dtype="int8"), a, 2,
                         5, 2)
    page_bytes = 5 * 256 * 2 * 16
    assert tkv.pool_bytes(bf) == 2 * 2 * page_bytes
    assert tkv.pool_bytes(i8) == 2 * page_bytes + 2 * 5 * 2 * 4
    # a contiguous fp8 cache counts its values and per-position scales
    c8 = tkv.alloc_contiguous(tkv.CacheSpec(dtype="fp8"), a, 2, 8)
    assert tkv.pool_bytes(c8) == 2 * (2 * 8 * 2 * 16) + 2 * (2 * 8 * 2 * 4)

"""Port parity: the plain PyTorch prefix-extend attention (the version the
wrapper takes for CPU tensors, and the one the CUDA kernel is held against
on the card) vs the JAX Pallas kernel (interpret mode) and its jnp oracle,
on the same numpy inputs.  Mirrors the sweep of
``test_chunk_prefill.py::test_prefix_extend_kernel_matches_ref``
({bf16, int8, fp8} pools x full / gqa / mqa heads x W in {1, 5, 32}),
adds bf16 queries, holds W = 1 against the port's paged decode attention,
and holds the model layer (``attention_prefill_paged``), ``LM.
prefill_paged`` and the ``starts=`` page scatter against JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.paged_attention import (  # noqa: E402
    paged_prefix_extend_pallas)
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_prefix_extend_ref as jax_ref)
from repro.kvcache import CacheSpec as JSpec  # noqa: E402
from repro.kvcache.quant import _qmax_of  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.paged_attention import ops as torch_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref, paged_prefix_extend_ref)

torch.manual_seed(0)

#: fp32 outputs: both sides compute in fp32 from identical inputs and
#: differ only in summation order (online vs two-pass softmax), ~1e-6
F32_TOL = 1e-5
#: bf16 outputs: one fp32 result rounded to bf16 on each side; a 1e-6
#: difference before rounding can move an element by one bf16 ulp
#: (2^-8 relative, about 4e-3), so 1e-2 holds it with margin
BF16_TOL = 1e-2


def _to_torch(x):
    """A JAX array as a torch tensor with the same bits (bf16 and fp8
    cross through integer views)."""
    a = np.array(x)
    if a.dtype.name.startswith("float8"):
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return tensor_from_numpy(a)


def _pool(rng, n, page, kh, d, dtype):
    """Random page pool in ``dtype`` with per-page-per-kv-head scales (as
    ``test_chunk_prefill.py`` makes them)."""
    raw = rng.normal(size=(n, page, kh, d)).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(raw, jnp.bfloat16), None
    store = JSpec(dtype=dtype).store_dtype
    sc = np.abs(raw).max(axis=(1, 3)) / _qmax_of(store) + 1e-9
    q = raw / sc[:, None, :, None]
    if dtype == "int8":
        q = np.clip(np.round(q), -127, 127)
    return jnp.asarray(q, store), jnp.asarray(sc, jnp.float32)


def _inputs(dtype, h, kvh, w, q_dtype=jnp.float32, seed=0):
    """The reference sweep's rows: a pure-chunk start (prefix 0), a
    page-aligned prefix, a partial last page, a full-horizon prefix with
    width 0, and a completely empty slot."""
    rng = np.random.default_rng(seed)
    s_n, d, page, p_n = 5, 16, 8, 4
    n = 1 + s_n * p_n
    q = jnp.asarray(rng.normal(size=(s_n, w, h, d)), q_dtype)
    kp, ks = _pool(rng, n, page, kvh, d, dtype)
    vp, vs = _pool(rng, n, page, kvh, d, dtype)
    bt = jnp.asarray(rng.permutation(np.arange(1, n)).reshape(s_n, p_n),
                     jnp.int32)
    prefix = jnp.asarray([0, 16, 13, p_n * page, 0], jnp.int32)
    widths = jnp.asarray([w, max(w // 2, 1), w, 0, 0], jnp.int32)
    ck = jnp.asarray(rng.normal(size=(s_n, w, kvh, d)), jnp.float32)
    cv = jnp.asarray(rng.normal(size=(s_n, w, kvh, d)), jnp.float32)
    return q, kp, vp, bt, prefix, ck, cv, widths, ks, vs


def _torch_args(args):
    return [None if a is None else _to_torch(a) for a in args]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 1)])  # full/gqa/mqa
@pytest.mark.parametrize("w", [1, 5, 32])
def test_plain_prefix_extend_matches_jax(dtype, h, kvh, w):
    """The port's plain version (through the op, on CPU tensors) against
    the Pallas kernel in interpret mode and the jnp oracle, fp32 q."""
    args = _inputs(dtype, h, kvh, w)
    out = torch_ops.paged_prefix_extend_attention(*_torch_args(args))
    ker = paged_prefix_extend_pallas(*args, interpret=True)
    ref = jax_ref(*args)
    _close(out, ker, F32_TOL)
    _close(out, ref, F32_TOL)
    # the empty slot (no prefix, no chunk) gives exact zeros
    assert float(out[4].abs().max()) == 0.0
    assert torch_ops.extend_launches == 0


@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 1)])
def test_plain_prefix_extend_bf16_queries(dtype, h, kvh):
    """bf16 q gives a bf16 output on both sides (the serving dtype)."""
    args = _inputs(dtype, h, kvh, 5, q_dtype=jnp.bfloat16, seed=1)
    out = paged_prefix_extend_ref(*_torch_args(args))
    assert out.dtype == torch.bfloat16
    _close(out.float(), jax_ref(*args), BF16_TOL)
    _close(out.float(), paged_prefix_extend_pallas(*args, interpret=True),
           BF16_TOL)


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 1)])
def test_width_one_equals_paged_decode(h, kvh):
    """One query per slot is a decode step: extend attention over the
    prefix plus one fresh key equals the port's paged decode attention
    over the pages with that key written at position prefix_lens[s]."""
    q, kp, vp, bt, prefix, ck, cv, _, _, _ = _torch_args(
        _inputs("bf16", h, kvh, 1, seed=2))
    kp, vp = kp.float(), vp.float()
    prefix = torch.tensor([0, 16, 13, 31, 7], dtype=torch.int32)
    widths = torch.ones(5, dtype=torch.int32)
    ext = paged_prefix_extend_ref(q, kp, vp, bt, prefix, ck, cv, widths)
    page = kp.shape[1]
    kw, vw = kp.clone(), vp.clone()
    for s, n in enumerate(prefix.tolist()):
        pg = int(bt[s, n // page])
        kw[pg, n % page] = ck[s, 0]
        vw[pg, n % page] = cv[s, 0]
    dec = paged_attention_ref(q[:, 0], kw, vw, bt, prefix + 1)
    _close(ext[:, 0], dec, F32_TOL)


class _OnOtherDevice:
    """Stands in for a tensor on a device that is neither the CPU, nor
    CUDA, nor meta (the wrapper reads its device first)."""
    device = torch.device("xpu")


def test_extend_wrapper_dispatches_on_device_only():
    """A tensor that is neither on the CPU, nor on a CUDA device, nor on
    meta is refused; the CPU path is the plain version, bit for bit, and
    meta tensors take it too (a dry-run trace's shapes)."""
    args = _torch_args(_inputs("int8", 4, 2, 5))
    want = paged_prefix_extend_ref(*args)
    assert torch.equal(torch_ops.paged_prefix_extend_attention(*args), want)
    meta = [a.to("meta") if a is not None else None for a in args]
    out = torch_ops.paged_prefix_extend_attention(*meta)
    assert out.is_meta and out.shape == want.shape
    with pytest.raises(ValueError, match="unsupported device"):
        torch_ops.paged_prefix_extend_attention(_OnOtherDevice(), *args[1:])
    assert torch_ops.extend_launches == torch_ops.extend_tc_launches == 0


# ---------------------------------------------------------------------------
# kvcache: the starts= scatter; allocator growth and references


def test_scatter_prefill_starts_bit_equal_to_jax():
    """Chunks written at page-aligned starts land on the same pages, bit
    for bit, as the reference's scatter; padding tokens and a length-0
    pad row go to the null page (not compared: its duplicate writes have
    no defined winner on either side)."""
    from repro import kvcache as jkv
    from repro.configs.base import AttentionConfig as JAttn
    from repro_torch import kvcache as tkv
    from repro_torch.configs.base import AttentionConfig as TAttn
    rng = np.random.default_rng(4)
    b, page, pps, c = 3, 8, 6, 16
    n = 1 + b * pps
    kw = dict(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16)
    jc = jkv.alloc_paged(JSpec(layout="paged", page_size=page), JAttn(**kw),
                         b, n, pps)
    tc = tkv.alloc_paged(tkv.CacheSpec(layout="paged", page_size=page),
                         TAttn(**kw), b, n, pps)
    table = rng.permutation(np.arange(1, n)).reshape(b, pps).astype(np.int32)
    jc["block_table"] = jnp.asarray(table)
    tc["block_table"] = torch.from_numpy(table.copy())
    for starts, lengths in (([0, 8, 16], [16, 16, 5]),
                            ([16, 24, 0], [9, 16, 0])):
        k = rng.normal(size=(b, c, 2, 16)).astype(np.float32)
        v = rng.normal(size=(b, c, 2, 16)).astype(np.float32)
        slots = np.asarray([0, 1, 2], np.int32)
        jc = jkv.paged_scatter_prefill(jc, jnp.asarray(slots),
                                       jnp.asarray(lengths, jnp.int32),
                                       jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(starts, jnp.int32))
        tkv.paged_scatter_prefill(tc, torch.from_numpy(slots),
                                  torch.tensor(lengths, dtype=torch.int32),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  torch.tensor(starts, dtype=torch.int32))
    for key in ("k_pages", "v_pages"):
        a = np.asarray(jc[key].astype(jnp.float32))[1:]
        t = tc[key].float().numpy()[1:]
        np.testing.assert_array_equal(t, a)


def test_allocator_extend_and_ref_match_jax():
    """The same assign / extend / ref / unref / release sequence leaves
    the port's allocator in the reference's state: free list, block
    table and reference counts; the same calls fail on both."""
    from repro.serve.paged import OutOfPagesError as JOOP
    from repro.serve.paged import PageAllocator as JAlloc
    from repro_torch.serve.paged import OutOfPagesError as TOOP
    from repro_torch.serve.paged import PageAllocator as TAlloc
    ja, ta = JAlloc(9, 4, 2), TAlloc(9, 4, 2)

    def both(name, *args):
        outs = []
        for al, err in ((ja, JOOP), (ta, TOOP)):
            try:
                outs.append(getattr(al, name)(*args))
            except (err, ValueError) as e:
                outs.append(type(e).__name__)
        assert outs[0] == outs[1], (name, args, outs)

    both("alloc", 0, 1)
    both("extend", 0, 2)
    both("assign", 1, ja.owned(0)[:2], 1)
    both("ref", ja.owned(0)[0])
    both("extend", 1, 2)              # 4 pages > 3 free -> refused
    both("extend", 1, 5)              # past the per-slot maximum
    both("extend", 1, 1)
    both("release", 0)
    both("unref", ja.owned(1)[0])
    both("release", 1)
    both("ref", 3)                    # freed page: refused on both
    both("extend", 0, 1)              # slot owns nothing
    assert ja.free == ta.free
    np.testing.assert_array_equal(ja.table, ta.table)
    np.testing.assert_array_equal(ja.refs, ta.refs)


# ---------------------------------------------------------------------------
# model layer and LM.prefill_paged


def _layer_setup():
    """The reference's ``_prefill_paged_setup`` (bf16 pools, a page-aligned
    prefix committed through the real write path, one ragged chunk), built
    once from numpy for both sides."""
    from repro import kvcache as jkv
    from repro.configs.base import AttentionConfig as JAttn
    from repro.models.attention import init_attention
    from repro_torch import kvcache as tkv
    from repro_torch.configs.base import AttentionConfig as TAttn
    rng = np.random.default_rng(3)
    akw = dict(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
               rope_theta=10_000.0, qkv_bias=True)
    ja, ta = JAttn(**akw), TAttn(**akw)
    jp = init_attention(jax.random.PRNGKey(0), 32, ja, jnp.float32)
    tp = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jp)
    b, page, pps = 2, 8, 8
    n = 1 + b * pps
    table = np.arange(1, n).reshape(b, pps).astype(np.int32)
    jc = jkv.alloc_paged(JSpec(layout="paged", page_size=page), ja, b, n, pps)
    jc["block_table"] = jnp.asarray(table)
    tc = tkv.alloc_paged(tkv.CacheSpec(layout="paged", page_size=page), ta,
                         b, n, pps)
    tc["block_table"] = torch.from_numpy(table.copy())
    starts = np.asarray([16, 8], np.int32)
    t = int(starts.max())
    k_hist = rng.normal(size=(b, t, 2, 16)).astype(np.float32)
    v_hist = rng.normal(size=(b, t, 2, 16)).astype(np.float32)
    jc = jkv.paged_scatter_prefill(jc, jnp.arange(b, dtype=jnp.int32),
                                   jnp.asarray(starts), jnp.asarray(k_hist),
                                   jnp.asarray(v_hist))
    tkv.paged_scatter_prefill(tc, torch.arange(b), torch.from_numpy(starts),
                              torch.from_numpy(k_hist),
                              torch.from_numpy(v_hist))
    x = rng.normal(size=(b, 8, 32)).astype(np.float32)
    lengths = np.asarray([8, 5], np.int32)            # one ragged chunk
    jspos = (jnp.arange(b, dtype=jnp.int32), jnp.asarray(starts),
             jnp.asarray(lengths))
    tspos = (torch.arange(b), torch.from_numpy(starts),
             torch.from_numpy(lengths))
    return (jp, jnp.asarray(x), ja, jc, jspos), (tp, torch.from_numpy(x), ta,
                                                 tc, tspos)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_attention_prefill_paged_matches_jax(use_kernel):
    """The model layer in float32 against the reference's, with its
    Pallas kernel (interpret) and its eager oracle: same output to 1e-4
    (fp32 projections in another order), same pages bit for bit."""
    from repro.models.attention import attention_prefill_paged as jfn
    from repro_torch.models.attention import attention_prefill_paged as tfn
    (jp, jx, ja, jc, jspos), (tp, tx, ta, tc, tspos) = _layer_setup()
    jy, jc = jfn(jp, jx, ja, jc, jspos, use_kernel=use_kernel)
    ty, tc = tfn(tp, tx, ta, tc, tspos)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    for key in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(
            tc[key].float().numpy()[1:],
            np.asarray(jc[key].astype(jnp.float32))[1:])


def test_attention_prefill_paged_page_narrowing_is_exact():
    """Narrowing the block table to the prefix's page span (the
    scheduler's ``max_pages``) gives the same output.  The plain version
    sums over the masked columns too, so only the summation order may
    differ (fp32 tolerance); the kernel never reads them."""
    from repro_torch.models.attention import attention_prefill_paged as tfn
    _, (tp, tx, ta, tc, tspos) = _layer_setup()
    tc2 = {k: v.clone() for k, v in tc.items()}
    full, _ = tfn(tp, tx, ta, tc, tspos)
    narrow, _ = tfn(tp, tx, ta, tc2, tspos + (2,))
    _close(narrow, full, F32_TOL)


def _lm_pair():
    from repro.configs import get_smoke_config as j_smoke
    from repro.models.model import LM as JLM
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.models.model import LM as TLM
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32")
    tcfg = t_smoke("qwen2-1.5b").with_(dtype="float32")
    jlm = JLM(jcfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    tlm = TLM(tcfg, device="cpu")
    tp = tlm.prepare(params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu"))
    return (jlm, jp), (tlm, tp)


@pytest.mark.parametrize("max_pages", [None, 4])
def test_lm_prefill_paged_logits_match_jax(max_pages):
    """``LM.prefill_paged`` in float32: a fresh chunk at start 0, then a
    continuation chunk over it and a ragged one over a second slot, with
    a length-0 pad row, give the reference's logits to 1e-4 (and the pad
    row takes its clamped position 0 on both sides)."""
    (jlm, jp), (tlm, tp) = _lm_pair()
    page, pps, n_slots = 8, 8, 2
    n = 1 + n_slots * pps
    table = np.arange(1, n).reshape(n_slots, pps).astype(np.int32)
    jc = jlm.init_paged_cache(n_slots, n, pps, page_size=page)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(jnp.asarray(table), x.shape)
                      if x.dtype == jnp.int32 else x, jc)
    tc = tlm.init_paged_cache(n_slots, n, pps, page_size=page)
    tc[0]["blk0"]["kv"]["block_table"].copy_(torch.from_numpy(table))
    rng = np.random.default_rng(5)
    vocab = jlm.cfg.vocab_size
    chunks = [  # (slots, starts, lengths, tokens (B, 16))
        ([0, 1], [0, 0], [16, 16], rng.integers(0, vocab, (2, 16))),
        ([0, 1, 0, 0], [16, 16, 0, 0], [16, 7, 0, 0],
         rng.integers(0, vocab, (4, 16))),
    ]
    for slots, starts, lengths, toks in chunks:
        mp = max_pages if max(starts) else None
        jl, jc = jlm.prefill_paged(jp, jnp.asarray(toks, jnp.int32), jc,
                                   jnp.asarray(slots, jnp.int32),
                                   jnp.asarray(starts, jnp.int32),
                                   jnp.asarray(lengths, jnp.int32),
                                   max_pages=mp)
        tl, tc = tlm.prefill_paged(tp, torch.from_numpy(toks), tc,
                                   torch.tensor(slots),
                                   torch.tensor(starts, dtype=torch.int32),
                                   torch.tensor(lengths, dtype=torch.int32),
                                   max_pages=mp)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# The CUDA kernel's tensor-core arithmetic for bf16 q and chunk, on the CPU

#: chip_smoke.py's element limit for bf16 outputs: |out - ref| <= ATOL x
#: rms(V) + RTOL x |ref| (V dequantized, the chunk's V included)
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-3
LOG2E = 1.4426950408889634


def _tile_step_extend(q, kp, vp, bt, prefix, ck, cv, widths, ks, vs):
    """The tensor-core tile step of ``csrc/paged_prefix_extend.cu`` in
    plain torch: for each (slot, kv head), 64-row tiles of the W·G row
    space; 64-key tiles in order, the prefix's (read through the block
    table, keys < L) then the chunk's up to the tile's largest w (fully
    masked tiles never visited); stored int8 / e4m3 values widened to
    bf16 exactly; scores q.k x (scale x log2 e x k_s of the key's page),
    running m and l in fp32; p's columns multiplied by v_s of their page,
    then fed to the second product as two bf16 terms."""
    s_n, w_n, h, d = q.shape
    page, kh = kp.shape[1], kp.shape[2]
    g = h // kh
    scale = LOG2E / d ** 0.5
    rows_n = w_n * g
    out = torch.zeros(s_n, w_n, h, d)
    for s in range(s_n):
        big_l = min(int(prefix[s]), bt.shape[1] * page)
        wid = min(int(widths[s]), w_n)
        for k in range(kh):
            q4 = q[s, :, k * g:(k + 1) * g].float().reshape(rows_n, d)
            for r0 in range(0, rows_n, 64):
                rr = torch.arange(r0, min(rows_n, r0 + 64))
                w_of_row = (rr // g)[:, None]
                j_end = min(wid, min(w_n - 1, (r0 + 63) // g) + 1)
                tiles = [("prefix", k0) for k0 in range(0, big_l, 64)]
                tiles += [("chunk", k0) for k0 in range(0, j_end, 64)]
                m = torch.full((len(rr), 1), -1e30)
                l = torch.zeros_like(m)
                acc = torch.zeros(len(rr), d)
                for kind, k0 in tiles:
                    if kind == "prefix":
                        kj = torch.arange(k0, min(big_l, k0 + 64))
                        pages = bt[s, kj // page].long()
                        kt = kp[pages, kj % page, k].float()
                        vt = vp[pages, kj % page, k].float()
                        ksc = scale * (ks[pages, k] if ks is not None
                                       else torch.ones(len(kj)))
                        vsc = (vs[pages, k] if vs is not None
                               else torch.ones(len(kj)))
                        ok = torch.ones(len(rr), len(kj), dtype=torch.bool)
                    else:
                        kj = torch.arange(k0, min(j_end, k0 + 64))
                        kt, vt = ck[s, kj, k].float(), cv[s, kj, k].float()
                        ksc = torch.full((len(kj),), scale)
                        vsc = torch.ones(len(kj))
                        ok = (kj[None, :] <= w_of_row) & (kj[None, :] < wid)
                    sc = (q4[rr] @ kt.T) * ksc[None, :]
                    sc = torch.where(ok, sc, torch.tensor(float("-inf")))
                    m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                    p = torch.exp2(sc - m_new)
                    corr = torch.exp2(m - m_new)
                    l = l * corr + p.sum(-1, keepdim=True)
                    pv = p * vsc[None, :]
                    hi = pv.bfloat16().float()
                    lo = (pv - hi).bfloat16().float()
                    acc = acc * corr + hi @ vt + lo @ vt
                    m = m_new
                o = acc / l.clamp(min=1e-30)
                out[s, (rr // g), k * g + rr % g] = o
    return out.to(q.dtype)


def _tc_inputs(pool, page, w, h, kvh, seed):
    """bf16 q and chunk over ``pool`` pools of ``page``-token pages, D 64:
    a chunk with no prefix, a prefix with a partial last page, a full
    horizon with width 0, and an empty slot (width 0, no prefix)."""
    rng = np.random.default_rng(seed)
    s_n, d, p_n = 4, 64, max(2, 160 // page)
    n = 1 + s_n * p_n
    q = jnp.asarray(rng.normal(size=(s_n, w, h, d)), jnp.bfloat16)
    kp, ks = _pool(rng, n, page, kvh, d, pool)
    vp, vs = _pool(rng, n, page, kvh, d, pool)
    bt = jnp.asarray(rng.permutation(np.arange(1, n)).reshape(s_n, p_n),
                     jnp.int32)
    prefix = jnp.asarray([0, p_n * page - page // 2 - 3, p_n * page, 0],
                         jnp.int32)
    widths = jnp.asarray([w, max(w // 2, 1), 0, 0], jnp.int32)
    ck = jnp.asarray(rng.normal(size=(s_n, w, kvh, d)), jnp.bfloat16)
    cv = jnp.asarray(rng.normal(size=(s_n, w, kvh, d)), jnp.bfloat16)
    return q, kp, vp, bt, prefix, ck, cv, widths, ks, vs


def _worst_share(out, ref, v_rms):
    o = torch.as_tensor(np.asarray(out, np.float32))
    r = torch.as_tensor(np.asarray(ref, np.float32))
    return float(((o - r).abs() / (BF16_ATOL * v_rms
                                   + BF16_RTOL * r.abs())).max())


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("page", [16, 256])
@pytest.mark.parametrize("w", [1, 5, 32])
def test_tensor_core_rounding_within_chip_limit(pool, page, w):
    """The kernel's bf16 plan against the Pallas kernel in interpret mode
    and the port's plain version, within the element limit chip_smoke.py
    holds the kernel to on the card.  Pages of 16 make a 64-key tile cross
    pages of different scales; the row with no prefix and no chunk gives
    zeros."""
    args = _tc_inputs(pool, page, w, 6, 2, seed=30 + w)
    t = _torch_args(args)
    got = _tile_step_extend(*t)
    assert got.dtype == torch.bfloat16 and got.shape == t[0].shape
    _, _, vp, _, _, _, cv, _, _, vs = t
    v = vp.float() if vs is None else vp.float() * vs[:, None, :, None]
    v_rms = max(float(v.pow(2).mean().sqrt()),
                float(cv.float().pow(2).mean().sqrt()))
    pallas = paged_prefix_extend_pallas(*args, interpret=True)
    plain = paged_prefix_extend_ref(*t)
    assert _worst_share(got.float(), pallas, v_rms) <= 1.0
    assert _worst_share(got.float(), plain.float(), v_rms) <= 1.0
    assert float(got[3].float().abs().max()) == 0.0

"""Port parity: speculative decoding (``repro_torch.spec``) against the
reference's ``repro.spec`` on the same numpy inputs, mirroring
``test_spec.py``.

* The verify attention (the plain prefix extend at W 1-5) against JAX's
  oracle on bf16 / int8 pools and 1 / 2 / 4 kv heads, and W 1 against
  paged decode.
* ``spec_accept``: greedy prefix rule and EOS / budget / ``max_len`` caps
  equal to JAX's on the same logits; sampled rows as a distribution (the
  port cannot draw JAX's threefry stream).
* ``NgramDrafter`` proposals, controller ``k`` choices (the quantized
  n-gram draft-cost rescale included), ``DraftLMDrafter`` proposals and
  ``draft_config_of`` equal to JAX's.
* ``cow`` / ``ensure_exclusive_tail`` / ``rollback_length`` and
  ``commit_spec_cache`` (int8 pools bit-equal, scales included) against
  JAX's.
* ``LM.verify_paged`` and the contiguous ``decode_step`` logits against
  JAX's.
* ``SpecEngine`` greedy float32 streams equal to JAX's ``SpecEngine`` and
  to the port's ``SchedEngine`` on bf16 and int8 pools, with the same
  syncs, stats and counters; self-speculation, the EDF urgency gate,
  sampled runs.
* int8 weights through both arms (an int8 draft LM on the draft arm):
  "fused" equal to "ref" and to JAX's streams.

Smoke-size qwen2 (2 layers, d 64) in float32, as ``test_spec.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import spec as jspec  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_prefix_extend_ref as jax_extend_ref)
from repro.models.model import LM as JLM  # noqa: E402
from repro.quant.qops import quantize_tree as j_quantize_tree  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402
from repro_torch.sched import SchedEngine as TSched  # noqa: E402

torch.manual_seed(0)

#: fp32 attention outputs from identical inputs: summation order only
F32_TOL = 1e-5
#: float32 logits of the smoke model: fp32 projections and attention in
#: another summation order on each side, over 2 layers
LOGIT_TOL = 1e-4


def _to_torch(x):
    return tensor_from_numpy(np.array(x))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# verify attention (the plain prefix extend) at W = k + 1


def _pool(rng, n, page, kh, d, dtype):
    """``test_spec.py``'s verify pools: bf16, or int8 with per-page scales."""
    raw = rng.normal(size=(n, page, kh, d)).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(raw, jnp.bfloat16), None
    sc = np.abs(raw).max(axis=(1, 3)) / 127.0 + 1e-9
    q = np.clip(np.round(raw / sc[:, None, :, None]), -127, 127)
    return jnp.asarray(q, jnp.int8), jnp.asarray(sc, jnp.float32)


def _verify_inputs(dtype, kh, w_n, seed=0):
    """Four slots: a partial last page, an empty slot, a full page and a
    full horizon; widths from w_n down to 0 (width 1 is plain decode)."""
    rng = np.random.default_rng(seed)
    s_n, h, d, page, p_n = 4, 4, 16, 8, 4
    n_pages = 1 + s_n * p_n
    q = jnp.asarray(rng.normal(size=(s_n, w_n, h, d)), jnp.float32)
    kp, ks = _pool(rng, n_pages, page, kh, d, dtype)
    vp, vs = _pool(rng, n_pages, page, kh, d, dtype)
    bt = jnp.asarray(rng.permutation(np.arange(1, n_pages))
                     .reshape(s_n, p_n), jnp.int32)
    lengths = jnp.asarray([13, 0, 24, 32], jnp.int32)
    widths = jnp.asarray([w_n, 0, min(1, w_n), max(w_n - 2, 1)], jnp.int32)
    ck = jnp.asarray(rng.normal(size=(s_n, w_n, kh, d)), jnp.bfloat16)
    cv = jnp.asarray(rng.normal(size=(s_n, w_n, kh, d)), jnp.bfloat16)
    return q, kp, vp, bt, lengths, ck, cv, widths, ks, vs


@pytest.mark.parametrize("w_n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kh", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_verify_attention_matches_jax(dtype, kh, w_n):
    """The port's verify attention (the prefix-extend op's plain version on
    CPU tensors: fp32 q over a bf16 chunk) equals JAX's gather oracle on
    every query row inside its width (F32_TOL); the width-0 slot gives
    exact zeros on both sides."""
    args = _verify_inputs(dtype, kh, w_n)
    out = tops.paged_prefix_extend_attention(
        *[None if a is None else _to_torch(a) for a in args])
    ref = np.asarray(jax_extend_ref(*args))
    widths = np.asarray(args[7])
    for s, wid in enumerate(widths):
        np.testing.assert_allclose(out[s, :wid].numpy(), ref[s, :wid],
                                   atol=F32_TOL, rtol=F32_TOL)
    assert float(out[1].abs().max()) == 0.0
    assert float(np.abs(ref[1]).max()) == 0.0


def test_verify_width1_matches_paged_decode():
    """A width-1 verify (no drafts) scores what paged decode scores after
    writing the token (``test_spec.py``'s check), on the port and against
    the same JAX computation (F32_TOL)."""
    from repro.kernels.paged_attention.ops import (
        paged_attention as j_decode)
    from repro_torch.kernels.paged_attention.ops import paged_attention
    rng = np.random.default_rng(1)
    s_n, h, kh, d, page, p_n = 2, 4, 2, 16, 8, 3
    n_pages = 1 + s_n * p_n
    kp = rng.normal(size=(n_pages, page, kh, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, kh, d)).astype(np.float32)
    kp = np.asarray(jnp.asarray(kp, jnp.bfloat16).astype(jnp.float32))
    vp = np.asarray(jnp.asarray(vp, jnp.bfloat16).astype(jnp.float32))
    bt = np.arange(1, n_pages).reshape(s_n, p_n).astype(np.int32)
    lengths = np.asarray([9, 17], np.int32)
    q = rng.normal(size=(s_n, 1, h, d)).astype(np.float32)
    ck = np.asarray(jnp.asarray(rng.normal(size=(s_n, 1, kh, d)),
                                jnp.bfloat16).astype(jnp.float32))
    cv = np.asarray(jnp.asarray(rng.normal(size=(s_n, 1, kh, d)),
                                jnp.bfloat16).astype(jnp.float32))
    t = [torch.from_numpy(a.copy()) for a in (q, kp, vp, bt, lengths, ck,
                                              cv)]
    ver = tops.paged_prefix_extend_attention(
        t[0], t[1], t[2], t[3], t[4], t[5].bfloat16(), t[6].bfloat16(),
        torch.ones(s_n, dtype=torch.int32))
    kp2, vp2 = kp.copy(), vp.copy()
    pg = bt[np.arange(s_n), lengths // page]
    kp2[pg, lengths % page] = ck[:, 0]
    vp2[pg, lengths % page] = cv[:, 0]
    dec = paged_attention(t[0][:, 0], torch.from_numpy(kp2),
                          torch.from_numpy(vp2), t[3], t[4] + 1)
    jdec = j_decode(jnp.asarray(q[:, 0]), jnp.asarray(kp2),
                    jnp.asarray(vp2), jnp.asarray(bt),
                    jnp.asarray(lengths + 1), use_kernel=False)
    np.testing.assert_allclose(ver[:, 0].numpy(), dec.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec),
                               atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# exact accept / reject


def _both_accept(logits, fed, widths, active, temps, remaining, lengths,
                 eos=-1, max_len=10_000):
    """Greedy ``spec_accept`` on both sides: (y, n_emit, n_match) each."""
    a = [np.asarray(x) for x in (logits, fed, widths, active, temps,
                                 remaining, lengths)]
    jy, jn, jm = jspec.spec_accept(
        jnp.asarray(a[0], jnp.float32), jnp.asarray(a[1], jnp.int32),
        jnp.asarray(a[2], jnp.int32), jnp.asarray(a[3]),
        jnp.asarray(a[4], jnp.float32), jnp.asarray(a[5], jnp.int32),
        jnp.asarray(a[6], jnp.int32), eos, max_len, jax.random.PRNGKey(0))
    ty, tn, tm = tspec.spec_accept(
        torch.as_tensor(a[0], dtype=torch.float32),
        torch.as_tensor(a[1]).long(), torch.as_tensor(a[2], dtype=torch.int32),
        torch.as_tensor(a[3]), torch.as_tensor(a[4], dtype=torch.float32),
        torch.as_tensor(a[5], dtype=torch.int32),
        torch.as_tensor(a[6], dtype=torch.int32), eos, max_len)
    return (ty.numpy(), tn.numpy(), tm.numpy()), (np.asarray(jy),
                                                  np.asarray(jn),
                                                  np.asarray(jm))


def _same(t, j):
    (ty, tn, tm), (jy, jn, jm) = t, j
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tm, jm)
    for s, n in enumerate(tn):
        np.testing.assert_array_equal(ty[s, :n], jy[s, :n])


def _peaked(targets, v=8):
    logits = np.full((1, len(targets), v), -10.0, np.float32)
    for j, t in enumerate(targets):
        logits[0, j, t] = 10.0
    return logits


#: test_spec.py's greedy cases: (fed, width, active, remaining, lengths,
#: eos, max_len) -> (n_match, n_emit, emitted) on targets [3, 5, 2, 7]
ACCEPT_CASES = {
    "mismatch": ([1, 3, 5, 6], 4, True, 100, 0, -1, 10_000, 2, 3,
                 [3, 5, 2]),
    "full": ([1, 3, 5, 2], 4, True, 100, 0, -1, 10_000, 3, 4, [3, 5, 2, 7]),
    "width1": ([1, 3, 5, 2], 1, True, 100, 0, -1, 10_000, 0, 1, [3]),
    "eos": ([1, 3, 5, 2], 4, True, 100, 0, 5, 10_000, 3, 2, [3, 5]),
    "budget": ([1, 3, 5, 2], 4, True, 2, 0, -1, 10_000, 3, 2, [3, 5]),
    "max_len": ([1, 3, 5, 2], 4, True, 100, 7, -1, 10, 3, 2, [3, 5]),
    "inactive": ([1, 3, 5, 2], 4, False, 100, 0, -1, 10_000, 3, 0, []),
}


@pytest.mark.parametrize("case", sorted(ACCEPT_CASES))
def test_spec_accept_greedy_rule_and_caps_match_jax(case):
    """Greedy rows accept drafts up to the first argmax mismatch, then
    emit the target's correction (or the bonus token), capped at the first
    EOS, the budget and ``max_len - 1``: the port's counts and tokens
    equal JAX's exactly."""
    fed, wid, act, rem, ln, eos, max_len, n_match, n_emit, toks = \
        ACCEPT_CASES[case]
    t, j = _both_accept(_peaked([3, 5, 2, 7]), np.asarray([fed]), [wid],
                        [act], [0.0], [rem], [ln], eos=eos, max_len=max_len)
    _same(t, j)
    (ty, tn, tm), _ = t, j
    assert tm[0] == n_match and tn[0] == n_emit
    assert list(ty[0, :n_emit]) == toks


def test_spec_accept_random_batches_match_jax():
    """Random logits with drafts that partly follow the argmax, random
    widths, budgets, lengths near ``max_len`` and an EOS id: every slot's
    counts and emitted tokens equal JAX's."""
    rng = np.random.default_rng(3)
    s_n, w, v = 16, 5, 12
    for trial in range(6):
        logits = rng.normal(size=(s_n, w, v)).astype(np.float32) * 3
        greedy = logits.argmax(-1)
        fed = rng.integers(0, v, (s_n, w))
        follow = rng.random((s_n, w - 1)) < 0.7
        fed[:, 1:] = np.where(follow, greedy[:, :-1], fed[:, 1:])
        widths = rng.integers(1, w + 1, s_n)
        active = rng.random(s_n) < 0.9
        remaining = rng.integers(1, 8, s_n)
        lengths = rng.integers(0, 40, s_n)
        t, j = _both_accept(logits, fed, widths, active, np.zeros(s_n),
                            remaining, lengths, eos=trial, max_len=44)
        _same(t, j)


def test_spec_accept_sampled_rows_deterministic_cases():
    """``test_spec.py``'s sampled cases on the port: a draft of target
    probability ~1 is always accepted; one of ~0 always rejected, and the
    residual sample never re-emits it."""
    v, w = 8, 3
    logits = np.zeros((1, w, v), np.float32)
    logits[0, 0, 4] = 30.0
    logits[0, 1, 6] = -40.0
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        y, n_emit, n_match = tspec.spec_accept(
            torch.from_numpy(logits), torch.tensor([[1, 4, 6]]),
            torch.tensor([3], dtype=torch.int32), torch.tensor([True]),
            torch.tensor([1.0]), torch.tensor([100], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32), -1, 10_000, gen)
        assert int(n_match[0]) == 1 and int(n_emit[0]) == 2
        assert int(y[0, 0]) == 4 and int(y[0, 1]) != 6


def test_spec_accept_sampled_stream_has_the_target_distribution():
    """Exact rejection sampling as a distribution (the reference's
    threefry draws cannot be reproduced): over 20,000 rows with fixed
    drafts the first emitted token follows softmax(logits[0] / T), and
    after an accepted first draft the second follows softmax(logits[1] /
    T).  The first draft is the first position's likeliest token, so
    about 12,800 rows accept it; each empirical frequency within 0.02
    (over 4 sigma at these counts)."""
    rng = np.random.default_rng(4)
    s_n, w, v, temp = 20_000, 3, 5, 0.9
    row = rng.normal(size=(w, v)).astype(np.float32)
    logits = torch.from_numpy(np.broadcast_to(row, (s_n, w, v)).copy())
    p = torch.softmax(torch.from_numpy(row) / temp, dim=-1).numpy()
    d1 = int(p[0].argmax())
    fed = torch.tensor([[0, d1, (d1 + 1) % v]] * s_n)
    gen = torch.Generator().manual_seed(0)
    y, n_emit, _ = tspec.spec_accept(
        logits, fed, torch.full((s_n,), w, dtype=torch.int32),
        torch.ones(s_n, dtype=torch.bool), torch.full((s_n,), temp),
        torch.full((s_n,), 100, dtype=torch.int32),
        torch.zeros(s_n, dtype=torch.int32), -1, 10_000, gen)
    f0 = np.bincount(y[:, 0].numpy(), minlength=v) / s_n
    np.testing.assert_allclose(f0, p[0], atol=0.02)
    hit = (y[:, 0] == d1).numpy()                # first draft accepted
    assert (n_emit.numpy()[hit] >= 2).all()
    f1 = np.bincount(y[hit, 1].numpy(), minlength=v) / hit.sum()
    np.testing.assert_allclose(f1, p[1], atol=0.02)


# ---------------------------------------------------------------------------
# drafters and controller


def test_ngram_proposals_match_jax():
    """``test_spec.py``'s histories plus 200 random repetitive ones: the
    port's proposals equal JAX's, for k 0-6 and n_max 1-3."""
    rng = np.random.default_rng(5)
    hists = [np.array([7, 1, 2, 3, 9, 1, 2, 3], np.int32),
             np.arange(10, dtype=np.int32),
             np.array([4, 5, 6] * 4, np.int32)]
    for _ in range(200):
        pat = rng.integers(0, 6, rng.integers(2, 7))
        h = np.concatenate([np.tile(pat, rng.integers(1, 4)),
                            rng.integers(0, 6, rng.integers(0, 5))])
        hists.append(h.astype(np.int32))
    for n_max in (1, 2, 3):
        jd = jspec.NgramDrafter(k_max=6, n_max=n_max)
        td = tspec.NgramDrafter(k_max=6, n_max=n_max)
        for h in hists:
            for k in (0, 1, 4, 6):
                assert list(td.propose(h, k)) == list(jd.propose(h, k))
    batch = [(0, 0, hists[0], 4), (1, 1, hists[2], 2)]
    t = tspec.NgramDrafter(k_max=4).propose_batch(batch, 3)
    j = jspec.NgramDrafter(k_max=4).propose_batch(batch, 3)
    assert {s: list(v) for s, v in t.items()} == \
        {s: list(v) for s, v in j.items()}


@pytest.mark.parametrize("arm", ["ngram", "draft"])
def test_controller_k_choices_match_jax(arm):
    """The same acceptance history gives the same EMA and the same k at
    every step (``test_spec.py``'s walk to k_max and to 0, then random)."""
    rng = np.random.default_rng(6)
    jc = jspec.AdaptiveDraftController(n_slots=2, k_max=8, arm=arm)
    tc = tspec.AdaptiveDraftController(n_slots=2, k_max=8, arm=arm)
    rounds = [(0, 4, 4)] * 12 + [(0, 8, 0)] * 20 + [
        (int(rng.integers(0, 2)), int(p), int(rng.integers(0, p + 1)))
        for p in rng.integers(0, 9, 60)]
    for slot, prop, acc in rounds:
        for c in (jc, tc):
            c.update(slot, prop, acc)
        assert tc.k_for(slot) == jc.k_for(slot)
        np.testing.assert_array_equal(tc.ema, jc.ema)
    assert tc.stats() == jc.stats()
    tc.reset(0)
    jc.reset(0)
    assert tc.k_for(0) == jc.k_for(0)
    fixed = tspec.AdaptiveDraftController(n_slots=1, k_max=5,
                                          adaptive=False)
    assert fixed.k_for(0) == 5


def test_quantized_ngram_rescale_waits_for_the_cost_model():
    """With quantized target weights the n-gram arm's draft cost is
    divided by the cost model's quantized-decode ratio: at a tier built
    from the reference's peaks the rescaled ``draft_cost`` and every
    ``k_for`` equal JAX's controller's for int8 / fp8 / int4 targets (and
    bf16, which is not rescaled), full width and smoke, bf16 and int8 KV
    at both layouts; the draft-LM arm is never rescaled."""
    from repro.configs import get_config as j_full
    from repro.core.costmodel import TIERS
    from repro.launch.mesh import HW
    from repro_torch.configs import get_config as t_full
    from repro_torch.core.costmodel import HwTier
    jt = TIERS["v5e-1"]
    tier = HwTier(jt.name, jt.chips, jt.mem_cap, jt.power_budget,
                  peak_flops_bf16=HW["peak_flops_bf16"],
                  peak_flops_int8=HW["peak_flops_int8"], hbm_bw=HW["hbm_bw"],
                  link_bw=HW["ici_bw_per_link"], links=HW["ici_links"],
                  tdp_watts=HW["tdp_watts"], idle_watts=HW["idle_watts"])
    rng = np.random.default_rng(8)
    history = [(int(rng.integers(0, 2)), int(p), int(rng.integers(0, p + 1)))
               for p in rng.integers(0, 9, 40)]
    rescaled = 0
    for jget, tget in ((j_full, t_full), (j_smoke, t_smoke)):
        for quant in ("bf16", "int8", "fp8", "int4"):
            for kv in ("bfloat16", "int8"):
                for layout in ("contiguous", "paged"):
                    jc = jget("qwen2-1.5b").with_(
                        quant=quant, kv_cache_dtype=kv,
                        decode_attn_impl="paged_pallas"
                        if layout == "paged" else "eager")
                    tc = tget("qwen2-1.5b").with_(quant=quant,
                                                  kv_cache_dtype=kv)
                    for arm in ("ngram", "draft"):
                        j = jspec.AdaptiveDraftController(2, 8, arm=arm,
                                                          cfg=jc)
                        t = tspec.AdaptiveDraftController(
                            2, 8, arm=arm, cfg=tc, tier=tier, layout=layout)
                        assert t.draft_cost == j.draft_cost
                        rescaled += t.draft_cost != 0.02 and arm == "ngram"
                        for slot, prop, acc in history:
                            t.update(slot, prop, acc)
                            j.update(slot, prop, acc)
                            assert t.k_for(slot) == j.k_for(slot)
    assert rescaled > 0


def test_draft_config_matches_jax():
    """``draft_config_of`` gives the reference's draft config, field by
    field (the reference's ``decode_attn_impl`` has no port field: the
    cache layout picks the attention), at smoke size and at full width
    (qwen2-1.5b's draft: 1 layer, d 384, 3 heads padded to 4 over 2)."""
    from repro.configs import get_config as j_full
    from repro_torch.configs import get_config as t_full
    for jc, tc in ((j_smoke("qwen2-1.5b"), t_smoke("qwen2-1.5b")),
                   (j_full("qwen2-1.5b"), t_full("qwen2-1.5b"))):
        jd, td = jspec.draft_config_of(jc), tspec.draft_config_of(tc)
        for f in dataclasses.fields(td):
            if f.name == "attention":
                for g in dataclasses.fields(td.attention):
                    assert getattr(td.attention, g.name) == \
                        getattr(jd.attention, g.name), g.name
            else:
                assert getattr(td, f.name) == getattr(jd, f.name), f.name
        assert td.attention.heads_padded == jd.attention.heads_padded
    assert (td.num_layers, td.d_model, td.attention.num_heads,
            td.attention.heads_padded, td.attention.num_kv_heads,
            td.attention.head_dim) == (1, 384, 3, 4, 2, 128)


@pytest.fixture(scope="module")
def models():
    """The float32 smoke qwen2 on both sides, one parameter tree."""
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32")
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    tcfg = t_smoke("qwen2-1.5b").with_(dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def test_draft_lm_proposals_match_jax(models):
    """A ``draft_config_of`` draft LM (1 layer, d 32, random weights shared
    through the bridge) proposes JAX's drafts over three rounds of a
    two-slot batch: catch-up on a whole prompt, then on the confirmed
    tokens, with a new request in a reused slot; one host read a round."""
    jcfg, _, tcfg, _ = models
    jdc, tdc = jspec.draft_config_of(jcfg), tspec.draft_config_of(tcfg)
    jdp = JLM(jdc).init(jax.random.PRNGKey(1))
    tdp = params_from_numpy(jax.tree.map(np.asarray, jdp), tdc, device="cpu")
    jd = jspec.DraftLMDrafter(JLM(jdc), jdp, n_slots=2, max_len=64, k_max=4)
    td = tspec.DraftLMDrafter(TLM(tdc, device="cpu"), tdp, n_slots=2,
                              max_len=64, k_max=4)
    rng = np.random.default_rng(7)
    vocab = jcfg.vocab_size
    hists = {0: rng.integers(0, vocab, 9), 1: rng.integers(0, vocab, 5)}
    rids = {0: 0, 1: 1}
    for rnd in range(3):
        batch = [(s, rids[s], hists[s].astype(np.int32), 4 - s)
                 for s in (0, 1)]
        jp, tp = jd.propose_batch(batch, 4), td.propose_batch(batch, 4)
        assert {s: list(v) for s, v in tp.items()} == \
            {s: list(v) for s, v in jp.items()}, rnd
        for s in (0, 1):
            hists[s] = np.concatenate([hists[s], rng.integers(0, vocab, 2)])
        if rnd == 1:                     # a new request in slot 1
            rids[1], hists[1] = 2, rng.integers(0, vocab, 7)
    np.testing.assert_array_equal(td.pos, jd.pos)
    assert td.syncs == jd.syncs == 3


def test_draft_lm_self_speculation_proposes_target_tokens(models):
    """The target drafting for itself proposes its own greedy continuation
    (the port's SchedEngine stream), in one host read."""
    _, _, tcfg, tp = models
    lm = TLM(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, tcfg.vocab_size, (6,)).astype(np.int32)
    eng = TSched(lm, tp, n_slots=1, max_len=64, page_size=8,
                 decode_block=4, prefill_chunk=16, prefix_cache=False)
    rid = eng.submit(prompt, max_new_tokens=5)
    ref = eng.run_to_completion()[rid].out_tokens
    d = tspec.DraftLMDrafter(lm, tp, n_slots=1, max_len=64, k_max=4)
    hist = np.concatenate([prompt, np.asarray(ref[:1], np.int32)])
    drafts = d.propose_batch([(0, rid, hist, 4)], 4)[0]
    assert list(drafts) == ref[1:5]
    assert d.syncs == 1


# ---------------------------------------------------------------------------
# copy-on-write, rollback and the commit


def _cow_case(side):
    """``test_spec.py``'s copy-on-write case on one side: slot 1 shares
    slot 0's second page; the spec span [5, 8) of slot 0 covers it."""
    from repro.serve.paged import PageAllocator as JAlloc
    from repro_torch.serve.paged import PageAllocator as TAlloc
    rng = np.random.default_rng(0)
    page, kh, d = 4, 2, 8
    al = (JAlloc if side == "jax" else TAlloc)(n_pages=8,
                                               max_pages_per_slot=4,
                                               n_slots=2)
    p0 = al.alloc(0, 2)
    al.assign(1, [p0[1]], 1)
    shared = p0[1]            # (p0 is the slot's owned list: cow edits it)
    arrays = {"k_pages": rng.normal(size=(8, page, kh, d)),
              "v_pages": rng.normal(size=(8, page, kh, d)),
              "k_scales": rng.random((8, kh)),
              "v_scales": rng.random((8, kh))}
    if side == "jax":
        node = {k: jnp.asarray(v, jnp.bfloat16 if "pages" in k
                               else jnp.float32) for k, v in arrays.items()}
        node["block_table"] = jnp.asarray(al.table, jnp.int32)
        cache = {"kv": node}
        out = jspec.ensure_exclusive_tail(cache, al, 0, 5, 8, page)
        out_node = out["kv"]
    else:
        node = {k: torch.as_tensor(v, dtype=torch.bfloat16 if "pages" in k
                                   else torch.float32)
                for k, v in arrays.items()}
        node["block_table"] = torch.as_tensor(al.table)
        cache = [{"blk0": {"kv": node}}]
        out = tspec.ensure_exclusive_tail(cache, al, 0, 5, 8, page)
        out_node = out[0]["blk0"]["kv"]
    result = {k: np.asarray(jnp.asarray(np.array(v, np.float32))
                            if side == "jax" else _np(v))
              for k, v in out_node.items() if k != "block_table"}
    again = (jspec if side == "jax" else tspec).ensure_exclusive_tail(
        out, al, 0, 5, 8, page)
    rolled = (jspec if side == "jax" else tspec).rollback_length(
        al, 0, 8, 5, page)
    return dict(shared=shared, table=al.table.copy(), refs=al.refs.copy(),
                free=sorted(al.free), bt=np.asarray(out_node["block_table"]),
                pages=result, arrays=arrays, rolled=rolled,
                again=again is out)


def test_cow_ensure_exclusive_tail_and_rollback_match_jax():
    """The shared page is copy-on-written the same way on both sides: the
    same fresh page, tables, references and free list, the contents and
    scales copied (and the shared page untouched), the device table row
    updated; rollback through the tail returns the same pages; a second
    call is a no-op."""
    j, t = _cow_case("jax"), _cow_case("torch")
    for key in ("table", "refs", "bt"):
        np.testing.assert_array_equal(t[key], j[key])
    assert t["free"] == j["free"] and t["rolled"] == j["rolled"]
    assert t["again"] and j["again"]
    fresh = int(t["table"][0, 1])
    shared = t["shared"]
    assert fresh != shared and t["refs"][shared] == 1 == t["refs"][fresh]
    assert t["rolled"] == [fresh]
    for name, arr in t["pages"].items():
        np.testing.assert_array_equal(arr, j["pages"][name])
        np.testing.assert_array_equal(arr[fresh], arr[shared])


def test_cow_refuses_exclusive_pages_and_rollback_audits_sharing():
    from repro_torch.serve.paged import PageAllocator
    al = PageAllocator(n_pages=6, max_pages_per_slot=3, n_slots=2)
    p0 = al.alloc(0, 2)
    with pytest.raises(ValueError, match="exclusive"):
        al.cow(0, 0)
    with pytest.raises(ValueError, match="no page"):
        al.cow(1, 0)
    al.assign(1, [p0[1]], 0)
    with pytest.raises(AssertionError, match="shared page"):
        tspec.rollback_length(al, 0, 8, 5, 4)
    assert tspec.span_pages(5, 8, 4) == jspec.span_pages(5, 8, 4) == [1]
    assert tspec.span_pages(8, 8, 4) == []


def _commit_case(dtype):
    """One layer's pools on both sides, history scattered by each side's
    prefill scatter, then a commit of a W-5 stage: slot 0 opens a fresh
    page (offset 0), slot 1 crosses a page boundary with rows scaled up x4
    (its page's running amax grows: a requantize), slot 2 accepts nothing,
    slot 3 is a free slot (null-page row)."""
    from repro import kvcache as jkv
    from repro.configs.base import AttentionConfig as JAttn
    from repro.serve.paged import commit_spec_cache as jcommit
    from repro_torch import kvcache as tkv
    from repro_torch.configs.base import AttentionConfig as TAttn
    from repro_torch.serve.paged import commit_spec_cache as tcommit
    rng = np.random.default_rng(8)
    akw = dict(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16)
    s_n, page, pps, w = 4, 8, 4, 5
    n = 1 + s_n * pps
    table = np.zeros((s_n, pps), np.int32)
    table[:3] = np.arange(1, 1 + 3 * pps).reshape(3, pps)
    spec = dict(layout="paged", page_size=page, dtype=dtype)
    jc = jkv.alloc_paged(jkv.CacheSpec(**spec), JAttn(**akw), s_n, n, pps)
    jc["block_table"] = jnp.asarray(table)
    tc = tkv.alloc_paged(tkv.CacheSpec(**spec), TAttn(**akw), s_n, n, pps)
    tc["block_table"] = torch.from_numpy(table.copy())
    lengths = np.asarray([16, 13, 7, 0], np.int32)
    k_hist = rng.normal(size=(s_n, 16, 2, 16)).astype(np.float32)
    v_hist = rng.normal(size=(s_n, 16, 2, 16)).astype(np.float32)
    jc = jkv.paged_scatter_prefill(jc, jnp.arange(s_n, dtype=jnp.int32),
                                   jnp.asarray(lengths), jnp.asarray(k_hist),
                                   jnp.asarray(v_hist))
    tkv.paged_scatter_prefill(tc, torch.arange(s_n), torch.from_numpy(lengths),
                              torch.from_numpy(k_hist),
                              torch.from_numpy(v_hist))
    ks = rng.normal(size=(s_n, w, 2, 16)).astype(np.float32)
    vs = rng.normal(size=(s_n, w, 2, 16)).astype(np.float32)
    ks[1, 1:] *= 4.0
    vs[1, 1:] *= 4.0
    jk, jv = jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16)
    n_write = np.asarray([5, 4, 0, 3], np.int32)
    jargs = ({"blk0": {"kv": jc}}, {"blk0": {"kv": {"k": jk, "v": jv}}},
             jnp.asarray(lengths), jnp.asarray(n_write))
    jit_out = jcommit(*jargs)["blk0"]["kv"]
    with jax.disable_jit():
        jout = jcommit(*jargs)["blk0"]["kv"]
    tout = tcommit([{"blk0": {"kv": tc}}],
                   [{"blk0": {"kv": {"k": _to_torch(jk),
                                     "v": _to_torch(jv)}}}],
                   torch.from_numpy(lengths),
                   torch.from_numpy(n_write))[0]["blk0"]["kv"]
    return jc, jout, jit_out, tout


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_commit_spec_cache_matches_jax(dtype):
    """The commit replays the accepted tokens' writes exactly as JAX's
    does: every real page and (int8) every real page's scale bit for bit
    against ``commit_spec_cache`` run eagerly (the null page takes the
    masked writes in no fixed order); the int8 case grows a page's scale,
    and a rejected token touches no real page.  Jitted, XLA divides the
    amax by 127 through the reciprocal (ROADMAP C, trap 1), so against
    the jitted commit the scales are held to one fp32 ulp (1.2e-7
    relative) and the pages bit for bit."""
    jc0, jout, jit_out, tout = _commit_case(dtype)
    names = ["k_pages", "v_pages"] + (
        ["k_scales", "v_scales"] if dtype == "int8" else [])
    for name in names:
        t = tout[name][1:]
        t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        j = np.asarray(jout[name][1:].astype(jnp.float32)
                       if jout[name].dtype == jnp.bfloat16
                       else jout[name][1:])
        np.testing.assert_array_equal(t, j, err_msg=name)
        jj = np.asarray(jit_out[name][1:].astype(jnp.float32))
        if name.endswith("scales"):
            np.testing.assert_allclose(t, jj, rtol=1.2e-7, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(t, jj, err_msg=name)
    if dtype == "int8":
        grew = np.asarray(jout["k_scales"]) != np.asarray(jc0["k_scales"])
        assert grew[1:].any()
    # slot 2 accepted nothing: its pages are as the scatter left them
    for name in names:
        pages = [1 + 2 * 4 + i for i in range(4)]
        np.testing.assert_array_equal(np.asarray(jout[name])[pages],
                                      np.asarray(jc0[name])[pages])


# ---------------------------------------------------------------------------
# LM.verify_paged and the contiguous decode


def _paged_pair(models, kv):
    """Both LMs with a paged cache whose slots hold prefixes of 16, 13 and
    0 tokens (written by each side's ``prefill_paged``)."""
    jcfg, jp, tcfg, tp = models
    jlm = JLM(jcfg.with_(kv_cache_dtype=kv))
    tlm = TLM(tcfg.with_(kv_cache_dtype=kv), device="cpu")
    tp = tlm.prepare(tp)
    page, pps, s_n = 8, 4, 3
    n = 1 + s_n * pps
    table = np.arange(1, n).reshape(s_n, pps).astype(np.int32)
    jc = jlm.init_paged_cache(s_n, n, pps, page_size=page)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(jnp.asarray(table), x.shape)
                      if x.dtype == jnp.int32 else x, jc)
    tc = tlm.init_paged_cache(s_n, n, pps, page_size=page)
    tc[0]["blk0"]["kv"]["block_table"].copy_(torch.from_numpy(table))
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jcfg.vocab_size, (s_n, 16))
    lens = np.asarray([16, 13, 0], np.int32)
    args = (np.arange(s_n, dtype=np.int32), np.zeros(s_n, np.int32), lens)
    _, jc = jlm.prefill_paged(jp, jnp.asarray(toks, jnp.int32), jc,
                              *[jnp.asarray(a) for a in args])
    tlm.prefill_paged(tp, torch.from_numpy(toks), tc,
                      *[torch.from_numpy(a) for a in args])
    return (jlm, jp, jc), (tlm, tp, tc), lens, rng


@pytest.mark.parametrize("max_pages", [None, 2])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_lm_verify_paged_matches_jax(models, kv, max_pages):
    """``LM.verify_paged`` in float32 over bf16 / int8 pools: the logits
    of every query row inside its width equal JAX's (LOGIT_TOL), the
    staged K/V equals JAX's to one bf16 step of the fp32 projections, and
    the pools are not written."""
    (jlm, jp, jc), (tlm, tp, tc), lens, rng = _paged_pair(models, kv)
    w = 5
    fed = rng.integers(0, jlm.cfg.vocab_size, (3, w))
    widths = np.asarray([5, 3, 1], np.int32)
    jstage = jlm.init_cache(3, w, kv_dtype="bfloat16")
    jl, jst = jlm.verify_paged(jp, jnp.asarray(fed, jnp.int32), jc, jstage,
                               jnp.asarray(lens), jnp.asarray(widths),
                               max_pages=max_pages)
    before = {k: v.clone() for k, v in tc[0]["blk0"]["kv"].items()}
    tstage = tlm.init_cache(3, w, kv_dtype="bfloat16")
    tl, tst = tlm.verify_paged(tp, torch.from_numpy(fed), tc, tstage,
                               torch.from_numpy(lens),
                               torch.from_numpy(widths), max_pages=max_pages)
    assert tuple(tl.shape) == (3, w, jlm.cfg.vocab_size)
    jl = np.asarray(jl)
    for s, wid in enumerate(widths):
        np.testing.assert_allclose(tl[s, :wid].numpy(), jl[s, :wid],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for k, v in tc[0]["blk0"]["kv"].items():
        assert torch.equal(v, before[k]), k
    for gi, group in enumerate(tst):
        for blk, node in group.items():
            jnode = jax.tree.map(lambda x: x[gi], jst[blk]["kv"]) \
                if jlm.cfg.scan_layers else jst[gi][blk]["kv"]
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    node["kv"][name].float().numpy(),
                    np.asarray(jnode[name].astype(jnp.float32)),
                    atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_decode_step_matches_jax(models, dtype):
    """``LM.decode_step`` over a contiguous bf16 cache (the draft LM's
    path): a prefill of 8 tokens, then 4 steps at per-row positions, one
    row lagging behind the other; logits equal JAX's to LOGIT_TOL in
    float32 and to a relative L2 of 2e-2 per row in bf16 (activations
    rounded to bf16 on each side in another order)."""
    jcfg, jp, tcfg, tp = models
    jlm, tlm = JLM(jcfg.with_(dtype=dtype)), TLM(tcfg.with_(dtype=dtype),
                                                 device="cpu")
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                          if x.dtype == jnp.float32 else x, jp)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tlm.cfg,
                               device="cpu")
    tp = tlm.prepare(tp)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, jcfg.vocab_size, (2, 8))
    jc = jlm.init_cache(2, 24)
    tc = tlm.init_cache(2, 24)
    _, jc = jlm.prefill(jp, jnp.asarray(toks, jnp.int32), jc)
    tlm.prefill(tp, torch.from_numpy(toks), tc)
    pos = np.asarray([8, 5], np.int32)
    for _ in range(4):
        tok = rng.integers(0, jcfg.vocab_size, 2)
        jl, jc = jlm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                                 jnp.asarray(pos))
        tl, tc = tlm.decode_step(tp, torch.from_numpy(tok), tc,
                                 torch.from_numpy(pos))
        jl = np.asarray(jl)
        if dtype == "float32":
            np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)
        else:
            rel = np.linalg.norm(tl.numpy() - jl, axis=-1) \
                / np.linalg.norm(jl, axis=-1)
            assert rel.max() <= 2e-2, rel
        pos = pos + 1


# ---------------------------------------------------------------------------
# engine end to end

#: counters both engines must agree on (wall-clock series excluded)
COUNTERS = ("serve_tokens_emitted_total", "serve_host_syncs_total",
            "serve_decode_steps_total", "serve_decode_tokens_total",
            "serve_kv_requant_events_total", "serve_prefill_dispatches_total",
            "serve_decode_dispatches_total", "sched_chunks_total",
            "sched_prefill_tokens_total")


def _real_page_scale_changes(before, after):
    """The reference's ``_kv_scale_change_count`` over real pages only, as
    the port counts (``test_torch_quant_serving.py``)."""
    from jax.tree_util import keystr, tree_flatten_with_path
    b = {keystr(p): x for p, x in tree_flatten_with_path(before)[0]
         if "_scales" in keystr(p)}
    total = jnp.zeros((), jnp.int32)
    for p, x in tree_flatten_with_path(after)[0]:
        if keystr(p) in b:
            total = total + jnp.sum(
                (b[keystr(p)][..., 1:, :] != x[..., 1:, :]).astype(jnp.int32))
    return total


def _repetitive_prompts(vocab, n=4):
    """``test_spec.py``'s prompts: a 6-token pattern three times and 3
    random tokens, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        pat = rng.integers(0, vocab, (6,)).tolist()
        out.append(pat * 3 + rng.integers(0, vocab, (3,)).tolist())
    return out


def _engine_kw(**kw):
    base = dict(n_slots=2, max_len=96, seed=0, page_size=8, decode_block=4,
                prefill_chunk=16, policy="fcfs", prefix_cache=False)
    return {**base, **kw}


def _run(cls, lm, params, prompts, max_new=20, **kw):
    eng = cls(lm, params, **_engine_kw(**kw))
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = eng.run_to_completion()
    return [done[i].out_tokens for i in ids], eng


_engine_runs = {}


def _spec_pair(models, kv):
    """JAX's and the port's SpecEngine (n-gram, k 6) and the port's
    SchedEngine on ``test_spec.py``'s repetitive prompts, made once."""
    if kv not in _engine_runs:
        jcfg, jp, tcfg, tp = models
        prompts = _repetitive_prompts(jcfg.vocab_size)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_engine, "_kv_scale_change_count",
                       _real_page_scale_changes)
            j = _run(jspec.SpecEngine, JLM(jcfg.with_(kv_cache_dtype=kv)),
                     jp, prompts, spec="ngram", draft_k=6)
        tlm = TLM(tcfg.with_(kv_cache_dtype=kv), device="cpu")
        t = _run(tspec.SpecEngine, tlm, tp, prompts, spec="ngram",
                 draft_k=6)
        base = _run(TSched, tlm, tp, prompts)
        _engine_runs[kv] = (j, t, base)
    return _engine_runs[kv]


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_spec_engine_matches_jax_and_plain_decode(models, kv):
    """The acceptance criterion on both pools: the port's n-gram
    SpecEngine gives JAX's SpecEngine streams and the port's SchedEngine
    streams token for token, with JAX's syncs, spec stats and counters
    (int8 requant events included), and one host sync per chunk dispatch,
    verify round and fallback decode block."""
    (jtoks, jeng), (ttoks, teng), (btoks, _) = _spec_pair(models, kv)
    assert ttoks == jtoks
    assert ttoks == btoks
    assert all(len(t) == 20 for t in ttoks)
    assert dataclasses.asdict(teng.spec_stats) == \
        dataclasses.asdict(jeng.spec_stats)
    assert teng.sync_count == jeng.sync_count
    assert teng.sync_count == teng.stats.chunks \
        + teng.spec_stats.verify_steps \
        + teng.steps_dispatched // teng.decode_block
    snap_t = teng.metrics.snapshot()["counters"]
    snap_j = jeng.metrics.snapshot()["counters"]
    for name in COUNTERS + tuple(f"spec_{f.name}_total" for f in
                                 dataclasses.fields(tspec.SpecStats)):
        assert snap_t[name] == snap_j[name], name
    if kv == "int8":
        assert snap_t["serve_kv_requant_events_total"] > 0
    np.testing.assert_array_equal(teng.controller.ema, jeng.controller.ema)
    tele = teng.telemetry()["spec"]
    assert tele["acceptance_rate"] > 0
    assert tele["accepted_per_step"] > 1.0 and tele["tokens_per_step"] > 2.0
    tj = jeng.telemetry()["spec"]
    for key in ("acceptance_rate", "accepted_per_step", "tokens_per_step",
                "controller"):
        assert tele[key] == tj[key], key
    assert sorted(teng.alloc.free) == sorted(jeng.alloc.free)


def test_spec_draft_self_speculation_engine(models):
    """Draft arm with the target drafting for itself: acceptance 1.0, more
    than 4 tokens a slot-step, the SchedEngine streams, and JAX's."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).tolist()
               for n in (8, 5)]
    tlm = TLM(tcfg, device="cpu")
    base, _ = _run(TSched, tlm, tp, prompts, max_new=16)
    toks, eng = _run(tspec.SpecEngine, tlm, tp, prompts, max_new=16,
                     spec="draft", draft_lm=tlm, draft_params=tp, draft_k=4,
                     adaptive=False)
    jtoks, jeng = _run(jspec.SpecEngine, JLM(jcfg), jp, prompts, max_new=16,
                       spec="draft", draft_lm=JLM(jcfg), draft_params=jp,
                       draft_k=4, adaptive=False)
    assert toks == base == jtoks
    tele = eng.telemetry()["spec"]
    assert tele["acceptance_rate"] == 1.0
    assert tele["tokens_per_step"] > 4.0
    assert eng.drafter.syncs == jeng.drafter.syncs > 0
    assert eng.sync_count == jeng.sync_count


def test_spec_temperature_runs_and_respects_budget(models):
    """Sampled speculation (the draft arm always proposes): every request
    gets exactly its budget, verify rounds run and drafts are proposed;
    the same generator seed gives the same streams."""
    _, _, tcfg, tp = models
    lm = TLM(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, (8,)).tolist()
               for _ in range(3)]
    runs = []
    for _ in range(2):
        eng = tspec.SpecEngine(lm, tp, **_engine_kw(
            spec="draft", draft_lm=lm, draft_params=tp, adaptive=False,
            draft_k=4))
        ids = [eng.submit(p, max_new_tokens=12, temperature=0.8)
               for p in prompts]
        done = eng.run_to_completion()
        assert all(len(done[i].out_tokens) == 12 for i in ids)
        assert eng.spec_stats.verify_steps > 0
        assert eng.spec_stats.drafts_proposed > 0
        runs.append([done[i].out_tokens for i in ids])
    assert runs[0] == runs[1]


def test_spec_edf_urgency_gate_falls_back_to_plain_decode(models):
    """While a queued request's EDF deadline is inside the slack, rounds
    take the plain fused decode block and the skip is counted; with no
    queue pressure the same settings speculate."""
    _, _, tcfg, tp = models
    lm = TLM(tcfg, device="cpu")
    long_p = _repetitive_prompts(tcfg.vocab_size, n=1)[0]
    urgent = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                               (6,)).tolist()
    eng = tspec.SpecEngine(lm, tp, **_engine_kw(
        spec="ngram", draft_k=6, policy="edf", n_slots=1, spec_slack_s=1e6))
    eng.submit(long_p, max_new_tokens=12, slo_ttft=10.0)
    eng.submit(urgent, max_new_tokens=4, slo_ttft=10.0)
    for _ in range(4):
        if not eng.queue:
            break
        eng.step()
        assert eng.spec_stats.verify_steps == 0
    assert eng.spec_stats.skipped_urgent > 0
    eng.run_to_completion()
    eng2 = tspec.SpecEngine(lm, tp, **_engine_kw(
        spec="ngram", draft_k=6, policy="edf", n_slots=1,
        spec_slack_s=1e-9))
    eng2.submit(long_p, max_new_tokens=12, slo_ttft=10.0)
    eng2.run_to_completion()
    assert eng2.spec_stats.verify_steps > 0


@pytest.mark.parametrize("arm", ["medusa", "none"])
def test_spec_bad_arms_raise(models, arm):
    """Only the n-gram and draft-LM arms speculate (``--spec none`` serves
    through the plain SchedEngine); the draft arm needs its model."""
    _, _, tcfg, tp = models
    lm = TLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="unknown spec arm"):
        tspec.SpecEngine(lm, tp, spec=arm, **_engine_kw())
    with pytest.raises(ValueError, match="draft_lm"):
        tspec.SpecEngine(lm, tp, spec="draft", **_engine_kw())


def _int8_spec_run(models, side, arm, impl):
    """One int8-weight SpecEngine drive (``test_quant_serving.py``'s spec
    arms) on JAX's side or the port's: the n-gram arm, or a random
    ``draft_config_of`` draft LM (seeded 1, bridged) quantized like the
    target.  ``adaptive=False``: every round verifies ``draft_k`` drafts."""
    jcfg, jp, tcfg, tp = models
    kw = dict(quant="int8", quant_matmul_impl=impl)
    jcfg, tcfg = jcfg.with_(**kw), tcfg.with_(**kw)
    prompts = _repetitive_prompts(jcfg.vocab_size)
    spec_kw = dict(spec=arm, draft_k=4, adaptive=False)
    if side == "jax":
        if arm == "draft":
            jdc = jspec.draft_config_of(jcfg)
            spec_kw.update(draft_lm=JLM(jdc), draft_params=j_quantize_tree(
                JLM(jdc).init(jax.random.PRNGKey(1)), quant="int8"))
        return _run(jspec.SpecEngine, JLM(jcfg),
                    j_quantize_tree(jp, quant="int8"), prompts, max_new=12,
                    **spec_kw)
    if arm == "draft":
        tdc = tspec.draft_config_of(tcfg)
        jdp = JLM(jspec.draft_config_of(jcfg)).init(jax.random.PRNGKey(1))
        tdp = params_from_numpy(jax.tree.map(np.asarray, jdp), tdc,
                                device="cpu")
        spec_kw.update(draft_lm=TLM(tdc, device="cpu"),
                       draft_params=quantize_tree(tdp, quant="int8"))
    return _run(tspec.SpecEngine, TLM(tcfg, device="cpu"),
                quantize_tree(tp, quant="int8"), prompts, max_new=12,
                **spec_kw)


@pytest.mark.parametrize("arm", ["ngram", "draft"])
def test_int8_weight_spec_engine_matches_jax_and_fused_equals_ref(models,
                                                                  arm):
    """``test_quant_serving.py``'s spec arms on the port: int8 weights
    (W8A8; the verify's M = 2 slots x 5 rows takes the decode kernel's
    plain version) through draft, verify, commit and rollback, and an
    int8 draft LM.  The port's "fused" gives its "ref" streams and JAX's
    (its oracle, which JAX's own suite holds equal to its fused kernels),
    with JAX's spec stats and syncs, token for token."""
    (jtoks, jeng) = _int8_spec_run(models, "jax", arm, "ref")
    (ttoks, teng) = _int8_spec_run(models, "port", arm, "fused")
    (rtoks, _) = _int8_spec_run(models, "port", arm, "ref")
    assert ttoks == rtoks == jtoks
    assert all(len(t) == 12 for t in ttoks)
    assert teng.spec_stats.verify_steps > 0
    assert teng.spec_stats.drafts_proposed > 0
    assert dataclasses.asdict(teng.spec_stats) == \
        dataclasses.asdict(jeng.spec_stats)
    assert teng.sync_count == jeng.sync_count
    if arm == "draft":
        assert teng.drafter.syncs == jeng.drafter.syncs > 0


@pytest.mark.parametrize("arm", ["ngram", "draft"])
def test_launch_serve_spec_on_cpu(capsys, arm):
    """``--spec`` serves through the SpecEngine on the CPU and prints its
    telemetry."""
    from repro_torch.launch.serve import main
    assert main(["--smoke", "--spec", arm, "--device", "cpu",
                 "--requests", "2", "--prompt-len", "20", "--max-new", "6",
                 "--slots", "2", "--max-len", "64", "--page-size", "8",
                 "--prefill-chunk", "16", "--decode-block", "4"]) == 0
    out = capsys.readouterr().out
    assert f"spec/{arm}" in out and "'spec': {" in out

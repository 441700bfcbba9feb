"""Port parity: the cost model (``repro_torch.core``) against the reference's
``repro.core.costmodel``, ``repro.core.space`` / ``apply`` and
``repro.kvcache.kv_bytes_per_token``.

The port carries no TPU number: its only tier is ``h100-1``.  So each
test builds the tiers it compares at from the reference's own ``HW`` and
``TIERS["v5e-1"]`` / ``["v5e-8"]`` (the 8-chip one exercises the
collective term), and every ported function must then return exactly
(``==``) what JAX's returns: over the port's four arch configs, full and
smoke, weights bf16 / int8 / fp8 / int4, KV bf16 / int8 / fp8, KV styles
full / gqa / mqa, both KV layouts (the reference picks paged bytes from
``decode_attn_impl="paged_pallas"``, the port from ``layout="paged"``)
and a few prompt / gen / chunk values.  The efficiency configurations
``predict`` prices are drawn from the copied ``space.py`` with a seeded
generator, and ``apply_efficiency_config`` gives JAX's config field by
field.  Also: ``CalibratedCostModel`` step by step, ``fit_profile`` over
the same samples, a JSON round trip that loads JAX's file, the analytic
parameter count against the port's built model, and the H100 tier.
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.paper_models import PAPER_MODELS  # noqa: E402
from repro.core import apply as japply  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.kvcache import kv_bytes_per_token as j_kv_bytes  # noqa: E402
from repro.launch.mesh import HW  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.obs import DispatchProfiler as JProfiler  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import apply as tapply  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.kvcache import kv_bytes_per_token as t_kv_bytes  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.obs import DISPATCH_KINDS  # noqa: E402
from repro_torch.obs import DispatchProfiler as TProfiler  # noqa: E402
from repro_torch.obs import MetricsRegistry as TRegistry  # noqa: E402


def _tier(name):
    """The reference's tier ``name`` with the reference's ``HW`` peaks, as
    a port ``HwTier``."""
    jt = jcm.TIERS[name]
    return tcm.HwTier(jt.name, jt.chips, jt.mem_cap, jt.power_budget,
                      peak_flops_bf16=HW["peak_flops_bf16"],
                      peak_flops_int8=HW["peak_flops_int8"],
                      hbm_bw=HW["hbm_bw"], link_bw=HW["ici_bw_per_link"],
                      links=HW["ici_links"], tdp_watts=HW["tdp_watts"],
                      idle_watts=HW["idle_watts"])


TIER_NAMES = ("v5e-1", "v5e-8")
QUANTS = ("bf16", "int8", "fp8", "int4")
KV_DTYPES = ("bfloat16", "int8", "fp8")
STYLES = ("full", "gqa", "mqa")
LAYOUTS = ("contiguous", "paged")
#: the archs the port serves; the sweeps below run over these
ARCHS = ["llama3.2-1b", "qwen2-1.5b", "rwkv6-1.6b", "stablelm-1.6b"]
#: the rest of the search's roster (config data only): the six other
#: assigned archs and the paper's six models
ROSTER = sorted(set(jconfigs.ARCH_IDS) - set(ARCHS)) + sorted(PAPER_MODELS)


def _pair(arch, smoke, layout="contiguous", **kw):
    """(JAX config, port config) of ``arch``, with ``kw`` applied to both
    and the KV layout spelled each side's way."""
    getter = "get_smoke_config" if smoke else "get_config"
    j = getattr(jconfigs, getter)(arch).with_(**kw)
    t = getattr(tconfigs, getter)(arch).with_(**kw)
    j = j.with_(decode_attn_impl="paged_pallas" if layout == "paged"
                else "eager")
    return j, t


def _variants(arch):
    """Every (smoke, quant, kv dtype, style, layout) of the sweep, as
    (JAX config, port config, layout)."""
    for smoke, q, kv, st, lay in itertools.product(
            (False, True), QUANTS, KV_DTYPES, STYLES, LAYOUTS):
        j, t = _pair(arch, smoke, lay, quant=q, kv_cache_dtype=kv,
                     kv_cache_style=st)
        yield j, t, lay


def _same_fields(t, j, path=""):
    """Every field of the port's dataclass ``t`` equals the reference's
    ``j`` (sub-dataclasses field by field)."""
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            assert dataclasses.is_dataclass(jv), path + f.name
            _same_fields(tv, jv, path + f.name + ".")
        else:
            assert tv == jv, (path + f.name, tv, jv)


# ---------------------------------------------------------------------------
# config data


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch):
    """``param_count`` / ``active_param_count`` of every config of the
    sweep, and of the MoE / MLA / mha / mqa configs the efficiency arms
    make of it, equal JAX's."""
    rng = np.random.default_rng(1)
    for smoke in (False, True):
        j, t = _pair(arch, smoke)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        for _ in range(12):
            eff = tspace.sample_config(rng)
            jeff = jspace.EfficiencyConfig(
                jspace.ArchChoice(**dataclasses.asdict(eff.arch)),
                jspace.FtChoice(**dataclasses.asdict(eff.ft)),
                jspace.InfChoice(**dataclasses.asdict(eff.inf)))
            ta = tapply.apply_efficiency_config(t, eff)
            ja = japply.apply_efficiency_config(j, jeff)
            assert ta.param_count() == ja.param_count()
            assert ta.active_param_count() == ja.active_param_count()


def _tree_size(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_size(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_size(v) for v in tree)
    return tree.numel()


def _formula_gap(cfg) -> int:
    """What the reference's analytic count adds over the built model: a
    norm counts its scale only (a layernorm also has a bias), and an
    RWKV-6 mixer counts six d x d projections and a 2d tail where the
    model has five and 10d (x_maa, five lerp vectors, w0, u, ln_x's
    scale and bias)."""
    d, n_layers = cfg.d_model, cfg.num_layers
    gap = 0
    if cfg.norm == "layernorm":
        gap -= (2 * n_layers + 1) * d
    if cfg.block_pattern == ("rwkv6",):
        gap += n_layers * (d * d - 8 * d)
    return gap


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_the_built_model(arch):
    """The analytic count equals the size of the port's ``LM.init`` tree
    (smoke width), which equals JAX's, up to the reference formula's own
    gap for layernorm and RWKV-6 configs (``_formula_gap``)."""
    j, t = _pair(arch, True)
    n_port = _tree_size(TLM(t, device="cpu").init(0))
    n_jax = sum(x.size for x in jax.tree.leaves(
        JLM(j).init(jax.random.PRNGKey(0))))
    assert n_port == n_jax
    assert t.param_count() - n_port == _formula_gap(t)
    if t.norm == "rmsnorm" and t.block_pattern == ("attn",):
        assert _formula_gap(t) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_bytes_per_token_matches_jax(arch):
    for j, t, lay in _variants(arch):
        for page in (8, 64, 256):
            assert t_kv_bytes(t, layout=lay, page_size=page) == \
                j_kv_bytes(j, layout=lay, page_size=page)


def test_kv_bytes_per_token_mla_matches_jax():
    """The MLA branch (latent + rope dims at bf16), on the config the
    search's attention arm makes."""
    eff = tspace.EfficiencyConfig(tspace.ArchChoice("mla", 0, 1))
    jeff = jspace.EfficiencyConfig(jspace.ArchChoice("mla", 0, 1))
    for smoke in (False, True):
        j, t = _pair("qwen2-1.5b", smoke)
        ta = tapply.apply_efficiency_config(t, eff)
        ja = japply.apply_efficiency_config(j, jeff)
        assert ta.attention.kind == "mla"
        for lay in LAYOUTS:
            assert t_kv_bytes(ta, layout=lay) == j_kv_bytes(ja, layout=lay)


# ---------------------------------------------------------------------------
# cost functions


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_prefill_hbm_bytes_matches_jax(arch):
    for j, t, lay in _variants(arch):
        for prompt, chunk, batch, fused, hz in (
                (40, 16, 1, True, None), (3000, 512, 8, True, None),
                (3000, 512, 2, False, None), (700, 256, 1, False, 1024),
                (1, 512, 1, True, None)):
            assert tcm.chunk_prefill_hbm_bytes(
                t, prompt, chunk=chunk, fused=fused, horizon=hz,
                batch=batch, layout=lay) == jcm.chunk_prefill_hbm_bytes(
                j, prompt, chunk=chunk, fused=fused, horizon=hz,
                batch=batch)


SHAPES = ((1, 0, None), (40, 12, 16), (512, 128, None), (3000, 64, 512))


@pytest.mark.parametrize("arch", ARCHS)
def test_service_estimate_matches_jax(arch):
    for name in TIER_NAMES:
        tier, jtier = _tier(name), jcm.TIERS[name]
        for j, t, lay in _variants(arch):
            for prompt, gen, chunk in SHAPES:
                assert tcm.service_estimate(
                    t, tier, prompt=prompt, gen=gen, chunk=chunk,
                    layout=lay) == jcm.service_estimate(
                    j, jtier, prompt=prompt, gen=gen, chunk=chunk)


@pytest.mark.parametrize("arch", ARCHS)
def test_rung_estimate_and_quant_decode_scale_match_jax(arch):
    """Every rung override (spec off, chunk, KV-dtype hint) on configs
    with each spec arm, and the quantized-decode ratio the spec
    controller divides by."""
    tier, jtier = _tier("v5e-1"), jcm.TIERS["v5e-1"]
    for j, t, lay in _variants(arch):
        for spec, k in (("none", 4), ("ngram", 4), ("draft", 2)):
            js, ts = (c.with_(spec_decode=spec, spec_draft_k=k)
                      for c in (j, t))
            for spec_off, chunk, kv in ((False, None, None),
                                        (True, 64, None),
                                        (True, 32, "int8")):
                kw = dict(spec_off=spec_off, prefill_chunk=chunk,
                          kv_dtype=kv, prompt=256, gen=64)
                assert tcm.rung_estimate(ts, tier, layout=lay, **kw) == \
                    jcm.rung_estimate(js, "v5e-1", **kw)
        for prompt, gen in ((512, 128), (64, 16)):
            assert tcm.quant_decode_scale(
                t, tier, prompt=prompt, gen=gen, layout=lay) == \
                jcm.quant_decode_scale(j, jtier, prompt=prompt, gen=gen)


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_estimate_matches_jax(arch):
    for name in TIER_NAMES:
        tier, jtier = _tier(name), jcm.TIERS[name]
        for j, t, lay in _variants(arch):
            for kind in DISPATCH_KINDS:
                for tokens, rows, steps, bucket, ctx in (
                        (16, 2, 4, 8, 32), (4096, 8, 1, 512, 1024),
                        (0, 0, 0, 0, 0), (40, 3, 8, 5, 2000)):
                    kw = dict(kind=kind, tokens=tokens, rows=rows,
                              steps=steps, bucket=bucket, ctx=ctx)
                    assert tcm.dispatch_estimate(t, tier, layout=lay,
                                                 **kw) == \
                        jcm.dispatch_estimate(j, jtier, **kw)
            with pytest.raises(ValueError, match="unknown dispatch kind"):
                tcm.dispatch_estimate(t, tier, kind="warp")


def _j_eff(eff):
    return jspace.EfficiencyConfig(
        jspace.ArchChoice(**dataclasses.asdict(eff.arch)),
        jspace.FtChoice(**dataclasses.asdict(eff.ft)),
        jspace.InfChoice(**dataclasses.asdict(eff.inf)))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_predict_match_jax(arch):
    """Configurations drawn from the copied space (the family's mask, as
    the reference's tuner draws them): the applied config equals JAX's
    field by field, and ``predict`` (batch, chunked prefill, a measured
    acceptance, with and without a calibration) returns JAX's dict."""
    rng = np.random.default_rng(2026)
    calib_t, calib_j = tcm.CalibratedCostModel(), jcm.CalibratedCostModel()
    for c in (calib_t, calib_j):
        c.update("decode_block", "a", 3e-3, 1e-3)
        c.update("admit", "a", 1.5e-3, 1e-3)
    for smoke in (False, True):
        j, t = _pair(arch, smoke)
        mask = tspace.space_for_family(t.family)
        for _ in range(10):
            eff = tspace.sample_config(rng, mask)
            jeff = _j_eff(eff)
            ta = tapply.apply_efficiency_config(t, eff)
            ja = japply.apply_efficiency_config(j, jeff)
            _same_fields(ta, ja)
            for name, lay in itertools.product(TIER_NAMES, LAYOUTS):
                jj = j.with_(decode_attn_impl="paged_pallas"
                             if lay == "paged" else "eager")
                for kw in (dict(), dict(prompt=3000, gen=64, batch=4,
                                        prefill_chunk=512),
                           dict(spec_accept_rate=0.8, gen=0)):
                    for ct, cj in ((None, None), (calib_t, calib_j)):
                        assert tcm.predict(
                            t, eff, _tier(name), calibration=ct,
                            layout=lay, **kw) == jcm.predict(
                            jj, jeff, jcm.TIERS[name], calibration=cj,
                            **kw)


@pytest.mark.parametrize("name", ROSTER)
def test_roster_configs_price_as_jax(name):
    """The roster's other configs (MoE, Mamba, encoder, cross-attention,
    windows, MHA), which the port prices but does not serve: parameter
    counts at full (and smoke) width, each drawn configuration applied
    field by field, and ``predict`` at the reference's 1-, 8- and
    256-chip tiers in both layouts, with and without a calibration."""
    rng = np.random.default_rng(7)
    calib_t, calib_j = tcm.CalibratedCostModel(), jcm.CalibratedCostModel()
    for c in (calib_t, calib_j):
        c.update("decode_block", "a", 3e-3, 1e-3)
        c.update("admit", "a", 1.5e-3, 1e-3)
    getters = ["get_config"] + (["get_smoke_config"]
                                if name in jconfigs.ARCH_IDS else [])
    for getter in getters:
        j, t = (getattr(m, getter)(name) for m in (jconfigs, tconfigs))
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        effs = [tspace.EfficiencyConfig.default()] + [
            tspace.sample_config(rng, tspace.space_for_family(t.family))
            for _ in range(6)]
        for eff in effs:
            jeff = _j_eff(eff)
            ta = tapply.apply_efficiency_config(t, eff)
            _same_fields(ta, japply.apply_efficiency_config(j, jeff))
            assert ta.param_count() == japply.apply_efficiency_config(
                j, jeff).param_count()
            for tier_name, lay in itertools.product(
                    TIER_NAMES + ("v5e-256",), LAYOUTS):
                jj = j.with_(decode_attn_impl="paged_pallas"
                             if lay == "paged" else "eager")
                for ct, cj in ((None, None), (calib_t, calib_j)):
                    assert tcm.predict(t, eff, _tier(tier_name),
                                       calibration=ct, layout=lay) == \
                        jcm.predict(jj, jeff, jcm.TIERS[tier_name],
                                    calibration=cj)


def test_space_matches_jax():
    """The copied space: the same arms, the same enumeration and size per
    family mask, the same seeded draws and feature encodings."""
    for name in ("ATTENTION_KINDS", "MOE_EXPERTS", "MOE_TOPK", "FT_METHODS",
                 "FT_RANKS", "FT_ALPHA_MULT", "QUANTS", "QUANT_METHODS",
                 "KV_STYLES", "SPEC_ARMS", "SPEC_DRAFT_KS",
                 "FEATURE_DIM_CONFIG"):
        assert getattr(tspace, name) == getattr(jspace, name), name
    for fam in ("dense", "ssm"):
        tm, jm = tspace.space_for_family(fam), jspace.space_for_family(fam)
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
        assert tspace.space_size(tm) == jspace.space_size(jm)
        te, je = tspace.enumerate_space(tm), jspace.enumerate_space(jm)
        assert len(te) == len(je) == tspace.space_size(tm)
        assert [c.to_dict() for c in te[::97]] == \
            [c.to_dict() for c in je[::97]]
        rt, rj = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(50):
            ct, cj = tspace.sample_config(rt, tm), jspace.sample_config(rj,
                                                                        jm)
            assert ct.to_dict() == cj.to_dict()
            assert tspace.encode_config(ct) == jspace.encode_config(cj)
    assert tspace.EfficiencyConfig.default().to_dict() == \
        jspace.EfficiencyConfig.default().to_dict()


# ---------------------------------------------------------------------------
# calibration


def test_calibration_steps_match_jax():
    """``update`` / ``correction`` (exact series, kind-level fallback,
    unseen kind) / ``calibrate`` / ``phase_scale`` / ``n_samples`` after
    every step of the same random update sequence."""
    rng = np.random.default_rng(3)
    t, j = tcm.CalibratedCostModel(beta=0.3), jcm.CalibratedCostModel(
        beta=0.3)
    arms = ("a", "b", "c")
    for _ in range(60):
        kind = DISPATCH_KINDS[int(rng.integers(0, 5))]
        arm = arms[int(rng.integers(0, 3))]
        m, p = float(rng.uniform(1e-4, 1e-1)), float(rng.uniform(1e-5,
                                                                 1e-2))
        assert t.update(kind, arm, m, p) == j.update(kind, arm, m, p)
        for k in DISPATCH_KINDS:
            for a in arms + ("unseen", None):
                assert t.correction(k, a) == j.correction(k, a)
                assert t.calibrate(k, 2e-3, a) == j.calibrate(k, 2e-3, a)
        for phase in ("prefill", "decode", "other"):
            assert t.phase_scale(phase) == j.phase_scale(phase)
        assert t.n_samples == j.n_samples
    assert t.factors == j.factors


def _profilers(cfg_t, cfg_j, n=30):
    """A port and a JAX profiler with the same samples (host stamps only)."""
    rng = np.random.default_rng(4)
    tp, jp = TProfiler(enabled=True), JProfiler(enabled=True)
    tp.bind(cfg_t, layout="paged")
    jp.bind(cfg_j)
    for _ in range(n):
        kind = DISPATCH_KINDS[int(rng.integers(0, 5))]
        kw = dict(tokens=int(rng.integers(1, 4096)),
                  rows=int(rng.integers(1, 9)),
                  steps=int(rng.integers(1, 9)),
                  bucket=int(2 ** rng.integers(0, 10)),
                  ctx=int(rng.integers(1, 4096)))
        t0 = float(rng.uniform(0, 10))
        t1 = t0 + float(rng.uniform(1e-4, 0.1))
        tp.record(kind, t0, t1, **kw)
        jp.record(kind, t0, t1, **kw)
    return tp, jp


def test_fit_profile_and_json_round_trip_match_jax(tmp_path):
    """``fit_profile`` over the same samples gives JAX's records and
    factors (int8 KV on the paged layout); the drift gauges carry JAX's
    series; the port loads the file JAX writes and JAX the port's."""
    jc, tc = _pair("qwen2-1.5b", False, "paged", kv_cache_dtype="int8",
                   quant="int8")
    tp, jp = _profilers(tc, jc)
    t, j = tcm.CalibratedCostModel(), jcm.CalibratedCostModel()
    assert t.fit_profile(tp, tc, _tier("v5e-1"), layout="paged") == \
        j.fit_profile(jp, jc, jcm.TIERS["v5e-1"])
    assert t.factors == j.factors
    tm, jm = TRegistry(), JRegistry()
    t.register_metrics(tm)
    j.register_metrics(jm)
    assert tm.snapshot()["gauges"] == jm.snapshot()["gauges"]
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    j.save(str(jpath))
    t.save(str(tpath))
    assert jpath.read_text() == tpath.read_text()
    loaded = tcm.CalibratedCostModel.load(str(jpath))
    assert loaded.factors == j.factors and loaded.beta == j.beta
    assert jcm.CalibratedCostModel.load(str(tpath)).factors == t.factors
    for kind in DISPATCH_KINDS:
        assert loaded.correction(kind) == j.correction(kind)


# ---------------------------------------------------------------------------
# the H100 tier


def test_h100_tier_is_the_data_sheet():
    """The port's tiers are H100s only (one card, an 8-card board, a
    256-card NVLink domain, and the paper's three tier names for them);
    one H100 SXM at the data sheet's dense rates, with the measured idle
    draw; int8 weights take the int8 rate, fp8 and bf16 the bf16 rate;
    one chip has no collective term."""
    assert set(tcm.TIERS) == {"h100-1", "h100-8", "h100-256", "consumer",
                              "datacenter", "high_perf"}
    t = tcm.TIERS["h100-1"]
    assert (t.chips, t.mem_cap, t.power_budget, t.tdp_watts) == \
        (1, 80e9, 700.0, 700.0)
    assert (t.peak_flops_bf16, t.peak_flops_int8, t.hbm_bw) == \
        (989.4e12, 1978.9e12, 3.35e12)
    assert 0 < t.idle_watts < t.tdp_watts
    cfg = tconfigs.get_config("qwen2-1.5b")
    assert tcm._peak_flops(cfg, t) == 989.4e12
    assert tcm._peak_flops(cfg.with_(quant="fp8"), t) == 989.4e12
    assert tcm._peak_flops(cfg.with_(quant="int8"), t) == 1978.9e12
    est = tcm.service_estimate(cfg, prompt=512, gen=128)
    assert est["t_collective_decode_s"] == 0.0
    # a decode step of qwen2-1.5b reads its 3.09 GB of bf16 weights
    assert est["t_decode_tok_s"] == pytest.approx(
        est["hbm_bytes_decode"] / 3.35e12)
    assert math.isclose(est["weight_bytes_decode"], 2 * cfg.param_count())
    # the paged layout spreads int8 scales over a page: fewer KV bytes
    q = cfg.with_(kv_cache_dtype="int8")
    assert t_kv_bytes(q, layout="paged") < t_kv_bytes(q)
    assert tcm.service_estimate(q, prompt=512, gen=128, layout="paged")[
        "kv_bytes_decode"] < tcm.service_estimate(q, prompt=512, gen=128)[
        "kv_bytes_decode"]

"""Port parity: per-dispatch profiling (``repro_torch.obs.profile``) and the
online calibration loop, mirroring ``test_profile.py``.

* Profiling is free: with a ``DispatchProfiler`` on and off, the port's
  ``PagedEngine``, ``SchedEngine`` under preemption, n-gram ``SpecEngine``
  and eager ``Engine`` give the same greedy streams and ``sync_count``
  (float32, smoke width), and the streams are JAX's.
* The port's samples equal those of JAX's twin engine one for one, in
  kind, arm, tokens, rows, steps, bucket and ctx; only ``dur_s`` (a wall
  clock) is not compared.
* The disabled profiler is a no-op; the arm label; ``export_gauges``
  writes the reference's metric names, and at one chip a sample's
  attainment is its analytic roofline time over its measured time.
* ``dispatch_estimate`` covers every kind; ``fit_profile`` is
  prequential (it halves the median error of a consistent multiple); the
  calibration feeds back into ``predict``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import spec as jspec  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.obs import DispatchProfiler as JProfiler  # noqa: E402
from repro.sched import SchedEngine as JSched  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import PagedEngine as JPaged  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core.costmodel import (TIERS, CalibratedCostModel,  # noqa
                                        dispatch_estimate, predict)
from repro_torch.core.space import EfficiencyConfig  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.obs import (DISPATCH_KINDS, DispatchProfiler,  # noqa: E402
                             MetricsRegistry)
from repro_torch.sched import SchedEngine as TSched  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import PagedEngine as TPaged  # noqa: E402

torch.manual_seed(0)

#: the sample fields held equal to JAX's (``dur_s`` is a wall clock)
FIELDS = ("kind", "arm", "tokens", "rows", "steps", "bucket", "ctx")


@pytest.fixture(scope="module")
def models():
    """The smoke qwen2 in float32 on both sides, one parameter tree."""
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32")
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    tcfg = t_smoke("qwen2-1.5b").with_(dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _drive(eng, prompts, max_new):
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = eng.run_to_completion()
    return [done[i].out_tokens for i in ids]


def _three_runs(models, jcls, tcls, prompts, max_new, **kw):
    """The port unprofiled and profiled, and JAX profiled: (streams,
    host syncs, profiler, engine) of each."""
    jcfg, jp, tcfg, tp = models
    out = []
    for cls, lm, params, prof in (
            (tcls, TLM(tcfg, device="cpu"), tp, None),
            (tcls, TLM(tcfg, device="cpu"), tp,
             DispatchProfiler(enabled=True)),
            (jcls, JLM(jcfg), jp, JProfiler(enabled=True))):
        eng = cls(lm, params, profiler=prof, **kw)
        toks = _drive(eng, prompts, max_new)
        # JAX's eager Engine counts no syncs: it syncs once a dispatch
        syncs = getattr(eng, "sync_count", None)
        out.append((toks, len(prof.samples) if syncs is None else syncs,
                    prof, eng))
    return out


def _check(runs, kinds):
    (base_t, base_s, _, _), (toks, syncs, prof, _), \
        (jtoks, jsyncs, jprof, _) = runs
    assert toks == base_t == jtoks
    assert syncs == base_s == jsyncs
    assert {s.kind for s in prof.samples} == kinds
    assert all(s.dur_s > 0 for s in prof.samples)
    assert [tuple(getattr(s, f) for f in FIELDS) for s in prof.samples] == \
        [tuple(getattr(s, f) for f in FIELDS) for s in jprof.samples]
    return prof


def test_profiling_is_sync_free_paged_engine(models):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (n,)).tolist() for n in (8, 5)]
    runs = _three_runs(models, JPaged, TPaged, prompts, 9, n_slots=2,
                       max_len=64, seed=0, page_size=8, decode_block=4)
    prof = _check(runs, {"admit", "decode_block"})
    # every dispatch the engine synced on is attributed exactly once
    assert len(prof.samples) == runs[0][1]


def test_profiling_is_sync_free_sched_under_preemption(models):
    """The scheduler's most dispatch-dense path: chunked prefill over a
    pool tight enough to force preemption."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (8,)).tolist(),
               rng.integers(0, 512, (5,)).tolist()]
    runs = _three_runs(models, JSched, TSched, prompts, 20, policy="fcfs",
                       prefix_cache=False, n_slots=2, seed=0, page_size=8,
                       decode_block=4, prefill_chunk=8, max_len=48,
                       n_pages=7)
    assert runs[1][3].stats.preemptions > 0
    assert runs[1][3].stats.preemptions == runs[2][3].stats.preemptions
    prof = _check(runs, {"admit", "prefill_chunk", "decode_block"})
    assert len(prof.samples) == runs[0][1]


def test_profiling_is_sync_free_spec_engine(models):
    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(3):
        pat = rng.integers(0, 512, (6,)).tolist()
        prompts.append(pat * 3 + rng.integers(0, 512, (3,)).tolist())
    runs = _three_runs(models, jspec.SpecEngine, tspec.SpecEngine, prompts,
                       16, spec="ngram", n_slots=2, max_len=96, seed=0,
                       page_size=8, decode_block=4, prefill_chunk=16,
                       policy="fcfs", prefix_cache=False)
    assert runs[1][3].spec_stats.verify_steps > 0
    prof = _check(runs, {s.kind for s in runs[2][2].samples})
    assert {"draft_propose", "spec_round"} <= {s.kind for s in prof.samples}


def test_profiling_is_sync_free_eager_engine(models):
    """The eager Engine: one admit sample a request (batch 1) and one
    decode_block sample (one step) a decode tick."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, (n,)).tolist() for n in (7, 12, 3)]
    runs = _three_runs(models, JEngine, TEngine, prompts, 6, n_slots=2,
                       max_len=64, seed=0)
    prof = _check(runs, {"admit", "decode_block"})
    assert sum(s.kind == "admit" for s in prof.samples) == 3
    assert all(s.steps == 1 for s in prof.samples)
    assert len(prof.samples) == runs[0][1]


# ---------------------------------------------------------------------------
# profiler mechanics


def test_disabled_profiler_is_noop_and_schema_safe():
    prof = DispatchProfiler(enabled=False)
    prof.bind(object())                      # never touches the cfg
    prof.record("admit", 0.0, 1.0, tokens=4)
    assert prof.samples == [] and prof.arm == ""
    m = MetricsRegistry()
    prof.export_gauges(m)
    assert m.snapshot()["gauges"] == {}      # no profile_* families


def test_profiler_arm_label_and_bucket(models):
    jcfg, _, tcfg, _ = models
    t, j = DispatchProfiler(enabled=True), JProfiler(enabled=True)
    t.bind(tcfg.with_(kv_cache_dtype="int8"), model_parallel=2)
    j.bind(jcfg.with_(kv_cache_dtype="int8"), model_parallel=2)
    assert t.arm == j.arm == "kv=int8,q=bf16:fused,k=4,mp=2"
    t.record("decode_block", 1.0, 1.5, steps=4, bucket=4)
    s = t.samples[0]
    assert s.arm.endswith(",b=4") and s.dur_s == pytest.approx(0.5)


def test_export_gauges_and_attainment(models):
    """``export_gauges`` writes the reference's three metric families; at
    one chip a single sample's attainment is its analytic roofline time
    over its measured time, the inverse of its drift ratio."""
    _, _, tcfg, tp = models
    prof = DispatchProfiler(enabled=True)
    eng = TPaged(TLM(tcfg, device="cpu"), tp, n_slots=2, max_len=64,
                 seed=0, page_size=8, decode_block=4, profiler=prof)
    _drive(eng, [list(range(6))], 8)
    tier = TIERS["h100-1"]
    summ = prof.summary(tier)
    assert summ
    for agg in summ.values():
        assert agg["count"] >= 1 and agg["seconds"] > 0
        assert agg["flops"] > 0 and agg["hbm_bytes"] > 0
        assert 0 < agg["attainment"] < 1     # a CPU never hits H100 peak
    m = MetricsRegistry()
    prof.export_gauges(m, tier)
    fams = {k.split("{")[0] for k in m.snapshot()["gauges"]}
    assert fams == {"profile_dispatch_seconds_total",
                    "profile_dispatch_count",
                    "profile_roofline_attainment"}
    for s in prof.samples:
        one = DispatchProfiler(enabled=True).bind(tcfg, layout="paged")
        one.samples.append(s)
        (agg,) = one.summary(tier).values()
        est = dispatch_estimate(tcfg, tier, kind=s.kind, tokens=s.tokens,
                                rows=s.rows, steps=s.steps, bucket=s.bucket,
                                ctx=s.ctx, layout="paged")
        assert agg["attainment"] == pytest.approx(est / s.dur_s, rel=1e-12)


# ---------------------------------------------------------------------------
# dispatch-level estimates and calibration


def test_dispatch_estimate_covers_all_kinds(models):
    _, _, tcfg, _ = models
    for kind in DISPATCH_KINDS:
        assert dispatch_estimate(tcfg, kind=kind, tokens=16, rows=2,
                                 steps=4, bucket=8, ctx=32) > 0, kind
    with pytest.raises(ValueError):
        dispatch_estimate(tcfg, kind="warp")
    one = dispatch_estimate(tcfg, kind="decode_block", rows=2, steps=1,
                            ctx=32)
    four = dispatch_estimate(tcfg, kind="decode_block", rows=2, steps=4,
                             ctx=32)
    assert four == pytest.approx(4 * one)
    # spec_decode="none" must not zero the draft estimate (a zero
    # prediction is uncalibratable)
    assert tcfg.spec_decode == "none"
    assert dispatch_estimate(tcfg, kind="draft_propose", rows=2, bucket=4,
                             ctx=32) > 0


def test_fit_profile_prequential_halves_median_error(models):
    """Samples at a consistent multiple of the analytic estimate: once the
    online corrections are in the loop the median relative error drops
    >= 2x (the first sample of a series is predicted uncorrected — the
    prequential part); the drift gauges export one series per (kind,
    arm)."""
    _, _, tcfg, _ = models
    prof = DispatchProfiler(enabled=True).bind(tcfg)
    rng = np.random.default_rng(7)
    for i in range(24):
        kind = ("admit", "decode_block")[i % 2]
        est = dispatch_estimate(tcfg, kind=kind, tokens=8, rows=2, steps=4,
                                bucket=8, ctx=32)
        prof.record(kind, 0.0, 50.0 * est * float(rng.uniform(0.9, 1.1)),
                    tokens=8, rows=2, steps=4, bucket=8, ctx=32)
    calib = CalibratedCostModel()
    recs = calib.fit_profile(prof, tcfg)
    assert len(recs) == 24
    assert recs[0]["calibrated_s"] == recs[0]["predicted_s"]

    def med_err(key):
        return float(np.median([abs(r[key] - r["measured_s"])
                                / r["measured_s"] for r in recs]))

    assert med_err("predicted_s") >= 2 * med_err("calibrated_s")
    m = MetricsRegistry()
    calib.register_metrics(m)
    g = m.snapshot()["gauges"]
    assert sum(k.startswith("costmodel_drift_ratio") for k in g) == 2
    assert all(math.isfinite(v) for v in g.values())


def test_calibration_feeds_back_into_predict(models):
    _, _, tcfg, _ = models
    eff = EfficiencyConfig.default()
    tier = TIERS["h100-1"]
    base = predict(tcfg, eff, tier, prompt=64, gen=32)
    c = CalibratedCostModel()
    c.update("decode_block", "arm", measured_s=3e-3, predicted_s=1e-3)
    assert c.phase_scale("decode") == pytest.approx(3.0)
    assert c.phase_scale("prefill") == 1.0
    cal = predict(tcfg, eff, tier, prompt=64, gen=32, calibration=c)
    assert cal["latency_ms"] > base["latency_ms"]
    assert cal["energy_j"] > base["energy_j"]

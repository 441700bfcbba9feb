"""Port parity: overload resilience (``repro_torch.resil`` and the resilient
scheduler tick) against ``repro.resil`` / ``repro.sched``.

* ``FaultInjector``: the same seed and call sequence give the same fault
  schedule, counts and mangled drafts as JAX's (one numpy generator,
  drawn in the same order), on its own and through the allocator.
* ``DegradationLadder``: the same pressure sequence gives the same rungs,
  pressures and transitions as JAX's; its rung surface; ``priced()``
  equal to JAX's at a tier built from the reference's peaks, on bf16 and
  int8 KV at both layouts.  The policies' retry-after hints (SJF's from
  the cost model) equal JAX's.
* ``SchedEngine`` under oom / fault / shrink chaos (spikes left out: they
  depend on the wall clock; backoff 0 for the same reason): the same
  per-request outcomes, streams, ``resil_*`` counters, injector counts,
  host syncs and free pages as JAX's, with retries to spare and with
  retries exhausted (``failed``, no crash).
* Port-only properties: faults off and an idle ladder are sync- and
  token-identical to the plain tick; a deadline retires ``timed_out``
  and frees the pages; the shed rung's ``retry_after_s`` grows with queue
  depth; draft mangling and the ``spec_off`` rung leave ``SpecEngine``'s
  greedy streams unchanged; a plain ``RuntimeError`` (a kernel fault on
  the card) propagates through the resilient tick.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import resil as jresil  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.sched import SchedEngine as JSched  # noqa: E402
from repro.sched.policy import make_policy as j_policy  # noqa: E402
from repro.serve.engine import Request as JReq  # noqa: E402
from repro.serve.paged import OutOfPagesError as JOutOfPages  # noqa: E402
from repro.serve.paged import PageAllocator as JAlloc  # noqa: E402
from repro_torch import resil as tresil  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry as TRegistry  # noqa: E402
from repro_torch.sched import SchedEngine as TSched  # noqa: E402
from repro_torch.sched.policy import make_policy as t_policy  # noqa: E402
from repro_torch.serve.engine import Request as TReq  # noqa: E402
from repro_torch.serve.paged import OutOfPagesError  # noqa: E402
from repro_torch.serve.paged import PageAllocator as TAlloc  # noqa: E402
from repro_torch.spec import SpecEngine  # noqa: E402

torch.manual_seed(0)

#: scheduler settings of the engine drives (a pool of 25 pages of 8)
SCHED_KW = dict(n_slots=2, max_len=96, seed=0, page_size=8,
                prefill_chunk=16, decode_block=4, policy="fcfs")


# ---------------------------------------------------------------------------
# injector


def _fault_schedule(mod, inj_kw, n=40):
    """Drive an injector through a fixed mix of hook calls; record what
    each call did (raised, or the mangled proposals)."""
    inj = mod.FaultInjector(5, **inj_kw)
    alloc = (JAlloc if mod is jresil else TAlloc)(12, 6, 2)
    out_of_pages = JOutOfPages if mod is jresil else OutOfPagesError
    alloc.injector = inj
    out = []
    for i in range(n):
        try:
            if i % 3 == 0:
                alloc.alloc(0, 1)
                alloc.release(0)
            else:
                inj.pre_dispatch(("admit", "decode_block")[i % 2])
            out.append("ok")
        except mod.InjectedFault as e:
            out.append(f"fault:{e.kind}")
        except out_of_pages as e:
            out.append(f"oom:{type(e).__name__}")
        props = {0: np.arange(3, dtype=np.int32), 1: None,
                 2: np.arange(2, dtype=np.int32)}
        mangled = inj.mangle_proposals(props, 4)
        out.append([None if v is None else v.tolist()
                    for _, v in sorted(mangled.items())])
    return out, dict(inj.counts), inj.describe()


@pytest.mark.parametrize("inj_kw", [
    dict(fault_p=0.3), dict(oom_p=0.4, fault_p=0.2, draft_p=0.3),
    dict(oom_p=0.2, shrink_pages=9, spike_p=0.2, spike_s=0.0,
         fault_p=0.1, draft_p=0.5)])
def test_injector_schedule_and_counts_match_jax(inj_kw):
    assert _fault_schedule(tresil, inj_kw) == _fault_schedule(jresil, inj_kw)


def test_injector_spec_and_taxonomy():
    spec = "seed=3,oom=0.5,fault=0.25,spike=0.1,spike_s=0.001,draft=0.3," \
           "shrink=2"
    t, j = (m.FaultInjector.from_spec(spec) for m in (tresil, jresil))
    assert t.describe() == j.describe() and t.enabled
    assert tresil.FaultInjector.from_spec("") is None
    assert not tresil.FaultInjector(0).enabled
    with pytest.raises(ValueError, match="unknown chaos knob"):
        tresil.FaultInjector.from_spec("bogus=1")
    assert tresil.OUTCOMES == jresil.OUTCOMES
    assert tresil.FAULT_KINDS == jresil.FAULT_KINDS
    assert issubclass(tresil.InjectedPageFault, OutOfPagesError)
    assert tresil.is_transient(tresil.InjectedFault("x", kind="admit"))
    assert tresil.is_transient(torch.OutOfMemoryError("out of memory"))
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: unspecified launch failure",
                "RESOURCE_EXHAUSTED"):
        assert not tresil.is_transient(RuntimeError(msg)), msg


# ---------------------------------------------------------------------------
# degradation ladder


def _ladder_trace(mod, registry_cls):
    m = registry_cls()
    g = {"depth": 0.0, "free": 20.0}
    m.gauge("serve_queue_depth", fn=lambda: g["depth"])
    m.gauge("serve_pages_total", fn=lambda: 25.0)
    m.gauge("serve_pages_free", fn=lambda: g["free"])
    ttft = m.histogram("serve_ttft_seconds", "submit -> first token")
    lad = mod.DegradationLadder(m, n_slots=2, slo_ttft=0.05,
                                dwell_ticks=2, cool_ticks=3)
    out = []
    rng = np.random.default_rng(0)
    for tick in range(60):
        calm = tick >= 45                  # then 15 calm ticks: it cools
        g["depth"] = 0.0 if calm else float(rng.integers(0, 7))
        g["free"] = 24.0 if calm else float(rng.integers(0, 25))
        for _ in range(0 if calm else int(rng.integers(0, 3))):
            ttft.observe(float(rng.uniform(0.0, 0.12)))
        out.append((lad.update(), round(lad.last_pressure, 12),
                    lad.transitions, lad.name))
    return out


def test_ladder_hysteresis_matches_jax():
    """Queue depth, page occupancy and TTFT misses against a 50 ms SLO,
    drawn at random for 45 ticks, then 15 calm ones: the same rungs,
    pressures and transitions, and the trace climbs and falls."""
    t = _ladder_trace(tresil, TRegistry)
    assert t == _ladder_trace(jresil, JRegistry)
    rungs = [r for r, *_ in t]
    assert max(rungs) >= 2 and rungs[-1] < max(rungs)


def test_ladder_rung_surface_and_pricing_waits_for_a5():
    lad = tresil.DegradationLadder(TRegistry(), n_slots=2)
    jlad = jresil.DegradationLadder(JRegistry(), n_slots=2)
    for rung, name in enumerate(tresil.RUNG_NAMES):
        lad.rung = jlad.rung = rung
        for f in (lambda x: x.name, lambda x: x.spec_off,
                  lambda x: x.chunk_for(64, 8), lambda x: x.chunk_for(8, 8),
                  lambda x: x.kv_dtype_hint, lambda x: x.shed,
                  lambda x: x.draft_k_cap(6)):
            assert f(lad) == f(jlad)
    # the cost model's price of every rung, as JAX's (qwen2-1.5b at full
    # width, a spec arm on the config so that the spec_off rung moves it)
    from repro.configs import get_config as j_full
    from repro_torch.configs import get_config as t_full
    tier = _cost_tier()
    for kv in ("bfloat16", "int8"):
        for layout in ("contiguous", "paged"):
            jc = j_full("qwen2-1.5b").with_(
                kv_cache_dtype=kv, spec_decode="ngram",
                decode_attn_impl="paged_pallas" if layout == "paged"
                else "eager")
            tc = t_full("qwen2-1.5b").with_(kv_cache_dtype=kv,
                                            spec_decode="ngram")
            for kw in (dict(), dict(prompt=3000, gen=128, base_chunk=512,
                                    page_size=256),
                       dict(prompt=40, gen=8, base_chunk=16, page_size=8)):
                rows = lad.priced(tc, tier, layout=layout, **kw)
                assert rows == jlad.priced(jc, "v5e-1", **kw)
                assert [r["name"] for r in rows] == list(tresil.RUNG_NAMES)
            assert rows[1]["t_decode_tok_s"] > rows[0]["t_decode_tok_s"]


def _cost_tier():
    """The reference's v5e-1 tier with its ``HW`` peaks, as a port tier
    (the port itself carries only ``h100-1``)."""
    from repro.core.costmodel import TIERS
    from repro.launch.mesh import HW
    from repro_torch.core.costmodel import HwTier
    jt = TIERS["v5e-1"]
    return HwTier(jt.name, jt.chips, jt.mem_cap, jt.power_budget,
                  peak_flops_bf16=HW["peak_flops_bf16"],
                  peak_flops_int8=HW["peak_flops_int8"], hbm_bw=HW["hbm_bw"],
                  link_bw=HW["ici_bw_per_link"], links=HW["ici_links"],
                  tdp_watts=HW["tdp_watts"], idle_watts=HW["idle_watts"])


@pytest.mark.parametrize("name", ["fcfs", "sjf", "edf"])
def test_retry_after_matches_jax(name):
    """Retry-after hints equal JAX's at every queue depth; SJF's is its
    cost-model estimate of the shed request times its rank (qwen2-1.5b
    at full width, at a tier built from the reference's peaks)."""
    from repro.configs import get_config as j_full
    from repro_torch.configs import get_config as t_full
    tp = t_policy(name, slo_ttft=0.2, cfg=t_full("qwen2-1.5b"),
                  tier=_cost_tier())
    jp = j_policy(name, slo_ttft=0.2, cfg=j_full("qwen2-1.5b"),
                  tier="v5e-1")
    for depth in (0, 1, 2, 7):
        for now in (100.0, 100.1, 100.5):
            for plen, new in ((16, 32), (3000, 256)):
                t = TReq(rid=0, prompt=np.zeros(plen, np.int32),
                         max_new_tokens=new, t_submit=100.0)
                j = JReq(rid=0, prompt=np.zeros(plen, np.int32),
                         max_new_tokens=new, t_submit=100.0)
                assert tp.retry_after(t, now, depth) == \
                    jp.retry_after(j, now, depth)


# ---------------------------------------------------------------------------
# resilient scheduler


@pytest.fixture(scope="module")
def models():
    """The smoke qwen2 in float32 on both sides, one parameter tree."""
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32")
    jlm = JLM(jcfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    tcfg = t_smoke("qwen2-1.5b").with_(dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return (jlm, jp), (TLM(tcfg, device="cpu"), tp)


def _prompts(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(k),)).tolist()
            for k in rng.integers(10, 40, n)]


def _drive(eng, prompts, max_new=7):
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = eng.run_to_completion()
    return ([done[i].out_tokens for i in ids],
            [done[i].outcome for i in ids])


def _resil_state(eng, prompts, max_new=7):
    streams, outcomes = _drive(eng, prompts, max_new)
    c = eng.metrics.snapshot()["counters"]
    return {"streams": streams, "outcomes": outcomes,
            "resil": {k: v for k, v in c.items() if k.startswith("resil")},
            "counts": dict(eng.injector.counts), "syncs": eng.sync_count,
            "free": len(eng.alloc.free),
            "held": len(eng.prefix.nodes) if eng.prefix else 0}


@pytest.mark.parametrize("spec,retries", [
    ("seed=0,oom=0.05,fault=0.1,shrink=4", 50), ("seed=1,fault=0.4", 1)])
def test_sched_chaos_matches_jax(models, spec, retries):
    (jlm, jp), (tlm, tp) = models
    prompts = _prompts(jlm.cfg.vocab_size)
    kw = dict(SCHED_KW, max_retries=retries, backoff_s=0.0)
    j = _resil_state(JSched(jlm, jp, injector=jresil.FaultInjector.from_spec(
        spec), **kw), prompts)
    t = _resil_state(TSched(tlm, tp, injector=tresil.FaultInjector.from_spec(
        spec), **kw), prompts)
    assert t == j
    assert t["counts"]["dispatch"] > 0
    assert t["resil"]["resil_recovered_total"] > 0
    # every page is free or held by the prefix cache
    assert t["free"] + t["held"] == 25 - 1
    if retries > 1:
        assert t["outcomes"] == ["ok"] * len(prompts)
        assert t["streams"] == _drive(TSched(tlm, tp, **SCHED_KW),
                                      prompts)[0]
    else:
        assert "failed" in t["outcomes"]


def test_faults_off_and_idle_ladder_are_identical(models):
    """A disabled injector draws nothing; an idle ladder (4 requests on 2
    slots: pressure <= 0.5) never moves: the streams and host syncs of
    the plain tick."""
    _, (tlm, tp) = models
    prompts = _prompts(tlm.cfg.vocab_size, n=4, seed=2)
    runs = []
    for extra in ({}, {"injector": tresil.FaultInjector(0)},
                  {"ladder": True}):
        eng = TSched(tlm, tp, **SCHED_KW, **extra)
        runs.append((_drive(eng, prompts), eng.sync_count))
        assert eng.resilient == ("ladder" in extra)
    assert runs[0] == runs[1] == runs[2]
    assert eng.ladder.rung == 0 and eng.ladder.transitions == 0


def test_retries_exhausted_fail_without_crash(models):
    _, (tlm, tp) = models
    prompts = _prompts(tlm.cfg.vocab_size, n=4, seed=3)
    inj = tresil.FaultInjector(0, fault_p=1.0)
    eng = TSched(tlm, tp, injector=inj, max_retries=2, backoff_s=0.0,
                 prefix_cache=False, **SCHED_KW)
    streams, outcomes = _drive(eng, prompts)
    assert outcomes == ["failed"] * 4 and streams == [[]] * 4
    c = eng.metrics.snapshot()["counters"]
    assert c["resil_failed_total"] == 4
    assert c['resil_requests_total{outcome="failed"}'] == 4
    assert len(eng.alloc.free) == eng.alloc.n_pages - 1


def test_deadline_times_out_and_frees_pages(models):
    """Two requests in flight and two queued when the deadline passes:
    all four retire ``timed_out`` at the next tick and every page is
    freed (the deadline is lowered mid-drive so that the wall clock does
    not decide who is in flight)."""
    _, (tlm, tp) = models
    prompts = _prompts(tlm.cfg.vocab_size, n=4, seed=4)
    eng = TSched(tlm, tp, max_request_s=1e9, prefix_cache=False, **SCHED_KW)
    ids = [eng.submit(p, max_new_tokens=30) for p in prompts]
    for _ in range(3):
        eng.step()
    assert len(eng.active) + len(eng._prefilling) == 2 and eng.queue
    assert len(eng.alloc.free) < eng.alloc.n_pages - 1
    eng.max_request_s = 0.0
    eng.run_to_completion()
    assert [eng.registry[i].outcome for i in ids] == ["timed_out"] * 4
    c = eng.metrics.snapshot()["counters"]
    assert c["resil_timeouts_total"] == 4
    assert sum(c[f'resil_requests_total{{outcome="{o}"}}']
               for o in tresil.OUTCOMES) == 4
    assert len(eng.alloc.free) == eng.alloc.n_pages - 1


def test_shed_rung_retry_after_grows_with_depth(models):
    """24 requests on 2 slots with the ladder on: the rung climbs to
    ``shed``; every shed request carries a retry-after > 0 that grows
    with its FCFS rank, and the outcomes sum to the requests."""
    _, (tlm, tp) = models
    prompts = _prompts(tlm.cfg.vocab_size, n=24, seed=5)
    eng = TSched(tlm, tp, ladder=True, **SCHED_KW)
    ids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    rungs = set()
    while eng.queue or eng.active or eng._prefilling:
        eng.step()
        rungs.add(eng.ladder.rung)
    assert max(rungs) == 4
    reqs = [eng.registry[i] for i in ids]
    shed = [r for r in reqs if r.outcome == "shed"]
    assert shed and all(r.retry_after_s > 0 for r in shed)
    hints = [r.retry_after_s for r in shed]         # FCFS rank = rid order
    assert hints == sorted(hints) and hints[-1] > hints[0]
    c = eng.metrics.snapshot()["counters"]
    assert c["resil_shed_total"] == len(shed)
    assert sum(r.outcome in tresil.OUTCOMES for r in reqs) == 24
    assert {r.outcome for r in reqs} <= {"ok", "shed"}


def test_spec_engine_mangled_drafts_and_spec_off_keep_streams(models):
    """n-gram speculation with 30% of the proposals replaced by garbage,
    and with the ladder held at ``spec_off`` (every round falls back to
    plain decode): the plain scheduler's greedy streams."""
    _, (tlm, tp) = models
    rng = np.random.default_rng(6)
    base = rng.integers(0, tlm.cfg.vocab_size, (8,)).tolist()
    prompts = [base * 4 + rng.integers(0, tlm.cfg.vocab_size,
                                       (3,)).tolist() for _ in range(3)]
    want = _drive(TSched(tlm, tp, **SCHED_KW), prompts, 12)[0]
    inj = tresil.FaultInjector(0, draft_p=0.3)
    eng = SpecEngine(tlm, tp, spec="ngram", draft_k=4, adaptive=False,
                     injector=inj, **SCHED_KW)
    assert _drive(eng, prompts, 12)[0] == want
    assert inj.counts["draft"] > 0 and eng.spec_stats.verify_steps > 0
    held = tresil.DegradationLadder(TRegistry(), n_slots=2, high=2.0,
                                    low=-1.0)
    held.rung = 1
    eng = SpecEngine(tlm, tp, spec="ngram", draft_k=4, adaptive=False,
                     ladder=held, **SCHED_KW)
    assert _drive(eng, prompts, 12)[0] == want
    assert eng.spec_stats.verify_steps == 0
    assert eng.spec_stats.fallback_steps > 0


def test_kernel_fault_propagates_through_the_resilient_tick(models):
    """A plain RuntimeError from a dispatch (how torch reports a sticky
    CUDA error) is never recovered: the resilient tick lets it out."""
    _, (tlm, tp) = models
    inj = tresil.FaultInjector(0, oom_p=1e-9)
    eng = TSched(tlm, tp, injector=inj, **SCHED_KW)

    def launch_failure(*a, **k):
        raise RuntimeError("CUDA error: unspecified launch failure")
    eng._decode_impl = launch_failure
    eng.submit(_prompts(tlm.cfg.vocab_size, n=1)[0], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="launch failure"):
        eng.run_to_completion()

"""Port parity: the port's ``SchedEngine`` against JAX's ``SchedEngine`` on
``test_sched.py``'s engine workloads (cold FCFS, warm vs cold shared
prefix, the tight-pool preemption, the long prompt chunked at 16, EDF
urgent-first), in float32 configs, with JAX run at both
``chunk_prefill_impl`` values.  Held equal: greedy streams, ``sync_count``,
``SchedStats``, prefix-cache stats, the ``serve_*`` / ``sched_*`` /
``prefix_*`` counters, preemption counts and the page pool at the end.

The long prompt is held to JAX's scheduler at the same chunk size, not to
one-shot prefill: at this trace chunking order flips a greedy near-tie on
both sides (ROADMAP C).  Also: the prefix cache and the policies against
JAX's, and the cost-model policies (SJF, EDF's admission control) priced
at a tier built from the reference's peaks, alone and driving the engine.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.sched import PrefixCache as JPrefix  # noqa: E402
from repro.sched import SchedEngine as JSched  # noqa: E402
from repro.sched import make_policy as j_policy  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.serve.engine import Request as JReq  # noqa: E402
from repro.serve.paged import PageAllocator as JAlloc  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.sched import PrefixCache as TPrefix  # noqa: E402
from repro_torch.sched import SchedEngine as TSched  # noqa: E402
from repro_torch.sched import make_policy as t_policy  # noqa: E402
from repro_torch.serve.engine import PagedEngine as TPaged  # noqa: E402
from repro_torch.serve.engine import Request as TReq  # noqa: E402
from repro_torch.serve.paged import PageAllocator as TAlloc  # noqa: E402

torch.manual_seed(0)

#: counters both engines must agree on (wall-clock series excluded)
COUNTERS = ("serve_requests_submitted_total", "serve_requests_retired_total",
            "serve_tokens_emitted_total", "serve_host_syncs_total",
            "serve_decode_steps_total", "serve_decode_tokens_total",
            "serve_eos_total", "serve_kv_requant_events_total",
            "serve_prefill_dispatches_total",
            "serve_decode_dispatches_total",
            "sched_admitted_total", "sched_preemptions_total",
            "sched_chunks_total", "sched_prefill_tokens_total",
            "sched_prefix_hit_tokens_total", "sched_slo_rejected_total")
PREFIX_COUNTERS = ("prefix_lookups_total", "prefix_hits_total",
                   "prefix_hit_tokens_total", "prefix_inserted_total",
                   "prefix_evicted_total")


@pytest.fixture(scope="module")
def models():
    """The smoke qwen2 in float32 on both sides, one parameter tree."""
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32")
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    tcfg = t_smoke("qwen2-1.5b").with_(dtype="float32")
    tlm = TLM(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tlm, tp


def _prompts(vocab, name):
    """``test_sched.py``'s prompts for each workload, drawn as there from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    if name == "cold":
        return [rng.integers(0, vocab, (n,)).tolist()
                for n in (8, 5, 12, 8, 3)]
    if name == "shared":
        shared = rng.integers(0, vocab, (24,)).tolist()
        return [shared + rng.integers(0, vocab,
                                      (int(rng.integers(3, 8)),)).tolist()
                for _ in range(6)]
    if name == "preempt":
        return [rng.integers(0, vocab, (8,)).tolist(),
                rng.integers(0, vocab, (5,)).tolist()]
    if name == "long":
        long_p = rng.integers(0, vocab, (40,)).tolist()
        short_p = rng.integers(0, vocab, (6,)).tolist()
        return [short_p, long_p]
    if name == "edf":
        return [rng.integers(0, vocab, (8,)).tolist(),
                rng.integers(0, vocab, (8,)).tolist()]
    raise ValueError(name)


#: workload -> (engine kwargs, per-request submit kwargs)
WORKLOADS = {
    "cold": (dict(policy="fcfs", prefix_cache=False), [dict(
        max_new_tokens=9)] * 5),
    "shared_warm": (dict(policy="fcfs", prefix_cache=True),
                    [dict(max_new_tokens=8)] * 6),
    "shared_cold": (dict(policy="fcfs", prefix_cache=False),
                    [dict(max_new_tokens=8)] * 6),
    "preempt_tight": (dict(policy="fcfs", prefix_cache=False,
                           prefill_chunk=8, max_len=48, n_pages=7),
                      [dict(max_new_tokens=20)] * 2),
    "preempt_ample": (dict(policy="fcfs", prefix_cache=False,
                           prefill_chunk=8, max_len=48),
                      [dict(max_new_tokens=20)] * 2),
    "long": (dict(policy="fcfs", prefix_cache=False, prefill_chunk=16),
             [dict(max_new_tokens=12)] * 2),
    # the urgent request's 1 µs TTFT target is missed on any machine
    "edf": (dict(policy="edf", prefix_cache=False, n_slots=1),
            [dict(max_new_tokens=4, slo_ttft=10.0),
             dict(max_new_tokens=4, slo_ttft=1e-6)]),
}


def _drive(cls, lm, params, name):
    kw, submit_kw = WORKLOADS[name]
    kw = {"n_slots": 2, "max_len": 64, "seed": 0, "page_size": 8,
          "decode_block": 4, "prefill_chunk": 16, **kw}
    eng = cls(lm, params, **kw)
    prompts = _prompts(lm.cfg.vocab_size, name.split("_")[0])
    ids = [eng.submit(p, **s) for p, s in zip(prompts, submit_kw)]
    done = eng.run_to_completion()
    return eng, [done[i] for i in ids]


_port_runs = {}


def _port(models, name):
    """The port's run of a workload, made once per module."""
    if name not in _port_runs:
        _, _, tlm, tp = models
        _port_runs[name] = _drive(TSched, tlm, tp, name)
    return _port_runs[name]


def _counters(eng):
    snap = eng.metrics.snapshot()["counters"]
    names = COUNTERS + (PREFIX_COUNTERS if eng.prefix is not None else ())
    out = {k: snap[k] for k in names}
    for o in ("ok", "shed", "timed_out", "failed"):
        key = f'resil_requests_total{{outcome="{o}"}}'
        out[key] = snap[key]
    return out


@pytest.mark.parametrize("impl", ["fused", "eager"])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_sched_engine_matches_jax(models, name, impl):
    jcfg, jp, _, _ = models
    jeng, jreqs = _drive(JSched, JLM(jcfg.with_(chunk_prefill_impl=impl)),
                         jp, name)
    teng, treqs = _port(models, name)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert [r.prefix_hit_tokens for r in treqs] == \
        [r.prefix_hit_tokens for r in jreqs]
    assert teng.sync_count == jeng.sync_count
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert _counters(teng) == _counters(jeng)
    if jeng.prefix is not None:
        assert teng.prefix.stats() == jeng.prefix.stats()
    # the pool at the end: same free pages, same references (the prefix
    # cache keeps its pages)
    assert sorted(teng.alloc.free) == sorted(jeng.alloc.free)
    np.testing.assert_array_equal(teng.alloc.refs, jeng.alloc.refs)
    tel_t, tel_j = teng.telemetry(), jeng.telemetry()
    for key in ("admitted", "preemptions", "chunks", "prefill_tokens",
                "prefix_hit_tokens", "policy", "prefix", "sync_count"):
        assert tel_t[key] == tel_j[key], key


def test_sched_workloads_keep_the_reference_properties(models):
    """What ``test_sched.py`` asserts of each workload holds for the
    port's runs too (syncs = chunk dispatches + decode blocks; warm ==
    cold with >= 2x fewer prefill tokens; the tight pool preempts and
    drains; the long prompt takes >= 3 chunks; EDF admits the urgent
    request first and misses only its TTFT)."""
    eng, reqs = _port(models, "cold")
    assert eng.sync_count == eng.stats.chunks \
        + eng.steps_dispatched // eng.decode_block
    assert all(r.t_admit is not None for r in reqs)
    warm, wreqs = _port(models, "shared_warm")
    cold, creqs = _port(models, "shared_cold")
    assert [r.out_tokens for r in wreqs] == [r.out_tokens for r in creqs]
    assert cold.stats.prefill_tokens / warm.stats.prefill_tokens >= 2.0
    st = warm.prefix.stats()
    assert st["hits"] >= 4 and st["hit_tokens"] >= 4 * 24
    tight, treqs = _port(models, "preempt_tight")
    ample, areqs = _port(models, "preempt_ample")
    assert tight.stats.preemptions > 0 and ample.stats.preemptions == 0
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in areqs]
    assert len(tight.alloc.free) == tight.alloc.n_pages - 1
    long_eng, _ = _port(models, "long")
    assert long_eng.stats.chunks >= 3
    edf, (relaxed, urgent) = _port(models, "edf")
    assert urgent.t_first < relaxed.t_first
    assert urgent.t_admit <= relaxed.t_admit
    assert edf.telemetry()["slo"] == {"ttft_attainment": 0.5,
                                      "tpot_attainment": None}


def test_sched_fcfs_single_chunk_matches_paged_engine(models):
    """FCFS without a prefix cache on prompts that fit one chunk gives
    the port's ``PagedEngine`` streams."""
    _, _, tlm, tp = models
    peng = TPaged(tlm, tp, n_slots=2, max_len=64, seed=0, page_size=8,
                  decode_block=4)
    prompts = _prompts(tlm.cfg.vocab_size, "cold")
    ids = [peng.submit(p, max_new_tokens=9) for p in prompts]
    done = peng.run_to_completion()
    _, reqs = _port(models, "cold")
    assert [done[i].out_tokens for i in ids] == [r.out_tokens for r in reqs]


def test_sched_tracing_is_sync_free_under_preemption(models):
    """Chunk spans, preempt instants and readmit queue spans change
    neither the streams nor the sync count."""
    from repro_torch.obs import Tracer
    _, _, tlm, tp = models
    kw, submit_kw = WORKLOADS["preempt_tight"]
    tr = Tracer(enabled=True)
    eng = TSched(tlm, tp, n_slots=2, seed=0, page_size=8, decode_block=4,
                 tracer=tr, **kw)
    ids = [eng.submit(p, **s) for p, s in
           zip(_prompts(tlm.cfg.vocab_size, "preempt"), submit_kw)]
    done = eng.run_to_completion()
    base, breqs = _port(models, "preempt_tight")
    assert [done[i].out_tokens for i in ids] == \
        [r.out_tokens for r in breqs]
    assert eng.sync_count == base.sync_count
    assert any(e.get("ph") == "i" and e["name"] == "preempt"
               for e in tr.events)


# ---------------------------------------------------------------------------
# prefix cache and policies against JAX's


def test_prefix_cache_matches_jax():
    """The same insert / lookup / evict sequence over the same allocator
    state gives the reference's hits, pages, stats and references,
    including the ``len - 1`` lookup cap and LRU leaf eviction."""
    page = 4
    caches = []
    for alloc_cls, cache_cls in ((JAlloc, JPrefix), (TAlloc, TPrefix)):
        al = alloc_cls(n_pages=16, max_pages_per_slot=4, n_slots=3)
        caches.append((al, cache_cls(al, page)))
    rng = np.random.default_rng(7)
    a = rng.integers(0, 100, (12,)).tolist()
    b = a[:8] + rng.integers(0, 100, (5,)).tolist()
    outs = []
    for al, pc in caches:
        log = []
        pages_a = al.alloc(0, 3)
        pc.insert(np.asarray(a), pages_a)
        log.append(pc.lookup(a))                  # capped: 11 tokens -> 2
        log.append(pc.lookup(a + [1]))            # full 12 tokens -> 3
        log.append(pc.lookup(b))                  # shares 2 pages
        log.append(pc.lookup(a[:4]))              # 3 tokens -> no page
        hit, shared = pc.lookup(b, count=False)
        al.assign(1, shared, 2)
        pc.insert(np.asarray(b), al.owned(1))
        al.release(0)
        log.append(pc.evict_pages(1))             # a's leaf: cache-only
        al.release(1)
        log.append(pc.evict_pages(10))            # the rest, leaves first
        pc.count_lookup(8)
        log.append(pc.stats())
        log.append((sorted(al.free), al.refs.tolist(), len(pc.nodes)))
        outs.append(log)
    assert outs[0] == outs[1]


def _req(cls, rid, t_submit, slo=None):
    return cls(rid=rid, prompt=np.zeros(8, np.int32), max_new_tokens=8,
               t_submit=t_submit, slo_ttft=slo)


@pytest.mark.parametrize("name", ["fcfs", "edf"])
def test_policy_order_matches_jax(name):
    """Admission order, preemption victim and EDF's deadline-passed drop
    agree with the reference's policies."""
    spec = [(0, 1.0, 0.5), (1, 0.5, 2.0), (2, 2.0, None), (3, 0.6, 0.1)]
    outs = []
    for make, req_cls in ((j_policy, JReq), (t_policy, TReq)):
        pol = make(name, slo_ttft=1.0)
        reqs = [_req(req_cls, *s) for s in spec]
        outs.append(([r.rid for r in sorted(
            reqs, key=lambda r: pol.priority(r, 3.0))],
            max(reqs, key=lambda r: pol.victim(r, 3.0)).rid,
            [pol.admit_drop(r, 1.0) for r in reqs]))
    assert outs[0] == outs[1]


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


def _cost_reqs(cls):
    """Requests of 8 / 500 / 3,000 tokens, some part-prefilled or
    mid-stream (a readmit's recompute counts), some with their own SLO."""
    out = []
    for rid, (plen, new, progress, gen, t_sub, slo) in enumerate((
            (8, 4, 0, 0, 0.0, None), (500, 64, 0, 0, 0.2, 0.01),
            (3000, 16, 1024, 0, 0.0, 0.05), (500, 128, 0, 30, 0.1, None),
            (3000, 512, 0, 0, 0.4, 0.002), (8, 256, 8, 100, 0.3, 1.0))):
        r = cls(rid=rid, prompt=np.zeros(plen, np.int32), max_new_tokens=new,
                t_submit=t_sub, slo_ttft=slo)
        r.progress = progress
        r.out_tokens = list(range(gen))
        out.append(r)
    return out


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_cost_model_parts_raise_until_ported(kv, layout):
    """SJF and EDF's admission check now price with the cost model: with
    a tier built from the reference's peaks, qwen2-1.5b at full width
    (estimates of milliseconds) and ``now`` fixed, SJF's remaining
    service, admission order (aging included), victim and retry-after,
    and EDF's order and ``admit_drop`` equal JAX's policies', on bf16 and
    int8 KV at both layouts (JAX prices the paged one through
    ``decode_attn_impl``).  Some drops come from the cost model alone
    (deadline not yet passed)."""
    from repro.configs import get_config as j_full
    from repro_torch.configs import get_config as t_full
    tier = _cost_tier()
    jc = j_full("qwen2-1.5b").with_(
        kv_cache_dtype=kv,
        decode_attn_impl="paged_pallas" if layout == "paged" else "eager")
    tc = t_full("qwen2-1.5b").with_(kv_cache_dtype=kv)
    kw = dict(slo_ttft=0.02, prefill_chunk=512)
    jr, tr = _cost_reqs(JReq), _cost_reqs(TReq)
    cost_drops = 0
    for name in ("sjf", "edf"):
        jp = j_policy(name, cfg=jc, tier="v5e-1", **kw)
        tp = t_policy(name, cfg=tc, tier=tier, layout=layout, **kw)
        for now in (0.0, 0.03, 0.205, 0.39, 5.0):
            assert [r.rid for r in sorted(
                tr, key=lambda r: tp.priority(r, now))] == \
                [r.rid for r in sorted(jr, key=lambda r: jp.priority(r, now))]
            assert [tp.priority(t, now) for t in tr] == \
                [jp.priority(j, now) for j in jr]
            assert max(tr, key=lambda r: tp.victim(r, now)).rid == \
                max(jr, key=lambda r: jp.victim(r, now)).rid
            drops = [tp.admit_drop(t, now) for t in tr]
            assert drops == [jp.admit_drop(j, now) for j in jr]
            if name == "edf":
                cost_drops += sum(d and now < tp.deadline(t)
                                  for d, t in zip(drops, tr))
            for depth in (0, 1, 5):
                assert [tp.retry_after(t, now, depth) for t in tr] == \
                    [jp.retry_after(j, now, depth) for j in jr]
        if name == "sjf":
            assert [tp.remaining_s(t) for t in tr] == \
                [jp.remaining_s(j) for j in jr]
    assert cost_drops > 0
    with pytest.raises(ValueError, match="sjf needs the model config"):
        t_policy("sjf")
    with pytest.raises(ValueError, match="unknown policy"):
        t_policy("lifo")


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


#: cost-model policy drives: (engine kwargs, workload prompts, submit kw)
COST_DRIVES = {
    # 5 prompts of 3-12 tokens on 2 slots: SJF admits the shortest first
    "sjf_cold": (dict(policy="sjf", prefix_cache=False), "cold",
                 [dict(max_new_tokens=9)] * 5),
    # the tight pool: SJF's victim is the longest remaining job
    "sjf_preempt": (dict(policy="sjf", prefix_cache=False, prefill_chunk=8,
                         max_len=48, n_pages=7), "preempt",
                    [dict(max_new_tokens=20)] * 2),
    # EDF + admission control on one slot: the request whose deadline
    # passed before admission is rejected, the others are served
    "edf_admission": (dict(policy="edf", prefix_cache=False, n_slots=1,
                           admission_control=True), "cold",
                      [dict(max_new_tokens=6, slo_ttft=s)
                       for s in (60.0, -1.0, 60.0, -1.0, 60.0)]),
}


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("drive", sorted(COST_DRIVES))
def test_cost_model_policies_drive_like_jax(models, drive, kv):
    """The float32 ``SchedEngine`` under SJF and under EDF with admission
    control gives JAX's streams, syncs, ``SchedStats`` (``slo_rejected``
    included), counters and rejections, on bf16 and int8 pools; each
    engine builds its own policy (config, tier, chunk, and the paged
    layout on the port's side), and both price every request alike.
    SJF's aging is set to 0 on both sides, so that the order depends on
    the estimates alone and not on the wall clock."""
    jcfg, jp, tlm, tp = models
    kw, wl, submit_kw = COST_DRIVES[drive]
    kw = {"n_slots": 2, "max_len": 64, "seed": 0, "page_size": 8,
          "decode_block": 4, "prefill_chunk": 16, **kw}
    runs = []
    for cls, lm, params, tier in (
            (JSched, JLM(jcfg.with_(kv_cache_dtype=kv)), jp, "v5e-1"),
            (TSched, TLM(tlm.cfg.with_(kv_cache_dtype=kv), device="cpu"),
             tp, _cost_tier())):
        with pytest.MonkeyPatch.context() as mp:
            # JAX's requant count over real pages only, as the port counts
            mp.setattr(j_engine, "_kv_scale_change_count",
                       _real_page_scale_changes)
            eng = cls(lm, params, tier=tier, **kw)
            if eng.policy.name == "sjf":
                eng.policy.aging = 0.0
            prompts = _prompts(lm.cfg.vocab_size, wl)
            ids = [eng.submit(p, **s) for p, s in zip(prompts, submit_kw)]
            done = eng.run_to_completion()
        runs.append((eng, [done[i] for i in ids]))
    (jeng, jreqs), (teng, treqs) = runs
    assert teng.policy.layout == "paged"
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.rejected for r in treqs] == [r.rejected for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert teng.sync_count == jeng.sync_count
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert _counters(teng) == _counters(jeng)
    if drive == "edf_admission":
        assert teng.stats.slo_rejected == 2
        assert all(r.out_tokens == [] for r in treqs if r.rejected)
        assert all(len(r.out_tokens) == 6 for r in treqs if not r.rejected)
    else:
        assert [teng.policy.remaining_s(t) for t in treqs] == \
            [jeng.policy.remaining_s(j) for j in jreqs]
    if drive == "sjf_preempt":
        assert teng.stats.preemptions > 0
    assert sorted(teng.alloc.free) == sorted(jeng.alloc.free)


def test_chunk_must_be_a_page_multiple(models):
    _, _, tlm, tp = models
    with pytest.raises(ValueError, match="multiple of page_size"):
        TSched(tlm, tp, n_slots=1, max_len=32, page_size=8, prefill_chunk=12)


def test_launch_serve_policy_on_cpu(capsys):
    """``--policy`` serves through the scheduler on the CPU and prints its
    telemetry."""
    from repro_torch.launch.serve import main
    assert main(["--smoke", "--policy", "fcfs", "--device", "cpu",
                 "--requests", "3", "--prompt-len", "20", "--max-new", "4",
                 "--slots", "2", "--max-len", "64", "--page-size", "8",
                 "--prefill-chunk", "16", "--decode-block", "4"]) == 0
    out = capsys.readouterr().out
    assert "sched/fcfs" in out and "sched telemetry" in out

"""Host decisions that read the clock, under a model axis of 2: every
rank reads rank 0's clock (``serve.engine.shared_clock``), so that SJF's
aging, EDF, admission control, the degradation ladder, request
deadlines, chaos recovery's backoff, ``spec_slack_s`` and open-loop
arrivals decide alike on every rank.

One 2-rank gloo world (float32 smoke qwen2 on JAX's weights) is started
for the module; rank 1's own clock runs an hour ahead and 1.5x as fast,
and rank 0's readings are recorded.  (i) The drives whose decisions do
not depend on the clock (``test_torch_sched.py``'s cost-model drives,
``test_torch_resil.py``'s chaos drives at backoff 0, the spec EDF gate)
give JAX's single-device streams, outcomes, syncs and counters on both
ranks.  (ii) Drives whose decisions read the clock give equal streams,
outcomes, admission orders, rung traces and syncs on both ranks, and one
rank replaying rank 0's readings gives the same; each shows the
decision it exercises.  (iii) ``launch.serve --model-parallel 2`` with
every clock-reading option exits 0 with equal ranks.  A sharded FCFS
drive reads no shared clock."""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _host_decision_arms as arms  # noqa: E402
from repro import resil as jresil  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.sched import SchedEngine as JSched  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.resil import OUTCOMES  # noqa: E402

#: counters the cost-model drives must share with JAX's engine
#: (``test_torch_sched.py``'s list, wall-clock series excluded)
COUNTERS = ("serve_requests_submitted_total", "serve_requests_retired_total",
            "serve_tokens_emitted_total", "serve_host_syncs_total",
            "serve_decode_steps_total", "serve_decode_tokens_total",
            "serve_eos_total", "serve_kv_requant_events_total",
            "serve_prefill_dispatches_total",
            "serve_decode_dispatches_total",
            "sched_admitted_total", "sched_preemptions_total",
            "sched_chunks_total", "sched_prefill_tokens_total",
            "sched_prefix_hit_tokens_total", "sched_slo_rejected_total") + \
    tuple(f'resil_requests_total{{outcome="{o}"}}' for o in OUTCOMES)


def _cost_tier():
    """The reference's v5e-1 tier with its ``HW`` peaks, as a port tier
    (as ``test_torch_sched.py`` builds it)."""
    from repro.core.costmodel import TIERS
    from repro.launch.mesh import HW
    from repro_torch.core.costmodel import HwTier
    jt = TIERS["v5e-1"]
    return HwTier(jt.name, jt.chips, jt.mem_cap, jt.power_budget,
                  peak_flops_bf16=HW["peak_flops_bf16"],
                  peak_flops_int8=HW["peak_flops_int8"], hbm_bw=HW["hbm_bw"],
                  link_bw=HW["ici_bw_per_link"], links=HW["ici_links"],
                  tdp_watts=HW["tdp_watts"], idle_watts=HW["idle_watts"])


def _cost_arm(kw, prompts, submit) -> dict:
    return {"engine": "sched",
            "kw": {"max_len": 64, "prefix_cache": False, **kw},
            "requests": [(0, ("cost", prompts, i), s)
                         for i, s in enumerate(submit)]}


#: (i) drives whose decisions do not read the clock, held to JAX
COST = {
    "sjf_cold": _cost_arm(dict(policy="sjf"), "cold",
                          [dict(max_new_tokens=9)] * 5),
    "sjf_preempt": _cost_arm(dict(policy="sjf", prefill_chunk=8, max_len=48,
                                  n_pages=7), "preempt",
                             [dict(max_new_tokens=20)] * 2),
    "edf_admission": _cost_arm(dict(policy="edf", n_slots=1,
                                    admission_control=True), "cold",
                               [dict(max_new_tokens=6, slo_ttft=s)
                                for s in (60.0, -1.0, 60.0, -1.0, 60.0)]),
}
CHAOS = {f"chaos_{i}": {"engine": "sched", "chaos": spec,
                        "kw": dict(policy="fcfs", max_len=96, max_retries=r,
                                   backoff_s=0.0),
                        "requests": [(0, ("chaos", j),
                                      dict(max_new_tokens=7))
                                     for j in range(6)]}
         for i, (spec, r) in enumerate((
             ("seed=0,oom=0.05,fault=0.1,shrink=4", 50),
             ("seed=1,fault=0.4", 1)))}
#: the spec EDF gate: a slack no queued deadline clears, then one every
#: deadline clears (``test_torch_spec.py``'s drive)
GATE = {name: {"engine": "spec",
               "kw": dict(spec="ngram", draft_k=6, policy="edf", n_slots=1,
                          prefix_cache=False, spec_slack_s=slack),
               "requests": reqs}
        for name, slack, reqs in (
            ("gate_urgent", 1e6,
             [(0, ("rep", 0), dict(max_new_tokens=12, slo_ttft=10.0)),
              (0, ("rand", 6, 1), dict(max_new_tokens=4, slo_ttft=10.0))]),
            ("gate_free", 1e-9,
             [(0, ("rep", 0), dict(max_new_tokens=12, slo_ttft=10.0))]))}


def _reqs(n, tick=0, src="chaos", **kw):
    return [(tick, (src, i) if src == "chaos" else ("rand", 12, i),
             dict(kw)) for i in range(n)]


#: (ii) drives whose decisions read the clock
CLOCK = {
    # SJF with aging: 3 long prompts, then 3 short ones a tick later; the
    # third long one has waited and goes before the short ones
    "sjf_aging": {"engine": "sched", "kw": dict(policy="sjf"),
                  "requests": [(0, ("rand", 36 + i, i), dict(max_new_tokens=8))
                               for i in range(3)]
                  + [(1, ("rand", 10 + i, 10 + i), dict(max_new_tokens=8))
                     for i in range(3)]},
    # EDF: two urgent requests a tick after two relaxed ones, on one
    # slot: their 1 ms deadlines pass in the queue, and they go next
    "edf_deadline": {"engine": "sched", "kw": dict(policy="edf", n_slots=1),
                     "requests": _reqs(2, max_new_tokens=6, slo_ttft=60.0)
                     + [(1, ("chaos", 2 + i),
                         dict(max_new_tokens=6, slo_ttft=1e-3))
                        for i in range(2)]},
    # EDF with admission control: the same, plus one whose 50 ms deadline
    # may pass behind the first; the passed ones are dropped
    "edf_drop": {"engine": "sched",
                 "kw": dict(policy="edf", n_slots=1, admission_control=True),
                 "requests": _reqs(2, max_new_tokens=6, slo_ttft=60.0)
                 + [(0, ("chaos", 4), dict(max_new_tokens=6, slo_ttft=0.05))]
                 + [(1, ("chaos", 2 + i),
                     dict(max_new_tokens=6, slo_ttft=1e-3))
                    for i in range(2)]},
    # a burst of 8 on 2 slots with a 5 ms TTFT target: the ladder climbs
    "ladder": {"engine": "sched",
               "kw": dict(policy="fcfs", ladder=True, slo_ttft=0.005),
               "requests": _reqs(8, src="rand", max_new_tokens=8)},
    # a 50 ms deadline for requests that take longer in the queue
    "timeouts": {"engine": "sched",
                 "kw": dict(policy="fcfs", max_request_s=0.05),
                 "requests": _reqs(6, max_new_tokens=24)},
    # EDF urgency gate: a queued request's 60 ms deadline comes inside the
    # 58 ms slack after 2 ms; speculation resumes behind a relaxed one
    "spec_slack": {"engine": "spec",
                   "kw": dict(spec="ngram", draft_k=4, policy="edf",
                              n_slots=1, spec_slack_s=0.058),
                   "requests": [(0, ("rep", i), dict(max_new_tokens=12,
                                                     slo_ttft=s))
                                for i, s in enumerate((0.06, 0.06, 60.0))]},
    # faults and spikes recovered with a 5 ms exponential backoff
    "chaos_backoff": {"engine": "sched",
                      "chaos": "seed=0,oom=0.05,fault=0.2,spike=0.1,"
                               "spike_s=0.002",
                      "kw": dict(policy="fcfs", max_retries=50,
                                 backoff_s=0.005),
                      "requests": _reqs(6, max_new_tokens=7)},
    # open-loop Poisson arrivals (100 a second) into EDF with admission
    # control and a 50 ms TTFT target
    "open_loop": {"engine": "sched", "arrival_rate": 100.0,
                  "kw": dict(policy="edf", admission_control=True,
                             slo_ttft=0.05),
                  "requests": _reqs(6, max_new_tokens=8)},
    # the paged engine under spikes and a shrunk pool: no decision reads
    # the clock, so no reading is shared
    "paged_chaos": {"engine": "paged",
                    "chaos": "seed=0,spike=0.3,spike_s=0.002,shrink=2",
                    "requests": _reqs(4, max_new_tokens=8)},
    # plain FCFS: no decision reads the clock, no reading is shared
    "fcfs_plain": {"engine": "sched", "kw": dict(policy="fcfs"),
                   "requests": _reqs(4, max_new_tokens=8)},
}

#: the serving CLI's drive with every clock-reading option
CLI = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
       "--model-parallel", "2", "--requests", "6", "--max-new", "8",
       "--slots", "2", "--max-len", "96", "--page-size", "8",
       "--prefill-chunk", "16", "--prompt-len", "40", "--policy", "edf",
       "--admission-control", "--slo-ttft", "50", "--degrade",
       "--max-request-s", "30", "--chaos",
       "seed=1,oom=0.05,fault=0.1,spike=0.05", "--arrival-rate", "40"]


def _jax_drives(jcfg, jparams) -> dict:
    """JAX's single-device SchedEngine on the (i) drives (the cost
    drives at the reference's v5e-1 tier, SJF's aging 0)."""
    out = {}
    for name, arm in dict(COST, **CHAOS).items():
        kw = dict(arms.BASE, **arm["kw"])
        if "chaos" in arm:
            kw["injector"] = jresil.FaultInjector.from_spec(arm["chaos"])
        else:
            kw["tier"] = "v5e-1"
        eng = JSched(JLM(jcfg), jparams, **kw)
        if eng.policy.name == "sjf":
            eng.policy.aging = 0.0
        sched = arms._schedule(arm, jcfg.vocab_size)
        ids = [eng.submit(p, **s) for _, p, s in sched]
        done = eng.run_to_completion()
        reqs = [done[i] for i in ids]
        out[name] = {
            "streams": [list(r.out_tokens) for r in reqs],
            "outcomes": [r.outcome for r in reqs],
            "rejected": [r.rejected for r in reqs],
            "preemptions": [r.preemptions for r in reqs],
            "syncs": eng.sync_count,
            "stats": dict(vars(eng.stats)),
            "counters": eng.metrics.snapshot()["counters"],
            "free": sorted(int(p) for p in eng.alloc.free),
            "injected": (dict(eng.injector.counts) if "chaos" in arm
                         else None)}
    return out


def _cli_run():
    from repro_torch.launch.serve import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(CLI)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def runs():
    """The world (every arm on both ranks), the CLI's world and JAX's
    drives at once; then every clock arm on one rank replaying rank 0's
    readings, and the SJF arm without aging."""
    from concurrent.futures import ThreadPoolExecutor
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32")
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    weights = jax.tree.map(np.asarray, jparams)
    tier = _cost_tier()
    world_arms = {name: dict(arm, kw=dict(arm["kw"], tier=tier),
                             **({"aging": 0.0} if arm["kw"]["policy"] == "sjf"
                                else {}))
                  for name, arm in COST.items()}
    world_arms.update(CHAOS, **GATE, **CLOCK)
    with ThreadPoolExecutor(2) as pool:
        world = pool.submit(spawn_world, arms.world, 2, world_arms, weights,
                            device="cpu", threads=1,
                            timeout_s=arms.WORLD_TIMEOUT_S)
        cli = pool.submit(_cli_run)
        jax_runs = _jax_drives(jcfg, jparams)
        ranks = world.result()
        cli = cli.result()
    replays = {name: arms.run_arm(arm, weights, clock=arms.Replay(
        ranks[0][name]["readings"])) for name, arm in CLOCK.items()}
    pure_sjf = arms.run_arm(dict(CLOCK["sjf_aging"], aging=0.0), weights)
    return {"ranks": ranks, "jax": jax_runs, "replays": replays,
            "cli": cli, "pure_sjf": pure_sjf}


#: what every rank and the replay must agree on
SAME = ("streams", "outcomes", "rejected", "preemptions", "syncs", "admits",
        "rungs", "spec_trace", "counters", "stats", "spec_stats",
        "injected", "free", "held")


def _same(a: dict, b: dict) -> dict:
    return {k: (a.get(k), b.get(k)) for k in SAME if a.get(k) != b.get(k)}


@pytest.mark.parametrize("name", sorted(COST) + sorted(CHAOS))
def test_clock_free_drives_on_two_ranks_match_jax(runs, name):
    """The cost-model drives (SJF, SJF under preemption, EDF with
    admission control) and the chaos drives give JAX's single-device
    streams, outcomes, rejections, preemptions, syncs, stats, counters,
    free pages and injected faults, on both ranks (rank 1's own clock
    skewed)."""
    want = runs["jax"][name]
    for rank, res in enumerate(runs["ranks"]):
        got = res[name]
        for key in ("streams", "outcomes", "rejected", "preemptions",
                    "syncs", "stats", "free"):
            assert got[key] == want[key], (name, rank, key)
        keys = COUNTERS if name in COST else sorted(
            k for k in want["counters"] if k.startswith("resil"))
        assert {k: got["counters"][k] for k in keys} == \
            {k: want["counters"][k] for k in keys}, (name, rank)
        if name in CHAOS:
            assert got["injected"] == want["injected"], (name, rank)
        assert got["shared_readings"] > 0, (name, rank)
    if name == "edf_admission":
        assert want["stats"]["slo_rejected"] == 2
    if name == "chaos_0":
        assert want["outcomes"] == ["ok"] * 6
    if name == "chaos_1":
        assert "failed" in want["outcomes"]


def test_spec_urgency_gate_on_two_ranks(runs):
    """The spec EDF gate on both ranks: while a queued request's
    deadline is inside the slack no round verifies and the skips are
    counted; with no queue the same engine speculates."""
    for res in runs["ranks"]:
        urgent, free = res["gate_urgent"], res["gate_free"]
        assert _same(urgent, runs["ranks"][0]["gate_urgent"]) == {}
        first = [v for queued, v in urgent["spec_trace"][:4] if queued]
        assert first and all(v == 0 for v in first)
        assert urgent["spec_stats"]["skipped_urgent"] > 0
        assert free["spec_stats"]["verify_steps"] > 0
        assert [len(s) for s in urgent["streams"]] == [12, 4]


@pytest.mark.parametrize("name", sorted(CLOCK))
def test_clock_decisions_equal_on_every_rank(runs, name):
    """Under rank 1's skewed clock both ranks give the same streams,
    outcomes, admission order, rung trace, syncs and counters, and read
    the shared clock as often; a drive with no decision on the clock
    shares no reading."""
    r0, r1 = (res[name] for res in runs["ranks"])
    assert _same(r0, r1) == {}
    assert r0["shared_readings"] == r1["shared_readings"]
    shared = name not in ("paged_chaos", "fcfs_plain")
    assert (r0["shared_readings"] > 0) == shared
    assert ("broadcast/clock" in r0["collectives"]) == shared
    assert len(r0["readings"]) >= r0["shared_readings"]


@pytest.mark.parametrize("name", sorted(CLOCK))
def test_one_rank_replaying_rank0_clock_decides_alike(runs, name):
    """One rank fed rank 0's readings in order takes every decision the
    two ranks took: the same streams, outcomes, admission order, rung
    trace, syncs and counters, reading the clock as many times."""
    r0, one = runs["ranks"][0][name], runs["replays"][name]
    assert _same(r0, one) == {}


def test_each_clock_drive_shows_its_decision(runs):
    """Each clock drive exercises what it names: SJF's aging reorders
    admissions against pure SJF, EDF admits the urgent requests first
    after their deadlines passed in the queue, admission control drops,
    the ladder climbs, deadlines time requests out, the urgency gate
    skips and later speculates, chaos recovers with backoff and every
    open-loop arrival is served once."""
    r = {name: res for name, res in runs["ranks"][0].items()}
    assert r["sjf_aging"]["admits"] != runs["pure_sjf"]["admits"]
    assert sorted(r["sjf_aging"]["admits"]) == list(range(6))
    assert r["edf_deadline"]["admits"] == [0, 2, 3, 1]
    assert r["edf_deadline"]["late_admits"] >= 2
    assert r["edf_deadline"]["outcomes"] == ["ok"] * 4
    assert r["edf_drop"]["stats"]["slo_rejected"] >= 2
    assert max(r["ladder"]["rungs"]) >= 1
    assert "timed_out" in r["timeouts"]["outcomes"]
    spec = r["spec_slack"]["spec_stats"]
    assert spec["skipped_urgent"] > 0 and spec["verify_steps"] > 0
    chaos = r["chaos_backoff"]
    assert chaos["injected"]["dispatch"] > 0
    assert chaos["counters"]["resil_recovered_total"] > 0
    assert chaos["outcomes"] == ["ok"] * 6
    assert len(r["open_loop"]["outcomes"]) == 6
    assert all(o in OUTCOMES for o in r["open_loop"]["outcomes"])
    assert r["paged_chaos"]["injected"]["latency"] > 0
    assert [len(s) for s in r["paged_chaos"]["streams"]] == [8] * 4


def test_serve_cli_model_parallel_takes_clock_decisions(runs):
    """``launch.serve --model-parallel 2 --device cpu`` with EDF,
    admission control, a TTFT target, the ladder, deadlines, chaos and
    open-loop arrivals exits 0 and finds every rank's streams and
    outcomes equal."""
    rc, out = runs["cli"]
    assert rc == 0
    assert "mesh {'data': 1, 'model': 2} over 2 ranks (gloo, cpu)" in out
    assert "every rank's streams equal, every rank's outcomes equal" in out
    assert "[serve] outcomes:" in out and "degrade ladder" in out

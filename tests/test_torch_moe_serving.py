"""Port parity: the engines serving MoE models against their JAX twins, in
float32 on the smoke configs, with the reference's ``LM.init`` weights
bridged to torch.  Held equal: greedy streams, host syncs, the engines'
counters and (paged engines) the page pool at the end, no page left
owned by a slot.

* granite-moe-3b-a800m through ``PagedEngine``, ``SchedEngine`` (chunked
  prefill, the prefix cache), the n-gram ``SpecEngine`` and the eager
  ``Engine``; llama4-scout-17b-a16e through the eager ``Engine`` with
  prompts past its window of 32 (paged engines refuse windows).
* Every engine with expert capacity forced down
  (``eval_capacity_factor`` 0.5): its padded shapes (pow2
  prompt buckets, row buckets, chunk widths, verify width k + 1, the
  token and position an idle slot carries) then decide which tokens
  drop, so a shape that differs from the reference's changes the
  stream.
* granite with int8 weights (attention linears take W8A8; the expert
  stacks and the router are not quantized) through ``PagedEngine``.

Each engine is held to its own JAX twin, never to another engine: with
capacity, chunked against whole prefill and paged against eager route in
different groups (ROADMAP C).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import spec as jspec  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.quant.qops import quantize_tree as j_quantize_tree  # noqa: E402
from repro.sched import SchedEngine as JSched  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import PagedEngine as JPaged  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.sched import SchedEngine as TSched  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import PagedEngine as TPaged  # noqa: E402

torch.manual_seed(0)

GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-scout-17b-a16e"

#: counters every engine must agree on (wall-clock series excluded)
COUNTERS = ("serve_requests_submitted_total", "serve_requests_retired_total",
            "serve_tokens_emitted_total", "serve_host_syncs_total")
PAGED_COUNTERS = COUNTERS + (
    "serve_decode_steps_total", "serve_decode_tokens_total",
    "serve_eos_total", "serve_prefill_dispatches_total",
    "serve_decode_dispatches_total")
SCHED_COUNTERS = PAGED_COUNTERS + (
    "sched_admitted_total", "sched_preemptions_total", "sched_chunks_total",
    "sched_prefill_tokens_total", "sched_prefix_hit_tokens_total")

#: engine -> (JAX class, port class, constructor kwargs, counters; JAX's
#: eager Engine keeps no sync counter, its syncs are counted apart)
ENGINES = {
    "paged": (JPaged, TPaged, dict(n_slots=3, max_len=96, page_size=8,
                                   decode_block=4), PAGED_COUNTERS),
    "sched": (JSched, TSched, dict(n_slots=3, max_len=96, page_size=8,
                                   decode_block=4, prefill_chunk=16,
                                   policy="fcfs", prefix_cache=True),
              SCHED_COUNTERS),
    "spec": (jspec.SpecEngine, tspec.SpecEngine,
             dict(n_slots=3, max_len=96, page_size=8, decode_block=4,
                  prefill_chunk=16, policy="fcfs", prefix_cache=False,
                  spec="ngram", draft_k=4), SCHED_COUNTERS),
    "eager": (JEngine, TEngine, dict(n_slots=3, max_len=96), COUNTERS[:3]),
}


def _cfgs(arch, drop, quant="bf16"):
    out = []
    for smoke in (j_smoke, t_smoke):
        cfg = smoke(arch).with_(dtype="float32", quant=quant)
        if drop:
            cfg = cfg.with_(moe=dataclasses.replace(
                cfg.moe, eval_capacity_factor=0.5))
        out.append(cfg)
    return out


_params = {}


def _weights(arch):
    """The reference's float32 parameters of the arch's smoke config."""
    if arch not in _params:
        cfg = j_smoke(arch).with_(dtype="float32")
        _params[arch] = JLM(cfg).init(jax.random.PRNGKey(0))
    return _params[arch]


def _prompts(vocab, arch):
    """Five requests on three slots, so two land in slots used before.
    granite: one of 40 tokens (two chunks), one that repeats a 6-token
    passage (n-gram drafts hit), one that shares the first's 24-token
    prefix (a prefix-cache hit), and short ones.  llama4: prompts of 40
    and 36 tokens, past its window of 32, and short ones."""
    rng = np.random.default_rng(0)
    if arch == LLAMA4:
        return [rng.integers(0, vocab, (n,)).tolist()
                for n in (40, 36, 9, 5, 12)]
    first = rng.integers(0, vocab, (40,)).tolist()
    pat = rng.integers(0, vocab, (6,)).tolist()
    return [first, pat * 3 + rng.integers(0, vocab, (2,)).tolist(),
            rng.integers(0, vocab, (7,)).tolist(),
            first[:24] + rng.integers(0, vocab, (5,)).tolist(),
            rng.integers(0, vocab, (12,)).tolist()]


def _drive(cls, lm, params, prompts, max_new, kw):
    eng = cls(lm, params, seed=0, **kw)
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = eng.run_to_completion()
    return eng, [done[i].out_tokens for i in ids]


def _count_jax_syncs(eng):
    """JAX's eager Engine reads each device program's result once."""
    n = {"syncs": 0}
    for name in ("_prefill_one", "_decode"):
        fn = getattr(eng, name)

        def counted(*a, _fn=fn):
            n["syncs"] += 1
            return _fn(*a)
        setattr(eng, name, counted)
    return n


_runs = {}


def _both(engine, arch, drop, quant="bf16"):
    """JAX's and the port's drive of one engine, made once."""
    key = (engine, arch, drop, quant)
    if key not in _runs:
        jcls, tcls, kw, _ = ENGINES[engine]
        jcfg, tcfg = _cfgs(arch, drop, quant)
        jp = j_quantize_tree(_weights(arch), quant=quant)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
        prompts = _prompts(jcfg.vocab_size, arch)
        max_new = 10
        if engine == "eager":
            jeng = jcls(JLM(jcfg), jp, seed=0, **kw)
            syncs = _count_jax_syncs(jeng)
            ids = [jeng.submit(p, max_new_tokens=max_new) for p in prompts]
            done = jeng.run_to_completion()
            jeng.sync_count = syncs["syncs"]
            j = (jeng, [done[i].out_tokens for i in ids])
        else:
            j = _drive(jcls, JLM(jcfg), jp, prompts, max_new, kw)
        t = _drive(tcls, TLM(tcfg, device="cpu"), tp, prompts, max_new, kw)
        _runs[key] = (j, t)
    return _runs[key]


def _held(engine, arch, drop, quant="bf16"):
    (jeng, jtoks), (teng, ttoks) = _both(engine, arch, drop, quant)
    assert ttoks == jtoks
    assert all(len(t) == 10 for t in ttoks)
    assert teng.sync_count == jeng.sync_count
    names = ENGINES[engine][3]
    tc, jc = (e.metrics.snapshot()["counters"] for e in (teng, jeng))
    assert {k: tc[k] for k in names} == {k: jc[k] for k in names}
    if engine != "eager":
        assert sorted(teng.alloc.free) == sorted(jeng.alloc.free)
        assert not any(teng.alloc.owned(s) for s in range(teng.n_slots))
    if engine == "spec":
        assert dataclasses.asdict(teng.spec_stats) == \
            dataclasses.asdict(jeng.spec_stats)
        assert teng.spec_stats.verify_steps > 0
    return teng


@pytest.mark.parametrize("engine,arch,drop", [
    ("paged", GRANITE, False), ("paged", GRANITE, True),
    ("sched", GRANITE, True), ("spec", GRANITE, True),
    ("eager", GRANITE, True), ("eager", LLAMA4, False),
    ("eager", LLAMA4, True)])
def test_moe_engine_matches_jax(engine, arch, drop):
    teng = _held(engine, arch, drop)
    if engine == "sched":
        assert teng.metrics.snapshot()["counters"][
            "sched_prefix_hit_tokens_total"] > 0


def test_forced_drops_change_the_streams():
    """The forced-drop drives are not the dropless ones over again:
    capacity 0.5 drops routed outputs, and the streams move."""
    for engine, arch in (("paged", GRANITE), ("eager", LLAMA4)):
        (_, free), (_, dropped) = (_both(engine, arch, d)[1]
                                   for d in (False, True))
        assert free != dropped


def test_int8_weight_paged_engine_matches_jax():
    """int8 weights: the attention linears quantized, the expert stacks
    left in the model's dtype and the router in fp32; streams, syncs and
    counters equal JAX's."""
    teng = _held("paged", GRANITE, False, quant="int8")
    blk = teng.params["layers"][0]["blk0"]
    assert "qw" in blk["attn"]["wq"] and "w" not in blk["attn"]["wq"]
    assert blk["moe"]["gate_e"].dtype == torch.float32
    assert blk["moe"]["router"]["w"].dtype == torch.float32

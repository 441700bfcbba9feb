"""Port parity, engine level: quantized serving through the port's
``PagedEngine`` and ``SchedEngine`` against JAX's engines, in float32
configs, on the same bridged weights and prompts.

* int8 weights (W8A8, ``quant_matmul_impl="fused"``): the first batched
  admission is 2 x 128 padded rows, so it crosses the M = 128 split (the
  tiled kernel's path) while decode stays on the decode kernel's.  Held
  equal: greedy streams, ``sync_count``, the ``serve_*`` / ``sched_*``
  counters; and the port's "fused" == its "ref" (test_quant_serving.py).
* int8 / fp8 KV pools: streams, syncs and counters equal, and
  ``serve_kv_requant_events_total`` > 0 and equal to JAX's.  The port
  counts real pages only (the null page takes free slots' duplicate
  writes in no fixed order on CUDA), so JAX's engines are driven here with
  their count restricted to real pages the same way.
* ``SchedEngine`` on int8 pools: a warm prefix cache gives the cold
  streams (test_sched.py's int8 arm).
* fp8 weights: greedy agreement with bf16 >= 0.6 pooled over 3 seeds
  (test_quant_serving.py's floor; fp8 sums are not bit-comparable).
int8 KV is not held against the bf16 eager engine: that reference test
fails at the seed (ROADMAP C).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.quant.qops import quantize_tree as j_quantize_tree  # noqa: E402
from repro.sched import SchedEngine as JSched  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.serve.engine import PagedEngine as JPaged  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as tops  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402
from repro_torch.sched import SchedEngine as TSched  # noqa: E402
from repro_torch.serve.engine import PagedEngine as TPaged  # noqa: E402

torch.manual_seed(0)

#: counters both engines must agree on (wall-clock series excluded)
COUNTERS = ("serve_requests_submitted_total", "serve_requests_retired_total",
            "serve_tokens_emitted_total", "serve_host_syncs_total",
            "serve_decode_steps_total", "serve_decode_tokens_total",
            "serve_eos_total", "serve_kv_requant_events_total",
            "serve_prefill_dispatches_total",
            "serve_decode_dispatches_total")
SCHED_COUNTERS = ("sched_admitted_total", "sched_preemptions_total",
                  "sched_chunks_total", "sched_prefill_tokens_total",
                  "sched_prefix_hit_tokens_total",
                  "sched_slo_rejected_total", "prefix_lookups_total",
                  "prefix_hits_total", "prefix_hit_tokens_total")
KW = dict(n_slots=2, max_len=128, seed=0, page_size=8, decode_block=4)
SCHED_KW = dict(policy="fcfs", prefix_cache=True, prefill_chunk=128)


@pytest.fixture(scope="module")
def base():
    """The float32 smoke qwen2's reference parameters and the prompts: a
    72- and an 80-token prompt admitted together, short ones after, and
    one that shares the first's 48-token prefix (a prefix-cache hit)."""
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32")
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    vocab = jcfg.vocab_size
    first = rng.integers(0, vocab, (72,)).tolist()
    prompts = [first, rng.integers(0, vocab, (80,)).tolist()]
    prompts += [rng.integers(0, vocab, (n,)).tolist() for n in (12, 8, 3)]
    prompts.append(first[:48] + rng.integers(0, vocab, (7,)).tolist())
    return jcfg, jp, prompts


def _pair(base, quant="bf16", kv="bfloat16", impl="fused"):
    jcfg, jp, _ = base
    kw = dict(quant=quant, kv_cache_dtype=kv, quant_matmul_impl=impl)
    jcfg = jcfg.with_(**kw)
    tcfg = t_smoke("qwen2-1.5b").with_(dtype="float32", **kw)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return (JLM(jcfg), j_quantize_tree(jp, quant=quant),
            TLM(tcfg, device="cpu"), quantize_tree(tp, quant=quant))


def _drive(cls, lm, params, prompts, max_new=9, **kw):
    eng = cls(lm, params, **{**KW, **kw})
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = eng.run_to_completion()
    return eng, [done[i].out_tokens for i in ids]


def _counters(eng, names=COUNTERS):
    snap = eng.metrics.snapshot()["counters"]
    return {k: snap[k] for k in names}


_runs = {}


def _counting_plain_calls(fn):
    """``fn()`` with the tiled and decode plain versions counted."""
    calls = {"tiled": 0, "decode": 0}
    saved = tops.int8_matmul_ref, tops.w8a8_decode_ref

    def tiled(*a, **k):
        calls["tiled"] += 1
        return saved[0](*a, **k)

    def decode(*a, **k):
        calls["decode"] += 1
        return saved[1](*a, **k)

    tops.int8_matmul_ref, tops.w8a8_decode_ref = tiled, decode
    try:
        return fn(), calls
    finally:
        tops.int8_matmul_ref, tops.w8a8_decode_ref = saved


def _real_page_scale_changes(before, after):
    """The reference's ``_kv_scale_change_count`` over real pages: the
    scale entries of pages >= 1 (page axis second to last) that differ."""
    from jax.tree_util import keystr, tree_flatten_with_path
    b = {keystr(p): x for p, x in tree_flatten_with_path(before)[0]
         if "_scales" in keystr(p)}
    total = jnp.zeros((), jnp.int32)
    for p, x in tree_flatten_with_path(after)[0]:
        if keystr(p) in b:
            total = total + jnp.sum(
                (b[keystr(p)][..., 1:, :] != x[..., 1:, :]).astype(jnp.int32))
    return total


def _both(base, engine, quant="bf16", kv="bfloat16"):
    """JAX's and the port's run of one engine configuration, made once,
    with the port's calls of the tiled / decode plain versions."""
    key = (engine, quant, kv)
    if key not in _runs:
        jlm, jq, tlm, tq = _pair(base, quant, kv)
        cls, kw = ((JSched, TSched), SCHED_KW) if engine == "sched" \
            else ((JPaged, TPaged), {})
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_engine, "_kv_scale_change_count",
                       _real_page_scale_changes)
            j = _drive(cls[0], jlm, jq, base[2], **kw)
        t, calls = _counting_plain_calls(
            lambda: _drive(cls[1], tlm, tq, base[2], **kw))
        _runs[key] = (j, t, calls)
    return _runs[key]


@pytest.mark.parametrize("engine", ["paged", "sched"])
def test_int8_weight_engines_match_jax(base, engine):
    (jeng, jtoks), (teng, ttoks), calls = _both(base, engine, quant="int8")
    # 7 linears per layer on both sides of the M = 128 split
    n = 7 * teng.lm.cfg.num_layers
    assert calls["tiled"] >= n and calls["decode"] >= n
    assert calls["tiled"] % n == 0 and calls["decode"] % n == 0
    assert ttoks == jtoks
    assert all(len(t) == 9 for t in ttoks)
    assert teng.sync_count == jeng.sync_count
    assert _counters(teng) == _counters(jeng)
    if engine == "sched":
        assert _counters(teng, SCHED_COUNTERS) == \
            _counters(jeng, SCHED_COUNTERS)
        assert teng.stats.prefix_hit_tokens > 0


@pytest.mark.parametrize("engine", ["paged", "sched"])
def test_int8_fused_equals_ref(base, engine):
    """The port's "fused" (the kernels' plain versions, bias folded into
    the decode epilogue) gives the streams of its "ref" (the oracles)."""
    _, (_, fused), _ = _both(base, engine, quant="int8")
    _, _, tlm, tq = _pair(base, "int8", impl="ref")
    cls, kw = (TSched, SCHED_KW) if engine == "sched" else (TPaged, {})
    _, ref = _drive(cls, tlm, tq, base[2], **kw)
    assert fused == ref


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_kv_engines_match_jax(base, kv):
    (jeng, jtoks), (teng, ttoks), _ = _both(base, "paged", kv=kv)
    assert ttoks == jtoks
    assert teng.sync_count == jeng.sync_count
    assert _counters(teng) == _counters(jeng)
    assert _counters(teng)["serve_kv_requant_events_total"] > 0


def test_int8_weights_and_pools_through_the_scheduler_match_jax(base):
    (jeng, jtoks), (teng, ttoks), _ = _both(base, "sched", "int8", "int8")
    assert ttoks == jtoks
    assert teng.sync_count == jeng.sync_count
    assert _counters(teng) == _counters(jeng)
    assert _counters(teng, SCHED_COUNTERS) == _counters(jeng, SCHED_COUNTERS)
    assert _counters(teng)["serve_kv_requant_events_total"] > 0


def test_sched_int8_pools_warm_equals_cold(base):
    """test_sched.py's int8 arm: prefix-cache admissions skip the shared
    pages and stay token-identical to a cold cache, computing >= 2x fewer
    prefill tokens."""
    *_, tlm, tp = _pair(base, kv="int8")
    rng = np.random.default_rng(0)
    vocab = tlm.cfg.vocab_size
    shared = rng.integers(0, vocab, (24,)).tolist()
    prompts = [shared + rng.integers(0, vocab, (int(rng.integers(3, 8)),)
                                     ).tolist() for _ in range(6)]
    runs = {}
    for warm in (False, True):
        eng = TSched(tlm, tp, policy="fcfs", prefix_cache=warm, n_slots=2,
                     max_len=64, seed=0, page_size=8, decode_block=4,
                     prefill_chunk=16)
        ids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        done = eng.run_to_completion()
        runs[warm] = ([done[i].out_tokens for i in ids], eng)
    (cold_toks, cold), (warm_toks, warm) = runs[False], runs[True]
    assert warm_toks == cold_toks
    assert all(len(t) == 8 for t in warm_toks)
    assert cold.stats.prefill_tokens / warm.stats.prefill_tokens >= 2.0
    assert warm.prefix.stats()["hit_tokens"] >= 4 * 24


def test_fp8_weights_greedy_agreement_floor():
    """fp8 weights vs bf16 on the bf16 smoke config: greedy agreement
    >= 0.6 pooled over three prompt sets, as test_quant_serving.py holds
    the reference (near-uniform random logits flip near-ties, and one flip
    diverges the rest of a stream)."""
    jcfg = j_smoke("qwen2-1.5b")
    tcfg = t_smoke("qwen2-1.5b")
    tp = params_from_numpy(jax.tree.map(
        np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0))), tcfg,
        device="cpu")
    lm_bf = TLM(tcfg, device="cpu")
    lm8 = TLM(tcfg.with_(quant="fp8"), device="cpu")
    p8 = quantize_tree(tp, quant="fp8")
    pairs = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, tcfg.vocab_size, (12,)).tolist()
                   for _ in range(4)]
        _, b = _drive(TPaged, lm_bf, tp, prompts, 8, max_len=64)
        _, q = _drive(TPaged, lm8, p8, prompts, 8, max_len=64)
        pairs += [(x, y) for xs, ys in zip(q, b) for x, y in zip(xs, ys)]
    agree = sum(x == y for x, y in pairs) / len(pairs)
    assert agree >= 0.6, f"fp8 greedy agreement {agree:.3f} below floor"


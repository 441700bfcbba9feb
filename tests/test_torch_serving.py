"""Port parity: the port's ``PagedEngine`` against JAX's ``PagedEngine`` on
``test_serving.py``'s workloads, in float32 configs (bf16 prefill-vs-decode
rounding flips greedy near-ties on both sides), with ``use_kernels`` off
and on.  Greedy token streams, ``sync_count`` and the ``serve_*``
counters must be equal.  Also EOS mid-block with page reuse, deferred
admission when pages run out, and temperature sampling (held only as
"runs and stays in vocab": the two samplers' noise differs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve.engine import PagedEngine as JPaged  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.serve.engine import PagedEngine as TPaged  # noqa: E402
from repro_torch.serve.paged import OutOfPagesError  # noqa: E402

torch.manual_seed(0)

#: counters both engines must agree on (wall-clock series excluded)
COUNTERS = ("serve_requests_submitted_total", "serve_requests_retired_total",
            "serve_tokens_emitted_total", "serve_host_syncs_total",
            "serve_decode_steps_total", "serve_decode_tokens_total",
            "serve_eos_total", "serve_kv_requant_events_total",
            "serve_prefill_dispatches_total",
            "serve_decode_dispatches_total")


def _setup(use_kernels=False):
    jcfg = j_smoke("qwen2-1.5b").with_(dtype="float32",
                                      use_kernels=use_kernels)
    tcfg = t_smoke("qwen2-1.5b").with_(dtype="float32",
                                      use_kernels=use_kernels)
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = TLM(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).tolist()
               for n in (8, 5, 12, 8, 3)]
    return (jlm, jparams), (tlm, tparams), prompts


def _drive(cls, lm, params, prompts, max_new, **kw):
    eng = cls(lm, params, seed=0, **kw)
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = eng.run_to_completion()
    return eng, [done[i].out_tokens for i in ids]


def _counters(eng):
    snap = eng.metrics.snapshot()["counters"]
    out = {k: snap[k] for k in COUNTERS}
    for o in ("ok", "shed", "timed_out", "failed"):
        key = f'resil_requests_total{{outcome="{o}"}}'
        out[key] = snap[key]
    return out


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("max_new,decode_block", [(9, 4), (17, 8)])
def test_paged_engine_matches_jax_engine(use_kernels, max_new,
                                         decode_block):
    """Slot churn over 2 slots, multi-page slots, batched admission:
    identical greedy streams, host syncs and serve_* counters."""
    (jlm, jp), (tlm, tp), prompts = _setup(use_kernels)
    kw = dict(n_slots=2, max_len=64, page_size=8, decode_block=decode_block)
    jeng, jtoks = _drive(JPaged, jlm, jp, prompts, max_new, **kw)
    teng, ttoks = _drive(TPaged, tlm, tp, prompts, max_new, **kw)
    assert ttoks == jtoks
    assert all(len(t) == max_new for t in ttoks)
    assert teng.sync_count == jeng.sync_count
    assert _counters(teng) == _counters(jeng)
    assert len(teng.alloc.free) == teng.alloc.n_pages - 1


def test_paged_engine_eos_and_page_reuse_matches_jax():
    """EOS mid-block retires the slot, frees its pages, and the reused
    pages serve later requests: equal to the JAX engine token for token."""
    (jlm, jp), (tlm, tp), prompts = _setup()
    _, probe = _drive(JPaged, jlm, jp, prompts[:1], 6, n_slots=1,
                      max_len=64, page_size=8, decode_block=4)
    eos = probe[0][3]                   # stop 4 tokens in
    kw = dict(n_slots=1, max_len=64, eos_id=eos, page_size=8,
              decode_block=4)
    jeng, jtoks = _drive(JPaged, jlm, jp, prompts, 6, **kw)
    teng, ttoks = _drive(TPaged, tlm, tp, prompts, 6, **kw)
    assert ttoks == jtoks
    assert any(len(t) < 6 for t in ttoks), "EOS must fire"
    assert teng.sync_count == jeng.sync_count
    assert _counters(teng) == _counters(jeng)
    assert len(teng.alloc.free) == teng.alloc.n_pages - 1


def test_out_of_pages_defers_admission_like_jax():
    """With pages for only one request in flight, the second waits and
    completes after the first retires — same streams and syncs as JAX."""
    (jlm, jp), (tlm, tp), prompts = _setup()
    small = [prompts[0][:8], prompts[1][:5]]
    kw = dict(n_slots=2, max_len=32, page_size=8, decode_block=4, n_pages=4)
    jeng, jtoks = _drive(JPaged, jlm, jp, small, 5, **kw)
    teng, ttoks = _drive(TPaged, tlm, tp, small, 5, **kw)
    assert ttoks == jtoks and all(len(t) == 5 for t in ttoks)
    assert teng.sync_count == jeng.sync_count


def test_out_of_pages_raises_when_nothing_can_free():
    """A request whose horizon can never fit the pool raises
    OutOfPagesError (nothing in flight would ever free pages)."""
    _, (tlm, tp), prompts = _setup()
    eng = TPaged(tlm, tp, n_slots=1, max_len=64, page_size=8, n_pages=2)
    eng.submit(prompts[2], max_new_tokens=20)
    with pytest.raises(OutOfPagesError, match="need"):
        eng.run_to_completion()


def test_temperature_sampling_runs_and_stays_in_vocab():
    _, (tlm, tp), prompts = _setup()
    eng = TPaged(tlm, tp, n_slots=2, max_len=64, page_size=8,
                 decode_block=4, seed=0)
    i = eng.submit(prompts[0], max_new_tokens=6, temperature=0.8)
    j = eng.submit(prompts[1], max_new_tokens=6)          # greedy
    done = eng.run_to_completion()
    assert len(done[i].out_tokens) == 6 and len(done[j].out_tokens) == 6
    assert all(0 <= t < tlm.cfg.vocab_size for t in done[i].out_tokens)
    # the greedy row is unaffected by its neighbour's sampling
    _, greedy = _drive(TPaged, tlm, tp, [prompts[1]], 6, n_slots=2,
                       max_len=64, page_size=8, decode_block=4)
    assert done[j].out_tokens == greedy[0]


def test_submit_rejects_overlong_prompt():
    _, (tlm, tp), _ = _setup()
    eng = TPaged(tlm, tp, n_slots=1, max_len=16, page_size=8)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(16)))


def test_decode_loop_is_bounded_by_known_budgets():
    """The fused block runs only the steps some slot can still use
    (``steps_run``) while ``steps_dispatched`` keeps the reference's
    per-block count; one host read per block either way."""
    _, (tlm, tp), prompts = _setup()
    eng, toks = _drive(TPaged, tlm, tp, prompts[:2], 3, n_slots=2,
                       max_len=64, page_size=8, decode_block=8)
    assert all(len(t) == 3 for t in toks)
    assert eng.steps_dispatched == 8 * eng.metrics.snapshot()["counters"][
        "serve_decode_dispatches_total"]
    assert eng.steps_run == 2            # max_new 3: one token at prefill
    assert eng.sync_count == 2           # one admission + one block


def test_launch_serve_cpu_smoke(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "llama3.2-1b", "--smoke", "--paged",
                 "--requests", "3", "--max-new", "5", "--slots", "2",
                 "--max-len", "64", "--page-size", "16",
                 "--decode-block", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] llama3.2-1b: 3 requests, 15 tokens" in out
    assert "paged," in out and "host syncs" in out

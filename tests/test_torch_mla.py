"""Port parity of MLA (the search's ``mla`` attention arm): the smoke
qwen2-1.5b with ``apply_efficiency_config`` of an MLA arm on each side
(kv_lora_rank 16, rope_head_dim 8), the reference's ``LM.init`` pytree
bridged to torch, the same numpy tokens.

* ``LM.logits`` to 1e-4 in float32 (with and without ``q_lora_rank``)
  and 2e-2 in bf16; ``prefill`` (logits, the bf16 latent cache) to 1e-4.
* ``decode_step`` from the reference's own cache (bridged) to 1e-4 (the
  absorbed matmul against the latent), and teacher-forced decode against the
  full-context logits at ``tests/test_archs.py``'s 2e-2 (the latent cache
  is bf16 even in float32, as in the reference).
* The eager ``Engine``'s greedy streams equal JAX's ``Engine`` in float32;
  ``PagedEngine`` refuses MLA, as the reference asserts.
* ``LM.loss`` (the training forward through MLA): finite, with finite
  gradients on every MLA leaf; the port's proxy evaluator on an MLA arm.
* R7: the reference's quantized MLA decode raises ``KeyError: 'w'``; the
  port's absorbs the dequantized up-projections, and its teacher-forced
  decode holds its own full-sequence logits of the quantized tree at
  1e-2 for fp8 / int4 and 4e-2 for int8 (``R7_BAR`` says why).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _train_pairs import (batch, one_intraop_thread,  # noqa: E402,F401
                          tbatch)
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import apply as japply  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch.bridge import (params_from_numpy, params_to_numpy,  # noqa: E402
                                state_from_numpy)
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import apply as tapply  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.quant import quantize_tree as t_quantize  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import PagedEngine  # noqa: E402
from repro_torch.train.loop import loss_and_grads  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_intraop_thread")


TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _mla(cfg, apply_mod, space_mod, q_lora_rank=0, **over):
    """The smoke qwen2 under the search's mla arm (each package's
    ``apply_efficiency_config``), optionally with a query
    down-projection of ``q_lora_rank``."""
    eff = space_mod.EfficiencyConfig(
        space_mod.ArchChoice("mla", 0, 1), space_mod.FtChoice("full", 0, 1),
        space_mod.InfChoice("bf16", "none", "full"))
    cfg = apply_mod.apply_efficiency_config(cfg, eff)
    return cfg.with_(attention=dataclasses.replace(
        cfg.attention, q_lora_rank=q_lora_rank), **over)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32", q_lora_rank=0):
    """(JAX LM, port LM, JAX params, port params); the port's tree is
    shared by the tests, which only read it."""
    jcfg = _mla(j_smoke("qwen2-1.5b"), japply, jspace, q_lora_rank,
                dtype=dtype)
    tcfg = _mla(t_smoke("qwen2-1.5b"), tapply, tspace, q_lora_rank,
                dtype=dtype)
    assert dataclasses.asdict(tcfg.attention) == \
        dataclasses.asdict(jcfg.attention)
    assert (tcfg.attention.kv_lora_rank, tcfg.attention.rope_head_dim) \
        == (16, 8)
    jlm, tlm = JLM(jcfg), TLM(tcfg, device="cpu")
    if dtype == "bfloat16":     # the bf16 init is the float32 one, cast
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                          _pair("float32", q_lora_rank)[2])
    else:
        jp = jlm.init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jlm, tlm, jp, tp


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(vocab, b=2, s=16, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("dtype,q_lora_rank", [
    ("float32", 0), ("bfloat16", 0), ("float32", 8)])
def test_logits_and_prefill_match_jax(dtype, q_lora_rank):
    """Logits in every case; in float32 without ``q_down`` also the
    prefill's logits and latent cache and one decode step from the
    reference's cache."""
    jlm, tlm, jp, tp = _pair(dtype, q_lora_rank)
    assert ("q_down" in tp["layers"][0]["blk0"]["attn"]) == bool(q_lora_rank)
    toks = _tokens(jlm.cfg.vocab_size)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        _np(tlm.logits(tp, torch.from_numpy(toks).long())),
        _np(jax.jit(jlm.logits)(jp, jnp.asarray(toks))), atol=tol, rtol=tol)
    if (dtype, q_lora_rank) != ("float32", 0):
        return              # the prefill, its cache and a decode step once
    jl, jc = jlm.prefill(jp, jnp.asarray(toks), jlm.init_cache(2, 24))
    tl, tc = tlm.prefill(tp, torch.from_numpy(toks).long(),
                         tlm.init_cache(2, 24))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=tol)
    node = tc[0]["blk0"]["kv"]
    assert set(node) == {"c_kv", "k_pe"}
    assert node["c_kv"].dtype == node["k_pe"].dtype == torch.bfloat16
    assert tuple(node["c_kv"].shape) == (2, 24, 16)
    want = state_from_numpy(jax.tree.map(np.asarray, jc), tlm.cfg, "cpu")
    for g, wg in zip(tc, want):
        for name in ("c_kv", "k_pe"):
            np.testing.assert_allclose(_np(g["blk0"]["kv"][name]),
                                       _np(wg["blk0"]["kv"][name]),
                                       atol=tol, rtol=tol)
    # one decode step (the absorbed matmul) from the reference's cache
    pos = np.full((2,), 16, np.int32)
    jl, jc2 = jax.jit(jlm.decode_step)(jp, jnp.asarray(toks[:, 0]), jc,
                                       jnp.asarray(pos))
    tl, tc2 = tlm.decode_step(tp, torch.from_numpy(toks[:, 0]).long(), want,
                              torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    want = state_from_numpy(jax.tree.map(np.asarray, jc2), tlm.cfg, "cpu")
    for g, wg in zip(tc2, want):
        for name in ("c_kv", "k_pe"):
            np.testing.assert_allclose(_np(g["blk0"]["kv"][name]),
                                       _np(wg["blk0"]["kv"][name]),
                                       atol=1e-2, rtol=1e-2)


def test_decode_matches_full_context():
    """The port's teacher-forced decode gives its full-context logits to
    2e-2 (the latent cache is bf16; the logits test holds one decode step
    to the reference's at 1e-4)."""
    _, tlm, _, tp = _pair()
    toks = _tokens(tlm.cfg.vocab_size)
    full = _np(tlm.logits(tp, torch.from_numpy(toks).long()))
    _, tc = tlm.prefill(tp, torch.from_numpy(toks[:, :8]).long(),
                        tlm.init_cache(2, 24))
    for i in range(8, 16):
        tl, tc = tlm.decode_step(tp, torch.from_numpy(toks[:, i]).long(), tc,
                                 torch.full((2,), i))
        np.testing.assert_allclose(_np(tl), full[:, i], atol=2e-2,
                                   rtol=2e-2)


def test_engine_streams_match_jax():
    """The eager Engine over contiguous latent caches: greedy streams of
    more requests than slots equal JAX's Engine in float32; PagedEngine
    refuses MLA."""
    jlm, tlm, jp, tp = _pair()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jlm.cfg.vocab_size, (n,)).tolist()
               for n in (14, 9, 9)]

    def serve(eng):
        ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        done = eng.run_to_completion()
        return [done[i].out_tokens for i in ids]
    jstreams = serve(JEngine(jlm, jp, n_slots=2, max_len=48, seed=0))
    teng = TEngine(tlm, tp, n_slots=2, max_len=48, seed=0)
    assert serve(teng) == jstreams
    assert all(len(s) == 6 for s in jstreams)
    assert set(teng.cache[0]["blk0"]["kv"]) == {"c_kv", "k_pe"}
    with pytest.raises(ValueError, match="MLA"):
        PagedEngine(tlm, tp, n_slots=1, max_len=16)


def test_loss_and_proxy_through_mla():
    """The training forward through MLA (the forward the logits test
    holds to the reference's, under autograd): a finite loss and a
    finite, non-zero gradient on every MLA leaf; the proxy evaluator
    trains an MLA arm."""
    _, tlm, _, tp = _pair()
    tloss, _, tg = loss_and_grads(tlm, tp, tbatch(batch(tlm.cfg.vocab_size,
                                                        s=64)))
    assert torch.isfinite(tloss)
    attn = tg["layers"][0]["blk0"]["attn"]
    assert set(attn) == {"kv_down", "k_rope", "kv_up_k", "kv_up_v", "wo",
                         "q_up"}
    assert all(torch.isfinite(g["w"]).all() and g["w"].abs().sum() > 0
               for g in attn.values())
    from repro_torch.core import evaluator as tev
    from repro_torch.core.costmodel import TIERS
    from repro_torch.core.features import TASKS
    eff = tspace.EfficiencyConfig(tspace.ArchChoice("mla", 0, 1),
                                  tspace.FtChoice("lora", 4, 2),
                                  tspace.InfChoice("bf16", "none", "full"))
    obj = tev.Evaluator(t_smoke("qwen2-1.5b"), TASKS["mmlu"],
                        TIERS["h100-1"], mode="proxy", proxy_steps=3,
                        device="cpu").evaluate(eff)
    assert np.isfinite(obj).all() and 0.0 < obj[0] <= 100.0


#: teacher-forced decode against full-sequence logits, max |diff| over
#: the largest logit.  fp8 / int4 weights quantize no activation and hold
#: the int8 bar of 1e-2 (2.8e-3 / 2.2e-3 measured).  int8 (W8A8) cannot:
#: one bf16 ulp of the cache moves a quantized activation a whole int8
#: step downstream (ROADMAP C trap 5), so even the GQA smoke qwen2, with
#: no MLA, decodes 1.9e-2 from its int8 full-sequence logits; MLA's
#: absorbed int8 decode is 2.5e-2, held at 4e-2.
R7_BAR = {"int8": 4e-2, "fp8": 1e-2, "int4": 1e-2}


@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
def test_quantized_decode_r7(quant):
    """R7: on a quantized MLA tree the reference's decode reads
    ``kv_up_k["w"]`` and raises KeyError (shown on int8).  The port absorbs the
    dequantized up-projections: its decode equals the decode of the same
    tree with those two linears replaced by dense dequantized weights,
    its teacher-forced decode holds its own full-sequence logits of the
    quantized tree at ``R7_BAR``."""
    from repro_torch.peft.lora import _dequantize
    jlm, tlm, jp, tp = _pair()
    toks = _tokens(jlm.cfg.vocab_size)
    # the port's quantized tree is the reference's bit for bit
    # (test_torch_quant), so it stands in for it in the reference's decode
    tq = t_quantize(tp, quant=quant)
    if quant == "int8":
        jq = jax.tree.map(jnp.asarray, params_to_numpy(tq, tlm.cfg))
        with pytest.raises(KeyError, match="'w'"):
            jlm.decode_step(jq, jnp.asarray(toks[:, 8]),
                            jlm.init_cache(2, 24),
                            jnp.full((2,), 8, jnp.int32))
    assert "qw" in tq["layers"][0]["blk0"]["attn"]["kv_up_k"]
    dense = [{"blk0": {**g["blk0"], "attn": {
        **g["blk0"]["attn"],
        **{n: {"w": _dequantize(g["blk0"]["attn"][n])}
           for n in ("kv_up_k", "kv_up_v")}}}} for g in tq["layers"]]
    tdense = {**tq, "layers": dense}
    full = _np(tlm.logits(tq, torch.from_numpy(toks).long()))
    tl, tc = tlm.prefill(tq, torch.from_numpy(toks[:, :8]).long(),
                         tlm.init_cache(2, 24))
    dc = [{"blk0": {"kv": {n: t.clone() for n, t in g["blk0"]["kv"].items()}}}
          for g in tc]
    scale = np.abs(full).max()
    for i in range(8, 16):
        tok, pos = torch.from_numpy(toks[:, i]).long(), torch.full((2,), i)
        tl, tc = tlm.decode_step(tq, tok, tc, pos)
        dl, dc = tlm.decode_step(tdense, tok, dc, pos)
        np.testing.assert_allclose(_np(tl), _np(dl), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(_np(tl) / scale, full[:, i] / scale,
                                   atol=R7_BAR[quant])

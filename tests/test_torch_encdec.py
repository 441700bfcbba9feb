"""Port parity of the encoder and cross-attention models: whisper-base
(an encoder over stub frame embeddings, cross-attention in every decoder
block) and llama-3.2-vision-11b (stub patch embeddings, cross-attention
in every second block of the smoke config), their smoke configs in
float32, the reference's ``LM.init`` pytree bridged to torch, and the
same numpy tokens and ``modality_input`` (``tests/conftest.py``'s
``make_batch``, cast to float32 on both sides).  The weights are the
port's ``LM.init`` tree in the reference's layout (``params_to_numpy``),
handed to both sides.  The reference's functions run under ``jax.jit``,
compiled once an arch and shared by the tests (``_jfns``): its encoder,
``logits`` and ``prefill`` as one program, ``decode_step``, and
``value_and_grad`` of ``loss``.

* ``encoder_forward``, ``LM.logits`` and ``prefill`` (logits and every
  cache leaf: self-attention K / V, the source's ``xk`` / ``xv``) to
  1e-4.
* A decode step from the reference's cache (bridged) to 1e-4, and the
  port's own teacher-forced decode against its full-context logits at
  ``tests/test_archs.py``'s 2e-2.
* ``LM.loss`` to 1e-5 and every gradient leaf to 1e-4 relative L2.
* ``modality_spec`` is the reference's; llava-1.5-7b builds and gives
  finite logits; the proxy evaluator refuses these models with a
  ``ValueError`` where the reference's fails deeper down.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _train_pairs import (assert_trees_close,  # noqa: E402,F401
                          one_intraop_thread, tbatch)
from conftest import make_batch  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.specs import modality_spec as j_modality_spec  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_to_numpy, state_from_numpy  # noqa: E402
from repro_torch.configs.specs import modality_spec  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.train.loop import loss_and_grads  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_intraop_thread")


ARCHS = ("whisper-base", "llama-3.2-vision-11b")
CACHE_LEN = 24


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX LM, port LM, JAX params, port params): the port's
    ``LM.init(1)`` tree and the same weights in the reference's layout;
    the port's tree is shared by the tests, which only read it."""
    jcfg = jconfigs.get_smoke_config(arch).with_(dtype="float32")
    tcfg = tconfigs.get_smoke_config(arch).with_(dtype="float32")
    jlm, tlm = JLM(jcfg), TLM(tcfg, device="cpu")
    tp = tlm.init(1)
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp, tcfg))
    return jlm, tlm, jp, tp


@functools.lru_cache(maxsize=None)
def _jfns(arch):
    """The reference's programs of ``arch``, jitted once: ``forward``
    (the encoder's output, ``logits`` and ``prefill`` in one program),
    ``decode`` and ``grad`` (``value_and_grad`` of ``loss``)."""
    jlm = _pair(arch)[0]

    def forward(p, tokens, src):
        enc = (jtr.encoder_forward(p["encoder"], src, jlm.cfg)
               if jlm.cfg.encoder is not None else None)
        cache = jlm.init_cache(tokens.shape[0], CACHE_LEN)
        return (enc, jlm.logits(p, tokens, modality_input=src),
                jlm.prefill(p, tokens, cache, modality_input=src))
    return {"forward": jax.jit(forward), "decode": jax.jit(jlm.decode_step),
            "grad": jax.jit(jax.value_and_grad(jlm.loss, has_aux=True,
                                               allow_int=True))}


def _inputs(cfg, b=2, s=16):
    """make_batch's tokens, labels and modality_input (float32), as numpy
    and as JAX / torch tensors."""
    nb = {k: np.asarray(v).astype(np.float32) if
          k == "modality_input" else np.asarray(v)
          for k, v in make_batch(cfg, b=b, s=s, seed=3).items()}
    return nb, {k: jnp.asarray(v) for k, v in nb.items()}, tbatch(nb)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x).astype(np.float32)


def _assert_caches_close(tcache, jcache, cfg, tol):
    want = state_from_numpy(jax.tree.map(np.asarray, jcache), cfg, "cpu")
    for g, wg in zip(tcache, want):
        assert g.keys() == wg.keys()
        for blk in g:
            got = {**g[blk]["kv"], **{k: v for k, v in g[blk].items()
                                      if k != "kv"}}
            exp = {**wg[blk]["kv"], **{k: v for k, v in wg[blk].items()
                                       if k != "kv"}}
            assert got.keys() == exp.keys()
            for name in got:
                # bf16 caches: one ulp where float32 rounding ties differ
                np.testing.assert_allclose(_np(got[name]), _np(exp[name]),
                                           atol=tol, rtol=1e-2, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_encoder_logits_and_prefill_match_jax(arch):
    jlm, tlm, jp, tp = _pair(arch)
    cfg = tlm.cfg
    nb, jb, tb = _inputs(cfg)
    src = tb["modality_input"]
    assert tuple(src.shape) == modality_spec(cfg, 2).shape
    j_enc, j_logits, (jl, jc) = _jfns(arch)["forward"](
        jp, jb["tokens"], jb["modality_input"])
    if cfg.encoder is not None:
        assert len(tp["encoder"]["layers"]) == cfg.encoder.num_layers
        np.testing.assert_allclose(
            _np(ttr.encoder_forward(tp["encoder"], src, cfg)), _np(j_enc),
            atol=1e-4, rtol=1e-4)
    kinds = ttr.block_kinds(cfg)
    assert kinds == jtr.block_kinds(jlm.cfg)
    assert any(k["xattn"] for k in kinds)
    full = _np(tlm.logits(tp, tb["tokens"], modality_input=src))
    np.testing.assert_allclose(full, _np(j_logits), atol=1e-4, rtol=1e-4)
    tl, tc = tlm.prefill(tp, tb["tokens"], tlm.init_cache(2, CACHE_LEN),
                         modality_input=src)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_caches_close(tc, jc, cfg, 1e-2)
    # one decode step from the reference's cache: no source passed, the
    # cross-attention reads the cached K / V
    tcache = state_from_numpy(jax.tree.map(np.asarray, jc), cfg, "cpu")
    jl, jc2 = _jfns(arch)["decode"](jp, jb["tokens"][:, 0], jc,
                                    jnp.asarray(np.full((2,), 16, np.int32)))
    tl, tc2 = tlm.decode_step(tp, tb["tokens"][:, 0], tcache,
                              torch.full((2,), 16))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_caches_close(tc2, jc2, cfg, 1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_context(arch):
    """Decode reads the source's K / V from the cache (no source passed):
    the port's teacher-forced decode gives its full-context logits to
    2e-2 (bf16 caches; the prefill test holds one decode step to the
    reference's at 1e-4)."""
    _, tlm, _, tp = _pair(arch)
    _, _, tb = _inputs(tlm.cfg)
    src = tb["modality_input"]
    full = _np(tlm.logits(tp, tb["tokens"], modality_input=src))
    _, tc = tlm.prefill(tp, tb["tokens"][:, :8],
                        tlm.init_cache(2, CACHE_LEN),
                        modality_input=src)
    for i in range(8, 12):
        tl, tc = tlm.decode_step(tp, tb["tokens"][:, i], tc,
                                 torch.full((2,), i))
        np.testing.assert_allclose(_np(tl), full[:, i], atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """The training forward with ``modality_input`` (the encoder and
    cross-attention under autograd): loss and metrics to 1e-5, every
    gradient leaf (the encoder's, ``norm_x`` and ``xattn`` included) to
    1e-4 relative L2."""
    jlm, tlm, jp, tp = _pair(arch)
    _, jb, tb = _inputs(tlm.cfg, s=64)
    (jloss, jm), jg = _jfns(arch)["grad"](jp, jb)
    tloss, tm, tg = loss_and_grads(tlm, tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert_trees_close(tg, jg, tlm.cfg, 1e-4, "grads")
    if tlm.cfg.encoder is not None:
        assert float(tg["encoder"]["layers"][0]["attn"]["wq"]["w"]
                     .abs().sum()) > 0


def test_modality_spec_llava_and_the_proxy():
    """``modality_spec`` gives the reference's shape and dtype for every
    arch; llava-1.5-7b (cross-attention every 4th block) builds at a
    reduced width and gives finite logits with a source; the proxy
    evaluator refuses a source model with a ValueError."""
    for arch in tconfigs.ARCH_IDS:
        t = modality_spec(tconfigs.get_config(arch), 3)
        j = j_modality_spec(jconfigs.get_config(arch), 3)
        assert (t is None) == (j is None)
        if t is not None:
            assert t.shape == j.shape and t.dtype == torch.bfloat16 \
                and j.dtype == jnp.bfloat16
    cfg = tconfigs.get_config("llava-1.5-7b").with_(
        num_layers=4, d_model=64, d_ff=128, vocab_size=512,
        num_image_tokens=12,
        attention=tconfigs.AttentionConfig(kind="mha", num_heads=4,
                                           num_kv_heads=4, head_dim=16))
    lm = TLM(cfg, device="cpu")
    params = lm.init(0)
    assert "xattn" in params["layers"][0]["blk3"]
    src = torch.randn(modality_spec(cfg, 2).shape).bfloat16()
    assert torch.isfinite(lm.logits(params, torch.arange(12).reshape(2, 6),
                                     modality_input=src)).all()
    from repro_torch.core.costmodel import TIERS
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.features import TASKS
    from repro_torch.core.space import EfficiencyConfig
    ev = Evaluator(tconfigs.get_config("whisper-base"), TASKS["mmlu"],
                   TIERS["h100-1"], mode="proxy", proxy_steps=1,
                   device="cpu")
    with pytest.raises(ValueError, match="modality_input"):
        ev.evaluate(EfficiencyConfig.default())

"""Port parity of the optimizer: AdamW (masked, fp32 state, one rounding
into the parameter's dtype), the global-norm clip, the cosine schedule
and gradient compression with error feedback, against ``repro.optim`` on
the same numpy trees; and the two traps of the reference's layout:
weight decay reaches a leaf by its rank in the reference's (stacked)
tree, and the global norm counts the frozen weights' gradients."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _train_pairs import (assert_trees_close, batch, flat, jbatch,  # noqa: E402
                          pair, tbatch, to_torch)
from repro.core import apply as japply  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.peft.lora import trainable_mask  # noqa: E402
from repro_torch.train.loop import loss_and_grads  # noqa: E402


def _tree(rng):
    """A small mixed tree: matrices, vectors, a bf16 matrix, an int8
    leaf (numpy)."""
    return {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32),
            "h": {"m": rng.normal(size=(4, 4)).astype(np.float32),
                  "q": rng.integers(-5, 5, (3, 3)).astype(np.int8)}}


def _t(tree, dtypes=None):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)


def test_adamw_matches_jax():
    """Three masked updates with a cosine schedule (warmup 2): params and
    moments within 1e-6 relative; the frozen leaf and the int8 leaf
    untouched; zero-size state for both."""
    rng = np.random.default_rng(0)
    p = _tree(rng)
    mask = {"w": True, "b": True, "h": {"m": False, "q": True}}
    lr_j = jadamw.cosine_schedule(1e-2, 2, 10)
    lr_t = tadamw.cosine_schedule(1e-2, 2, 10)
    jp, js = jax.tree.map(jnp.asarray, p), jadamw.init_adamw(
        jax.tree.map(jnp.asarray, p), mask)
    tp = _t(p)
    ts = tadamw.init_adamw(tp, mask)
    for i in range(3):
        g = {k: v for k, v in _tree(np.random.default_rng(10 + i)).items()}
        jg = jax.tree.map(jnp.asarray, g)
        jg["h"]["q"] = np.zeros((3, 3), jax.dtypes.float0)
        jp, js = jadamw.adamw_update(jg, js, jp, lr=lr_j, mask=mask)
        tg = _t(g)
        tg["h"]["q"] = None
        tp, ts = tadamw.adamw_update(tg, ts, tp, lr=lr_t, mask=mask)
    for k, want in flat(jp).items():
        got = flat(jax.tree.map(lambda t: t.numpy(), tp))[k]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert np.array_equal(tp["h"]["m"].numpy(), p["h"]["m"])
    assert np.array_equal(tp["h"]["q"].numpy(), p["h"]["q"])
    assert ts.mu["h"]["m"].shape == (0,) and ts.nu["h"]["q"].shape == (0,)
    np.testing.assert_allclose(ts.nu["w"].numpy(), js.nu["w"], rtol=1e-6)
    assert ts.step == int(js.step) == 3


@functools.lru_cache(maxsize=None)
def _decayed(stacked: bool):
    """qwen2-1.5b smoke (QKV bias) with DoRA adapters (rank 4), every
    float leaf moved off its init by +0.5 (zero biases would not show
    decay), then one AdamW update with zero gradients on both sides ->
    (port config, port tree before, port tree after, JAX tree after), in
    the reference's layout."""
    jlm, tlm, jp, _ = pair("qwen2-1.5b", scan_layers=stacked)
    eff = jspace.EfficiencyConfig(jspace.ArchChoice(),
                                  jspace.FtChoice("dora", 4, 2),
                                  jspace.InfChoice())
    jq = japply.apply_to_params(jp, eff, jax.random.PRNGKey(1))
    jq = jax.tree.map(lambda a: a + 0.5, jq)
    tq = to_torch(jq, tlm.cfg)
    zeros_j = jax.tree.map(jnp.zeros_like, jq)
    jp2, _ = jax.jit(lambda g, s, p: jadamw.adamw_update(
        g, s, p, lr=0.5, weight_decay=0.1))(zeros_j, jadamw.init_adamw(jq),
                                            jq)
    before = flat(params_to_numpy(tq, tlm.cfg))
    tp2, _ = tadamw.adamw_update(
        jax.tree.map(torch.zeros_like, tq), tadamw.init_adamw(tq), tq,
        lr=0.5, weight_decay=0.1,
        decay=tadamw.decay_mask(tq, stacked=stacked))
    return before, flat(params_to_numpy(tp2, tlm.cfg)), flat(jp2)


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("leaf", [
    ("layers", "blk0", "norm1", "scale"),                 # a norm scale
    ("layers", "blk0", "attn", "wq", "b"),                # a bias
    ("layers", "blk0", "attn", "wq", "lora", "scaling"),  # LoRA scaling
    ("layers", "blk0", "attn", "wq", "lora", "m"),        # DoRA magnitude
    ("final_norm", "scale"),                  # never stacked: never decayed
])
def test_weight_decay_follows_the_reference_rank(leaf, stacked):
    """One update with zero gradients moves a leaf only by weight decay.
    The reference stacks group leaves on the group axis under
    ``scan_layers``, so there a norm scale, a bias, LoRA's ``scaling``
    and DoRA's ``m`` are 2-D and decayed; the port keeps them 1-D per
    group and must decay them all the same (``decay_mask``).  Without
    stacking, and outside the layers, 1-D leaves are not decayed."""
    before, got, want = _decayed(stacked)
    key = "/" + "/".join(leaf if leaf[0] != "layers" or stacked
                         else ("layers", "g0") + leaf[1:])
    np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    decayed = not np.array_equal(before[key], got[key])
    assert decayed == (stacked and leaf[0] == "layers"), (key, decayed)


def test_global_norm_counts_the_frozen_weights():
    """LoRA (rank 4): the clip's norm is over every float gradient, the
    frozen base's included, as the reference's ``value_and_grad`` of the
    whole tree gives it; the adapters' gradients alone have a smaller
    norm, so freezing the base by dropping its gradients would change
    the clip and every update."""
    jlm, tlm, jp, _ = pair("llama3.2-1b")
    eff = jspace.EfficiencyConfig(jspace.ArchChoice(),
                                  jspace.FtChoice("lora", 4, 2),
                                  jspace.InfChoice())
    jq = japply.apply_to_params(jp, eff, jax.random.PRNGKey(1))
    # non-zero b, so that every adapter leaf has a gradient
    jq = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.05 if "b" == getattr(path[-1], "key", "")
        and any(getattr(k, "key", "") == "lora" for k in path) else a, jq)
    tq = to_torch(jq, tlm.cfg)
    b = batch(512)
    jclipped, jnorm = jax.jit(lambda p, bt: jadamw.clip_by_global_norm(
        jax.grad(lambda q: jlm.loss(q, bt)[0])(p), 0.5))(jq, jbatch(b))
    _, _, tg = loss_and_grads(tlm, tq, tbatch(b))
    tclipped, tnorm = tadamw.clip_by_global_norm(tg, 0.5)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-5)
    assert_trees_close(tclipped, jclipped, tlm.cfg, 1e-4, "clipped")
    mask = trainable_mask(tq, "lora")
    only = jax.tree.map(lambda g, m: g if m else None, tg, mask,
                        is_leaf=lambda x: x is None)
    _, adapters_norm = tadamw.clip_by_global_norm(only, 0.5)
    assert float(adapters_norm) < 0.5 * float(tnorm)


def test_cosine_schedule_matches_jax():
    jlr = jadamw.cosine_schedule(3e-4, 5, 20)
    tlr = tadamw.cosine_schedule(3e-4, 5, 20)
    for s in range(0, 26):
        np.testing.assert_allclose(float(tlr(s)),
                                   float(jlr(jnp.asarray(s, jnp.int32))),
                                   rtol=1e-6, err_msg=str(s))


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compression_with_error_feedback_matches_jax(scheme):
    """Three rounds: the compressed gradients, the carried error and the
    ratio equal the reference's (the same fp32 arithmetic)."""
    rng = np.random.default_rng(3)
    shapes = {"w": (16, 12), "b": (12,), "m": (5, 7)}
    jerr = jcompress.init_error_feedback(
        {k: jnp.zeros(s) for k, s in shapes.items()})
    terr = tcompress.init_error_feedback(
        {k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        jout, jerr, jr = jcompress.compress_grads(
            jax.tree.map(jnp.asarray, g), jerr, scheme=scheme,
            topk_ratio=0.1)
        tout, terr, tr = tcompress.compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, terr,
            scheme=scheme, topk_ratio=0.1)
        assert tr == jr
        for k in shapes:
            np.testing.assert_allclose(tout[k].numpy(), jout[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
            np.testing.assert_allclose(terr[k].numpy(), jerr[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    if scheme == "topk":
        assert (tout["w"] != 0).sum().item() == int(16 * 12 * 0.1)

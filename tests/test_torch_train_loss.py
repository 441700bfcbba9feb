"""Port parity of the training forward: ``LM.loss`` and its gradients
against ``jax.value_and_grad(LM.loss, allow_int=True)`` on the same
bridged smoke parameters and numpy batches (float32), remat policies,
the chunked cross-entropy, and quantized bases (int8, int4) trained
through the reference's oracle math.

Bars: loss and metrics 1e-5 relative, every gradient leaf 1e-4 relative
L2; RWKV-6 at its forward bar (ROADMAP C trap 6: loss 1e-2, gradients
2e-2); int8 weights at trap 5's 1e-2 (one upstream ulp is a whole int8
step of an activation)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _train_pairs import (assert_trees_close, batch, jbatch, pair,  # noqa: E402
                          rel_l2, tbatch, to_torch)
from repro.models import model as jmodel  # noqa: E402
from repro.quant.qops import quantize_tree as jquantize  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.transformer import group_forward  # noqa: E402
from repro_torch.train.loop import loss_and_grads  # noqa: E402

BARS = {"qwen2-1.5b": (1e-5, 1e-4), "llama3.2-1b": (1e-5, 1e-4),
        "granite-moe-3b-a800m": (1e-5, 1e-4), "rwkv6-1.6b": (1e-2, 2e-2)}


def _jax_loss_grads(jlm, jp, b):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jlm.loss, has_aux=True, allow_int=True))(jp, jbatch(b))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _check(jlm, tlm, jp, tp, b, loss_tol, grad_tol):
    jloss, jm, jg = _jax_loss_grads(jlm, jp, b)
    tloss, tm, tg = loss_and_grads(tlm, tp, tbatch(b))
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), jm[k], rtol=loss_tol,
                                   atol=loss_tol * 1e-2, err_msg=k)
    np.testing.assert_allclose(float(tloss), jloss, rtol=loss_tol)
    assert_trees_close(tg, jg, tlm.cfg, grad_tol, "grads")
    return tm


@pytest.mark.parametrize("arch", list(BARS))
def test_loss_and_grads_match_jax(arch):
    """qwen2-1.5b (tied head, QKV bias), llama3.2-1b, granite-moe (MoE at
    training capacity: aux losses added to the loss, dropped fraction in
    the metrics) and rwkv6-1.6b; S 128 over ce_chunk 64 (two chunks)."""
    jlm, tlm, jp, tp = pair(arch)
    tm = _check(jlm, tlm, jp, tp, batch(jlm.cfg.vocab_size), *BARS[arch])
    if arch.startswith("granite"):
        assert {"moe_lb_loss", "moe_z_loss", "moe_dropped_frac"} <= tm.keys()
        aux = float(tm["moe_lb_loss"]) + float(tm["moe_z_loss"])
        assert float(tm["loss"]) == pytest.approx(
            float(tm["ce_loss"]) + aux, rel=1e-6)


@pytest.mark.parametrize("quant", ["int8", "int4", "fp8"])
def test_quantized_matmul_train_grads_match_jax(quant):
    """One quantized linear (with a bias) in the training forward, the
    reference's "ref" oracle: the output and the gradients w.r.t. the
    activations, the fp32 scale and the bias equal JAX's on the same
    inputs (the W8A8 path passes gradient through the activations' amax
    scale only; ``round`` has zero gradient on both sides)."""
    from repro.quant import qops as jq
    from repro_torch.bridge import tensor_from_numpy
    from repro_torch.quant import qops as tq
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(48,)).astype(np.float32)
    gy = rng.normal(size=(3, 5, 48)).astype(np.float32)
    jp = jq.quantize_linear({"w": jnp.asarray(w)}, quant=quant)

    def jf(x, scale, b):
        return jq.quantized_matmul(x, {**jp, "scale": scale}, bias=b)
    jy, vjp = jax.vjp(jf, jnp.asarray(x), jp["scale"], jnp.asarray(bias))
    jgx, jgs, jgb = vjp(jnp.asarray(gy))
    tx = torch.from_numpy(x).requires_grad_()
    ts = tensor_from_numpy(np.asarray(jp["scale"])).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    ty = tq.quantized_matmul(tx, {"qw": tensor_from_numpy(
        np.asarray(jp["qw"])), "scale": ts}, bias=tb, impl="train")
    tgx, tgs, tgb = torch.autograd.grad(ty, (tx, ts, tb),
                                        torch.from_numpy(gy))
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-5,
                               atol=1e-5)
    for got, want in ((tgx, jgx), (tgs, jgs), (tgb, jgb)):
        assert rel_l2(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("quant,bars", [("int8", (1e-2, 1e-1)),
                                        ("int4", (1e-5, 1e-4))])
def test_quantized_base_trains_through_the_oracles(quant, bars):
    """A quantized tree's training forward runs the reference's "ref"
    math (QLoRA's int4 base; W8A8): loss and every float gradient (the
    fp32 scales included) equal JAX's; the integer weights get none.
    int8 is held to trap 5's 1e-2 on the loss and 1e-1 on gradients: an
    ulp of difference upstream flips a whole int8 step of an activation,
    which moves a d_model-64 scale's gradient by a few percent (the
    linear itself is held at 1e-5 above)."""
    jlm, tlm, jp, _ = pair("llama3.2-1b")
    jq = jquantize(jp, quant=quant)
    tq = to_torch(jq, tlm.cfg)
    _, _, grads = loss_and_grads(tlm, tq, tbatch(batch(512)))
    assert grads["layers"][0]["blk0"]["attn"]["wq"]["qw"] is None
    assert grads["layers"][0]["blk0"]["attn"]["wq"]["scale"] is not None
    _check(jlm, tlm, jq, tq, batch(512), *bars)


def test_remat_policies_give_bit_equal_grads():
    """Remat none / full / dots recompute the same values: loss, metrics
    and gradients bit-equal (llama3.2-1b and granite-moe smoke)."""
    for arch in ("llama3.2-1b", "granite-moe-3b-a800m"):
        _, tlm, _, tp = pair(arch)
        b = tbatch(batch(tlm.cfg.vocab_size, s=64))
        outs = {}
        for policy in ("none", "full", "dots"):
            lm = tmodel.LM(tlm.cfg.with_(remat_policy=policy), device="cpu")
            outs[policy] = loss_and_grads(lm, tp, b)
        base = outs["none"]
        for policy in ("full", "dots"):
            got = outs[policy]
            assert torch.equal(got[0], base[0]), (arch, policy)
            for k in base[1]:
                assert torch.equal(got[1][k], base[1][k]), (arch, policy, k)
            flat_b = [g for g in _leaves(base[2]) if g is not None]
            flat_g = [g for g in _leaves(got[2]) if g is not None]
            assert all(torch.equal(x, y) for x, y in zip(flat_g, flat_b)), \
                (arch, policy)


def _leaves(t):
    from repro_torch.tree import leaves
    return leaves(t)


@pytest.mark.parametrize("s,chunk,mask,n_valid", [
    (128, 32, False, None),      # four chunks
    (96, 64, False, None),       # 64 does not divide 96: one chunk
    (128, 64, True, 500),        # a mask, padded vocab columns
])
def test_chunked_cross_entropy_matches_jax(s, chunk, mask, n_valid):
    """CE, accuracy and their gradients w.r.t. the states and the head."""
    rng = np.random.default_rng(1)
    b, d, v = 2, 32, 512
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    bt = batch(n_valid or v, b=b, s=s, seed=2, mask=mask)
    m = bt.get("mask")

    def jfn(x, w):
        return jmodel.chunked_cross_entropy(
            x, w, jnp.asarray(bt["labels"]), chunk=chunk, n_valid=n_valid,
            mask=None if m is None else jnp.asarray(m))
    (jce, jacc), jvjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = jvjp((jnp.ones(()), jnp.zeros(())))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tce, tacc = tmodel.chunked_cross_entropy(
        tx, tw, torch.from_numpy(bt["labels"]).long(), chunk=chunk,
        n_valid=n_valid, mask=None if m is None else torch.from_numpy(m))
    tgx, tgw = torch.autograd.grad(tce, (tx, tw))
    tce, tacc = tce.detach(), tacc.detach()
    np.testing.assert_allclose(tce.item(), float(jce), rtol=1e-5)
    assert tacc.item() == float(jacc)
    assert rel_l2(tgx.numpy(), jgx) <= 1e-5
    assert rel_l2(tgw.numpy(), jgw) <= 1e-5


def test_training_forward_is_a_full_sequence_without_cache():
    """``train=True`` is the loss's forward only: with a cache or in
    decode it raises instead of mixing training math into serving."""
    _, tlm, _, tp = pair("llama3.2-1b")
    x = torch.zeros((1, 4, tlm.cfg.d_model))
    cache = tlm.init_cache(1, 8)
    with pytest.raises(ValueError, match="training forward"):
        group_forward(tp["layers"][0], x, tlm.cfg, mode="prefill",
                      cache=cache[0], pos=None, train=True)
    with pytest.raises(ValueError, match="training forward"):
        group_forward(tp["layers"][0], x[:, :1], tlm.cfg, mode="decode",
                      cache=None, pos=None, train=True)

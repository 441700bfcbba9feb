"""Port parity of the Mamba mixer (``models/ssm.py``'s Mamba half)
against ``repro.models.ssm`` in float32, on one block of jamba's smoke
width (d 64, d_inner 128, N 8, d_conv 4), with the same weights, states
and inputs on both sides, drawn with numpy from a seed (``conv_b``,
``D``, ``dt_bias`` and ``A_log`` away from the reference's constant
inits).  The reference's functions run under one module-level
``jax.jit`` each (one compile a length).

* ``mamba_forward`` (output, ``ssm`` and ``conv``) at 16, 64, 200, 256 and
  300 tokens (lengths the reference takes: 1, 1, 1, 2 and 2 chunks), from
  a zero and from a carried state, and ``mamba_decode`` steps after it,
  to 1e-5 relative L2.
* The main path's chunked log-step scan against its plain oracle, the
  sequential recurrence, at chunk boundaries and ragged tails.
* The reference's fault 10: its ``mamba_forward`` refuses 301 tokens
  (``sl % n_chunks``); the port takes them, equal to the sequential
  recurrence, and to the reference's 300-token forward and one decode
  step.
* The training forward (each chunk checkpointed) has the gradients of
  the unchunked oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _train_pairs import one_intraop_thread, rel_l2  # noqa: E402,F401
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import _tree  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_intraop_thread")

ARCH = "jamba-1.5-large-398b"
D_MODEL, BATCH = 64, 2
#: lengths the reference takes (1, 1, 1, 2 and 2 of its chunks)
LENGTHS = (16, 64, 200, 256, 300)
TOL = 1e-5

_j_forward = jax.jit(jssm.mamba_forward, static_argnums=2)
_j_decode = jax.jit(jssm.mamba_decode, static_argnums=2)


def _block(seed=0):
    """(SSMConfig, numpy params in ``init_mamba``'s layout, numpy carried
    state, rng), all drawn with numpy from ``seed``."""
    s = j_smoke(ARCH).ssm
    rng = np.random.default_rng(seed)
    di, n = s.expand * D_MODEL, s.d_state
    dtr = s.dt_rank or D_MODEL // 16

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def linear(d_in, d_out):
        return {"w": rng.uniform(-1, 1, (d_in, d_out)).astype(np.float32)
                / np.float32(d_in ** 0.5)}
    p = {"in_proj": linear(D_MODEL, 2 * di), "conv_w": f32(di, s.d_conv,
                                                          scale=0.3),
         "conv_b": f32(di, scale=0.1), "x_proj": linear(di, dtr + 2 * n),
         "dt_proj": linear(dtr, di),
         "dt_bias": rng.uniform(-4.0, -1.0, (di,)).astype(np.float32),
         "A_log": (np.log(np.arange(1, n + 1, dtype=np.float32))[None]
                   + f32(di, n, scale=0.2)).astype(np.float32),
         "D": f32(di), "out_proj": linear(di, D_MODEL)}
    state = {"ssm": f32(BATCH, di, n), "conv": f32(BATCH, s.d_conv - 1, di)}
    return s, p, state, rng


def _zero(state):
    return {k: np.zeros_like(v) for k, v in state.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_close(got, want, what):
    err = rel_l2(_np(got), _np(want))
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("sl", LENGTHS)
def test_mamba_forward_and_decode_match_jax(sl, carried):
    """The forward's output and both state leaves, then two decode steps
    from the forward's state, to 1e-5 relative L2."""
    s, p, state, rng = _block()
    if not carried:
        state = _zero(state)
    x = rng.normal(size=(BATCH, sl, D_MODEL)).astype(np.float32)
    jy, jst = _j_forward(_j(p), jnp.asarray(x), s, _j(state))
    tp = _tree(p, None)
    ty, tst = tssm.mamba_forward(tp, torch.from_numpy(x), s,
                                 _tree(state, None))
    _assert_close(ty, jy, "y")
    for k in ("ssm", "conv"):
        assert tst[k].dtype == torch.float32
        _assert_close(tst[k], jst[k], k)
    for step in range(2):
        xt = rng.normal(size=(BATCH, 1, D_MODEL)).astype(np.float32)
        jy, jst = _j_decode(_j(p), jnp.asarray(xt), s, jst)
        ty, tst = tssm.mamba_decode(tp, torch.from_numpy(xt), s, tst)
        _assert_close(ty, jy, f"decode {step} y")
        for k in ("ssm", "conv"):
            _assert_close(tst[k], jst[k], f"decode {step} {k}")


def _scan_inputs(sl, seed=3):
    """Random fp32 scan operands (B 2, di 32, N 8) with decays in the
    range a trained model gives (dt 0.001-0.5, A -1..-16)."""
    g = torch.Generator().manual_seed(seed)
    b, di, n = 2, 32, 8
    dt = torch.rand((b, sl, di), generator=g) * 0.5 + 1e-3
    a = -torch.arange(1, n + 1, dtype=torch.float32).repeat(di, 1) \
        * (torch.rand((di, 1), generator=g) + 0.5)
    bmat, cmat = (torch.randn((b, sl, n), generator=g) for _ in range(2))
    x = torch.randn((b, sl, di), generator=g)
    h0 = torch.randn((b, di, n), generator=g)
    return h0, dt, a, bmat, cmat, x


@pytest.mark.parametrize("sl,chunk", [(1, 128), (5, 4), (128, 128),
                                      (129, 128), (301, 128), (300, 7)])
def test_chunked_scan_matches_sequential_oracle(sl, chunk):
    """``mamba_scan`` (Hillis–Steele within a chunk, the state carried
    across chunks) equals the sequential recurrence, y and the final
    state, whatever the chunk boundaries."""
    args = _scan_inputs(sl)
    h, y = tssm.mamba_scan(*args, chunk=chunk)
    h_ref, y_ref = tssm.mamba_scan_ref(*args)
    _assert_close(y, y_ref, "y")
    _assert_close(h, h_ref, "h")


def test_port_takes_any_length_reference_fault_10():
    """301 tokens: the reference asserts ``sl % n_chunks == 0`` (fault 10);
    the port's forward equals itself with the scan swapped for the
    sequential recurrence, and its first 300 tokens and state equal the
    reference's 300-token forward, its 301st the reference's decode
    step after it."""
    s, p, state, rng = _block(1)
    x = rng.normal(size=(BATCH, 301, D_MODEL)).astype(np.float32)
    with pytest.raises(AssertionError):
        jssm.mamba_forward(_j(p), jnp.asarray(x), s, _j(state))
    tp, tx = _tree(p, None), torch.from_numpy(x)
    ty, tst = tssm.mamba_forward(tp, tx, s, _tree(state, None))

    def oracle(h0, dt, a, bmat, cmat, xs, **_):
        return tssm.mamba_scan_ref(h0, dt, a, bmat, cmat, xs)
    mp = pytest.MonkeyPatch()
    mp.setattr(tssm, "mamba_scan", oracle)
    try:
        oy, ost = tssm.mamba_forward(tp, tx, s, _tree(state, None))
    finally:
        mp.undo()
    _assert_close(ty, oy, "y vs oracle")
    for k in ("ssm", "conv"):
        _assert_close(tst[k], ost[k], f"{k} vs oracle")
    jy, jst = _j_forward(_j(p), jnp.asarray(x[:, :300]), s, _j(state))
    jy2, jst = _j_decode(_j(p), jnp.asarray(x[:, 300:]), s, jst)
    _assert_close(ty[:, :300], jy, "y[:300] vs reference")
    _assert_close(ty[:, 300:], jy2, "y[300] vs reference decode")
    for k in ("ssm", "conv"):
        _assert_close(tst[k], jst[k], f"{k} vs reference")


def test_training_forward_gradients_match_the_unchunked_oracle():
    """``train=True`` checkpoints each chunk step: the gradients of every
    weight and the input equal those through the sequential recurrence
    (no checkpoint) at 200 tokens, two chunks of 128 and 72."""
    s, p, state, rng = _block(2)
    x = torch.from_numpy(rng.normal(size=(BATCH, 200, D_MODEL)
                                    ).astype(np.float32))

    def grads(scan):
        tp = _tree(p, None)
        leaves = [tp["in_proj"]["w"], tp["out_proj"]["w"], tp["A_log"],
                  tp["dt_bias"], tp["conv_w"], tp["D"]]
        xx = x.clone().requires_grad_()
        for t in leaves:
            t.requires_grad_()
        mp = pytest.MonkeyPatch()
        if scan is not None:
            mp.setattr(tssm, "mamba_scan", scan)
        try:
            y, st = tssm.mamba_forward(tp, xx, s, _tree(state, None),
                                       train=True)
        finally:
            mp.undo()
        (y.square().mean() + st["ssm"].square().mean()).backward()
        return [t.grad for t in leaves] + [xx.grad]

    def oracle(h0, dt, a, bmat, cmat, xs, **_):
        return tssm.mamba_scan_ref(h0, dt, a, bmat, cmat, xs)
    for got, want in zip(grads(None), grads(oracle)):
        assert float(got.abs().sum()) > 0
        _assert_close(got, want, "grad")

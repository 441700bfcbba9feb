"""Port parity: the plain WKV-6 recurrence (B8's plain version, what
``kernels/wkv6/ops.py`` runs on CPU tensors) against the reference's
Pallas kernel in interpret mode, its chunked oracle and its step-by-step
oracle, on ``test_kernels.py``'s sweep and distributions, with zero and
non-zero carried state, at atol/rtol 1e-4 (the reference's chunked-vs-scan
tolerance).  At sequence lengths that are not a multiple of the 64-token
chunk, where the reference's chunked form asserts, against the scan.
Then the CUDA kernel's own arithmetic (``wkv6_tc_emulate``) against the
same oracles at the card's element-wise bar."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv6.ref import wkv6_chunked_ref as j_chunked  # noqa: E402
from repro.kernels.wkv6.ref import wkv6_scan_ref as j_scan  # noqa: E402
from repro.kernels.wkv6.wkv6 import wkv6_pallas  # noqa: E402
from repro_torch.kernels.wkv6 import ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import (wkv6_chunked_ref,  # noqa: E402
                                          wkv6_scan_ref, wkv6_tc_emulate)

TOL = dict(atol=1e-4, rtol=1e-4)
#: (B, S, H, D) of test_kernels.py::test_wkv6_chunked_vs_scan
SWEEP = [(1, 64, 2, 16), (2, 128, 4, 16), (2, 256, 2, 32)]


def _inputs(b, s, h, d, s0_scale, seed=0):
    """r, k, v, logw, u, s0 as float32 numpy arrays, with the reference
    tests' distributions."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(b, s, h, d))
    k = rng.normal(size=(b, s, h, d)) * 0.3
    v = rng.normal(size=(b, s, h, d))
    logw = -np.abs(rng.normal(size=(b, s, h, d))) * 0.1 - 0.01
    u = rng.normal(size=(h, d)) * 0.1
    s0 = rng.normal(size=(b, h, d, d)) * s0_scale
    return [x.astype(np.float32) for x in (r, k, v, logw, u, s0)]


def _port(args):
    o, s = ops.wkv6(*(torch.from_numpy(a) for a in args))
    return o.numpy(), s.numpy()


def _jax(fn, args, **kw):
    o, s = fn(*(jnp.asarray(a) for a in args), **kw)
    return np.asarray(o), np.asarray(s)


@pytest.mark.parametrize("s0_scale", [0.0, 0.2])
@pytest.mark.parametrize("shape", SWEEP)
def test_plain_wkv6_matches_reference_oracles(shape, s0_scale):
    args = _inputs(*shape, s0_scale)
    o, s = _port(args)
    for ref in (_jax(j_chunked, args, chunk=64), _jax(j_scan, args)):
        np.testing.assert_allclose(o, ref[0], **TOL)
        np.testing.assert_allclose(s, ref[1], **TOL)


@pytest.mark.parametrize("s0_scale", [0.0, 0.2])
def test_plain_wkv6_matches_pallas_kernel_interpret(s0_scale):
    args = _inputs(2, 128, 2, 16, s0_scale, seed=1)
    o, s = _port(args)
    jo, js = _jax(wkv6_pallas, args, interpret=True)
    np.testing.assert_allclose(o, jo, **TOL)
    np.testing.assert_allclose(s, js, **TOL)


@pytest.mark.parametrize("seq", [1, 37, 100])
def test_plain_wkv6_takes_any_length(seq):
    """The tail chunk is padded with r = k = v = 0, logw = 0, which leaves
    the state as the real tokens left it: the chunked form equals the
    reference's scan at lengths its own chunked form refuses."""
    args = _inputs(2, seq, 2, 16, 0.2, seed=seq)
    o, s = _port(args)
    jo, js = _jax(j_scan, args)
    np.testing.assert_allclose(o, jo, **TOL)
    np.testing.assert_allclose(s, js, **TOL)
    if seq > 64:
        with pytest.raises(AssertionError, match="not divisible"):
            _jax(j_chunked, args, chunk=64)


def test_port_scan_and_chunked_forms_agree():
    args = [torch.from_numpy(a) for a in _inputs(1, 150, 2, 16, 0.2, 3)]
    o1, s1 = wkv6_chunked_ref(*args)
    o2, s2 = wkv6_scan_ref(*args)
    torch.testing.assert_close(o1, o2, **TOL)
    torch.testing.assert_close(s1, s2, **TOL)


def test_wkv6_upcasts_bf16_inputs_on_the_cpu():
    """bf16 r/k/v go through the plain version on exact fp32 copies, as
    the reference's op upcasts them."""
    args = _inputs(1, 64, 2, 16, 0.2, seed=4)
    t = [torch.from_numpy(a) for a in args]
    t[:3] = [x.bfloat16() for x in t[:3]]
    o, s = ops.wkv6(*t)
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    ref = _jax(j_scan, [x.float().numpy() for x in t])
    np.testing.assert_allclose(o.numpy(), ref[0], **TOL)
    np.testing.assert_allclose(s.numpy(), ref[1], **TOL)


class _OnOtherDevice:
    """Stands in for a tensor on a device that is neither the CPU, nor
    CUDA, nor meta (the wrapper reads its device first)."""
    device = torch.device("xpu")


def test_wkv6_refuses_other_devices():
    """Meta tensors take the plain version (a dry-run trace's shapes);
    any device other than the CPU, CUDA and meta is refused."""
    args = [torch.from_numpy(a).to("meta") for a in _inputs(1, 4, 2, 16, 0)]
    o, s = ops.wkv6(*args)
    assert o.is_meta and o.shape == args[0].shape and s.is_meta
    with pytest.raises(ValueError, match="unsupported device"):
        ops.wkv6(_OnOtherDevice(), *args[1:])


# --- the CUDA kernel's arithmetic, emulated on the CPU -------------------
#: phase 11's sequence lengths on the card, and those around a sub-chunk
EMU_LENGTHS = [1, 16, 17, 64, 100, 300]
#: element-wise bar of chip_smoke.py phase 11: 1e-4 x the oracle's rms
EMU_BAR = 1e-4


def _emu_inputs(s, strong, bf16, seed):
    """chip_smoke.py phase 11's distributions at B 1, H 2, D 64 (the
    kernel's head dim): r, v ~ N(0, 1), k ~ 0.3 N, logw = -0.1|N| - 0.01
    or, for strong decays, -exp(N); u ~ 0.1 N; s0 ~ 0.2 N.  bf16: r / k /
    v rounded to bf16, as the model hands them to the kernel."""
    rng = np.random.default_rng(seed)
    shape = (1, s, 2, 64)
    r = rng.normal(size=shape)
    k = rng.normal(size=shape) * 0.3
    v = rng.normal(size=shape)
    n = rng.normal(size=shape)
    logw = -np.exp(n) if strong else -np.abs(n) * 0.1 - 0.01
    u = rng.normal(size=(2, 64)) * 0.1
    s0 = rng.normal(size=(1, 2, 64, 64)) * 0.2
    args = [x.astype(np.float32) for x in (r, k, v, logw, u, s0)]
    if bf16:
        args[:3] = [torch.from_numpy(x).bfloat16().float().numpy()
                    for x in args[:3]]
    return args


def _share(out, ref) -> float:
    """The worst element's distance from the oracle, as a share of the
    bar (1.0 = at the bar)."""
    rms = float(np.sqrt(np.mean(np.square(ref))))
    return float(np.max(np.abs(out - ref))) / (EMU_BAR * rms)


def _emulate(args, split):
    o, s = wkv6_tc_emulate(*(torch.from_numpy(a) for a in args), split=split)
    return o.numpy(), s.numpy()


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
@pytest.mark.parametrize("seq", EMU_LENGTHS)
def test_tc_emulation_meets_the_bar_against_the_oracles(seq, strong, bf16):
    """The B8 kernel's plan (16-token sub-chunks with their anchors, 4 x 4
    FMA tiles on the diagonal, TF32 hi + lo operands with fp32 sums, the
    state pass and the output pass) holds o and the final state within
    1e-4 x rms of JAX's scan oracle, element by element, and of its
    chunked oracle where that takes the length."""
    args = _emu_inputs(seq, strong, bf16, seed=seq)
    o, s = _emulate(args, "tf32x3")
    oracles = [_jax(j_scan, args)]
    if seq <= 64 or seq % 64 == 0:
        oracles.append(_jax(j_chunked, args, chunk=64))
    for ro, rs in oracles:
        assert _share(o, ro) <= 1.0
        assert _share(s, rs) <= 1.0


def test_one_bf16_term_misses_the_bar():
    """The split is needed: with one bf16 term for every operand the same
    plan misses the bar on the cases above (the kernel feeds TF32 hi +
    lo)."""
    misses = []
    for seq, strong in ((17, False), (100, True), (300, False)):
        args = _emu_inputs(seq, strong, False, seed=seq)
        ro, rs = _jax(j_scan, args)
        o, s = _emulate(args, "bf16")
        misses.append(max(_share(o, ro), _share(s, rs)))
        o, s = _emulate(args, "tf32x3")
        assert max(_share(o, ro), _share(s, rs)) <= 1.0
    assert min(misses) > 1.0, misses

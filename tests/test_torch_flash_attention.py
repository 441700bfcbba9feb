"""Port parity: the plain PyTorch flash attention (the version the wrapper
takes for CPU tensors, and the one the CUDA kernel is held against on the
card) vs the JAX Pallas kernel (interpret mode) and its jnp oracle, on
the same numpy inputs.  Mirrors ``test_kernels.py::
test_flash_attention_shapes`` and ``::test_flash_attention_window``, and
adds the ragged lengths the engine's power-of-two buckets produce.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops as torch_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

torch.manual_seed(0)


def _qkv(seed, b, s, h, kvh, d, dtype):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.normal(size=(b, s, h, d)), dtype),
            jnp.asarray(rng.normal(size=(b, s, kvh, d)), dtype),
            jnp.asarray(rng.normal(size=(b, s, kvh, d)), dtype))


def _check(q, k, v, window, tol, kernel=True):
    want = [np.asarray(jax_ref(q, k, v, causal=True, window=window),
                       np.float32)]
    if kernel:
        want.append(np.asarray(jax_flash(q, k, v, causal=True,
                                         window=window), np.float32))
    tq, tk, tv = (tensor_from_numpy(np.asarray(x)) for x in (q, k, v))
    o_port = attention_ref(tq, tk, tv, causal=True, window=window)
    o_wrap = torch_ops.flash_attention(tq, tk, tv, causal=True,
                                       window=window)
    assert o_port.dtype == tq.dtype and o_port.shape == tq.shape
    for got in (o_port, o_wrap):
        for w in want:
            np.testing.assert_allclose(got.float().numpy(), w, atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize("b,s,h,kvh,d", [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 4, 2, 64),      # GQA
    (1, 256, 4, 1, 64),      # MQA
    (2, 512, 8, 2, 128),     # bigger head dim
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_matches_jax_shapes(b, s, h, kvh, d, dtype):
    q, k, v = _qkv(0, b, s, h, kvh, d, dtype)
    _check(q, k, v, None, 2e-2 if dtype == jnp.bfloat16 else 2e-5)


@pytest.mark.parametrize("window", [64, 128])
def test_flash_plain_matches_jax_window(window):
    q, k, v = _qkv(1, 2, 256, 4, 4, 64, jnp.float32)
    _check(q, k, v, window, 2e-5)


@pytest.mark.parametrize("s", [8, 16, 100])
def test_flash_plain_ragged_lengths(s):
    """Lengths that are not a multiple of the kernel's 64-row tiles (the
    engine's buckets start at 8); the JAX kernel takes them as one
    whole-length block."""
    q, k, v = _qkv(2, 2, s, 4, 2, 16, jnp.float32)
    _check(q, k, v, None, 2e-5)


class _OnOtherDevice:
    """Stands in for a tensor on a device that is neither the CPU, nor
    CUDA, nor meta (the wrapper reads its device first)."""
    device = torch.device("xpu")


def test_flash_wrapper_refuses_unknown_device():
    """Meta tensors take the plain version (a dry-run trace's shapes);
    any device other than the CPU, CUDA and meta is refused."""
    q, k, v = (tensor_from_numpy(np.asarray(x)).to("meta")
               for x in _qkv(3, 1, 8, 2, 1, 16, jnp.float32))
    out = torch_ops.flash_attention(q, k, v)
    assert out.is_meta and out.shape == q.shape
    with pytest.raises(ValueError, match="unsupported device"):
        torch_ops.flash_attention(_OnOtherDevice(), k, v)
    assert torch_ops.launches == torch_ops.tc_launches == 0


# ---------------------------------------------------------------------------
# The CUDA kernel's tensor-core arithmetic for bf16 operands, on the CPU

#: chip_smoke.py's element limit for bf16 outputs: |out - ref| <= ATOL x
#: rms(V) + RTOL x |ref| (two bf16 ulps, and rounding noise of V's scale)
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-3
LOG2E = 1.4426950408889634


def _tile_step_flash(q, k, v, window, p_terms=2):
    """The tensor-core tile step of ``csrc/flash_attention.cu`` in plain
    torch: 64-row q tiles, 64-key tiles in order from the window's lower
    edge to the causal edge (fully masked tiles skipped), bf16 operands
    with fp32 products, running m (log2 units) and l in fp32, P fed to
    the second product as ``p_terms`` bf16 terms (the kernel: 2) while l
    sums the fp32 p; causal."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = LOG2E / d ** 0.5
    out = torch.empty(b, s, h, d)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # b kh 1 t d
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    qf = q.float().reshape(b, s, kh, g, d).permute(0, 2, 3, 1, 4)
    for q0 in range(0, s, 64):
        rows = torch.arange(q0, min(s, q0 + 64))[:, None]
        qt = qf[..., q0:q0 + 64, :]
        m = torch.full((b, kh, g, len(rows), 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, kh, g, len(rows), d)
        hi = min(t, q0 + 64)
        lo = (max(0, q0 - window + 1) // 64) * 64 if window else 0
        for k0 in range(lo, hi, 64):
            cols = torch.arange(k0, min(t, k0 + 64))[None, :]
            sc = (qt @ kf[..., k0:k0 + 64, :].transpose(-1, -2)) * scale
            ok = cols <= rows
            if window:
                ok &= cols > rows - window
            sc = torch.where(ok, sc, torch.tensor(float("-inf")))
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp2(sc - m_new)
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            pv = torch.zeros_like(acc)
            rest = p
            for _ in range(p_terms):
                term = rest.bfloat16().float()
                pv += term @ vf[..., k0:k0 + 64, :]
                rest = rest - term
            acc = acc * corr + pv
            m = m_new
        o = acc / l.clamp(min=1e-30)
        out[:, q0:q0 + 64] = o.permute(0, 3, 1, 2, 4).reshape(b, -1, h, d)
    return out.to(q.dtype)


def _worst_share(out, ref, v_rms):
    """The worst element's share of chip_smoke.py's bf16 limit."""
    o, r = out.float(), ref.float()
    return float(((o - r).abs() / (BF16_ATOL * v_rms
                                   + BF16_RTOL * r.abs())).max())


def _bf16_qkv(seed, b, s, h, kvh, d):
    """bf16 inputs from numpy as torch tensors, and float32 copies of the
    same values for the Pallas kernel (an fp32 output: the reference is
    not rounded to bf16 again)."""
    q, k, v = _qkv(seed, b, s, h, kvh, d, jnp.bfloat16)
    exact = [jnp.asarray(x, jnp.float32) for x in (q, k, v)]
    return [tensor_from_numpy(np.asarray(x)) for x in (q, k, v)], exact


@pytest.mark.parametrize("s,window", [(8, None), (100, None), (512, None),
                                      (512, 64)])
@pytest.mark.parametrize("h,kvh", [(4, 2), (8, 1)])
def test_tensor_core_rounding_within_chip_limit(s, window, h, kvh):
    """The kernel's bf16 plan (two-term P) against the Pallas kernel in
    interpret mode on the same values in fp32 and against the port's
    plain version, within the element limit chip_smoke.py holds the
    kernel to on the card."""
    (tq, tk, tv), exact = _bf16_qkv(10 + s, 1, s, h, kvh, 64)
    got = _tile_step_flash(tq, tk, tv, window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    v_rms = float(tv.float().pow(2).mean().sqrt())
    pallas = torch.from_numpy(np.array(jax_flash(
        *exact, causal=True, window=window), np.float32))
    plain = attention_ref(tq, tk, tv, causal=True, window=window)
    assert _worst_share(got, pallas, v_rms) <= 1.0
    assert _worst_share(got, plain, v_rms) <= 1.0


def test_one_bf16_term_of_p_is_past_the_chip_limit():
    """Why the kernel feeds P as two bf16 terms: rounded once to bf16
    (8 significant bits), p moves outputs past the element limit; two
    terms stay within it.  (The TPU kernel keeps p in fp32: its
    ``p.astype(v.dtype)`` casts to the fp32 copy of v.)"""
    (tq, tk, tv), _ = _bf16_qkv(20, 2, 100, 4, 2, 64)
    plain = attention_ref(tq, tk, tv)
    v_rms = float(tv.float().pow(2).mean().sqrt())
    assert _worst_share(_tile_step_flash(tq, tk, tv, None, p_terms=1),
                        plain, v_rms) > 1.0
    assert _worst_share(_tile_step_flash(tq, tk, tv, None), plain,
                        v_rms) <= 1.0

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


def test_flash_wrapper_refuses_unknown_device():
    q, k, v = (tensor_from_numpy(np.asarray(x)).to("meta")
               for x in _qkv(3, 1, 8, 2, 1, 16, jnp.float32))
    with pytest.raises(ValueError, match="unsupported device"):
        torch_ops.flash_attention(q, k, v)
    assert torch_ops.launches == 0

"""Port parity: the plain PyTorch paged decode attention (the version the
wrapper takes for CPU tensors, and the one the CUDA kernel is held
against on the card) vs the JAX Pallas kernel (interpret mode) and its
jnp oracle, on the same numpy inputs.  Mirrors the sweep of
``test_serving.py::test_paged_kernel_matches_ref`` plus int8 / fp8 pools.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.ops import paged_attention as jax_paged  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.paged_attention import ops as torch_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402

torch.manual_seed(0)


def _to_torch(x):
    """A JAX array as a torch tensor with the same bits (bf16 and fp8
    cross through integer views)."""
    a = np.array(x)                  # a writable copy
    if a.dtype.name.startswith("float8"):
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return tensor_from_numpy(a)


def _inputs(rng, s, h, kvh, d, page, pps, dtype, kv="same"):
    """numpy-seeded q, pools, block table, lengths (a free slot, a
    partial last page, a full slot) and, for quantized pools, scales."""
    n = s * pps + 1
    q = jnp.asarray(rng.normal(size=(s, h, d)), dtype)
    ks = vs = None
    if kv == "int8":
        kp = jnp.asarray(rng.integers(-127, 128, (n, page, kvh, d)), jnp.int8)
        vp = jnp.asarray(rng.integers(-127, 128, (n, page, kvh, d)), jnp.int8)
    elif kv == "fp8":
        kp = jnp.asarray(rng.normal(size=(n, page, kvh, d)) * 4,
                         jnp.float8_e4m3fn)
        vp = jnp.asarray(rng.normal(size=(n, page, kvh, d)) * 4,
                         jnp.float8_e4m3fn)
    else:
        kp = jnp.asarray(rng.normal(size=(n, page, kvh, d)), dtype)
        vp = jnp.asarray(rng.normal(size=(n, page, kvh, d)), dtype)
    if kv in ("int8", "fp8"):
        ks = jnp.asarray(rng.uniform(0.01, 0.06, (n, kvh)), jnp.float32)
        vs = jnp.asarray(rng.uniform(0.01, 0.06, (n, kvh)), jnp.float32)
    pool = list(rng.permutation(np.arange(1, n)))
    bt = jnp.asarray([[pool.pop() for _ in range(pps)] for _ in range(s)],
                     jnp.int32)
    lengths = np.asarray(rng.integers(1, pps * page, (s,)), np.int32)
    lengths[0], lengths[-1] = 0, pps * page
    return q, kp, vp, bt, jnp.asarray(lengths), ks, vs


def _check(args, tol):
    o_kernel = np.asarray(jax_paged(*args), np.float32)
    o_jref = np.asarray(jax_ref(*args), np.float32)
    targs = [None if a is None else _to_torch(a) for a in args]
    o_port = paged_attention_ref(*targs)
    o_wrap = torch_ops.paged_attention(*targs)       # CPU -> plain version
    assert o_port.dtype == targs[0].dtype
    for got in (o_port, o_wrap):
        got = got.float().numpy()
        np.testing.assert_allclose(got, o_kernel, atol=tol, rtol=tol)
        np.testing.assert_allclose(got, o_jref, atol=tol, rtol=tol)
    assert (o_port[0].float() == 0).all(), "length-0 slot gives zeros"


@pytest.mark.parametrize("s,h,kvh,d,page,pps", [
    (2, 4, 4, 32, 8, 3),      # MHA
    (3, 4, 2, 64, 8, 4),      # GQA
    (2, 8, 1, 64, 16, 2),     # MQA
    (4, 8, 2, 128, 32, 2),    # bigger head dim / page
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_plain_matches_jax_kernel_and_ref(s, h, kvh, d, page, pps,
                                                dtype):
    rng = np.random.default_rng(0)
    args = _inputs(rng, s, h, kvh, d, page, pps, dtype)
    # f32: summation order only; bf16: the output rounds to bf16
    _check(args[:5], 1e-5 if dtype == jnp.float32 else 1e-2)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("s,h,kvh,d,page,pps", [
    (3, 4, 2, 64, 8, 4),      # GQA
    (2, 8, 1, 32, 16, 2),     # MQA
])
def test_paged_plain_matches_jax_quantized_pools(kv, s, h, kvh, d, page,
                                                 pps):
    rng = np.random.default_rng(1)
    args = _inputs(rng, s, h, kvh, d, page, pps, jnp.float32, kv=kv)
    # same dequantized values on both sides; fp32 throughout
    _check(args, 1e-5)


def test_split_plan_covers_horizon():
    """The kernel's token ranges tile every slot's horizon exactly, in
    multiples of 16 tokens, and fill the card at the serving shape."""
    for n_slots, kh, horizon in [(8, 2, 1024), (1, 1, 8), (2, 4, 96),
                                 (64, 8, 4096)]:
        n_split, tps = torch_ops.split_plan(n_slots, kh, horizon)
        assert tps % 16 == 0 and n_split * tps >= horizon
        assert (n_split - 1) * tps < horizon
    assert torch_ops.split_plan(8, 2, 1024) == (16, 64)


def test_wrapper_dispatches_on_device_only():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused; the CPU path is the plain version, bit for bit."""
    rng = np.random.default_rng(2)
    args = [_to_torch(a) for a in _inputs(rng, 2, 4, 2, 32, 8, 2,
                                           jnp.float32)[:5]]
    assert torch.equal(torch_ops.paged_attention(*args),
                       paged_attention_ref(*args))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        torch_ops.paged_attention(*meta)
    assert torch_ops.launches == 0

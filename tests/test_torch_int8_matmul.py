"""Port parity, kernel level: the plain versions of the quantized matmuls
(B4 tiled W8A8, B5 W8A8 decode, B6 fp8 decode), the W4A16 path and the
quantization oracles against ``repro.kernels.int8_matmul`` on the same
numpy inputs.

The JAX side is called eagerly, outside any outer ``jax.jit``: under jit
XLA on the CPU turns ``amax / 127`` into a multiply by the reciprocal
(one ulp away on some rows).  The Pallas wrappers' own jit is kept, and
there XLA contracts the decode epilogue ``acc·xs·ws + b`` into one fused
multiply-add, which the port's plain version computes exactly.  int8
results are held bit for bit; fp8 (fp32 sums in another order) to 1e-5 in
float32 and two bf16 ulps in bfloat16; int4 to 1e-5.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.int8_matmul import ops as jops  # noqa: E402
from repro.kernels.int8_matmul import ref as jref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as tops  # noqa: E402
from repro_torch.kernels.int8_matmul import ref as tref  # noqa: E402
from repro_torch.kvcache.quant import to_store  # noqa: E402

torch.manual_seed(0)

#: test_kernels.py DECODE_SHAPES: M = live decode slots, K/N model-ish,
#: ragged and K > N
DECODE_SHAPES = [(1, 64, 64), (3, 160, 96), (8, 512, 768), (4, 64, 32),
                 (8, 768, 128)]
#: test_kernels.py test_int8_matmul and test_int8_matmul_kernel_ragged_pad
TILED_SHAPES = [(128, 256, 128), (256, 512, 256), (64, 128, 512),
                (130, 520, 320), (65, 192, 96), (257, 513, 129)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bits(x) -> np.ndarray:
    """Raw bits of an array or tensor, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.view({1: torch.uint8, 2: torch.int16,
                    4: torch.int32}[x.element_size()]).numpy()
    a = np.asarray(x)
    return a.view(f"u{a.itemsize}")


def _assert_bits(t, j):
    np.testing.assert_array_equal(_bits(t), _bits(j))


def _operands(m, k, n, seed=0, dtype="bfloat16"):
    """Raw activations, an int8 weight with its scales, and a bias, as in
    test_kernels.py's ``_decode_operands``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n))
    ws = (np.abs(w).max(axis=0) / 127.0).astype(np.float32)
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    bias = rng.standard_normal((n,)).astype(np.float32)
    jx = jnp.asarray(x, DTYPES[dtype][0])
    return jx, _t(jx), wq, ws, bias


@pytest.mark.parametrize("shape", [(200, 1536), (3, 160), (64, 1)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_rowwise_and_colwise_bit_equal(shape, dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(shape) * 3, DTYPES[dtype][0])
    x = x.at[0].set(0)                        # a zero row: the 1e-8 floor
    for jfn, tfn in ((jref.quantize_rowwise, tref.quantize_rowwise),
                     (jref.quantize_colwise, tref.quantize_colwise)):
        jq, js = jfn(x)
        tq, ts = tfn(_t(x))
        _assert_bits(tq, jq)
        _assert_bits(ts, js)


def test_int4_quantize_pack_unpack_bit_equal():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    jp, js = jref.quantize_int4_colwise(jnp.asarray(w))
    tp, ts = tref.quantize_int4_colwise(torch.from_numpy(w))
    assert tp.dtype == torch.uint8 and tuple(tp.shape) == (32, 48)
    _assert_bits(tp, jp)
    _assert_bits(ts, js)
    w4 = rng.integers(-8, 8, (64, 32)).astype(np.int8)
    _assert_bits(tref.pack_int4(torch.from_numpy(w4)),
                 jref.pack_int4(jnp.asarray(w4)))
    np.testing.assert_array_equal(
        tref.unpack_int4(tref.pack_int4(torch.from_numpy(w4))).numpy(), w4)


@pytest.mark.parametrize("m,k,n", TILED_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_matmul_bit_equal(m, k, n, dtype):
    """The tiled W8A8 op (CPU: its plain version) against the oracle and
    the Pallas kernel run through the interpreter."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((m, k)))
    w = jnp.asarray(rng.standard_normal((k, n)))
    xq, xs = jref.quantize_rowwise(x)
    wq, ws = jref.quantize_colwise(w)
    jdt, tdt = DTYPES[dtype]
    t = tops.int8_matmul(_t(xq), _t(wq), _t(xs), _t(ws), out_dtype=tdt)
    assert tops.launches == tops.tc_launches == 0   # CPU: no kernel launch
    _assert_bits(t, jref.int8_matmul_ref(xq, wq, xs, ws, out_dtype=jdt))
    _assert_bits(t, jops.int8_matmul(xq, wq, xs, ws, out_dtype=jdt,
                                     use_kernel=True))


@pytest.mark.parametrize("m,k,n", DECODE_SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_w8a8_decode_bit_equal(m, k, n, with_bias, dtype):
    """B5's plain version == JAX ``w8a8_matmul_decode`` bit for bit: row
    scales, in-kernel quantization, exact int32 sums and the bias folded
    into one fused multiply-add."""
    jx, tx, wq, ws, bias = _operands(m, k, n, dtype=dtype)
    b = bias if with_bias else None
    j = jops.w8a8_matmul_decode(jx, jnp.asarray(wq), jnp.asarray(ws),
                                bias=None if b is None else jnp.asarray(b))
    t = tops.w8a8_matmul_decode(tx, torch.from_numpy(wq),
                                torch.from_numpy(ws),
                                bias=None if b is None
                                else torch.from_numpy(b))
    assert t.dtype == DTYPES[dtype][1] and tuple(t.shape) == (m, n)
    _assert_bits(t, j)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_w8a8_decode_counts_no_launch_on_the_cpu(dtype):
    """On CPU tensors B5 takes its plain version: neither its launch
    counter nor its tensor-core step's moves, at a shape that takes the
    tensor-core step on the card."""
    _, tx, wq, ws, bias = _operands(8, 1536, 256, dtype=dtype)
    tops.decode_launches = tops.decode_tc_launches = 0
    tops.w8a8_matmul_decode(tx, torch.from_numpy(wq), torch.from_numpy(ws),
                            bias=torch.from_numpy(bias))
    assert tops.decode_launches == tops.decode_tc_launches == 0


def test_bias_epilogue_is_one_fused_multiply_add():
    """Where a separate multiply and add would round twice, the plain
    epilogue rounds once, as XLA's contracted epilogue does."""
    jx, tx, wq, ws, bias = _operands(8, 512, 768, dtype="float32")
    xq, xs = tref.quantize_rowwise(tx)
    acc = tref.int8_dot(xq, torch.from_numpy(wq)).float() * xs[:, None]
    wst, bt = torch.from_numpy(ws)[None, :], torch.from_numpy(bias)[None, :]
    two = acc * wst + bt
    fused = tref.fma_f32(acc, wst.expand_as(acc), bt.expand_as(acc))
    exact = acc.double() * wst.double() + bt.double()
    assert (two != fused).any()
    assert ((fused.double() - exact).abs()
            <= (two.double() - exact).abs()).all()
    j = jops.w8a8_matmul_decode(jx, jnp.asarray(wq), jnp.asarray(ws),
                                bias=jnp.asarray(bias))
    _assert_bits(fused, j)


def _assert_bf16_ulps(t, j, ulps=2):
    t = t.float().numpy()
    j = np.asarray(j, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(j), 1e-30))) - 7)
    assert (np.abs(t - j) <= ulps * ulp).all()


@pytest.mark.parametrize("m,k,n", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fp8_decode_close(m, k, n, dtype):
    jx, tx, _, _, bias = _operands(m, k, n, dtype=dtype)
    rng = np.random.default_rng(1)
    w = rng.standard_normal((k, n))
    ws = (np.abs(w).max(axis=0) / 448.0).astype(np.float32)
    wq8 = np.asarray(jnp.asarray(w / ws, jnp.float8_e4m3fn))
    j = jops.fp8_matmul_decode(jx, jnp.asarray(wq8), jnp.asarray(ws),
                               bias=jnp.asarray(bias))
    t = tops.fp8_matmul_decode(tx, _t(wq8), torch.from_numpy(ws),
                               bias=torch.from_numpy(bias))
    if dtype == "float32":
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    else:
        _assert_bf16_ulps(t, j)


@pytest.mark.parametrize("m,k,n", [(64, 128, 64), (3, 128, 96)])
def test_int4_matmul_close(m, k, n):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed, scale = jref.quantize_int4_colwise(
        jnp.asarray(rng.standard_normal((k, n))))
    j = jops.int4_matmul(jnp.asarray(x), packed, scale)
    t = tops.int4_matmul(torch.from_numpy(x), _t(packed), _t(scale))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


def test_qwen2_down_width_is_exact():
    """M 8, K 8960 (qwen2's ``down``) x N 1536, with sums far beyond 2**24:
    one fp32 product over the whole K is inexact there, the port's tiled
    sum is exact and B5's plain version equals JAX's bit for bit."""
    rng = np.random.default_rng(5)
    k, n = 8960, 1536
    x = (1.0 + 0.1 * rng.standard_normal((8, k))).astype(np.float32)
    w = np.abs(rng.standard_normal((k, n)))
    ws = (w.max(axis=0) / 127.0).astype(np.float32)
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    xq, _ = tref.quantize_rowwise(torch.from_numpy(x))
    exact = xq.numpy().astype(np.int64) @ wq.astype(np.int64)
    assert exact.max() > 2 ** 24
    whole = (xq.float() @ torch.from_numpy(wq).float()).double().numpy()
    assert (whole != exact).any()
    np.testing.assert_array_equal(
        tref.int8_dot(xq, torch.from_numpy(wq)).numpy(), exact)
    j = jops.w8a8_matmul_decode(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(wq), jnp.asarray(ws))
    t = tops.w8a8_matmul_decode(_t(jnp.asarray(x, jnp.bfloat16)),
                                torch.from_numpy(wq), torch.from_numpy(ws))
    _assert_bits(t, j)


def test_fp8_conversion_near_448():
    """torch's e4m3 cast and ml_dtypes agree bit for bit up to
    448·(1 + 2**-23); above 464 ml_dtypes gives NaN and torch saturates,
    which the KV store conversion (``to_store``) makes NaN as well."""
    near = np.concatenate([np.linspace(400.0, 448.0, 97),
                           [448.0 * (1 + 2 ** -23), 452.0, 463.9, 464.0],
                           -np.linspace(400.0, 448.0, 97)]).astype(
        np.float32)
    ref = near.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    np.testing.assert_array_equal(
        torch.from_numpy(near).to(torch.float8_e4m3fn).view(
            torch.uint8).numpy(), ref)
    over = np.asarray([470.0, -500.0, 1e6], np.float32)
    ref = over.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    assert (torch.from_numpy(over).to(torch.float8_e4m3fn).view(
        torch.uint8).numpy() != ref).all()
    np.testing.assert_array_equal(
        to_store(torch.from_numpy(over), torch.float8_e4m3fn).view(
            torch.uint8).numpy(), ref)
    # a weight column whose amax lands exactly on 448 after scaling
    w = np.zeros((4, 3), np.float32)
    w[:, 0] = [1.0, -2.0, 3.5, -7.0]
    w[:, 1] = [448.0, -448.0, 1.0, 0.0]
    w[:, 2] = [1e-3, 2e-3, -3e-3, 0.0]
    from repro.quant.qops import quantize_linear as jql
    from repro_torch.quant.qops import quantize_linear as tql
    j = jql({"w": jnp.asarray(w)}, quant="fp8")
    t = tql({"w": torch.from_numpy(w)}, quant="fp8")
    _assert_bits(t["qw"], j["qw"])
    _assert_bits(t["scale"], j["scale"])

"""Port parity: the plain RMSNorm (B7's plain version, what
``kernels/rmsnorm/ops.py`` runs on CPU tensors) against the reference's
Pallas kernel in interpret mode and its oracle, on ``test_kernels.py``'s
``test_rmsnorm`` sweep at the reference's tolerances (fp32 1e-5, bf16
2e-2), and the model's ``norm_apply("rmsnorm")`` against
``rmsnorm_apply``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_ref  # noqa: E402
from repro.kernels.rmsnorm.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.rmsnorm import ops  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

SHAPES = [(4, 64, 256), (2, 128, 512), (1, 8, 128)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(shape, dtype, seed=0):
    """x and scale in ``dtype`` on both sides, from the same numpy draw."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype)
    w = jnp.asarray(rng.normal(size=shape[-1:]).astype(np.float32), dtype)
    return (x, w), (tensor_from_numpy(np.asarray(x)),
                    tensor_from_numpy(np.asarray(w)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_rmsnorm_matches_pallas_kernel_and_oracle(shape, dtype):
    (jx, jw), (tx, tw) = _inputs(shape, getattr(jnp, dtype))
    out = ops.rmsnorm(tx, tw)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    rows = int(np.prod(shape[:-1]))
    kern = rmsnorm_pallas(jx, jw, block_rows=256 if rows % 256 == 0
                          else rows, interpret=True)
    tol = TOL[dtype]
    for ref in (kern, j_ref(jx, jw)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)


#: row lengths where the kernel's steps split: qwen2-1.5b's 1,536 and
#: llama3.2-1b's 2,048 (the warp step's longest), 8,192 (the long-row
#: step's longest) and 1,000 / 1,001 (not a whole number of 8-element
#: vectors at 1,001)
SPLIT_LENGTHS = [1536, 2048, 8192, 1000, 1001]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", SPLIT_LENGTHS)
def test_plain_rmsnorm_at_the_kernel_step_lengths(d, dtype):
    """The plain version against the Pallas kernel in interpret mode and
    the oracle at the row lengths where the CUDA kernel's warp step and
    long-row step divide, 10 rows (not a multiple of the warps a block)."""
    (jx, jw), (tx, tw) = _inputs((10, d), getattr(jnp, dtype), seed=d)
    out = ops.rmsnorm(tx, tw)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = TOL[dtype]
    for ref in (rmsnorm_pallas(jx, jw, block_rows=10, interpret=True),
                j_ref(jx, jw)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)


def test_rmsnorm_counts_no_warp_step_launch_on_the_cpu():
    ops.launches = ops.warp_launches = 0
    ops.rmsnorm(torch.ones((3, 1536), dtype=torch.bfloat16),
                torch.ones(1536, dtype=torch.bfloat16))
    assert ops.launches == ops.warp_launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_apply_rmsnorm_on_the_cpu_is_rmsnorm_apply(dtype):
    """The model's RMSNorm goes through the B7 op; on CPU tensors that is
    the plain version, which is the reference's ``rmsnorm_apply``."""
    (jx, jw), (tx, tw) = _inputs((3, 5, 64), getattr(jnp, dtype), seed=1)
    got = tl.norm_apply("rmsnorm", {"scale": tw}, tx, 1e-5)
    assert torch.equal(got, tl.rmsnorm_apply({"scale": tw}, tx, 1e-5))
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jl.rmsnorm_apply({"scale": jw}, jx), np.float32),
        atol=TOL[dtype], rtol=TOL[dtype])


def test_norm_apply_counts_no_launch_on_the_cpu():
    ops.launches = 0
    x = torch.ones((2, 8))
    tl.norm_apply("rmsnorm", {"scale": torch.ones(8)}, x, 1e-5)
    tl.norm_apply("layernorm", {"scale": torch.ones(8),
                                "bias": torch.zeros(8)}, x, 1e-5)
    assert ops.launches == 0


class _OnOtherDevice:
    """Stands in for a tensor on a device that is neither the CPU, nor
    CUDA, nor meta (the wrapper reads its device first)."""
    device = torch.device("xpu")


def test_rmsnorm_refuses_other_devices():
    """Meta tensors take the plain version (a dry-run trace's shapes);
    any device other than the CPU, CUDA and meta is refused."""
    x = torch.ones((2, 8), device="meta")
    out = ops.rmsnorm(x, torch.ones(8, device="meta"))
    assert out.is_meta and out.shape == x.shape
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rmsnorm(_OnOtherDevice(), torch.ones(8))

"""The numerics of the tensor-core steps of the paged decode kernel (B1)
and the fp8 decode matmul (B6), emulated on the CPU: the widening of
e4m3 weights to bf16, B6's order of sums (k-steps of 16 on four warps,
then split-K in a fixed order) and B1's step (bf16 q·k, P as hi + lo bf16
terms, warps and splits merged in order), each held within the element
limit ``chip_smoke.py`` holds the kernel to on the card, against the
port's plain version and, for B1, the JAX oracle on the same values.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as qmm  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import (_epilogue,  # noqa: E402
                                                 fp8_decode_ref)
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.quant.qops import quantize_linear  # noqa: E402

#: chip_smoke.py's bf16 element limit: |out - ref| <= ATOL * rms + RTOL |ref|
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-3
LOG2E = 1.4426950408889634
FP8 = torch.float8_e4m3fn


def _worst_share(out, ref, rms):
    o, r = out.float(), ref.float()
    return float(((o - r).abs() / (BF16_ATOL * rms
                                   + BF16_RTOL * r.abs())).max())


def _widen_like_b6(codes: torch.Tensor) -> torch.Tensor:
    """e4m3 bytes -> bf16 as B6's tensor-core step widens them: e4m3 ->
    f16 (cvt.rn.f16x2.e4m3x2, exact), the f16's exponent and mantissa
    moved down 3 bits into a bf16, times 2^112 in bf16."""
    h = codes.view(FP8).to(torch.float16).view(torch.int16).int() & 0xffff
    b = ((h & 0x7fff) >> 3) | (h & 0x8000)
    b = torch.where(b >= 0x8000, b - 0x10000, b).to(torch.int16)
    return b.view(torch.bfloat16) * torch.tensor(2.0 ** 112,
                                                 dtype=torch.bfloat16)


def test_every_finite_e4m3_code_widens_exactly():
    """Every finite e4m3 code gives the same value widened to fp32 (the
    plain version), to bf16 (torch) and through B6's bit move; the f16
    step sees only normal or zero values with three mantissa bits."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    f32 = codes.view(FP8).float()
    finite = torch.isfinite(f32)
    assert int(finite.sum()) == 254            # 0x7f and 0xff are NaN
    via_b6 = _widen_like_b6(codes)
    assert torch.equal(via_b6.float()[finite], f32[finite])
    assert torch.equal(codes.view(FP8).to(torch.bfloat16).float()[finite],
                       f32[finite])
    h = codes.view(FP8).to(torch.float16).view(torch.int16).int() & 0xffff
    h = h[finite]
    assert ((h & 0x7f) == 0).all()             # at most 3 mantissa bits
    assert (((h & 0x7c00) != 0) | ((h & 0x7fff) == 0)).all()   # no subnormal


def _b6_tile_order(x, wq, ws, bias):
    """B6's tensor-core step in fp32 on the CPU: bf16 x times bf16-widened
    w, summed over k-steps of 16, k-step j of a split going to warp j % 4,
    the warps added in order, then the splits in order, then the
    epilogue."""
    m, k = x.shape
    n = wq.shape[1]
    n_split, kps = qmm.decode_split(m, k, n, tc=True)
    xb = x.bfloat16().float()
    wb = wq.to(torch.bfloat16).float()
    acc = torch.zeros(m, n)
    for sp in range(n_split):
        k0, k1 = sp * kps, min(k, (sp + 1) * kps)
        warps = [torch.zeros(m, n) for _ in range(4)]
        for j, ks in enumerate(range(k0, k1, 16)):
            ke = min(ks + 16, k1)
            warps[j % 4] += xb[:, ks:ke] @ wb[ks:ke]
        part = ((warps[0] + warps[1]) + warps[2]) + warps[3]
        acc = acc + part
    return _epilogue(acc, ws, bias, x.dtype)


#: qwen2-1.5b's linears (K, N), as chip_smoke.py phase 8 times them
QWEN2_LINEARS = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]


@pytest.mark.parametrize("k,n", QWEN2_LINEARS)
@pytest.mark.parametrize("m", [1, 8, 128])
def test_b6_tile_order_within_the_chip_limit(m, k, n):
    """B6's order of sums at qwen2-1.5b's linear shapes stays within
    phase 8's element limit of the plain version (limit relative to the
    output's rms)."""
    rng = np.random.default_rng(m * 7 + n)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.02)
    p = quantize_linear({"w": w}, quant="fp8")
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                         ).bfloat16()
    bias = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)
                            * 0.1).bfloat16()
    ref = fp8_decode_ref(x, p["qw"], p["scale"], bias)
    got = _b6_tile_order(x, p["qw"], p["scale"], bias)
    rms = float(ref.float().pow(2).mean().sqrt())
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert _worst_share(got, ref, rms) <= 1.0


def test_b6_plan_fills_the_card_in_whole_stages():
    """The tensor-core step's split-K plan: k-ranges in whole 64-row
    stages that cover K, at most 8 (one thread block cluster), and enough
    blocks for 132 SMs wherever K allows it."""
    for k, n in QWEN2_LINEARS:
        n_split, kps = qmm.decode_split(8, k, n, tc=True)
        assert kps % 64 == 0 and (n_split - 1) * kps < k <= n_split * kps
        assert n_split <= 8
        assert -(-n // 128) * n_split >= 132 or n_split == 8


def _b1_tile_step(q, kp, vp, bt, lens, ks=None, vs=None):
    """B1's tensor-core step on the CPU: row groups of 16 query heads,
    the plan's splits, 64-key tiles of which each of 4 warps takes 16
    keys with its own online softmax in log2 units, p (times v's scale)
    fed as hi + lo bf16 terms, the warps merged in order, then the live
    splits merged in order."""
    s_n, h, d = q.shape
    page, kh_n = kp.shape[1], kp.shape[2]
    g_n = h // kh_n
    horizon = bt.shape[1] * page
    rgs = -(-g_n // 16)
    n_split, tps = pops.split_plan(s_n, kh_n, horizon, rgs)
    scale = LOG2E / math.sqrt(d)
    out = torch.zeros(s_n, h, d)
    for s in range(s_n):
        ln = max(0, min(int(lens[s]), horizon))
        n_live = max(1, -(-ln // tps))
        pos = torch.arange(ln)
        pg = bt[s, pos // page].long()
        for kh in range(kh_n):
            kk = kp[pg, pos % page, kh].float()
            vv = vp[pg, pos % page, kh].float()
            ksc = (ks[pg, kh] if ks is not None else torch.ones(ln)) * scale
            vsc = vs[pg, kh] if vs is not None else torch.ones(ln)
            for rg in range(rgs):
                h0 = kh * g_n + rg * 16
                rows = min(16, g_n - rg * 16)
                qr = q[s, h0:h0 + rows].float()
                parts = []
                for sp in range(n_live):
                    t0, t1 = sp * tps, min(sp * tps + tps, ln)
                    m = torch.full((4, rows), -1e30)
                    l = torch.zeros(4, rows)
                    o = torch.zeros(4, rows, d)
                    for k0 in range(t0, t1, 64):
                        for w in range(4):
                            a, b = k0 + 16 * w, min(k0 + 16 * w + 16, t1)
                            if a >= b:
                                continue
                            sc = (qr @ kk[a:b].T) * ksc[a:b]
                            m_new = torch.maximum(m[w], sc.amax(-1))
                            corr = torch.exp2(m[w] - m_new)
                            p = torch.exp2(sc - m_new[:, None])
                            l[w] = l[w] * corr + p.sum(-1)
                            pv = p * vsc[a:b]
                            hi = pv.bfloat16().float()
                            lo = (pv - hi).bfloat16().float()
                            o[w] = (o[w] * corr[:, None] + hi @ vv[a:b]
                                    + lo @ vv[a:b])
                            m[w] = m_new
                    mx = m.amax(0)
                    f = torch.exp2(m - mx)
                    lsum = sum(l[w] * f[w] for w in range(4))
                    acc = sum(o[w] * f[w][:, None] for w in range(4))
                    parts.append((mx, lsum, acc))
                mx = torch.stack([pt[0] for pt in parts]).amax(0)
                lsum, acc = 0.0, 0.0
                for pm, pl, pa in parts:
                    f = torch.exp2(pm - mx)
                    lsum = lsum + pl * f
                    acc = acc + pa * f[:, None]
                out[s, h0:h0 + rows] = acc / torch.clamp(lsum, min=1e-30
                                                         )[:, None]
    return out.to(q.dtype)


def _paged(rng, h, kvh, d, page, pps, kv):
    """numpy-seeded bf16 q and bf16 / int8 pools, a block table and
    lengths: a free slot, a one-token slot, a partial last page, a full
    slot."""
    s = 4
    n = s * pps + 1
    q = torch.from_numpy(rng.normal(size=(s, h, d)).astype(np.float32)
                         ).bfloat16()
    ks = vs = None
    if kv == "int8":
        kp = torch.from_numpy(rng.integers(-127, 128, (n, page, kvh, d))
                              .astype(np.int8))
        vp = torch.from_numpy(rng.integers(-127, 128, (n, page, kvh, d))
                              .astype(np.int8))
        ks = torch.from_numpy(rng.uniform(0.01, 0.06, (n, kvh))
                              .astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.01, 0.06, (n, kvh))
                              .astype(np.float32))
    else:
        kp, vp = (torch.from_numpy(rng.normal(size=(n, page, kvh, d))
                                   .astype(np.float32)).bfloat16()
                  for _ in range(2))
    bt = torch.from_numpy(rng.permutation(np.arange(1, n))[:s * pps]
                          .reshape(s, pps).astype(np.int32))
    lens = torch.tensor([0, 1, pps * page - page // 2, pps * page],
                        dtype=torch.int32)
    return q, kp, vp, bt, lens, ks, vs


@pytest.mark.parametrize("h,kvh,kv", [(12, 2, "bf16"), (12, 1, "bf16"),
                                      (32, 1, "bf16"), (12, 1, "int8")])
def test_b1_step_within_the_chip_limit(h, kvh, kv):
    """B1's tensor-core step at groups of 6, 12 and 32 query heads (and
    12 over an int8 pool) within phase 3's bf16 element limit of the
    plain version and of the JAX oracle on the same values."""
    rng = np.random.default_rng(h * 10 + kvh)
    args = _paged(rng, h, kvh, 64, 16, 12, kv)
    q, kp, vp, bt, lens, ks, vs = args
    got = _b1_tile_step(*args)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got[0] == 0).all(), "a length-0 slot gives zeros"
    v = vp.float() if vs is None else vp.float() * vs[:, None, :, None]
    rms = float(v.pow(2).mean().sqrt())
    plain = paged_attention_ref(*args)
    exact = [None if t is None else jnp.asarray(t.float().numpy())
             for t in (q, kp, vp)]
    oracle = torch.from_numpy(np.array(jax_ref(
        exact[0], exact[1], exact[2], jnp.asarray(bt.numpy()),
        jnp.asarray(lens.numpy()),
        None if ks is None else jnp.asarray(ks.numpy()),
        None if vs is None else jnp.asarray(vs.numpy())), np.float32))
    assert _worst_share(got, plain, rms) <= 1.0
    assert _worst_share(got, oracle, rms) <= 1.0

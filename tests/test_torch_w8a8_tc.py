"""The tensor-core step of the W8A8 decode matmul (B5), emulated on the
CPU lane by lane: the weight stage as the ``cp.async`` ring lays it out
(16-byte chunks XOR-swizzled by row), each lane's 8-byte loads turned into
k-packed words by the byte transpose (``transpose_quads``), the
``mma.sync`` m16n8k32 fragments those words and the quantized x rows form,
the fixed permutation of mma rows to columns undone where the sums are
stored, the row scales from the per-range partial maxima of a cluster, and
the ranges' int32 sums added in range order.  The emulation must give the
bits of the port's plain version and of JAX's ``w8a8_matmul_decode`` on
the same numpy inputs, at qwen2-1.5b's linears; and the wrapper's plan
must cut K in whole ring stages, at most 8 ranges, enough blocks for the
card, within the block's shared memory.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.int8_matmul import ops as jops  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as qmm  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import (fma_f32,  # noqa: E402
                                                 quantize_rowwise,
                                                 w8a8_decode_ref)

#: csrc/w8a8_decode.cu tc_step: columns, x rows and k-rows a block / stage
BN, MT, KS = 128, 8, 64
#: qwen2-1.5b's linears (K, N): wq / wo, wk / wv, gate / up, down
QWEN2_LINEARS = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]
SMEM_LIMIT = 227 * 1024


def _plan(m, k, n):
    """B5's tensor-core plan, as its wrapper makes it."""
    return qmm.decode_split(m, k, n, tc=True,
                            max_range_k=qmm.W8A8_TC_MAX_RANGE_K)


def _byte_perm(x, y, s):
    """CUDA ``__byte_perm(x, y, s)`` on uint32 arrays: result byte i is
    byte (nibble i of s) of the 8 bytes y:x."""
    src = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint32)
    for i in range(4):
        sel = np.uint64(8 * ((s >> (4 * i)) & 7))
        out |= ((src >> sel) & np.uint64(0xff)).astype(np.uint32) << np.uint32(
            8 * i)
    return out


def _transpose_quads(r):
    """``int8_pack.cuh`` transpose_quads over the last axis (4 words: k-row
    q holds columns 0-3 as bytes) -> word j holds column j's k-rows 0-3."""
    t0 = _byte_perm(r[..., 0], r[..., 1], 0x5140)
    t1 = _byte_perm(r[..., 0], r[..., 1], 0x7362)
    t2 = _byte_perm(r[..., 2], r[..., 3], 0x5140)
    t3 = _byte_perm(r[..., 2], r[..., 3], 0x7362)
    return np.stack([_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                     _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)],
                    -1)


def _wsw(r, c):
    """Byte offset of 16-byte chunk c of weight row r in a stage."""
    return r * BN + ((c ^ (((r >> 2) & 3) << 1)) << 4)


def _words(b):
    """(..., 4) uint8 -> (...) uint32, little-endian."""
    assert b.dtype == np.uint8
    b = b.astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _bytes(w):
    """(...) uint32 -> (..., 4) int8 values, little-endian."""
    return np.stack([((w >> np.uint32(8 * i)) & np.uint32(0xff)).astype(
        np.uint8) for i in range(4)], -1).view(np.int8)


def _lane_index():
    """The lane-level layout of one warp step: (warp, lane, p, q, byte) ->
    the byte of the stage the lane loads (warp w takes k-step w // 2 and
    column half w % 2; lane 4g + t reads k-rows 32 ks + 16 p + 4 t + q,
    columns 64 half + 8 g .. + 7)."""
    w = np.arange(4)[:, None, None, None, None]
    lane = np.arange(32)[None, :, None, None, None]
    p = np.arange(2)[None, None, :, None, None]
    q = np.arange(4)[None, None, None, :, None]
    b = np.arange(8)[None, None, None, None, :]
    g, t, ks, half = lane >> 2, lane & 3, w >> 1, w & 1
    return (_wsw(ks * 32 + 16 * p + 4 * t + q, half * 4 + (g >> 1))
            + (g & 1) * 8 + b)


def _b5_tc_emulate(x: np.ndarray, wq: np.ndarray):
    """The tensor-core step's int32 sums and row scales for x (M, K)
    float32 values and wq (K, N) int8, lane by lane.  Returns (acc (M, N)
    int64, xs (M,) float32)."""
    m, k = x.shape
    n = wq.shape[1]
    assert n % 16 == 0 and k % 32 == 0
    n_split, kps = _plan(m, k, n)
    assert kps % KS == 0 and n_split <= 8
    tiles, zb = -(-n // BN), -(-m // MT)
    spr = kps // KS                               # stage slots a range
    kp = n_split * kps

    # the row scales: each range's partial |x| maxima, combined by max
    xpad = np.zeros((zb * MT, kp), np.float32)
    xpad[:m, :k] = x
    pmax = np.abs(xpad).reshape(zb * MT, n_split, kps).max(-1)   # (rows, r)
    amax = pmax.max(-1)
    assert np.array_equal(amax, np.abs(xpad).max(-1))
    xs = (np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)).astype(
        np.float32)
    xq = np.clip(np.rint(xpad / xs[:, None]), -127, 127).astype(np.int8)
    xq[:, k:] = 0

    # the ring's stages: chunk c of row r of stage s at wsw(r, c)
    wpad = np.zeros((kp, tiles * BN), np.int8)
    wpad[:k, :n] = wq
    dest = (_wsw(np.arange(KS)[:, None], np.arange(8)[None, :])[:, :, None]
            + np.arange(16)).reshape(-1)
    assert np.array_equal(np.sort(dest), np.arange(KS * BN))
    src = wpad.reshape(n_split * spr, KS, tiles, 8, 16).transpose(
        2, 0, 1, 3, 4).reshape(tiles, n_split * spr, KS * BN)
    stage = np.empty_like(src)
    stage[..., dest] = src

    # each lane's 8-byte loads -> k-packed words (lo: p 0, hi: p 1; [0]
    # columns 0-3, [1] columns 4-7 of the lane's 8)
    raw = stage[..., _lane_index()].view(np.uint8)  # (T, S, 4, 32, 2, 4, 8)
    packed = np.stack([_transpose_quads(_words(raw[..., 0:4])),
                       _transpose_quads(_words(raw[..., 4:8]))], -2)
    # (T, S, warp, lane, p, half-of-8, j4): column 4 * h + j4 of the lane
    direct = _words(np.moveaxis(raw.reshape(*raw.shape[:-1], 2, 4), -3, -1))
    assert np.array_equal(packed, direct)

    # A fragment j of lane (g, t): a0 = column 2j (row g), a1 = column
    # 2j + 1 (row g + 8), k-rows 4t..; a2 / a3 the same at 16 + 4t..
    col = np.arange(8)
    lo, hi = packed[..., 0, :, :], packed[..., 1, :, :]   # (..., 2, 4)
    lo, hi = lo.reshape(*lo.shape[:-2], 8), hi.reshape(*hi.shape[:-2], 8)
    a0, a1 = lo[..., col[0::2]], lo[..., col[1::2]]        # (T, S, W, L, 4)
    a2, a3 = hi[..., col[0::2]], hi[..., col[1::2]]
    A = np.zeros((*a0.shape[:3], 4, 16, 32), np.int8)      # (T, S, W, j, i, k)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        A[:, :, :, :, g, 4 * t:4 * t + 4] = _bytes(a0[:, :, :, lane])
        A[:, :, :, :, g + 8, 4 * t:4 * t + 4] = _bytes(a1[:, :, :, lane])
        A[:, :, :, :, g, 16 + 4 * t:20 + 4 * t] = _bytes(a2[:, :, :, lane])
        A[:, :, :, :, g + 8, 16 + 4 * t:20 + 4 * t] = _bytes(a3[:, :, :, lane])
    # B fragment of lane (g, t): x row g, k-rows 4t.. and 16 + 4t.. of the
    # k-step, one 32-bit load each from the quantized slice
    xw = _words(xq.view(np.uint8).reshape(zb, MT, n_split * spr, 2, 8, 4))
    B = np.zeros((zb, n_split * spr, 2, 32, 8), np.int8)     # (Z, S, ks, k, n)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        B[:, :, :, 4 * t:4 * t + 4, g] = _bytes(xw[:, g, :, :, t])
        B[:, :, :, 16 + 4 * t:20 + 4 * t, g] = _bytes(xw[:, g, :, :, 4 + t])

    # D = A B per warp, summed over the range's stages (exact in float64:
    # |sum| <= kps * 127^2 < 2^53); then the store's permutation
    red = np.zeros((tiles, zb, n_split, 2, MT, BN), np.int64)
    for r in range(n_split):
        ss = slice(r * spr, (r + 1) * spr)
        for w in range(4):
            ks, half = w >> 1, w & 1
            a = A[:, ss, w].astype(np.float64)          # (T, S, j, i, k)
            b = B[:, ss, ks].astype(np.float64)         # (Z, S, k, n)
            d = np.einsum("tsjik,zskn->tzjin", a, b, optimize=True)
            d = np.rint(d).astype(np.int64)             # (T, Z, j, 16, 8)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(4):
                    c = half * 64 + 8 * g + 2 * j
                    red[:, :, r, ks, 2 * t, c] = d[:, :, j, g, 2 * t]
                    red[:, :, r, ks, 2 * t + 1, c] = d[:, :, j, g, 2 * t + 1]
                    red[:, :, r, ks, 2 * t, c + 1] = d[:, :, j, g + 8, 2 * t]
                    red[:, :, r, ks, 2 * t + 1, c + 1] = \
                        d[:, :, j, g + 8, 2 * t + 1]
    bsum = red[:, :, :, 0] + red[:, :, :, 1]            # the two k-steps
    acc = np.zeros((tiles, zb, MT, BN), np.int64)
    for r in range(n_split):                             # range order
        acc = acc + bsum[:, :, r]
        assert np.abs(acc).max(initial=0) < 2 ** 31, "int32 overflow"
    acc = acc.transpose(1, 2, 0, 3).reshape(zb * MT, tiles * BN)[:m, :n]
    return acc, xs[:m]


def _epilogue(acc, xs, ws, bias, out_dtype):
    """The kernel's epilogue: fp32 (acc * xs) then fma with ws and the
    bias (or a multiply by ws), rounded to the out type."""
    a = torch.from_numpy(acc.astype(np.float32)) * torch.from_numpy(xs)[:, None]
    wst = torch.from_numpy(ws)[None, :].expand_as(a)
    if bias is None:
        return (a * wst).to(out_dtype)
    return fma_f32(a, wst, bias.float()[None, :].expand_as(a)).to(out_dtype)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 8, 9, 128])
@pytest.mark.parametrize("k,n", QWEN2_LINEARS)
def test_b5_tc_plan_bit_equal_to_plain_and_jax(k, n, m, dtype):
    """The emulated tensor-core step gives the bits of B5's plain version
    and of JAX's ``w8a8_matmul_decode``, with and without a bias."""
    rng = np.random.default_rng(k + n + m)
    jdt = getattr(jnp, dtype)
    jx = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32) * 2, jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    w = rng.standard_normal((k, n))
    ws = (np.abs(w).max(axis=0) / 127.0).astype(np.float32)
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    acc, xs = _b5_tc_emulate(tx.float().numpy(), wq)
    _, ref_xs = quantize_rowwise(tx)
    assert np.array_equal(xs.view(np.int32), ref_xs.numpy().view(np.int32))
    for b in (None, bias):
        tb = None if b is None else torch.from_numpy(b)
        got = _epilogue(acc, xs, ws, tb, tx.dtype)
        plain = w8a8_decode_ref(tx, torch.from_numpy(wq),
                                torch.from_numpy(ws), tb)
        assert torch.equal(_bits(got), _bits(plain))
        j = jops.w8a8_matmul_decode(jx, jnp.asarray(wq), jnp.asarray(ws),
                                    bias=None if b is None
                                    else jnp.asarray(b))
        jt = torch.from_numpy(np.array(j.astype(jnp.float32))).to(got.dtype)
        assert torch.equal(_bits(got), _bits(jt))


@pytest.mark.parametrize("m", [1, 8, 9, 128])
def test_b5_plan_whole_stages_fills_the_card_and_fits(m):
    """B5's tensor-core plan: k-ranges in whole 64-row stages covering K,
    at most 8 (one cluster), enough blocks for 132 SMs wherever K and the
    cluster allow it, and a block's ring (4 slots for a range of at most 3
    stages, else 8) plus its x slice (quantized, and raw in fp32) within
    227 KB of shared memory, up to the step's longest K."""
    for k, n in QWEN2_LINEARS + [(16384, 256), (16384, 151936)]:
        n_split, kps = _plan(m, k, n)
        assert kps % KS == 0 and (n_split - 1) * kps < k <= n_split * kps
        assert n_split <= 8
        blocks = -(-n // BN) * -(-m // MT) * n_split
        assert blocks >= 132 or n_split == 8 or n_split == -(-k // KS)
        slots = 4 if kps <= 3 * KS else 8
        assert slots * KS * BN + MT * (kps + 16) + MT * kps * 4 <= SMEM_LIMIT


def test_b5_swizzle_spreads_a_half_warp_over_every_bank():
    """The stage swizzle: each half-warp's 8-byte loads (one k-row offset
    q and k-group p) cover 128 distinct bytes, all 32 banks once."""
    idx = _lane_index()                               # (4, 32, 2, 4, 8)
    for w in range(4):
        for p in range(2):
            for q in range(4):
                for h in range(2):
                    addr = idx[w, 16 * h:16 * h + 16, p, q].reshape(-1)
                    assert len(set(addr.tolist())) == 128
                    banks = (addr // 4) % 32
                    assert np.bincount(banks, minlength=32).tolist() == [4] * 32


@pytest.mark.parametrize("m", [1, 8, 9, 128])
def test_b5_x_slice_pitch_spreads_b_loads_over_every_bank(m):
    """The quantized x slice's row pitch (k_per_split + 16 bytes): the 32
    lanes' B-fragment words (x row g, k 4t) fall in 32 different banks."""
    for k, n in QWEN2_LINEARS:
        _, kps = _plan(m, k, n)
        lane = np.arange(32)
        addr = (lane >> 2) * (kps + 16) + 4 * (lane & 3)
        assert len(set(((addr // 4) % 32).tolist())) == 32

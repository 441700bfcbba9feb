// One 64 x 64 tile step of FlashAttention-2's forward pass on Hopper's
// tensor cores, for bf16 operands; shared by the flash prefill kernel
// (flash_attention.cu) and the prefix-extend kernel
// (paged_prefix_extend.cu).  fp32 operands keep the FMA step of
// attn_tile.cuh.
//
// A block of four warps owns 64 query rows, 16 a warp.  Q, K and V sit in
// shared memory as bf16 tiles of 64 rows x D, their 16-byte chunks XOR
// swizzled by row so that the eight rows an ldmatrix reads fall in eight
// different bank groups.  K and V arrive through a two-stage ring of
// cp.async copies (the kernels start tile n+1 before computing tile n).
// Both products are mma.sync.m16n8k16 (bf16 in, fp32 accumulate):
//   S = Q K^T   Q's A fragments stay in registers for the whole key loop,
//               K's B fragments come from ldmatrix;
//   O += P V    P's A fragments are built in registers from S's
//               accumulators (P never goes through shared memory), V's B
//               fragments from ldmatrix.trans.
// The online softmax runs on the accumulator fragments: each thread holds
// two rows (lane / 4 and lane / 4 + 8 of its warp's 16) and 16 of the
// tile's 64 columns; row max reduces over the four lanes of a row with
// shuffles, the row sum l stays a per-thread partial until the end.  Scores
// are kept in log2 units, so p = exp2(s - m).
//
// P is fed to the second product as two bf16 terms, hi = bf16(p) and
// lo = bf16(p - hi): one bf16 rounding of p (8 significant bits) moves an
// output by up to about 0.4% of the spread of V, several times the
// element limit the kernels are held to; two terms carry 16 bits, so the
// products cost 3 mma per 2 of the one-term plan and the outputs stay at
// the rounding of the output itself.
#pragma once

#include "common.cuh"

namespace repro {
namespace tc {

constexpr int kBQ = 64, kBK = 64;       // q rows / keys per tile
constexpr int kWarps = 4;               // 16 q rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Element offset of 16-byte chunk c of row r in a [rows][D] bf16 tile:
// chunk c ^ x(r), with x(r) spreading any eight consecutive rows over
// eight chunk positions (for D 16, two chunks a row, over the 8 rows of
// a 256-byte span).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = D / 8;
  const int x = C >= 8 ? (r & 7) : ((r / (8 / C)) & (C - 1));
  return r * D + ((c ^ x) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !pred
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count));
}

// this thread's arrival on ``bar``; the phase also waits for ``bytes``
// of asynchronous copies or remote stores
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a * b for one 16 x 8 x 16 tile, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as two bf16x2 terms hi + lo (x0 in the low halves)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Per-thread state: the running max m (log2 units) and partial row sum l
// of its two rows, the output accumulator fragments and Q's A fragments.
template <int D>
struct State {
  static constexpr int NT = D / 8;      // 8-column output tiles
  float m[2], l[2];
  float o[NT][4];
  uint32_t q[D / 16][4];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }

  // Q's A fragments of the warp's 16 rows, from the swizzled Q tile
  __device__ void load_q(const bf16* Qs, int warp, int lane) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(q[kk], Qs + swz<D>(warp * 16 + (lane & 15),
                                 2 * kk + (lane >> 4)));
  }
};

// Folds one tile of 64 keys into the state.  Ks / Vs: the tile as
// [kBK][D] swizzled bf16, filled and synchronised by the caller.  Score
// column c is q.k * kscale(c) (log2 units: the caller folds log2(e) and
// 1/sqrt(D) into kscale), p's column c is multiplied by vscale(c) before
// the second product (a dequantization scale of V; l sums p without it).
// With kMasked, valid(r, c) (block row r, tile column c) masks scores;
// the caller sets kMasked only on tiles that touch an edge.
template <int D, bool kMasked, typename KScale, typename VScale,
          typename Valid>
__device__ __forceinline__ void step(State<D>& st, const bf16* Ks,
                                     const bf16* Vs, int warp, int lane,
                                     KScale kscale, VScale vscale,
                                     Valid valid) {
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, Ks + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                             2 * kk + ((lane >> 3) & 1)));
      mma16816(s[2 * np], st.q[kk], b[0], b[1]);
      mma16816(s[2 * np + 1], st.q[kk], b[2], b[3]);
    }
  }

  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n * 8 + c0 + (e & 1);
      float x = s[n][e] * kscale(c);
      // a masked score is -inf, whose exp2 is exactly 0
      if (kMasked && !valid(r0 + (e >> 1) * 8, c))
        x = __int_as_float(static_cast<int>(0xff800000u));
      s[n][e] = x;
      rmax[e >> 1] = fmaxf(rmax[e >> 1], x);
    }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 1));
    rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 2));
    const float m_new = fmaxf(st.m[i], rmax[i]);
    corr[i] = exp2f(st.m[i] - m_new);
    st.m[i] = m_new;
    st.l[i] *= corr[i];
  }
#pragma unroll
  for (int n = 0; n < State<D>::NT; ++n) {
    st.o[n][0] *= corr[0];
    st.o[n][1] *= corr[0];
    st.o[n][2] *= corr[1];
    st.o[n][3] *= corr[1];
  }

#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    // A fragments of P's 16 x 16 block kk: a0 / a1 from score tile 2kk
    // (rows g / g + 8), a2 / a3 from tile 2kk + 1
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 2 * kk + half, c = n * 8 + c0;
      const float v0 = vscale(c), v1 = vscale(c + 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(s[n][2 * i] - st.m[i]);
        const float p1 = exp2f(s[n][2 * i + 1] - st.m[i]);
        st.l[i] += p0 + p1;
        split_bf16(p0 * v0, p1 * v1, ph[2 * half + i], pl[2 * half + i]);
      }
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Vs + swz<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                               2 * dp + (lane >> 4)));
      mma16816(st.o[2 * dp], ph, b[0], b[1]);
      mma16816(st.o[2 * dp], pl, b[0], b[1]);
      mma16816(st.o[2 * dp + 1], ph, b[2], b[3]);
      mma16816(st.o[2 * dp + 1], pl, b[2], b[3]);
    }
  }
}

// Normalises the accumulator and hands each thread's outputs to
// store(r, c, x0, x1): block row r, columns c and c + 1.  A row that saw
// no key has l == 0 and o == 0 and gives zeros.
template <int D, typename Store>
__device__ __forceinline__ void finish(const State<D>& st, int warp, int lane,
                                       Store store) {
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = st.l[i];
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < State<D>::NT; ++n) {
    store(r0, n * 8 + c0, st.o[n][0] / l[0], st.o[n][1] / l[0]);
    store(r0 + 8, n * 8 + c0, st.o[n][2] / l[1], st.o[n][3] / l[1]);
  }
}

// Two outputs of a bf16 row, one 32-bit store
__device__ __forceinline__ void store_bf16x2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

}  // namespace tc
}  // namespace repro

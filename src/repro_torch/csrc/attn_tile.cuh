// One 64 x 64 tile step of FlashAttention-2's forward pass, shared by the
// flash prefill kernel (flash_attention.cu) and the prefix-extend kernel
// (paged_prefix_extend.cu).
//
// A block of 256 threads owns 64 query rows.  Q (kBQ x D), K transposed
// (D x kBK) and V (kBK x D) sit in shared memory as fp32; each thread
// holds a 4 x 4 block of scores and a 4 x D/16 block of the output
// accumulator in registers, with the running row max m and row sum l.
// Row max and row sum reduce across the 16 threads of a row with
// shuffles.  The products run on the fp32 FMA units.
#pragma once

#include "common.cuh"

namespace repro {
namespace tile {

constexpr int kBQ = 64, kBK = 64;       // q rows / kv rows per tile
constexpr int kTX = 16, kTY = 16;       // 256 threads
constexpr int kThreads = kTX * kTY;
constexpr int kRQ = kBQ / kTY;          // score rows per thread
constexpr int kRK = kBK / kTX;          // score cols per thread (= 4)
constexpr int kPad = 4;                 // keeps float4 alignment, spreads banks

template <int D>
struct Smem {
  static constexpr int QS = D + kPad, KTS = kBK + kPad, PS = kBK + kPad;
  float* Qs;   // [kBQ][QS]
  float* Kt;   // [D][KTS]   (K transposed)
  float* Vs;   // [kBK][D]
  float* Ps;   // [kBQ][PS]
  __device__ explicit Smem(float* base)
      : Qs(base), Kt(base + kBQ * QS), Vs(base + kBQ * QS + D * KTS),
        Ps(base + kBQ * QS + D * KTS + kBK * D) {}
  static constexpr size_t bytes() {
    return sizeof(float) * ((size_t)kBQ * QS + (size_t)D * KTS
                            + (size_t)kBK * D + (size_t)kBQ * PS);
  }
};

// Per-thread online-softmax state of its kRQ rows.
template <int D>
struct State {
  static constexpr int DC = D / kTX;    // output cols per thread
  float m[kRQ], l[kRQ], acc[kRQ][DC];
  __device__ void init() {
#pragma unroll
    for (int a = 0; a < kRQ; ++a) {
      m[a] = kNegInf;
      l[a] = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
    }
  }
};

// Scores of the current K/V tile, masked by valid(a, c) for the thread's
// row a (block row ty * kRQ + a) and key column c (tile column
// tx * kRK + c), folded into the state.  The caller has filled Kt and Vs
// and synchronised; on return Ps has been read and may be reused after
// the caller's next __syncthreads().
template <int D, typename Valid>
__device__ __forceinline__ void step(const Smem<D>& sm, State<D>& st,
                                     int tx, int ty, float scale,
                                     Valid valid) {
  constexpr int QS = Smem<D>::QS, KTS = Smem<D>::KTS, PS = Smem<D>::PS;
  constexpr int DC = State<D>::DC;
  float sc[kRQ][kRK];
#pragma unroll
  for (int a = 0; a < kRQ; ++a)
#pragma unroll
    for (int c = 0; c < kRK; ++c) sc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 k4 = *reinterpret_cast<const float4*>(&sm.Kt[d * KTS + tx * kRK]);
#pragma unroll
    for (int a = 0; a < kRQ; ++a) {
      const float qv = sm.Qs[(ty * kRQ + a) * QS + d];
      sc[a][0] = fmaf(qv, k4.x, sc[a][0]);
      sc[a][1] = fmaf(qv, k4.y, sc[a][1]);
      sc[a][2] = fmaf(qv, k4.z, sc[a][2]);
      sc[a][3] = fmaf(qv, k4.w, sc[a][3]);
    }
  }

#pragma unroll
  for (int a = 0; a < kRQ; ++a) {
    bool ok[kRK];
    float rmax = kNegInf;
#pragma unroll
    for (int c = 0; c < kRK; ++c) {
      ok[c] = valid(a, c);
      sc[a][c] = ok[c] ? sc[a][c] * scale : kNegInf;
      if (ok[c]) rmax = fmaxf(rmax, sc[a][c]);
    }
#pragma unroll
    for (int off = kTX / 2; off > 0; off >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    const float m_new = fmaxf(st.m[a], rmax);
    const float corr = expf(st.m[a] - m_new);
    float rsum = 0.f;
#pragma unroll
    for (int c = 0; c < kRK; ++c) {
      const float p = ok[c] ? expf(sc[a][c] - m_new) : 0.f;
      rsum += p;
      sm.Ps[(ty * kRQ + a) * PS + tx * kRK + c] = p;
    }
#pragma unroll
    for (int off = kTX / 2; off > 0; off >>= 1)
      rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
    st.l[a] = st.l[a] * corr + rsum;
#pragma unroll
    for (int c = 0; c < DC; ++c) st.acc[a][c] *= corr;
    st.m[a] = m_new;
  }
  __syncthreads();

#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    float pv[kRQ];
#pragma unroll
    for (int a = 0; a < kRQ; ++a) pv[a] = sm.Ps[(ty * kRQ + a) * PS + j];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float vv = sm.Vs[j * D + tx + c * kTX];
#pragma unroll
      for (int a = 0; a < kRQ; ++a) st.acc[a][c] = fmaf(pv[a], vv, st.acc[a][c]);
    }
  }
}

}  // namespace tile
}  // namespace repro

// Shared helpers of the int8 / fp8 matmul kernels: masked loads of four
// consecutive int8 (or fp8) bytes of a row-major matrix, and the 4 x 4
// byte transpose that turns four k-rows of four columns into one
// k-packed word per column, the operand layout of __dp4a.
#pragma once

#include "common.cuh"

namespace repro {

// Bytes [j0, j0 + 4) of row ``row`` of a row-major (rows x cols) int8
// matrix, packed little-endian into one word; bytes outside the matrix
// are 0.  kVec: cols % 4 == 0 and the base is 4-byte aligned, so an
// in-range quad is one aligned 32-bit load (j0 is a multiple of 4).
template <bool kVec>
__device__ __forceinline__ int load_quad(const int8_t* __restrict__ a,
                                         int rows, int cols, int row,
                                         int j0) {
  if (row >= rows || j0 >= cols) return 0;
  const int8_t* p = a + static_cast<size_t>(row) * cols + j0;
  if (kVec) return *reinterpret_cast<const int*>(p);
  int packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j0 + j < cols) packed |= (static_cast<int>(p[j]) & 0xff) << (8 * j);
  return packed;
}

// r[i] holds columns c..c+3 of k-row i (byte j = column j); on return
// c[j] holds k-rows 0..3 of column j (byte i = k-row i).
__device__ __forceinline__ void transpose_quads(const int (&r)[4],
                                                int (&c)[4]) {
  const int t0 = __byte_perm(r[0], r[1], 0x5140);  // r0b0 r1b0 r0b1 r1b1
  const int t1 = __byte_perm(r[0], r[1], 0x7362);  // r0b2 r1b2 r0b3 r1b3
  const int t2 = __byte_perm(r[2], r[3], 0x5140);
  const int t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// bias[n] as fp32 from an fp32 or bf16 bias vector (bf16 -> fp32 is exact).
__device__ __forceinline__ float bias_at(const void* __restrict__ bias,
                                         int bf16, int n) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n])
              : static_cast<const float*>(bias)[n];
}

// Largest |x| of row ``m`` of a row-major (M x K) activation matrix,
// reduced by one warp: 16-byte loads where K and the base allow them.
template <typename XT>
__device__ __forceinline__ float row_amax(const XT* __restrict__ x, int K,
                                          int m, int lane, bool vec) {
  constexpr int kPer = 16 / sizeof(XT);
  const XT* row = x + static_cast<size_t>(m) * K;
  float amax = 0.f;
  if (vec) {
#pragma unroll 4
    for (int k = lane * kPer; k < K; k += 32 * kPer) {
      float v[kPer];
      load_f32<XT, kPer>(row + k, v);
#pragma unroll
      for (int i = 0; i < kPer; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
  } else {
#pragma unroll 4
    for (int k = lane; k < K; k += 32)
      amax = fmaxf(amax, fabsf(to_f32<XT>(row[k])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  return amax;
}

}  // namespace repro

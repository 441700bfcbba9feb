// Tiled W8A8 matmul on pre-quantized operands.
//
// Replaces the TPU kernel repro/kernels/int8_matmul/int8_matmul.py:
// int8_matmul_pallas (_int8_mm_kernel).  Same function, bit for bit: for
// xq (M,K) int8, wq (K,N) int8, xs (M,) and ws (N,) fp32,
//     acc[m,n] = sum_k xq[m,k] * wq[k,n]                 (exact, int32)
//     y[m,n]   = (float(acc) * xs[m]) * ws[n]            cast to the out type
// The caller (quant/qops.py) quantizes x per row before it and adds the
// bias after it in the out type, as the reference does.
//
// What bounds it on an H100: operations.  On the main path M is a
// chunk of 8 x 512 = 4,096 rows, so each weight byte is used 4,096 times
// and each activation byte up to N times: far above the card's
// ops-per-byte ridge, the floor is 2·M·K·N int8 operations over the
// tensor cores' 1,979 TOPS.
//
// What the design does about it (a simple version): the Pallas kernel's
// 256x256x512 VMEM tiles become 128x128 output tiles of one block, with
// K walked in steps of 64.  The A tile is staged as k-packed words; the B
// tile (K x N, row major) is byte-transposed on its way into shared
// memory so that each column's 4 consecutive k share a word, which is
// exactly the operand layout of the int8 tensor-core instruction
// mma.sync m16n8k32 (s8 x s8 -> s32, exact).  The 8 warps each own a
// 64 x 32 tile (4 x 4 mma tiles, 64 int32 sums a thread).  The next
// tile's plain 32-bit global loads are held in registers while the
// current tile is multiplied (no cp.async, TMA or wgmma yet); ragged M,
// N and K are masked in the loads and stores.
#include "int8_pack.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kKQ = kBK / 4;          // k-packed words per tile row
constexpr int kPad = kKQ + 1;         // odd stride: few bank conflicts
constexpr int kAWords = kBM * kKQ / kThreads;         // A words a thread
constexpr int kBBlocks = kKQ * (kBN / 4) / kThreads;  // B 4x4 blocks

// One m16n8k32 int8 tensor-core product: d += a (16x32, row) x b (32x8,
// col), int32 sums.  Fragments as PTX lays them out: lane = 4g + t holds
// a = {A[g][4t..], A[g+8][4t..], A[g][16+4t..], A[g+8][16+4t..]},
// b = {B[4t..][g], B[16+4t..][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OT, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ xs,
                   const float* __restrict__ ws, OT* __restrict__ out,
                   int M, int K, int N) {
  __shared__ int a_s[kBM][kPad];
  __shared__ int b_s[kBN][kPad];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // 8 warps as 2 (M) x 4 (N), each a 64 x 32 tile: 4 x 4 mma tiles
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // the next tile's global loads are issued into registers before the
  // current tile's products, so their latency overlaps the tensor cores
  int ra[kAWords], rb[kBBlocks][4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kAWords; ++u) {
      const int e = threadIdx.x + u * kThreads;
      ra[u] = load_quad<kVec>(xq, M, K, m0 + e / kKQ, k0 + (e % kKQ) * 4);
    }
#pragma unroll
    for (int u = 0; u < kBBlocks; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int q = e / 32, cq = e % 32;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rb[u][j] = load_quad<kVec>(wq, K, N, k0 + q * 4 + j, n0 + cq * 4);
    }
  };
  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < kAWords; ++u) {
      const int e = threadIdx.x + u * kThreads;
      a_s[e / kKQ][e % kKQ] = ra[u];
    }
#pragma unroll
    for (int u = 0; u < kBBlocks; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int q = e / 32, cq = e % 32;
      int c[4];
      transpose_quads(rb[u], c);
#pragma unroll
      for (int j = 0; j < 4; ++j) b_s[cq * 4 + j][q] = c[j];
    }
    __syncthreads();
    if (k0 + kBK < K) load_tile(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kKQ; kk += 8) {         // two k32 steps
      int a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm + 16 * i + g;
        a[i][0] = a_s[row][kk + t];
        a[i][1] = a_s[row + 8][kk + t];
        a[i][2] = a_s[row][kk + 4 + t];
        a[i][3] = a_s[row + 8][kk + 4 + t];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn + 8 * j + g;
        b[j][0] = b_s[col][kk + t];
        b[j][1] = b_s[col][kk + 4 + t];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn + 8 * j + 2 * t + c;
          if (n >= N) continue;
          const float y = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[i][j][2 * h + c]), sx), ws[n]);
          out[static_cast<size_t>(m) * N + n] = from_f32<OT>(y);
        }
    }
}

template <typename OT>
void launch(const int8_t* xq, const int8_t* wq, const float* xs,
            const float* ws, void* out, int M, int K, int N, int vec,
            cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (vec)
    int8_matmul_kernel<OT, true><<<grid, kThreads, 0, st>>>(
        xq, wq, xs, ws, static_cast<OT*>(out), M, K, N);
  else
    int8_matmul_kernel<OT, false><<<grid, kThreads, 0, st>>>(
        xq, wq, xs, ws, static_cast<OT*>(out), M, K, N);
}

}  // namespace
}  // namespace repro

extern "C" {

// One launch of the tiled W8A8 matmul on ``stream``.  ``vec``: K % 4 == 0,
// N % 4 == 0 and both operands 4-byte aligned.  Returns 0, a CUDA error
// code from the launch, or -1 for a shape or dtype it does not take.
int int8_matmul(const int8_t* xq, const int8_t* wq, const float* xs,
                const float* ws, void* out, int M, int K, int N,
                int out_dtype, int vec, void* stream) {
  using namespace repro;
  if (M <= 0 || K <= 0 || N <= 0 || (M + kBM - 1) / kBM > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == kBF16)
    launch<__nv_bfloat16>(xq, wq, xs, ws, out, M, K, N, vec, st);
  else if (out_dtype == kF32)
    launch<float>(xq, wq, xs, ws, out, M, K, N, vec, st);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Skinny-M W8A8 matmul with the activation quantization fused in.
//
// Replaces the TPU kernel repro/kernels/int8_matmul/int8_matmul.py:
// w8a8_decode_matmul_pallas (_w8a8_decode_kernel), together with the row
// scales that repro/kernels/int8_matmul/ops.py:w8a8_matmul_decode
// computes before it.  Same function, bit for bit: for x (M,K) bf16/f32
// raw activations and wq (K,N) int8,
//     xs[m]    = max(max_k |x[m,k]|, 1e-8) / 127          (IEEE division)
//     xq[m,k]  = clip(round_half_even(x[m,k] / xs[m]), -127, 127)
//     acc[m,n] = sum_k xq[m,k] * wq[k,n]                  (exact, int32)
//     y[m,n]   = fma(acc * xs[m], ws[n], bias[n])  or  (acc * xs[m]) * ws[n]
// cast to the out type (round to nearest even).  The fma is what XLA makes
// of the reference epilogue ``acc*xs*ws + b``; without a bias the
// reference adds zeros, which gives the same bits as the plain product.
//
// What bounds it on an H100: bytes.  At decode M is the number of live
// slots (8 on the main path), so each weight byte feeds M multiply-adds,
// far below the card's ops-per-byte ridge; the floor is the K x N weight
// bytes over 3.35 TB/s.  One launch per linear (the decode step is
// host-bound: a second launch for the row scales would cost more host
// time than the whole kernel takes on the device).
//
// What the design does about it:
//  * The Pallas grid (N/bn, K/bk) carries an int32 accumulator in VMEM
//    across K steps.  Here a block owns 128 columns (4 per lane, read as
//    one 32-bit word per k-row: 128 contiguous bytes per warp) and a
//    range of K ("split"): column tiles x splits give about two blocks
//    per SM even where N is small (wk / wv have N = 256).  int32 sums are
//    exact in any order, so the split changes no bit: each split writes
//    its partial sums, and the last block of a column tile to finish (an
//    atomic counter per tile, reset by that block) adds them in split
//    order and applies the epilogue.
//  * Every block computes the row scales itself from the whole rows
//    (one warp a row, 16-byte loads; the rows are a few KB and stay in
//    L2), then quantizes its k-range of x chunk by chunk into shared
//    memory, 8 rows at a time.
//  * Each warp takes 4 k-rows at a time: four 32-bit loads a lane, a
//    byte transpose into k-packed words, and __dp4a against the staged
//    activations, 8 rows x 4 columns of int32 sums in registers; the 8
//    warps' sums meet in shared memory.
#include "int8_pack.cuh"

namespace repro {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;      // columns per block (4 per lane)
constexpr int kMT = 8;        // activation rows per pass
constexpr int kKC = 256;      // k per staged chunk (a multiple of 4)
constexpr int kMaxM = 128;    // the dispatch's skinny-M bound

template <typename OT>
__device__ __forceinline__ OT epilogue(int acc, float xs, float ws,
                                       const void* __restrict__ bias,
                                       int bias_bf16, int n) {
  const float a = __fmul_rn(__int2float_rn(acc), xs);
  const float y = bias != nullptr ? __fmaf_rn(a, ws, bias_at(bias, bias_bf16, n))
                                  : __fmul_rn(a, ws);
  return from_f32<OT>(y);
}

template <typename XT, typename OT, bool kVec>
__global__ void __launch_bounds__(kThreads)
w8a8_decode_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ ws,
                   const void* __restrict__ bias, int bias_bf16,
                   OT* __restrict__ out,
                   int* __restrict__ partial, int* __restrict__ counters,
                   int M, int K, int N, int k_per_split, int x_vec) {
  __shared__ float xs_s[kMaxM];
  __shared__ int xq_s[kMT][kKC / 4];
  __shared__ int red_s[kWarps][kMT][kBN];
  __shared__ bool last_s;

  const int tile = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = tile * kBN;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  for (int m = warp; m < M; m += kWarps) {
    const float amax = row_amax<XT>(x, K, m, lane, x_vec != 0);
    if (lane == 0) xs_s[m] = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  }

  for (int m0 = 0; m0 < M; m0 += kMT) {
    int acc[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int kc = k_begin; kc < k_end; kc += kKC) {
      const int klen = min(kKC, k_end - kc);
      __syncthreads();            // scales written / last chunk consumed
      for (int e = threadIdx.x; e < kMT * (kKC / 4); e += kThreads) {
        const int i = e / (kKC / 4), kq = e % (kKC / 4);
        const int m = m0 + i;
        int packed = 0;
        if (m < M) {
          const XT* row = x + static_cast<size_t>(m) * K + kc;
          const float s = xs_s[m];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = kq * 4 + j;
            if (kk < klen) {
              int q = __float2int_rn(__fdiv_rn(to_f32<XT>(row[kk]), s));
              q = max(-127, min(127, q));
              packed |= (q & 0xff) << (8 * j);
            }
          }
        }
        xq_s[i][kq] = packed;
      }
      __syncthreads();
      const int n = n0 + lane * 4;
#pragma unroll 2
      for (int kq = warp; kq * 4 < klen; kq += kWarps) {
        const int k = kc + kq * 4;
        int r[4], c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = load_quad<kVec>(wq, k_end, N, k + j, n);
        transpose_quads(r, c);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const int xp = xq_s[i][kq];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xp, c[j], acc[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red_s[warp][i][lane * 4 + j] = acc[i][j];
    __syncthreads();
    for (int e = threadIdx.x; e < kMT * kBN; e += kThreads) {
      const int i = e / kBN, c = e % kBN;
      const int m = m0 + i, n = n0 + c;
      if (m >= M || n >= N) continue;
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red_s[w][i][c];
      if (n_split == 1)
        out[static_cast<size_t>(m) * N + n] =
            epilogue<OT>(sum, xs_s[m], ws[n], bias, bias_bf16, n);
      else
        partial[(static_cast<size_t>(split) * M + m) * N + n] = sum;
    }
    __syncthreads();              // red_s is rewritten by the next pass
  }

  if (n_split == 1) return;
  __threadfence();                // this block's partials before its count
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = atomicAdd(&counters[tile], 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int e = threadIdx.x; e < M * kBN; e += kThreads) {
    const int m = e / kBN, n = n0 + e % kBN;
    if (n >= N) continue;
    int sum = 0;
    for (int s = 0; s < n_split; ++s)
      sum += __ldcg(&partial[(static_cast<size_t>(s) * M + m) * N + n]);
    out[static_cast<size_t>(m) * N + n] =
        epilogue<OT>(sum, xs_s[m], ws[n], bias, bias_bf16, n);
  }
  if (threadIdx.x == 0) counters[tile] = 0;     // ready for the next launch
}

template <typename XT, typename OT>
int launch(const void* x, const int8_t* wq, const float* ws,
           const void* bias, int bias_bf16, void* out, int* partial, int* counters, int M,
           int K, int N, int n_split, int k_per_split, int vec, int x_vec,
           cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, n_split);
  if (vec)
    w8a8_decode_kernel<XT, OT, true><<<grid, kThreads, 0, st>>>(
        static_cast<const XT*>(x), wq, ws, bias, bias_bf16, static_cast<OT*>(out),
        partial, counters, M, K, N, k_per_split, x_vec);
  else
    w8a8_decode_kernel<XT, OT, false><<<grid, kThreads, 0, st>>>(
        static_cast<const XT*>(x), wq, ws, bias, bias_bf16, static_cast<OT*>(out),
        partial, counters, M, K, N, k_per_split, x_vec);
  return 0;
}

}  // namespace
}  // namespace repro

extern "C" {

// One launch of the W8A8 decode matmul on ``stream``.  ``bias`` may be
// null; ``partial`` (n_split x M x N int32) and ``counters`` (one int32
// per 128-column tile, zero on entry and left zero) are used only when
// n_split > 1.  ``vec``: N % 4 == 0 and wq 4-byte aligned; ``x_vec``:
// K a multiple of 16 bytes of x and x 16-byte aligned.  Returns 0, a CUDA
// error code from the launch, or -1 for a shape or dtype it does not take.
int w8a8_decode_matmul(const void* x, const int8_t* wq, const float* ws,
                       const void* bias, void* out, int* partial,
                       int* counters, int M, int K, int N, int n_split,
                       int k_per_split, int x_dtype, int out_dtype, int bias_dtype, int vec,
                       int x_vec, void* stream) {
  using namespace repro;
  if (M <= 0 || M > kMaxM || K <= 0 || N <= 0 || n_split <= 0 ||
      k_per_split <= 0 || k_per_split % 4 != 0 ||
      static_cast<long long>(n_split) * k_per_split < K ||
      (n_split > 1 && (partial == nullptr || counters == nullptr)))
    return -1;
  if (bias != nullptr && bias_dtype != kF32 && bias_dtype != kBF16) return -1;
  const int bias_bf16 = bias_dtype == kBF16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_dtype == kBF16 && out_dtype == kBF16)
    rc = launch<__nv_bfloat16, __nv_bfloat16>(x, wq, ws, bias, bias_bf16, out, partial, counters, M, K, N, n_split, k_per_split, vec, x_vec, st);
  else if (x_dtype == kF32 && out_dtype == kF32)
    rc = launch<float, float>(x, wq, ws, bias, bias_bf16, out, partial, counters, M, K, N, n_split, k_per_split, vec, x_vec, st);
  else if (x_dtype == kBF16 && out_dtype == kF32)
    rc = launch<__nv_bfloat16, float>(x, wq, ws, bias, bias_bf16, out, partial, counters, M, K, N, n_split, k_per_split, vec, x_vec, st);
  else if (x_dtype == kF32 && out_dtype == kBF16)
    rc = launch<float, __nv_bfloat16>(x, wq, ws, bias, bias_bf16, out, partial, counters, M, K, N, n_split, k_per_split, vec, x_vec, st);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

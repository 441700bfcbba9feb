// Skinny-M weight-only fp8 matmul.
//
// Replaces the TPU kernel repro/kernels/int8_matmul/int8_matmul.py:
// fp8_decode_matmul_pallas (_fp8_decode_kernel).  Same function: for x
// (M,K) bf16/f32 and wq (K,N) float8 e4m3 ("fn": no infinities, max 448),
//     acc[m,n] = sum_k x[m,k] * float(wq[k,n])        (fp32)
//     y[m,n]   = fma(acc, ws[n], bias[n])  or  acc * ws[n]
// cast to the out type.  Every e4m3 value is exact in fp32, so the only
// difference from the reference is the order of the fp32 sums (its K
// tiles of 512 against this kernel's k-ranges and warps): the result is
// held to a tolerance, not bit for bit.
//
// What bounds it on an H100: bytes.  Each weight byte feeds M (8 at
// decode) multiply-adds; the floor is the K x N weight bytes over
// 3.35 TB/s.  One launch per linear, as for the W8A8 decode kernel.
//
// What the design does about it: the W8A8 decode kernel's layout.  A
// block owns 128 columns (4 per lane: one 32-bit load of four e4m3
// bytes per k-row, upcast in registers) and a k-range; the activations
// are staged in shared memory as fp32, 8 rows at a time; each warp takes
// every 8th k-row; the 8 warps' sums meet in shared memory in a fixed
// order, and split-K partials are added by the last block of each
// column tile in split order, so the result is the same on every run.
#include "int8_pack.cuh"

namespace repro {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;
constexpr int kMT = 8;
constexpr int kKC = 256;
constexpr int kMaxM = 128;

__device__ __forceinline__ void fp8x4_to_f32(int word, float (&w)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>((word >> (8 * j)) & 0xff);
    w[j] = static_cast<float>(v);
  }
}

template <typename OT>
__device__ __forceinline__ OT epilogue(float acc, float ws,
                                       const void* __restrict__ bias,
                                       int bias_bf16, int n) {
  const float y = bias != nullptr ? __fmaf_rn(acc, ws, bias_at(bias, bias_bf16, n))
                                  : __fmul_rn(acc, ws);
  return from_f32<OT>(y);
}

template <typename XT, typename OT, bool kVec>
__global__ void __launch_bounds__(kThreads)
fp8_decode_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                  const float* __restrict__ ws,
                  const void* __restrict__ bias, int bias_bf16,
                   OT* __restrict__ out,
                  float* __restrict__ partial, int* __restrict__ counters,
                  int M, int K, int N, int k_per_split) {
  __shared__ float x_s[kMT][kKC];
  __shared__ float red_s[kWarps][kMT][kBN];
  __shared__ bool last_s;

  const int tile = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = tile * kBN;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  for (int m0 = 0; m0 < M; m0 += kMT) {
    float acc[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int kc = k_begin; kc < k_end; kc += kKC) {
      const int klen = min(kKC, k_end - kc);
      __syncthreads();
      for (int e = threadIdx.x; e < kMT * kKC; e += kThreads) {
        const int i = e / kKC, kk = e % kKC;
        const int m = m0 + i;
        x_s[i][kk] = (m < M && kk < klen)
            ? to_f32<XT>(x[static_cast<size_t>(m) * K + kc + kk]) : 0.f;
      }
      __syncthreads();
      const int n = n0 + lane * 4;
#pragma unroll 4
      for (int kk = warp; kk < klen; kk += kWarps) {
        float w[4];
        fp8x4_to_f32(load_quad<kVec>(wq, k_end, N, kc + kk, n), w);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float xv = x_s[i][kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(xv, w[j], acc[i][j]);
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
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red_s[w][i][c];
      if (n_split == 1)
        out[static_cast<size_t>(m) * N + n] = epilogue<OT>(sum, ws[n], bias, bias_bf16, n);
      else
        partial[(static_cast<size_t>(split) * M + m) * N + n] = sum;
    }
    __syncthreads();
  }

  if (n_split == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = atomicAdd(&counters[tile], 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int e = threadIdx.x; e < M * kBN; e += kThreads) {
    const int m = e / kBN, n = n0 + e % kBN;
    if (n >= N) continue;
    float sum = 0.f;
    for (int s = 0; s < n_split; ++s)
      sum += __ldcg(&partial[(static_cast<size_t>(s) * M + m) * N + n]);
    out[static_cast<size_t>(m) * N + n] = epilogue<OT>(sum, ws[n], bias, bias_bf16, n);
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

template <typename XT, typename OT>
int launch(const void* x, const int8_t* wq, const float* ws,
           const void* bias, int bias_bf16, void* out, float* partial, int* counters,
           int M, int K, int N, int n_split, int k_per_split, int vec,
           cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, n_split);
  if (vec)
    fp8_decode_kernel<XT, OT, true><<<grid, kThreads, 0, st>>>(
        static_cast<const XT*>(x), wq, ws, bias, bias_bf16, static_cast<OT*>(out),
        partial, counters, M, K, N, k_per_split);
  else
    fp8_decode_kernel<XT, OT, false><<<grid, kThreads, 0, st>>>(
        static_cast<const XT*>(x), wq, ws, bias, bias_bf16, static_cast<OT*>(out),
        partial, counters, M, K, N, k_per_split);
  return 0;
}

}  // namespace
}  // namespace repro

extern "C" {

// One launch of the fp8 decode matmul on ``stream``; arguments as for
// w8a8_decode_matmul (``wq`` is the e4m3 weight's bytes, ``partial`` fp32).
int fp8_decode_matmul(const void* x, const int8_t* wq, const float* ws,
                      const void* bias, void* out, float* partial,
                      int* counters, int M, int K, int N, int n_split,
                      int k_per_split, int x_dtype, int out_dtype, int bias_dtype, int vec,
                      void* stream) {
  using namespace repro;
  if (M <= 0 || M > kMaxM || K <= 0 || N <= 0 || n_split <= 0 ||
      k_per_split <= 0 || static_cast<long long>(n_split) * k_per_split < K ||
      (n_split > 1 && (partial == nullptr || counters == nullptr)))
    return -1;
  if (bias != nullptr && bias_dtype != kF32 && bias_dtype != kBF16) return -1;
  const int bias_bf16 = bias_dtype == kBF16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_dtype == kBF16 && out_dtype == kBF16)
    rc = launch<__nv_bfloat16, __nv_bfloat16>(x, wq, ws, bias, bias_bf16, out, partial, counters, M, K, N, n_split, k_per_split, vec, st);
  else if (x_dtype == kF32 && out_dtype == kF32)
    rc = launch<float, float>(x, wq, ws, bias, bias_bf16, out, partial, counters, M, K, N, n_split, k_per_split, vec, st);
  else if (x_dtype == kBF16 && out_dtype == kF32)
    rc = launch<__nv_bfloat16, float>(x, wq, ws, bias, bias_bf16, out, partial, counters, M, K, N, n_split, k_per_split, vec, st);
  else if (x_dtype == kF32 && out_dtype == kBF16)
    rc = launch<float, __nv_bfloat16>(x, wq, ws, bias, bias_bf16, out, partial, counters, M, K, N, n_split, k_per_split, vec, st);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

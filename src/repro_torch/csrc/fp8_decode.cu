// Skinny-M weight-only fp8 matmul.
//
// Replaces the TPU kernel repro/kernels/int8_matmul/int8_matmul.py:
// fp8_decode_matmul_pallas (_fp8_decode_kernel).  Same function: for x
// (M,K) bf16/f32 and wq (K,N) float8 e4m3 ("fn": no infinities, max 448),
//     acc[m,n] = sum_k x[m,k] * float(wq[k,n])        (fp32)
//     y[m,n]   = fma(acc, ws[n], bias[n])  or  acc * ws[n]
// cast to the out type.  Every e4m3 value is exact in fp32 and in bf16,
// and a bf16 x bf16 product is exact in fp32, so the only difference from
// the reference is the order of the fp32 sums (its K tiles of 512 against
// this kernel's k-steps, warps and k-ranges): the result is held to a
// tolerance, not bit for bit.
//
// What bounds it on an H100: bytes.  Each weight byte feeds M (8 at
// decode) multiply-adds; the floor is the K x N weight bytes over
// 3.35 TB/s.  One launch per linear, as for the W8A8 decode kernel.
//
// What the design does about it.  bf16 x (fp8_decode_tc, the tensor-core
// step; needs N % 16 == 0, K % 8 == 0 and 16-byte aligned operands):
//  * Deep streaming.  A block owns 128 columns, 8 rows of x and a
//    k-range; its weight rows come through a ring of 16-byte cp.async.cg
//    copies in dynamic shared memory, 64 k-rows (8 KB) a stage, with x's
//    8 x 64 slice in the same stage.  The wrapper plans about four blocks
//    an SM; a k-range of at most 3 stages (the qwen2 decode shapes but
//    the 8,960-deep one) has all of them in flight at once in a 3-stage
//    ring (28 KB), a longer one keeps 7 in flight in an 8-stage ring
//    (73 KB).
//  * Tensor cores, with the roles swapped so that M 8 wastes nothing:
//    the product is y^T = w^T x^T on mma.sync m16n8k16 (bf16 in, fp32
//    accumulate), w^T's 16 columns a fragment as the M side and x's 8
//    rows as the N side.  Each warp takes one 16-row k-step of a stage;
//    a lane reads 16 columns of four k-rows with four 16-byte shared
//    loads (rows XOR-swizzled so that a warp's loads hit every bank
//    once), pairs the k-rows' bytes with byte permutes and widens each
//    pair in registers: cvt.rn.f16x2.e4m3x2 (exact), then the f16's
//    exponent and mantissa moved down 3 bits into a bf16 (an f16 widened
//    from e4m3 is normal or zero, so that bf16 is the value times
//    2^-112) and one exact bf16x2 multiply by 2^112.  The lane's 16
//    columns are the rows of 8 A fragments; which mma row is which
//    column is a fixed permutation undone when the sums are stored.
//  * M above 8 takes more blocks (grid z), each over 8 rows of x.
//  * Split-K on chip, in a fixed order.  The k-ranges of a (row block,
//    column tile), at most 8, form a thread block cluster.  Each block
//    adds its 4 warps' sums in warp order into its shared memory; after a
//    cluster barrier every block takes a share of the outputs and adds
//    the ranges' sums in range order through distributed shared memory,
//    then applies the epilogue.  No partial sum goes through device
//    memory, and the result is the same on every run.
// fp32 x (fp8_decode_kernel, the FMA step) keeps the W8A8 decode
// kernel's layout: 4 columns a lane (one 32-bit load of four e4m3 bytes
// per k-row, upcast in registers), x staged as fp32 8 rows at a time,
// each of 8 warps taking every 8th k-row.
#include "attn_tile_tc.cuh"
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

namespace tc_step {   // bf16 x: the tensor-core step

using tc::as_u32;
using tc::cp_async16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;                     // columns per block
constexpr int kMT = 8;                       // x rows per block (mma N side)
constexpr int kKS = kWarps * 16;             // k-rows per stage, a k-step a warp
constexpr int kXPitch = kKS + 8;             // bf16 per x row of a stage (144 B)
constexpr int kWBytes = kKS * kBN;           // weight bytes of a stage
constexpr int kStageBytes = kWBytes + kMT * kXPitch * 2;

// Byte offset of 16-byte chunk c of weight row r in a stage: the chunk
// index XORed with 2 * ((r / 2) % 4), so that the eight lanes of a
// shared-load phase (rows 2t or 2t + 1 for t < 4, chunks g and g + 1)
// fall on eight different chunk positions.
__device__ __forceinline__ int wsw(int r, int c) {
  return r * kBN + ((c ^ (((r >> 1) & 3) << 1)) << 4);
}

// An f16x2 widened from e4m3 -> the same two values as bf16x2, exactly.
// Such an f16 is zero or normal with at most its top three mantissa bits
// set, so its exponent and mantissa moved down 3 bits form the bf16 of
// the value times 2^-112; one bf16x2 multiply by 2^112 (0x7780) restores
// it.  (The e4m3 NaN codes would come out finite; the port's quantizer
// never stores them.)
__device__ __forceinline__ uint32_t f16x2_to_bf16x2(uint32_t h) {
  const uint32_t b = ((h & 0x7fff7fffu) >> 3) | (h & 0x80008000u);
  const uint32_t two112 = 0x77807780u;
  return as_u32(__hmul2(*reinterpret_cast<const __nv_bfloat162*>(&b),
                        *reinterpret_cast<const __nv_bfloat162*>(&two112)));
}

// Four e4m3 bytes as two pairs (bytes 0-1 and 2-3, the lower byte the
// lower k) -> two bf16x2 registers
__device__ __forceinline__ void widen_pairs(uint32_t w, uint32_t& lo,
                                            uint32_t& hi) {
  uint32_t h0, h1;
  asm("{\n .reg .b16 a, b;\n mov.b32 {a, b}, %2;\n"
      " cvt.rn.f16x2.e4m3x2 %0, a;\n cvt.rn.f16x2.e4m3x2 %1, b;\n}\n"
      : "=r"(h0), "=r"(h1) : "r"(w));
  lo = f16x2_to_bf16x2(h0);
  hi = f16x2_to_bf16x2(h1);
}

template <typename OT, int kStages>
__global__ void __launch_bounds__(kThreads)
fp8_decode_tc(const __nv_bfloat16* __restrict__ x,
              const int8_t* __restrict__ wq, const float* __restrict__ ws,
              const void* __restrict__ bias, int bias_bf16,
              OT* __restrict__ out, int M, int K, int N, int k_per_split) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int tile = blockIdx.x, split = blockIdx.y;
  const int m0 = blockIdx.z * kMT, n0 = tile * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_st = (k_end - k_begin + kKS - 1) / kKS;

  // copies of stage i (k-rows k_begin + 64 i ...) into ring slot i % 4;
  // rows past k_end and columns past N land as zeros
  auto load = [&](int i) {
    unsigned char* st = smem_tc + (i % kStages) * kStageBytes;
    const int kb = k_begin + i * kKS;
    for (int e = tid; e < kKS * (kBN / 16); e += kThreads) {
      const int r = e >> 3, c = e & 7, k = kb + r, n = n0 + c * 16;
      const bool ok = k < k_end && n < N;
      cp_async16(st + wsw(r, c),
                 ok ? wq + static_cast<size_t>(k) * N + n : wq, ok);
    }
    if (tid < kMT * (kKS / 8)) {
      const int r = tid >> 3, c = tid & 7, m = m0 + r, k = kb + c * 8;
      const bool ok = m < M && k < k_end;
      cp_async16(st + kWBytes + r * kXPitch * 2 + c * 16,
                 ok ? x + static_cast<size_t>(m) * K + k : x, ok);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_st) load(i);
    tc::cp_async_commit();
  }
  for (int i = 0; i < n_st; ++i) {
    tc::cp_async_wait<kStages - 2>();
    // stage i has landed for every thread, and every warp is done with
    // stage i - 1, whose slot the next copies overwrite
    __syncthreads();
    if (i + kStages - 1 < n_st) load(i + kStages - 1);
    tc::cp_async_commit();

    const unsigned char* st = smem_tc + (i % kStages) * kStageBytes;
    const int r0 = warp * 16 + 2 * t;
    // k-rows 2t, 2t + 1 (A's k pair 0) and 2t + 8, 2t + 9 (pair 1) of
    // this warp's k-step, the lane's 16 columns 16g ... 16g + 15
    const uint4 q0 = *reinterpret_cast<const uint4*>(st + wsw(r0, g));
    const uint4 q1 = *reinterpret_cast<const uint4*>(st + wsw(r0 + 1, g));
    const uint4 q2 = *reinterpret_cast<const uint4*>(st + wsw(r0 + 8, g));
    const uint4 q3 = *reinterpret_cast<const uint4*>(st + wsw(r0 + 9, g));
    const uint32_t* w0 = &q0.x;
    const uint32_t* w1 = &q1.x;
    const uint32_t* w2 = &q2.x;
    const uint32_t* w3 = &q3.x;
    // B fragment: x rows g, k pairs 2t and 2t + 8 of the k-step
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + kWBytes) + g * kXPitch +
        warp * 16 + 2 * t;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xs);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xs + 8);
    // A fragment j: column 16g + 2j is its row g, column 16g + 2j + 1
    // its row g + 8
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      uint32_t a[2][4];
      widen_pairs(__byte_perm(w0[v], w1[v], 0x5140), a[0][0], a[0][1]);
      widen_pairs(__byte_perm(w0[v], w1[v], 0x7362), a[1][0], a[1][1]);
      widen_pairs(__byte_perm(w2[v], w3[v], 0x5140), a[0][2], a[0][3]);
      widen_pairs(__byte_perm(w2[v], w3[v], 0x7362), a[1][2], a[1][3]);
      tc::mma16816(acc[2 * v], a[0], b0, b1);
      tc::mma16816(acc[2 * v + 1], a[1], b0, b1);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();   // the ring is free: the warps' sums go there

  // red[warp][m][column], fragment j's c0..c3 = (row g, x rows 2t, 2t+1),
  // (row g + 8, x rows 2t, 2t + 1)
  float* red = reinterpret_cast<float*>(smem_tc);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 16 * g + 2 * j;
    float* rw = red + (warp * kMT + 2 * t) * kBN + c;
    rw[0] = acc[j][0];
    rw[kBN] = acc[j][1];
    rw[1] = acc[j][2];
    rw[kBN + 1] = acc[j][3];
  }
  __syncthreads();
  // this k-range's sums, the warps added in order
  float* bsum = red + kWarps * kMT * kBN;
  for (int e = tid; e < kMT * kBN; e += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w * kMT * kBN + e];
    bsum[e] = sum;
  }
  // the cluster's k-ranges (rank = split) added in order: each block
  // takes every n-th group of 128 outputs
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int n_split = static_cast<int>(cl.num_blocks());
  for (int e = split * kThreads + tid; e < kMT * kBN;
       e += n_split * kThreads) {
    const int m = m0 + e / kBN, n = n0 + e % kBN;
    if (m >= M || n >= N) continue;
    float part[8];   // every range's sum in flight at once, then added
#pragma unroll
    for (int r = 0; r < 8; ++r)
      part[r] = r < n_split ? cl.map_shared_rank(bsum, r)[e] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < n_split) sum += part[r];
    out[static_cast<size_t>(m) * N + n] =
        epilogue<OT>(sum, ws[n], bias, bias_bf16, n);
  }
  cl.sync();   // no block leaves while another reads its shared memory
}

template <typename OT, int kStages>
int launch_stages(const void* x, const int8_t* wq, const float* ws,
                  const void* bias, int bias_bf16, void* out, int M, int K,
                  int N, int n_split, int k_per_split, cudaStream_t st) {
  constexpr int kSmem = kStages * kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fp8_decode_tc<OT, kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, n_split, (M + kMT - 1) / kMT);
  err = launch_clusters(fp8_decode_tc<OT, kStages>, grid,
                        dim3(1, n_split, 1), kThreads, kSmem, st,
                        static_cast<const __nv_bfloat16*>(x), wq, ws, bias,
                        bias_bf16, static_cast<OT*>(out), M, K, N,
                        k_per_split);
  return static_cast<int>(err);
}

// A k-range of at most 3 stages takes a 3-stage ring (28 KB: more blocks
// an SM), a longer one the 8-stage ring (73 KB)
template <typename OT>
int launch_tc(const void* x, const int8_t* wq, const float* ws,
              const void* bias, int bias_bf16, void* out, int M, int K,
              int N, int n_split, int k_per_split, cudaStream_t st) {
  if (n_split > 8 || k_per_split % kKS != 0) return -1;
  if (k_per_split <= 3 * kKS)
    return launch_stages<OT, 3>(x, wq, ws, bias, bias_bf16, out, M, K, N,
                                n_split, k_per_split, st);
  return launch_stages<OT, 8>(x, wq, ws, bias, bias_bf16, out, M, K, N,
                              n_split, k_per_split, st);
}

}  // namespace tc_step

}  // namespace
}  // namespace repro

extern "C" {

// Which step a launch takes: 1 for the tensor-core step (bf16 x, N a
// multiple of 16, K of 8, x and wq 16-byte aligned: ``aligned16``), 0
// for the FMA step.  fp8_decode_matmul dispatches on it; the Python
// wrapper plans the split with it and counts the tensor-core launches.
int fp8_decode_tc_step(int x_dtype, int K, int N, int aligned16) {
  using namespace repro;
  return x_dtype == kBF16 && N % 16 == 0 && K % 8 == 0 && aligned16;
}

// One launch of the fp8 decode matmul on ``stream``; arguments as for
// w8a8_decode_matmul (``wq`` is the e4m3 weight's bytes, ``partial``
// fp32).  The tensor-core step takes at most 8 k-ranges and no
// ``partial`` or ``counters``.
int fp8_decode_matmul(const void* x, const int8_t* wq, const float* ws,
                      const void* bias, void* out, float* partial,
                      int* counters, int M, int K, int N, int n_split,
                      int k_per_split, int x_dtype, int out_dtype,
                      int bias_dtype, int vec, int aligned16, void* stream) {
  using namespace repro;
  if (M <= 0 || M > kMaxM || K <= 0 || N <= 0 || n_split <= 0 ||
      k_per_split <= 0 || static_cast<long long>(n_split) * k_per_split < K)
    return -1;
  if (bias != nullptr && bias_dtype != kF32 && bias_dtype != kBF16) return -1;
  const int bias_bf16 = bias_dtype == kBF16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (fp8_decode_tc_step(x_dtype, K, N, aligned16)) {
    if (out_dtype == kBF16)
      rc = tc_step::launch_tc<__nv_bfloat16>(x, wq, ws, bias, bias_bf16, out, M, K, N, n_split, k_per_split, st);
    else if (out_dtype == kF32)
      rc = tc_step::launch_tc<float>(x, wq, ws, bias, bias_bf16, out, M, K, N, n_split, k_per_split, st);
    else
      rc = -1;
  } else if (n_split > 1 && (partial == nullptr || counters == nullptr))
    rc = -1;
  else if (x_dtype == kBF16 && out_dtype == kBF16)
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

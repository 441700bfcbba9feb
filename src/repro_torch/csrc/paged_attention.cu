// Paged single-query decode attention (flash-decoding over paged KV pools).
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py:
// paged_attention_pallas (_paged_kernel).  Same function: for every slot s
// and query head h, softmax(q·K^T / sqrt(D)) · V over the slot's first
// lengths[s] cached tokens, read page by page through block_table[s];
// fp32 online softmax; GQA with query heads kv-head-major (head
// kh*G + g reads kv head kh); a length-0 slot yields zeros.  int8 and
// fp8-e4m3 pools carry one fp32 scale per (page, kv head): the K scale
// multiplies the score, the V scale multiplies p·v.
//
// What bounds it on an H100: bytes.  Each cached K/V element is read
// once and used for G (<= 8) multiply-adds, far below the ~295 flop/byte
// the card needs before compute matters, so the floor is the K/V bytes
// of the live lengths over 3.35 TB/s.
//
// What the design does about it:
//  * The Pallas grid walks a slot's pages in order, carrying (m, l, acc)
//    in VMEM between steps.  Here blocks run in no order, so one block
//    owns a (slot, kv head, token range) and walks its range in a loop;
//    the ranges ("splits") give 8 slots x 2 kv heads enough blocks to
//    fill 132 SMs, and a second small kernel merges the splits' partial
//    softmax states.  Splits past a slot's length exit at once.
//  * A warp handles 4 tokens per step: each lane issues one vector load
//    per K and V row (8 loads in flight per lane) before any arithmetic,
//    so memory latency is overlapped; scores reduce across the warp with
//    shuffles, and all G query rows of the kv head reuse each K/V row.
//  * Pages are not staged whole (a 256-token bf16 page is 64 KB per
//    operand): tokens are addressed one row at a time through the block
//    table, so any page size works and a partial last page needs no mask.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;     // tokens per warp step
constexpr int kMaxG = 8;       // query heads per kv head held in registers

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const QT* __restrict__ q, const KVT* __restrict__ kp,
                   const KVT* __restrict__ vp, const int* __restrict__ bt,
                   const int* __restrict__ lengths,
                   const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int H, int KH, int page,
                   int P, int tps, float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;   // elements per lane
  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][D];

  const int s = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int G = H / KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = lane * EPL;
  const bool lane_live = d0 < D;
  const bool quantized = k_scales != nullptr;

  const int L = max(0, min(lengths[s], P * page));
  const int t_begin = split * tps;
  const int t_end = min(t_begin + tps, L);

  float qr[kMaxG][EPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    if (g < G && lane_live) {
      const QT* qrow = q + ((size_t)s * H + (size_t)kh * G + g) * D + d0;
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = to_f32<QT>(qrow[e]);
    }
  }

  float m[kMaxG], l[kMaxG], acc[kMaxG][EPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int* bt_row = bt + (size_t)s * P;
  for (int t0 = t_begin + warp * kUnroll; t0 < t_end;
       t0 += kWarps * kUnroll) {
    float kf[kUnroll][EPL], vf[kUnroll][EPL];
    float ksc[kUnroll], vsc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = t0 + u < t_end;
      const int tt = ok[u] ? t0 + u : t0;   // in range: t0 < t_end
      const int pg = bt_row[tt / page];
      const size_t off = (((size_t)pg * page + tt % page) * KH + kh) * D + d0;
      if (lane_live) {
        load_f32<KVT, EPL>(kp + off, kf[u]);
        load_f32<KVT, EPL>(vp + off, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
      ksc[u] = quantized ? k_scales[(size_t)pg * KH + kh] : 1.f;
      vsc[u] = quantized ? v_scales[(size_t)pg * KH + kh] : 1.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) continue;
      float sc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kf[u][e], part);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        sc[u] = ok[u] ? part * (scale * ksc[u]) : kNegInf;
      }
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, sc[u]);
      const float corr = expf(m[g] - mx);
      float p[kUnroll], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = ok[u] ? expf(sc[u] - mx) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u] * vsc[u], vf[u][e], a);
        acc[g][e] = a;
      }
      m[g] = mx;
    }
  }

  // merge the warps' states, then write this split's partial state
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  if (lane_live) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) continue;
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  const size_t base = ((size_t)s * KH + kh) * n_split + split;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - M);
      lsum = fmaf(sm_l[w][g], f, lsum);
      a = fmaf(sm_acc[w][g][d], f, a);
    }
    part_acc[base * G * D + idx] = a;
    if (d == 0) {
      part_m[base * G + g] = M;
      part_l[base * G + g] = lsum;
    }
  }
}

template <typename QT>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     QT* __restrict__ out, int H, int KH, int D,
                     int n_split) {
  const int s = blockIdx.x, kh = blockIdx.y;
  const int G = H / KH;
  const size_t base = ((size_t)s * KH + kh) * n_split;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    float M = kNegInf;
    for (int j = 0; j < n_split; ++j) M = fmaxf(M, part_m[(base + j) * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float f = expf(part_m[(base + j) * G + g] - M);
      lsum = fmaf(part_l[(base + j) * G + g], f, lsum);
      a = fmaf(part_acc[(base + j) * G * D + idx], f, a);
    }
    // a slot with no live token has l == 0 and acc == 0: zeros, as the
    // reference's flush writes
    out[((size_t)s * H + (size_t)kh * G) * D + idx] =
        from_f32<QT>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename QT, typename KVT, int D>
void launch(const void* q, const void* kp, const void* vp, const int* bt,
            const int* lengths, const float* ks, const float* vs, void* out,
            float* pm, float* pl, float* pa, int S, int H, int KH, int page,
            int P, int n_split, int tps, float scale, cudaStream_t stream) {
  dim3 grid(S, KH, n_split);
  paged_decode_split<QT, KVT, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), bt, lengths, ks, vs, pm, pl, pa, H, KH,
      page, P, tps, scale);
  paged_decode_combine<QT><<<dim3(S, KH), kThreads, 0, stream>>>(
      pm, pl, pa, static_cast<QT*>(out), H, KH, D, n_split);
}

template <typename QT, typename KVT>
int dispatch_d(int D, const void* q, const void* kp, const void* vp,
               const int* bt, const int* lengths, const float* ks,
               const float* vs, void* out, float* pm, float* pl, float* pa,
               int S, int H, int KH, int page, int P, int n_split, int tps,
               float scale, cudaStream_t st) {
  switch (D) {
    case 16: launch<QT, KVT, 16>(q, kp, vp, bt, lengths, ks, vs, out, pm, pl, pa, S, H, KH, page, P, n_split, tps, scale, st); return 0;
    case 64: launch<QT, KVT, 64>(q, kp, vp, bt, lengths, ks, vs, out, pm, pl, pa, S, H, KH, page, P, n_split, tps, scale, st); return 0;
    case 128: launch<QT, KVT, 128>(q, kp, vp, bt, lengths, ks, vs, out, pm, pl, pa, S, H, KH, page, P, n_split, tps, scale, st); return 0;
    default: return -1;
  }
}

template <typename QT>
int dispatch_kv(int kv_dtype, int D, const void* q, const void* kp,
                const void* vp, const int* bt, const int* lengths,
                const float* ks, const float* vs, void* out, float* pm,
                float* pl, float* pa, int S, int H, int KH, int page, int P,
                int n_split, int tps, float scale, cudaStream_t st) {
  switch (kv_dtype) {
    case kF32: return dispatch_d<QT, float>(D, q, kp, vp, bt, lengths, ks, vs, out, pm, pl, pa, S, H, KH, page, P, n_split, tps, scale, st);
    case kBF16: return dispatch_d<QT, __nv_bfloat16>(D, q, kp, vp, bt, lengths, ks, vs, out, pm, pl, pa, S, H, KH, page, P, n_split, tps, scale, st);
    case kI8: return dispatch_d<QT, int8_t>(D, q, kp, vp, bt, lengths, ks, vs, out, pm, pl, pa, S, H, KH, page, P, n_split, tps, scale, st);
    case kFP8: return dispatch_d<QT, __nv_fp8_e4m3>(D, q, kp, vp, bt, lengths, ks, vs, out, pm, pl, pa, S, H, KH, page, P, n_split, tps, scale, st);
    default: return -1;
  }
}

}  // namespace
}  // namespace repro

extern "C" {

// Launches the split kernel and the combine kernel on ``stream``.
// Returns 0, a CUDA error code from the launch, or -1 for a shape or
// dtype this kernel does not take (the Python wrapper checks those first).
int paged_attention_decode(const void* q, const void* k_pages,
                           const void* v_pages, const int* block_table,
                           const int* lengths, const float* k_scales,
                           const float* v_scales, void* out, float* part_m,
                           float* part_l, float* part_acc, int S, int H,
                           int KH, int D, int page, int P, int n_split,
                           int tokens_per_split, float scale, int q_dtype,
                           int kv_dtype, void* stream) {
  using namespace repro;
  if (S <= 0 || KH <= 0 || H % KH != 0 || H / KH > kMaxG || n_split <= 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (q_dtype == kF32)
    rc = dispatch_kv<float>(kv_dtype, D, q, k_pages, v_pages, block_table, lengths, k_scales, v_scales, out, part_m, part_l, part_acc, S, H, KH, page, P, n_split, tokens_per_split, scale, st);
  else if (q_dtype == kBF16)
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, D, q, k_pages, v_pages, block_table, lengths, k_scales, v_scales, out, part_m, part_l, part_acc, S, H, KH, page, P, n_split, tokens_per_split, scale, st);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

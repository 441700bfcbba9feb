// Multi-query prefix-extend attention over paged KV pools.
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py:
// paged_prefix_extend_pallas (_prefix_extend_kernel).  Same function:
// q (S,W,H,D), query w of slot s sitting at logical position
// prefix_lens[s] + w, attends
//   * the slot's paged prefix, positions < prefix_lens[s], read through
//     block_table[s] (int8 / fp8-e4m3 pools dequantized with their fp32
//     scale per (page, kv head)); whatever the pages hold at or past the
//     prefix (a prefill chunk's own just-scattered rows) is not read;
//   * the chunk's own fresh K/V, chunk_k / chunk_v (S,W,KH,D), causally:
//     key j when j <= w and j < widths[s];
// with an fp32 online softmax -> o (S,W,H,D) in q's type.  GQA is
// kv-head-major (head kh*G + g reads kv head kh).  Rows w >= widths[s]
// are padding, computed under the same masks; a row that sees no key
// (prefix 0, width 0) gives zeros.  q and the chunk are each fp32 or
// bf16 (speculative verify passes fp32 q with a bf16 chunk).
//
// What bounds it on an H100: operations.  At the scheduler's shape
// (4 slots x 512 chunk rows x 12 heads over 2, D 128, prefixes of
// 512-3072 tokens) the two products are about 2.4e10 operations, 24 µs
// at the bf16 tensor-core peak, against about 4 µs for the q, chunk,
// prefix K/V and output bytes; chip_smoke.py computes both from its
// inputs.  This first version runs the products on the fp32 FMA units
// (67 TFLOP/s), so in practice FMA throughput bounds it; mma/wgmma
// products, TMA loads and a split of long prefixes over more blocks for
// small W are later work.
//
// What the design does about it:
//  * The Pallas program owns a whole (slot, kv head) with its W·G rows in
//    VMEM and a sequential page axis.  W·G reaches 3,072 rows here, too
//    many for one Hopper block, so a block owns a 64-row tile of the W·G
//    row space (row r = query r / G, head r % G, the reference's q4
//    layout) for one (slot, kv head), and loops inside the block: first
//    over the prefix in 64-key tiles, then over the chunk keys up to the
//    tile's largest w.  Fully masked tiles are never visited, so a
//    chunk's cost follows its prefix, not the slot's page horizon.
//  * Prefix keys are addressed one row at a time through the block
//    table, as in the paged decode kernel: any page size works and a
//    partial last page needs no special case.  No clamp of the page
//    index is needed (the TPU grid's extra chunk step needed one).
//  * The tile step (64 x 64 scores, online softmax, p·v) is the flash
//    prefill kernel's, in attn_tile.cuh; K/V are dequantized to fp32 as
//    they are staged in shared memory.
#include "attn_tile.cuh"

namespace repro {
namespace {

using namespace tile;

// q, chunk and output elements: fp32 or bf16, chosen at run time (the
// loads sit outside the product loops, so the branch costs little and
// keeps the number of instantiations down)
__device__ __forceinline__ float load_wide(const void* p, size_t i, int dt) {
  return dt == kF32 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_wide(void* p, size_t i, int dt, float x) {
  if (dt == kF32)
    static_cast<float*>(p)[i] = x;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
}

template <typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
prefix_extend_fwd(const void* __restrict__ q, const KVT* __restrict__ kp,
                  const KVT* __restrict__ vp, const int* __restrict__ bt,
                  const int* __restrict__ prefix_lens,
                  const void* __restrict__ ck, const void* __restrict__ cv,
                  const int* __restrict__ widths,
                  const float* __restrict__ k_scales,
                  const float* __restrict__ v_scales, void* __restrict__ o,
                  int W, int H, int KH, int page, int P, float scale,
                  int q_dtype, int c_dtype) {
  constexpr int QS = Smem<D>::QS, KTS = Smem<D>::KTS;
  constexpr int DC = State<D>::DC;
  extern __shared__ float smem[];
  const Smem<D> sm(smem);

  const int r0 = blockIdx.x * kBQ, kh = blockIdx.y, s = blockIdx.z;
  const int G = H / KH, rows = W * G;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const bool quantized = k_scales != nullptr;

  // q row (w, g) of this (slot, kv head) -> element offset of its d = 0
  auto q_off = [&](int r) {
    return (((size_t)s * W + r / G) * H + (size_t)kh * G + r % G) * D;
  };
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D, r = r0 + i;
    sm.Qs[i * QS + d] = r < rows ? load_wide(q, q_off(r) + d, q_dtype) : 0.f;
  }

  const int L = max(0, min(prefix_lens[s], P * page));
  const int wid = max(0, min(widths[s], W));
  const int* bt_row = bt + (size_t)s * P;

  State<D> st;
  st.init();

  // 1. the paged prefix: every row sees keys < L
  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < L) {
        const int pg = bt_row[kj / page];
        const size_t off = (((size_t)pg * page + kj % page) * KH + kh) * D + d;
        kv = to_f32<KVT>(kp[off]);
        vv = to_f32<KVT>(vp[off]);
        if (quantized) {
          kv *= k_scales[(size_t)pg * KH + kh];
          vv *= v_scales[(size_t)pg * KH + kh];
        }
      }
      sm.Kt[d * KTS + j] = kv;
      sm.Vs[j * D + d] = vv;
    }
    __syncthreads();
    step<D>(sm, st, tx, ty, scale, [&](int a, int c) {
      return k0 + tx * kRK + c < L;
    });
  }

  // 2. the fresh chunk, causally: row w sees keys j <= w, j < wid
  const int w_hi = min(W - 1, (r0 + kBQ - 1) / G);   // the tile's largest w
  const int j_end = min(wid, w_hi + 1);
  for (int k0 = 0; k0 < j_end; k0 += kBK) {
    __syncthreads();
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < j_end) {
        const size_t off = (((size_t)s * W + kj) * KH + kh) * D + d;
        kv = load_wide(ck, off, c_dtype);
        vv = load_wide(cv, off, c_dtype);
      }
      sm.Kt[d * KTS + j] = kv;
      sm.Vs[j * D + d] = vv;
    }
    __syncthreads();
    step<D>(sm, st, tx, ty, scale, [&](int a, int c) {
      const int kj = k0 + tx * kRK + c;
      return kj < wid && kj <= (r0 + ty * kRQ + a) / G;
    });
  }

#pragma unroll
  for (int a = 0; a < kRQ; ++a) {
    const int r = r0 + ty * kRQ + a;
    if (r >= rows) continue;
    // a row that saw no key has l == 0 and acc == 0: zeros
    const float denom = fmaxf(st.l[a], 1e-30f);
    const size_t base = q_off(r);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_wide(o, base + tx + c * kTX, q_dtype, st.acc[a][c] / denom);
  }
}

template <typename KVT, int D>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* prefix_lens, const void* ck, const void* cv,
           const int* widths, const float* ks, const float* vs, void* o,
           int S, int W, int H, int KH, int page, int P, float scale,
           int q_dtype, int c_dtype, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      prefix_extend_fwd<KVT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = W * (H / KH);
  dim3 grid((rows + kBQ - 1) / kBQ, KH, S);
  prefix_extend_fwd<KVT, D><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const KVT*>(kp), static_cast<const KVT*>(vp), bt,
      prefix_lens, ck, cv, widths, ks, vs, o, W, H, KH, page, P, scale,
      q_dtype, c_dtype);
  return 0;
}

template <typename KVT>
int dispatch_d(int D, const void* q, const void* kp, const void* vp,
               const int* bt, const int* pl, const void* ck, const void* cv,
               const int* wd, const float* ks, const float* vs, void* o,
               int S, int W, int H, int KH, int page, int P, float scale,
               int qd, int cd, cudaStream_t st) {
  switch (D) {
    case 16: return launch<KVT, 16>(q, kp, vp, bt, pl, ck, cv, wd, ks, vs, o, S, W, H, KH, page, P, scale, qd, cd, st);
    case 64: return launch<KVT, 64>(q, kp, vp, bt, pl, ck, cv, wd, ks, vs, o, S, W, H, KH, page, P, scale, qd, cd, st);
    case 128: return launch<KVT, 128>(q, kp, vp, bt, pl, ck, cv, wd, ks, vs, o, S, W, H, KH, page, P, scale, qd, cd, st);
    default: return -1;
  }
}

}  // namespace
}  // namespace repro

extern "C" {

// Launches the kernel on ``stream``.  Returns 0, a CUDA error code from
// the launch, or -1 for a shape or dtype this kernel does not take (the
// Python wrapper checks those first).
int paged_prefix_extend_fwd(const void* q, const void* k_pages,
                            const void* v_pages, const int* block_table,
                            const int* prefix_lens, const void* chunk_k,
                            const void* chunk_v, const int* widths,
                            const float* k_scales, const float* v_scales,
                            void* out, int S, int W, int H, int KH, int D,
                            int page, int P, float scale, int q_dtype,
                            int c_dtype, int kv_dtype, void* stream) {
  using namespace repro;
  if (S <= 0 || W <= 0 || KH <= 0 || H % KH != 0 || page <= 0 || P < 0)
    return -1;
  if ((q_dtype != kF32 && q_dtype != kBF16) || (c_dtype != kF32 && c_dtype != kBF16))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (kv_dtype) {
    case kF32: rc = dispatch_d<float>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, q_dtype, c_dtype, st); break;
    case kBF16: rc = dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, q_dtype, c_dtype, st); break;
    case kI8: rc = dispatch_d<int8_t>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, q_dtype, c_dtype, st); break;
    case kFP8: rc = dispatch_d<__nv_fp8_e4m3>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, q_dtype, c_dtype, st); break;
    default: rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

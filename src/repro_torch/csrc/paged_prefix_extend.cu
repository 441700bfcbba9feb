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
// inputs.  On the fp32 FMA units (67 TFLOP/s) the same products need
// about 0.36 ms, so bf16 q and chunk over bf16 / int8 / fp8 pools take
// the tensor cores.
//
// What the design does about it:
//  * The Pallas program owns a whole (slot, kv head) with its W·G rows in
//    VMEM and a sequential page axis.  W·G reaches 3,072 rows here, too
//    many for one Hopper block, so a block owns a 64-row tile of the W·G
//    row space (row r = query r / G, head r % G, the reference's q4
//    layout) for one (slot, kv head), and loops inside the block: first
//    over the prefix in 64-key tiles, then over the chunk keys up to the
//    tile's largest w.  Fully masked tiles are never visited, so a
//    chunk's cost follows its prefix, not the slot's page horizon; masks
//    apply only on the tiles that touch L, the width or the diagonal.
//  * Prefix keys are addressed one row at a time through the block
//    table, as in the paged decode kernel: any page size works and a
//    partial last page needs no special case.  Rows at or past L are
//    never read (zero-filled), so whatever the null page holds cannot
//    reach an output.
//  * bf16 q and chunk over bf16 / int8 / fp8 pools
//    (prefix_extend_fwd_tc): the tile step of attn_tile_tc.cuh, mma.sync
//    m16n8k16 products from swizzled bf16 tiles in shared memory, with
//    the tiles of step n+1 in flight as cp.async copies (a two-stage
//    ring) while step n computes.  int8 and e4m3 values are exact in
//    bf16: their rows arrive as raw bytes in a ring of their own and are
//    widened into the bf16 ring once a tile has landed.  The scales stay
//    out of the products, as in the reference: k's scale multiplies each
//    score column, v's each column of p before p enters the second
//    product (a 64-key tile may cross pages of different scales).
//  * Other dtypes (fp32 q, chunk or pools: the float32 configs and
//    speculative verify's fp32 q) keep the FMA step of attn_tile.cuh
//    (prefix_extend_fwd), whose fp32 outputs are held to 1e-5: K/V
//    dequantized to fp32 as they are staged in shared memory.
#include "attn_tile.cuh"
#include "attn_tile_tc.cuh"

namespace repro {
namespace {

namespace fma_step {   // fp32 operands: the FMA tile step

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


}  // namespace fma_step

namespace tc_step {   // bf16 q and chunk over bf16 / int8 / fp8 pools: the tensor-core tile step

using namespace tc;

template <typename KVT, int D>
__global__ void __launch_bounds__(tc::kThreads, 2)
prefix_extend_fwd_tc(const tc::bf16* __restrict__ q,
                     const KVT* __restrict__ kp, const KVT* __restrict__ vp,
                     const int* __restrict__ bt,
                     const int* __restrict__ prefix_lens,
                     const tc::bf16* __restrict__ ck,
                     const tc::bf16* __restrict__ cv,
                     const int* __restrict__ widths,
                     const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales,
                     tc::bf16* __restrict__ o, int W, int H, int KH,
                     int page, int P, float scale_log2) {
  constexpr bool kQuant = sizeof(KVT) == 1;     // int8 / e4m3 pools
  constexpr int C = D / 8;                      // 16-byte chunks, bf16 row
  constexpr int CR = D / 16;                    // 16-byte chunks, raw row
  constexpr int kTile = kBK * D;                // elements of a K or V tile
  // [2][kBK][D] bf16 K, then V; for quantized pools the raw ring
  // [2 stages][K, V][kBK][D] bytes and the column scales [2][K, V][kBK];
  // Q [kBQ][D] bf16 sits after V, or on raw stage 1, which no copy
  // targets before Q's fragments are in registers
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + 2 * kTile;
  unsigned char* raw = reinterpret_cast<unsigned char*>(Vs + 2 * kTile);
  float* cols = reinterpret_cast<float*>(raw + 4 * kTile);
  bf16* Qs = kQuant ? reinterpret_cast<bf16*>(raw + 2 * kTile)
                    : reinterpret_cast<bf16*>(raw);

  const int r0 = blockIdx.x * kBQ, kh = blockIdx.y, s = blockIdx.z;
  const int G = H / KH, rows = W * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // q row (w, g) of this (slot, kv head) -> element offset of its d = 0
  auto q_off = [&](int r) {
    return (((size_t)s * W + r / G) * H + (size_t)kh * G + r % G) * D;
  };
  for (int i = tid; i < kBQ * C; i += kThreads) {
    const int r = i / C, c = i % C;
    cp_async16(Qs + swz<D>(r, c), q + q_off(min(r0 + r, rows - 1)) + c * 8,
               r0 + r < rows);
  }

  const int L = max(0, min(prefix_lens[s], P * page));
  const int wid = max(0, min(widths[s], W));
  const int* bt_row = bt + (size_t)s * P;
  const int w_lo = r0 / G;                           // the tile's smallest w
  const int w_hi = min(W - 1, (r0 + kBQ - 1) / G);   // and its largest
  const int j_end = min(wid, w_hi + 1);
  const int n_pre = (L + kBK - 1) / kBK;
  const int n_tiles = n_pre + (j_end + kBK - 1) / kBK;

  // starts the copies of tile n into stage n & 1: prefix tiles first,
  // then the chunk's
  auto load = [&](int n) {
    const int stage = n & 1;
    bf16* kd = Ks + stage * kTile;
    bf16* vd = Vs + stage * kTile;
    if (n < n_pre) {
      const int k0 = n * kBK;
      constexpr int CC = kQuant ? CR : C;
      constexpr int EPC = 16 / sizeof(KVT);            // elements a chunk
      unsigned char* rk = raw + stage * 2 * kTile;
      for (int i = tid; i < kBK * CC; i += kThreads) {
        const int j = i / CC, c = i % CC, kj = k0 + j;
        const bool ok = kj < L;
        const int kr = ok ? kj : 0;
        const size_t off =
            (((size_t)bt_row[kr / page] * page + kr % page) * KH + kh) * D
            + c * EPC;
        if constexpr (kQuant) {
          cp_async16(rk + j * D + c * 16, kp + off, ok);
          cp_async16(rk + kTile + j * D + c * 16, vp + off, ok);
        } else {
          cp_async16(kd + swz<D>(j, c), kp + off, ok);
          cp_async16(vd + swz<D>(j, c), vp + off, ok);
        }
      }
      if (kQuant && tid < kBK) {
        const int kj = k0 + tid;
        float ksc = scale_log2, vsc = 0.f;
        if (kj < L) {
          const size_t pk = (size_t)bt_row[kj / page] * KH + kh;
          ksc *= k_scales[pk];
          vsc = v_scales[pk];
        }
        cols[(stage * 2) * kBK + tid] = ksc;
        cols[(stage * 2 + 1) * kBK + tid] = vsc;
      }
    } else {
      const int k0 = (n - n_pre) * kBK;
      for (int i = tid; i < kBK * C; i += kThreads) {
        const int j = i / C, c = i % C, kj = k0 + j;
        const size_t off =
            (((size_t)s * W + min(kj, W - 1)) * KH + kh) * D + c * 8;
        cp_async16(kd + swz<D>(j, c), ck + off, kj < j_end);
        cp_async16(vd + swz<D>(j, c), cv + off, kj < j_end);
      }
      if (kQuant && tid < kBK) {
        cols[(stage * 2) * kBK + tid] = scale_log2;
        cols[(stage * 2 + 1) * kBK + tid] = 1.f;
      }
    }
  };

  // raw int8 / e4m3 rows of stage -> the bf16 ring (exact)
  auto widen = [&](int stage) {
    if constexpr (!kQuant) return;
    const unsigned char* rk = raw + stage * 2 * kTile;
    for (int i = tid; i < 2 * kBK * CR; i += kThreads) {
      const int which = i / (kBK * CR), j = (i / CR) % kBK, c = i % CR;
      const uint4 v16 =
          *reinterpret_cast<const uint4*>(rk + which * kTile + j * D + c * 16);
      const KVT* e = reinterpret_cast<const KVT*>(&v16);
      uint32_t w[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        w[t] = as_u32(__floats2bfloat162_rn(to_f32<KVT>(e[2 * t]),
                                            to_f32<KVT>(e[2 * t + 1])));
      bf16* dst = (which ? Vs : Ks) + stage * kTile;
      *reinterpret_cast<uint4*>(dst + swz<D>(j, 2 * c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(dst + swz<D>(j, 2 * c + 1)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  };

  if (n_tiles > 0) load(0);
  cp_async_commit();                              // Q and tile 0
  State<D> st;
  st.init();
  for (int n = 0; n < n_tiles; ++n) {
    const int stage = n & 1;
    cp_async_wait<0>();
    // tile n has landed for every thread, and every warp is done with
    // tile n - 1, whose stage the next copies overwrite
    __syncthreads();
    const bool widened = kQuant && n < n_pre;
    if (widened) widen(stage);
    if (n == 0) st.load_q(Qs, warp, lane);
    // the widened tile is visible, and Q has left raw stage 1
    if (widened || (kQuant && n == 0)) __syncthreads();
    if (n + 1 < n_tiles) load(n + 1);
    cp_async_commit();
    const bf16* kt = Ks + stage * kTile;
    const bf16* vt = Vs + stage * kTile;
    const float* kc = cols + (stage * 2) * kBK;
    const float* vc = kc + kBK;
    auto kscale = [&](int c) { return kQuant ? kc[c] : scale_log2; };
    auto vscale = [&](int c) { return kQuant ? vc[c] : 1.f; };
    if (n < n_pre) {
      const int k0 = n * kBK;
      if (k0 + kBK > L)
        step<D, true>(st, kt, vt, warp, lane, kscale, vscale,
                      [&](int, int c) { return k0 + c < L; });
      else
        step<D, false>(st, kt, vt, warp, lane, kscale, vscale,
                       [](int, int) { return true; });
    } else {
      const int k0 = (n - n_pre) * kBK;
      // unmasked when every key is below the width and at or below the
      // tile's smallest w
      if (k0 + kBK > wid || k0 + kBK - 1 > w_lo)
        step<D, true>(st, kt, vt, warp, lane, kscale, vscale,
                      [&](int r, int c) {
                        const int kj = k0 + c;
                        return kj < wid && kj <= (r0 + r) / G;
                      });
      else
        step<D, false>(st, kt, vt, warp, lane, kscale, vscale,
                       [](int, int) { return true; });
    }
  }
  cp_async_wait<0>();

  finish<D>(st, warp, lane, [&](int r, int c, float x0, float x1) {
    if (r0 + r < rows) store_bf16x2(o + q_off(r0 + r) + c, x0, x1);
  });
}

template <typename KVT, int D>
int launch_tc(const void* q, const void* kp, const void* vp, const int* bt,
              const int* prefix_lens, const void* ck, const void* cv,
              const int* widths, const float* ks, const float* vs, void* o,
              int S, int W, int H, int KH, int page, int P, float scale,
              cudaStream_t stream) {
  constexpr size_t kTile = (size_t)tc::kBK * D;
  // bf16 K/V ring and Q (80 KB at D 128); quantized pools: the bf16 ring,
  // the raw ring holding Q on its stage 1, and the column scales (97 KB)
  const size_t smem = sizeof(KVT) == 1
      ? 4 * kTile * 2 + 4 * kTile + 4 * tc::kBK * sizeof(float)
      : 4 * kTile * 2 + kTile * 2;
  cudaError_t err = cudaFuncSetAttribute(
      prefix_extend_fwd_tc<KVT, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = W * (H / KH);
  dim3 grid((rows + tc::kBQ - 1) / tc::kBQ, KH, S);
  prefix_extend_fwd_tc<KVT, D><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), bt, prefix_lens,
      static_cast<const tc::bf16*>(ck), static_cast<const tc::bf16*>(cv),
      widths, ks, vs, static_cast<tc::bf16*>(o), W, H, KH, page, P,
      scale * tc::kLog2e);
  return 0;
}

template <typename KVT>
int dispatch_tc(int D, const void* q, const void* kp, const void* vp,
                const int* bt, const int* pl, const void* ck, const void* cv,
                const int* wd, const float* ks, const float* vs, void* o,
                int S, int W, int H, int KH, int page, int P, float scale,
                cudaStream_t st) {
  switch (D) {
    case 16: return launch_tc<KVT, 16>(q, kp, vp, bt, pl, ck, cv, wd, ks, vs, o, S, W, H, KH, page, P, scale, st);
    case 64: return launch_tc<KVT, 64>(q, kp, vp, bt, pl, ck, cv, wd, ks, vs, o, S, W, H, KH, page, P, scale, st);
    case 128: return launch_tc<KVT, 128>(q, kp, vp, bt, pl, ck, cv, wd, ks, vs, o, S, W, H, KH, page, P, scale, st);
    default: return -1;
  }
}

}  // namespace tc_step

}  // namespace
}  // namespace repro

extern "C" {

// Which tile step a launch of these dtypes takes: 1 for the tensor-core
// step (bf16 q and chunk over bf16 / int8 / fp8 pools), 0 for the FMA
// step.  paged_prefix_extend_fwd dispatches on it; the Python wrapper
// counts the launches that took the tensor cores.
int paged_prefix_extend_tc_step(int q_dtype, int c_dtype, int kv_dtype) {
  using namespace repro;
  return q_dtype == kBF16 && c_dtype == kBF16
         && (kv_dtype == kBF16 || kv_dtype == kI8 || kv_dtype == kFP8);
}

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
  if (paged_prefix_extend_tc_step(q_dtype, c_dtype, kv_dtype)) {
    switch (kv_dtype) {
      case kBF16: rc = tc_step::dispatch_tc<__nv_bfloat16>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, st); break;
      case kI8: rc = tc_step::dispatch_tc<int8_t>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, st); break;
      default: rc = tc_step::dispatch_tc<__nv_fp8_e4m3>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, st);
    }
  } else {
    switch (kv_dtype) {
      case kF32: rc = fma_step::dispatch_d<float>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, q_dtype, c_dtype, st); break;
      case kBF16: rc = fma_step::dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, q_dtype, c_dtype, st); break;
      case kI8: rc = fma_step::dispatch_d<int8_t>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, q_dtype, c_dtype, st); break;
      case kFP8: rc = fma_step::dispatch_d<__nv_fp8_e4m3>(D, q, k_pages, v_pages, block_table, prefix_lens, chunk_k, chunk_v, widths, k_scales, v_scales, out, S, W, H, KH, page, P, scale, q_dtype, c_dtype, st); break;
      default: rc = -1;
    }
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

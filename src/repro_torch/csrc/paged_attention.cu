// Paged single-query decode attention (flash-decoding over paged KV pools).
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py:
// paged_attention_pallas (_paged_kernel).  Same function: for every slot s
// and query head h, softmax(q·K^T / sqrt(D)) · V over the slot's first
// lengths[s] cached tokens, read page by page through block_table[s];
// fp32 online softmax; GQA with query heads kv-head-major (head
// kh*G + g reads kv head kh), any G; a length-0 slot yields zeros.  int8
// and fp8-e4m3 pools carry one fp32 scale per (page, kv head): the K scale
// multiplies the score, the V scale multiplies p·v.
//
// What bounds it on an H100: bytes.  Each cached K/V element is read
// once and used for G multiply-adds, far below the ~295 flop/byte the
// card needs before compute matters, so the floor is the K/V bytes of the
// live lengths over 3.35 TB/s.
//
// What the design does about it:
//  * One launch, partial states on chip.  The Pallas grid walks a slot's
//    pages in order, carrying (m, l, acc) in VMEM between steps.  Here a
//    block owns a (slot, kv head, row group, token range) and walks its
//    range in a loop; the ranges ("splits", at most 8) give the slots and
//    kv heads enough blocks to fill the card.  The splits of a (slot, kv
//    head, row group) form a thread block cluster: each leaves its state
//    in its shared memory, and after a cluster barrier every block takes
//    a share of the outputs and merges the live splits' states in split
//    order through distributed shared memory.  A split past the slot's
//    length reads no K/V and its state is not merged; no partial state
//    goes through device memory, and the result is the same on every run.
//  * Any group.  The G query heads of a kv head are cut into row groups
//    of 16 (tensor-core step) or 8 (FMA step), one block each.
//  * bf16 q over bf16 / int8 / fp8 pools (paged_decode_tc): K and V
//    arrive in tiles of 64 tokens through a three-stage ring of 16-byte
//    cp.async.cg copies (two tiles in flight while one is computed), into
//    the XOR-swizzled bf16 tiles of attn_tile_tc.cuh; int8 / e4m3 rows
//    land as raw bytes and are widened exactly into the bf16 ring once a
//    tile has landed.  The block-table entries and scales of a tile are
//    read once, by one thread a key, while the tile three ahead of it is
//    computed, so no copy waits on a block-table read.  The row group's query
//    rows (padded to 16) are the M side of mma.sync m16n8k16; each of the
//    four warps takes 16 keys of a tile: S = Q K^T from ldmatrix
//    fragments, the online softmax on the accumulators, P (as two bf16
//    terms, hi + lo: one bf16 rounding of p is past the element limit
//    the kernels are held to) times V from ldmatrix.trans.  The warps'
//    states merge in shared memory in warp order.
//  * fp32 q or fp32 pools (paged_decode_fma): a warp handles 4 tokens
//    per step, each lane issuing one vector load per K and V row before
//    any arithmetic; scores reduce across the warp with shuffles.
#include <type_traits>

#include "attn_tile_tc.cuh"

namespace repro {
namespace {

constexpr int kBlock = 128;   // four warps, both steps
constexpr int kMaxSplit = 8;  // splits of a (slot, kv head): one cluster

// The state of this block's split for its R query rows -- max m, sum l
// (in the units of kLog2: log2 or natural) and unnormalised acc[R][D], in
// shared memory -- merged with the other live splits of the cluster in
// split order: the cluster's blocks (rank = split) share the outputs.
// A slot with no live token has l == 0 and acc == 0: zeros, as the
// reference's flush writes.
template <typename QT, bool kLog2>
__device__ void merge_splits(float* st_m, float* st_l, float* st_acc, int R,
                             int D, QT* __restrict__ out_rows, int n_live) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int n_blocks = static_cast<int>(cl.num_blocks());
  cl.sync();   // every split's state is in its shared memory
  for (int idx = rank * kBlock + threadIdx.x; idx < R * D;
       idx += n_blocks * kBlock) {
    const int r = idx / D;
    // every live split's values first (all loads in flight at once),
    // then the sums in split order
    float m[kMaxSplit], l[kMaxSplit], a[kMaxSplit];
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) {
      const bool live = j < n_live;
      m[j] = live ? cl.map_shared_rank(st_m, j)[r] : kNegInf;
      l[j] = live ? cl.map_shared_rank(st_l, j)[r] : 0.f;
      a[j] = live ? cl.map_shared_rank(st_acc, j)[idx] : 0.f;
    }
    float M = kNegInf;
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) M = fmaxf(M, m[j]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) {
      if (j >= n_live) break;
      const float f = kLog2 ? exp2f(m[j] - M) : expf(m[j] - M);
      lsum = fmaf(l[j], f, lsum);
      acc = fmaf(a[j], f, acc);
    }
    out_rows[idx] = from_f32<QT>(acc / fmaxf(lsum, 1e-30f));
  }
  cl.sync();   // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// fp32 q or fp32 pools: the FMA step, row groups of 8 query heads

namespace fma_step {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;     // tokens per warp step
constexpr int kRows = 8;       // query heads of a row group, in registers

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kBlock)
paged_decode_fma(const QT* __restrict__ q, const KVT* __restrict__ kp,
                 const KVT* __restrict__ vp, const int* __restrict__ bt,
                 const int* __restrict__ lengths,
                 const float* __restrict__ k_scales,
                 const float* __restrict__ v_scales, QT* __restrict__ out,
                 int H, int KH, int RG, int page, int P, int tps,
                 float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;   // elements per lane
  __shared__ float sm_m[kWarps][kRows];
  __shared__ float sm_l[kWarps][kRows];
  __shared__ float sm_acc[kWarps][kRows][D];
  __shared__ float st_m[kRows], st_l[kRows], st_acc[kRows * D];

  const int s = blockIdx.x, kh = blockIdx.y / RG, rg = blockIdx.y % RG;
  const int split = blockIdx.z;
  const int G = H / KH, R = min(kRows, G - rg * kRows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = lane * EPL;
  const bool lane_live = d0 < D;
  const bool quantized = k_scales != nullptr;

  // a split past the slot's length has an empty range
  const int L = max(0, min(lengths[s], P * page));
  const int n_live = max(1, (L + tps - 1) / tps);
  const int t_begin = split * tps;
  const int t_end = min(t_begin + tps, L);
  const int h0 = kh * G + rg * kRows;

  float qr[kRows][EPL];
#pragma unroll
  for (int g = 0; g < kRows; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    if (g < R && lane_live) {
      const QT* qrow = q + ((size_t)s * H + h0 + g) * D + d0;
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = to_f32<QT>(qrow[e]);
    }
  }

  float m[kRows], l[kRows], acc[kRows][EPL];
#pragma unroll
  for (int g = 0; g < kRows; ++g) {
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
    for (int g = 0; g < kRows; ++g) {
      if (g >= R) continue;
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

  // merge the warps' states in warp order
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  if (lane_live) {
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      if (g >= R) continue;
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += kBlock) {
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
    st_acc[idx] = a;
    if (d == 0) {
      st_m[g] = M;
      st_l[g] = lsum;
    }
  }
  merge_splits<QT, false>(st_m, st_l, st_acc, R, D,
                         out + ((size_t)s * H + h0) * D, n_live);
}

template <typename QT, typename KVT, int D>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* lengths, const float* ks, const float* vs, void* out,
           int S, int H, int KH, int page, int P, int n_split, int tps,
           float scale, cudaStream_t stream) {
  const int RG = (H / KH + kRows - 1) / kRows;
  return static_cast<int>(launch_clusters(
      paged_decode_fma<QT, KVT, D>, dim3(S, KH * RG, n_split),
      dim3(1, 1, n_split), kBlock, 0, stream, static_cast<const QT*>(q),
      static_cast<const KVT*>(kp), static_cast<const KVT*>(vp), bt, lengths,
      ks, vs, static_cast<QT*>(out), H, KH, RG, page, P, tps, scale));
}

}  // namespace fma_step

// ---------------------------------------------------------------------------
// bf16 q over bf16 / int8 / fp8 pools: the tensor-core step, row groups of
// 16 query heads

namespace tc_step {

using namespace tc;

// The low byte of w as an int8 or e4m3 value, widened exactly
template <typename KVT>
__device__ __forceinline__ float byte_to_f32(uint32_t w) {
  if constexpr (std::is_same<KVT, int8_t>::value) {
    return static_cast<float>(static_cast<int8_t>(w & 0xffu));
  } else {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(w & 0xffu);
    return static_cast<float>(v);
  }
}
constexpr int kRows = 16;      // query heads of a row group: mma's M side
constexpr int kStages = 3;     // K/V ring stages

template <typename KVT, int D>
__global__ void __launch_bounds__(kBlock)
paged_decode_tc(const bf16* __restrict__ q, const KVT* __restrict__ kp,
                const KVT* __restrict__ vp, const int* __restrict__ bt,
                const int* __restrict__ lengths,
                const float* __restrict__ k_scales,
                const float* __restrict__ v_scales, bf16* __restrict__ out,
                int H, int KH, int RG, int page, int P, int tps,
                float scale_log2) {
  constexpr bool kQuant = sizeof(KVT) == 1;     // int8 / e4m3 pools
  constexpr int C = D / 8;                      // 16-byte chunks, bf16 row
  constexpr int CR = D / 16;                    // 16-byte chunks, raw row
  constexpr int kTile = kBK * D;                // elements of a K or V tile
  // [3 stages][kBK][D] bf16 K, then V, Q [16][D] bf16, the pages of two
  // tiles [2][kBK]; for quantized pools the raw ring [3 stages][K, V][kBK]
  // [D] bytes and the column scales [3 stages][K, V][kBK].  After the key
  // loop the ring holds the warps' states for the merge.
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + kStages * kTile;
  bf16* Qs = Vs + kStages * kTile;
  int* pg_s = reinterpret_cast<int*>(Qs + kRows * D);
  unsigned char* raw = reinterpret_cast<unsigned char*>(pg_s + 2 * kBK);
  float* cols = reinterpret_cast<float*>(raw + 2 * kStages * kTile);

  const int s = blockIdx.x, kh = blockIdx.y / RG, rg = blockIdx.y % RG;
  const int split = blockIdx.z;
  const int G = H / KH, R = min(kRows, G - rg * kRows);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // a split past the slot's length has no tile
  const int L = max(0, min(lengths[s], P * page));
  const int n_live = max(1, (L + tps - 1) / tps);
  const int t_begin = split * tps;
  const int t_end = min(t_begin + tps, L);
  const int n_tiles = max(0, t_end - t_begin + kBK - 1) / kBK;
  const int h0 = kh * G + rg * kRows;
  const int* bt_row = bt + (size_t)s * P;

  // key ``tid`` of tile n: its page and scales (read by threads < kBK;
  // bounded by the split's range, not the length, so that the reads do
  // not wait for it: every block-table entry names a page)
  struct Key { int pg; float ks, vs; };
  const int t_stop = min(t_begin + tps, P * page);
  auto fetch = [&](int n) {
    Key k{0, 0.f, 0.f};
    const int kj = t_begin + n * kBK + tid;
    if (tid < kBK && kj < t_stop) {
      k.pg = __ldg(bt_row + kj / page);
      if (kQuant) {
        k.ks = scale_log2 * __ldg(k_scales + (size_t)k.pg * KH + kh);
        k.vs = __ldg(v_scales + (size_t)k.pg * KH + kh);
      }
    }
    return k;
  };
  auto publish_pages = [&](int n, const Key& k) {
    if (tid < kBK) pg_s[(n & 1) * kBK + tid] = k.pg;
  };
  auto publish_scales = [&](int n, const Key& k) {
    if (kQuant && tid < kBK) {
      cols[((n % kStages) * 2) * kBK + tid] = k.ks;
      cols[((n % kStages) * 2 + 1) * kBK + tid] = k.vs;
    }
  };
  // starts the copies of tile n into stage n % 3 (pages from pg_s); rows
  // at or past t_end are zero-filled and never read
  auto copy_tile = [&](int n) {
    const int stage = n % kStages;
    const int k0 = t_begin + n * kBK;
    const int* pgs = pg_s + (n & 1) * kBK;
    constexpr int CC = kQuant ? CR : C;
    constexpr int EPC = 16 / sizeof(KVT);            // elements a chunk
    unsigned char* rk = raw + stage * 2 * kTile;
    for (int i = tid; i < kBK * CC; i += kBlock) {
      const int j = i / CC, c = i % CC, kj = k0 + j;
      const bool ok = kj < t_end;
      const size_t off =
          (((size_t)pgs[j] * page + (ok ? kj % page : 0)) * KH + kh) * D +
          c * EPC;
      if constexpr (kQuant) {
        cp_async16(rk + j * D + c * 16, kp + off, ok);
        cp_async16(rk + kTile + j * D + c * 16, vp + off, ok);
      } else {
        cp_async16(Ks + stage * kTile + swz<D>(j, c), kp + off, ok);
        cp_async16(Vs + stage * kTile + swz<D>(j, c), vp + off, ok);
      }
    }
  };
  // raw int8 / e4m3 rows of stage -> the bf16 ring (exact)
  auto widen = [&](int stage) {
    const unsigned char* rk = raw + stage * 2 * kTile;
    for (int i = tid; i < 2 * kBK * CR; i += kBlock) {
      const int which = i / (kBK * CR), j = (i / CR) % kBK, c = i % CR;
      const uint4 v16 =
          *reinterpret_cast<const uint4*>(rk + which * kTile + j * D + c * 16);
      const uint32_t word[4] = {v16.x, v16.y, v16.z, v16.w};
      uint32_t w[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        w[t] = as_u32(__floats2bfloat162_rn(
            byte_to_f32<KVT>(word[t / 2] >> (16 * (t % 2))),
            byte_to_f32<KVT>(word[t / 2] >> (16 * (t % 2) + 8))));
      bf16* dst = (which ? Vs : Ks) + stage * kTile;
      *reinterpret_cast<uint4*>(dst + swz<D>(j, 2 * c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(dst + swz<D>(j, 2 * c + 1)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  };

  // Q's rows (rows past R repeat row R - 1's address and land as zeros),
  // then tiles 0 and 1 in flight before the loop
  for (int i = tid; i < kRows * C; i += kBlock) {
    const int r = i / C, c = i % C;
    cp_async16(Qs + swz<D>(r, c),
               q + ((size_t)s * H + h0 + min(r, R - 1)) * D + c * 8, r < R);
  }
  {
    const Key k0 = fetch(0), k1 = fetch(1);
    publish_pages(0, k0);
    publish_pages(1, k1);
    publish_scales(0, k0);
    publish_scales(1, k1);
  }
  __syncthreads();
  if (n_tiles > 0) copy_tile(0);
  cp_async_commit();                              // Q and tile 0
  if (n_tiles > 1) copy_tile(1);
  cp_async_commit();
  Key next = fetch(2);
  __syncthreads();   // tile 0's pages are read: the loop's first publish
                     // takes their slot

  State<D> st;
  st.init();
  for (int n = 0; n < n_tiles; ++n) {
    const int stage = n % kStages;
    cp_async_wait<1>();
    // pages of tile n + 2 to the slot tile n's copies no longer read
    publish_pages(n + 2, next);
    // tile n has landed for every thread, every warp is done with tile
    // n - 1, whose stage tile n + 2 takes, and its pages are visible
    __syncthreads();
    publish_scales(n + 2, next);
    if (n + 2 < n_tiles) copy_tile(n + 2);
    cp_async_commit();
    next = fetch(n + 3);
    if (kQuant) {
      widen(stage);
      __syncthreads();
    }
    if (n == 0) st.load_q(Qs, 0, lane);

    const bf16* kt = Ks + stage * kTile;
    const bf16* vt = Vs + stage * kTile;
    const float* kc = cols + (stage * 2) * kBK;
    const float* vc = kc + kBK;
    const int k0 = t_begin + n * kBK;
    const bool masked = k0 + kBK > t_end;
    // this warp's 16 keys: S = Q K^T as two 8-key accumulator tiles
    float sc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[h][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, kt + swz<D>(warp * 16 + (lane & 7) + ((lane >> 4) << 3),
                             2 * kk + ((lane >> 3) & 1)));
      mma16816(sc[0], st.q[kk], b[0], b[1]);
      mma16816(sc[1], st.q[kk], b[2], b[3]);
    }
    const int c0 = warp * 16 + 2 * (lane & 3);
    float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + h * 8 + (e & 1);
        float x = sc[h][e] * (kQuant ? kc[c] : scale_log2);
        // a masked score is -inf, whose exp2 is exactly 0
        if (masked && k0 + c >= t_end)
          x = __int_as_float(static_cast<int>(0xff800000u));
        sc[h][e] = x;
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
    for (int nt = 0; nt < State<D>::NT; ++nt) {
      st.o[nt][0] *= corr[0];
      st.o[nt][1] *= corr[0];
      st.o[nt][2] *= corr[1];
      st.o[nt][3] *= corr[1];
    }
    // P's A fragment: a0 / a1 from key tile 0 (rows g / g + 8), a2 / a3
    // from key tile 1; v's scale folded into p's column
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + h * 8;
      const float v0 = kQuant ? vc[c] : 1.f, v1 = kQuant ? vc[c + 1] : 1.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(sc[h][2 * i] - st.m[i]);
        const float p1 = exp2f(sc[h][2 * i + 1] - st.m[i]);
        st.l[i] += p0 + p1;
        split_bf16(p0 * v0, p1 * v1, ph[2 * h + i], pl[2 * h + i]);
      }
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, vt + swz<D>(warp * 16 + (lane & 7) +
                                   (((lane >> 3) & 1) << 3),
                               2 * dp + (lane >> 4)));
      mma16816(st.o[2 * dp], ph, b[0], b[1]);
      mma16816(st.o[2 * dp], pl, b[0], b[1]);
      mma16816(st.o[2 * dp + 1], ph, b[2], b[3]);
      mma16816(st.o[2 * dp + 1], pl, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' states -> shared memory (over the ring), merged in warp
  // order into this split's state for R rows
  float* wm = reinterpret_cast<float*>(smem_tc);     // [4][16]
  float* wl = wm + 4 * kRows;                        // [4][16]
  float* wo = wl + 4 * kRows;                        // [4][16][D]
  float* bm = wo + 4 * kRows * D;                    // [16]
  float* bl = bm + kRows;                            // [16]
  float* bacc = bl + kRows;                          // [16][D]
  const int g = lane >> 2, cq = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = st.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if ((lane & 3) == 0) {
      wm[warp * kRows + g + 8 * i] = st.m[i];
      wl[warp * kRows + g + 8 * i] = l;
    }
  }
#pragma unroll
  for (int nt = 0; nt < State<D>::NT; ++nt) {
    float* o0 = wo + (warp * kRows + g) * D + nt * 8 + cq;
    o0[0] = st.o[nt][0];
    o0[1] = st.o[nt][1];
    o0[8 * D] = st.o[nt][2];
    o0[8 * D + 1] = st.o[nt][3];
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += kBlock) {
    const int r = idx / D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, wm[w * kRows + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = exp2f(wm[w * kRows + r] - M);
      lsum = fmaf(wl[w * kRows + r], f, lsum);
      a = fmaf(wo[(w * kRows) * D + idx], f, a);
    }
    bacc[idx] = a;
    if (idx % D == 0) {
      bm[r] = M;
      bl[r] = lsum;
    }
  }
  merge_splits<bf16, true>(bm, bl, bacc, R, D,
                           out + ((size_t)s * H + h0) * D, n_live);
}

template <typename KVT, int D>
int launch_tc(const void* q, const void* kp, const void* vp, const int* bt,
              const int* lengths, const float* ks, const float* vs,
              void* out, int S, int H, int KH, int page, int P, int n_split,
              int tps, float scale, cudaStream_t stream) {
  constexpr size_t kTile = (size_t)kBK * D;
  // bf16 K/V ring, Q and the pages (100 KB at D 128); quantized pools add
  // the raw ring and the column scales (150 KB)
  const size_t smem = 2 * kStages * kTile * 2 + kRows * D * 2 + 2 * kBK * 4 +
                      (sizeof(KVT) == 1 ? 2 * kStages * kTile +
                                          2 * kStages * kBK * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_tc<KVT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int RG = (H / KH + kRows - 1) / kRows;
  return static_cast<int>(launch_clusters(
      paged_decode_tc<KVT, D>, dim3(S, KH * RG, n_split),
      dim3(1, 1, n_split), kBlock, smem, stream,
      static_cast<const bf16*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), bt, lengths, ks, vs,
      static_cast<bf16*>(out), H, KH, RG, page, P, tps, scale * kLog2e));
}

}  // namespace tc_step

using Launch = int (*)(const void*, const void*, const void*, const int*,
                       const int*, const float*, const float*, void*, int,
                       int, int, int, int, int, int, float, cudaStream_t);

template <typename QT, typename KVT>
Launch pick_fma(int D) {
  switch (D) {
    case 16: return fma_step::launch<QT, KVT, 16>;
    case 64: return fma_step::launch<QT, KVT, 64>;
    case 128: return fma_step::launch<QT, KVT, 128>;
    default: return nullptr;
  }
}

template <typename QT>
Launch pick_fma_kv(int kv_dtype, int D) {
  switch (kv_dtype) {
    case kF32: return pick_fma<QT, float>(D);
    case kBF16: return pick_fma<QT, __nv_bfloat16>(D);
    case kI8: return pick_fma<QT, int8_t>(D);
    case kFP8: return pick_fma<QT, __nv_fp8_e4m3>(D);
    default: return nullptr;
  }
}

template <typename KVT>
Launch pick_tc(int D) {
  switch (D) {
    case 16: return tc_step::launch_tc<KVT, 16>;
    case 64: return tc_step::launch_tc<KVT, 64>;
    case 128: return tc_step::launch_tc<KVT, 128>;
    default: return nullptr;
  }
}

}  // namespace
}  // namespace repro

extern "C" {

// Which step a launch of these dtypes takes: 1 for the tensor-core step
// (bf16 q over bf16 / int8 / fp8 pools; row groups of 16 query heads), 0
// for the FMA step (row groups of 8).  paged_attention_decode dispatches
// on it; the Python wrapper sizes the scratch and counts the tensor-core
// launches with it.
int paged_attention_tc_step(int q_dtype, int kv_dtype) {
  using namespace repro;
  return q_dtype == kBF16 &&
         (kv_dtype == kBF16 || kv_dtype == kI8 || kv_dtype == kFP8);
}

// One launch on ``stream``: the slots' token horizons cut into
// ``n_split`` (at most 8) ranges of ``tokens_per_split`` (a multiple of
// 64).  Returns 0, a CUDA error code from the launch, or -1 for a shape
// or dtype this kernel does not take (the Python wrapper checks those
// first).
int paged_attention_decode(const void* q, const void* k_pages,
                           const void* v_pages, const int* block_table,
                           const int* lengths, const float* k_scales,
                           const float* v_scales, void* out, int S, int H,
                           int KH, int D, int page, int P, int n_split,
                           int tokens_per_split, float scale, int q_dtype,
                           int kv_dtype, void* stream) {
  using namespace repro;
  if (S <= 0 || KH <= 0 || H % KH != 0 || n_split <= 0 || n_split > 8 ||
      page <= 0 || tokens_per_split <= 0 || tokens_per_split % tc::kBK != 0)
    return -1;
  Launch fn = nullptr;
  if (paged_attention_tc_step(q_dtype, kv_dtype)) {
    if (kv_dtype == kBF16) fn = pick_tc<__nv_bfloat16>(D);
    else if (kv_dtype == kI8) fn = pick_tc<int8_t>(D);
    else fn = pick_tc<__nv_fp8_e4m3>(D);
  } else if (q_dtype == kF32) {
    fn = pick_fma_kv<float>(kv_dtype, D);
  } else if (q_dtype == kBF16) {
    fn = pick_fma_kv<__nv_bfloat16>(kv_dtype, D);
  }
  if (fn == nullptr) return -1;
  const int rc = fn(q, k_pages, v_pages, block_table, lengths, k_scales,
                    v_scales, out, S, H, KH, page, P, n_split,
                    tokens_per_split, scale,
                    static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

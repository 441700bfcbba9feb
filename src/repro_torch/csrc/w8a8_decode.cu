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
// bytes over 3.35 TB/s (4.2 us at K 1,536, N 8,960).  One launch per
// linear (the decode step is host-bound: a second launch for the row
// scales would cost more host time than the whole kernel takes on the
// device).
//
// The tensor-core step (w8a8_decode_tc; N % 16 == 0, K % 32 == 0, K <=
// 16,384, x / wq / out 16-byte aligned: every qwen2-1.5b linear, bf16 or
// fp32 x, since the kernel quantizes x itself).  What the first design
// (kept below as the ragged step) lost: every block computed the row
// scales of all M rows from the whole rows before it asked for a weight
// byte, then quantized its k-range with scalar loads, and streamed the
// weight one 32-bit load a lane a k-row into __dp4a, with little in
// flight; its split-K partial sums went through device memory, finished
// by an atomic counter.  This step:
//  * Products on mma.sync.aligned.m16n8k32 s8 x s8 -> s32, with the roles
//    swapped: y^T = w^T x^T.  16 weight columns are the A (M) side, the
//    block's 8 rows of x the B (N) side, whose int8 rows are k-contiguous,
//    exactly B's layout.  A block owns 128 columns and a k-range; each of
//    its 4 warps takes one 32-deep k-step of a 64-row stage and one half
//    (64 columns) of the block's columns.  The weight is N-major, so a
//    lane reads 8 bytes (8 columns) of each of its 8 k-rows and turns four
//    k-rows of four columns into k-packed words with byte permutes
//    (transpose_quads): no transposed weight copy.  Column 8g + 2j of the
//    lane's half is row g of fragment j, column 8g + 2j + 1 its row g + 8,
//    a fixed permutation undone where the sums are stored.  int32 sums
//    are exact in any order, so none of this changes a bit.
//  * The weight streams through a ring of 16-byte cp.async.cg copies in
//    dynamic shared memory, 64 k-rows (8 KB) a stage, chunks XOR-swizzled
//    by row so that a half-warp's 8-byte loads hit every bank once.  A
//    k-range of at most 3 stages (every qwen2 decode shape but the 8,960-
//    deep one) has all of them in flight in a 4-slot ring, a longer one
//    keeps 7 in flight in an 8-slot ring.  The wrapper plans about four
//    blocks an SM.
//  * The weight bytes are in flight while the block works out the row
//    scales.  Its slice of x (8 rows of its k-range: 3 KB at the qwen2
//    decode shapes) goes out as the first group of 16-byte cp.async
//    copies and the first weight stages right behind it, so x lands
//    first: loads of x issued after the ring would wait behind the ~100
//    KB of weights that an SM's blocks have asked for.
//  * Row scales shared across the cluster, so that no block reads whole
//    rows.  The k-ranges of a (row block, column tile), at most 8, form
//    one thread block cluster.  Each block copies only its own k-range of
//    its 8 rows of x (a range is at most 2,048 deep, so the slice stays
//    on chip) and takes the partial |x| maximum over it, then stores it
//    into every range's shared memory (st.async through distributed
//    shared memory), where an mbarrier counts the bytes in.  A cluster
//    barrier between these remote stores and the blocks' reads would
//    wait, in its release, for the weight copies still in flight; the
//    mbarrier waits for the maxima alone.  A maximum is exact in any
//    order, so xs is bit for bit the whole row's.  Each thread then quantizes the
//    values it copied (IEEE division, round half to even) into the
//    quantized slice, where B fragments are one 32-bit load each.  With
//    one range the block reads the whole row, as before.
//  * Split-K summed on chip in a fixed order: each block adds its two
//    k-step warps' sums in its shared memory; after a cluster barrier
//    every block takes a share of the outputs, adds the ranges' sums in
//    range order through distributed shared memory and applies the
//    epilogue.  No partial sum goes through device memory: the step takes
//    no ``partial`` buffer and no counter.
//  * M above 8 takes more blocks (grid z), each over 8 rows of x.
//
// The ragged step (w8a8_decode_kernel: every other shape, unchanged from
// the first design):
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
#include "attn_tile_tc.cuh"
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

namespace tc_step {   // the tensor-core step

using tc::cp_async16;
using tc::mbar_arrive_tx;
using tc::mbar_init;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;                 // weight columns a block (2 halves)
constexpr int kMT = 8;                   // x rows a block (the mma N side)
constexpr int kKS = 64;                  // k-rows a stage: two 32-deep k-steps
constexpr int kWBytes = kKS * kBN;       // weight bytes of a stage
constexpr int kMaxK = 16384;             // the quantized x slice fits on chip
constexpr int kMaxSmem = 227 * 1024;

// One m16n8k32 int8 tensor-core product: d += a (16x32, row) x b (32x8,
// col), int32 sums.  Lane = 4g + t holds a = {A[g][4t..], A[g+8][4t..],
// A[g][16+4t..], A[g+8][16+4t..]}, b = {B[4t..][g], B[16+4t..][g]}, d =
// {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Waits for phase 0 of ``bar``, whose bytes come from other blocks of the
// cluster.  A wait that spins 2^24 times traps (a CUDA error at the next
// synchronisation) instead of hanging the card.
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tc::smem_u32(bar))
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) asm volatile("trap;\n");
  }
}

// The address of ``p`` (this block's shared memory) in block ``rank`` of
// the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(tc::smem_u32(p)), "r"(rank));
  return r;
}

// Stores ``v`` at ``addr`` in another block of the cluster, its 4 bytes
// counted on that block's mbarrier at ``bar``
__device__ __forceinline__ void st_async_f32(uint32_t addr, float v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// Byte offset of 16-byte chunk c of weight row r in a stage: the chunk
// index XORed with 2 * ((r / 4) % 4).  A half-warp's 8-byte loads read
// rows 4t + q (t < 4, one q) at chunks 4h + {0, 1}: eight different chunk
// positions, 128 bytes over the 32 banks.
__device__ __forceinline__ int wsw(int r, int c) {
  return r * kBN + ((c ^ (((r >> 2) & 3) << 1)) << 4);
}

// V elements of x (one 16-byte vector) quantized against scale s, packed
// as V int8 bytes (little-endian: the lower k the lower byte)
template <typename XT>
__device__ __forceinline__ void quantize_vec(const XT* p, float s,
                                             uint32_t (&q)[16 / sizeof(XT) / 4]) {
  constexpr int V = 16 / sizeof(XT);
  float v[V];
  load_f32<XT, V>(p, v);
#pragma unroll
  for (int w = 0; w < V / 4; ++w) {
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int qi = __float2int_rn(__fdiv_rn(v[4 * w + j], s));
      qi = max(-127, min(127, qi));
      packed |= static_cast<uint32_t>(qi & 0xff) << (8 * j);
    }
    q[w] = packed;
  }
}

template <typename XT, typename OT, int kStages>
__global__ void __launch_bounds__(kThreads)
w8a8_decode_tc(const XT* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ ws, const void* __restrict__ bias,
               int bias_bf16, OT* __restrict__ out, int M, int K, int N,
               int k_per_split) {
  constexpr int V = 16 / sizeof(XT);     // x elements a 16-byte vector
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __shared__ float pmax_s[8][kMT];       // [range][row] |x| maxima, pushed
                                         // here by every range
  __shared__ __align__(8) uint64_t xbar; // counts the pushed maxima' bytes
  __shared__ float xs_s[kMT];            // the rows' scales
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int split = blockIdx.y, n_split = static_cast<int>(cl.num_blocks());
  const int m0 = blockIdx.z * kMT, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_st = (k_end - k_begin + kKS - 1) / kKS;
  const int xpitch = k_per_split + 16;   // = 16 mod 64: B loads hit 32 banks
  int8_t* xq_s = reinterpret_cast<int8_t*>(smem_tc + kStages * kWBytes);
  // this range of the block's x rows, as read ([kMT][k_per_split])
  XT* xraw_s = reinterpret_cast<XT*>(smem_tc + kStages * kWBytes +
                                     kMT * xpitch);

  // copies of stage i (k-rows k_begin + 64 i ...) into ring slot i %
  // kStages; rows past k_end and columns past N land as zeros
  auto load = [&](int i) {
    unsigned char* st = smem_tc + (i % kStages) * kWBytes;
    const int kb = k_begin + i * kKS;
#pragma unroll
    for (int e = tid; e < kKS * (kBN / 16); e += kThreads) {
      const int r = e >> 3, c = e & 7, k = kb + r, n = n0 + c * 16;
      const bool ok = k < k_end && n < N;
      cp_async16(st + wsw(r, c),
                 ok ? wq + static_cast<size_t>(k) * N + n : wq, ok);
    }
  };

  // The ranges' partial maxima arrive by remote stores counted on xbar:
  // its phase completes once all n_split x 8 floats have landed.  Every
  // block arrives on the cluster barrier now, with nothing in flight, and
  // waits on it only before its first remote store: by then every
  // block's xbar is set up.
  if (tid == 0) {
    mbar_init(&xbar, 1);
    mbar_arrive_tx(&xbar, n_split * kMT * sizeof(float));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // x's slice goes out first, as the oldest group of copies: 16 threads a
  // row, each copying the 16-byte vectors it will quantize (3 KB a block
  // at the qwen2 decode shapes, against 24 KB of weights); rows past M
  // land as zeros.  Then the weight ring, whose bytes stay in flight
  // while the block works out the row scales.
  using XV = VecT<XT, V>;
  const int xr = tid >> 4, xj = tid & 15, xm = m0 + xr;
  const int klen = k_end - k_begin;
  XT* xraw = xraw_s + xr * k_per_split;
  {
    const XT* xrow = x + static_cast<size_t>(xm < M ? xm : 0) * K + k_begin;
    for (int kk = xj * V; kk < klen; kk += 16 * V)
      cp_async16(xraw + kk, xrow + kk, xm < M);
    tc::cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_st) load(i);
    tc::cp_async_commit();
  }

  // this range's |x| maximum of each of the block's rows, from the
  // thread's own copies, then a shuffle butterfly over the row's 16
  tc::cp_async_wait<kStages - 1>();
  {
    float amax = 0.f;
    for (int kk = xj * V; kk < klen; kk += 16 * V) {
      const XV v = *reinterpret_cast<const XV*>(xraw + kk);
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(to_f32<XT>(v.v[e])));
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    // pushed to every range of the cluster (this one included), through
    // distributed shared memory
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    if (xj == 0)
      for (int r = 0; r < n_split; ++r)
        st_async_f32(cluster_addr(&pmax_s[split][xr], r), amax,
                     cluster_addr(&xbar, r));
  }
  // the whole rows' maxima, from every range's (exact in any order); the
  // weight copies in flight are not waited for
  mbar_wait0(&xbar);
  if (tid < kMT) {
    float amax = 0.f;
    for (int r = 0; r < n_split; ++r) amax = fmaxf(amax, pmax_s[r][tid]);
    xs_s[tid] = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  }
  __syncthreads();
  // this range of the rows quantized into shared memory, each thread the
  // values it read above; k past k_end and rows past M as zeros
  {
    const float s = xs_s[xr];
    int8_t* dst = xq_s + xr * xpitch;
    for (int kk = xj * V; kk < n_st * kKS; kk += 16 * V) {
      uint32_t q[V / 4];
#pragma unroll
      for (int w = 0; w < V / 4; ++w) q[w] = 0;
      if (xm < M && kk < klen) quantize_vec<XT>(xraw + kk, s, q);
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>(dst + kk) = make_uint2(q[0], q[1]);
      else
        *reinterpret_cast<uint32_t*>(dst + kk) = q[0];
    }
  }

  // warp w: k-step w / 2 of each stage (32 k-rows), column half w % 2
  const int ks = warp >> 1, half = warp & 1;
  const int wc = half * 4 + (g >> 1), wb = (g & 1) * 8;
  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int i = 0; i < n_st; ++i) {
    tc::cp_async_wait<kStages - 2>();
    // stage i has landed for every thread (and, at i = 0, the quantized
    // x is in place), and every warp is done with stage i - 1, whose slot
    // the next copies overwrite
    __syncthreads();
    if (i + kStages - 1 < n_st) load(i + kStages - 1);
    tc::cp_async_commit();

    const unsigned char* st = smem_tc + (i % kStages) * kWBytes;
    // k-packed words of the lane's 8 columns over k-rows k0 .. k0 + 3 of
    // the stage: c0 columns 0-3, c1 columns 4-7
    auto kpack = [&](int k0, int (&c0)[4], int (&c1)[4]) {
      int r0[4], r1[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint2 v =
            *reinterpret_cast<const uint2*>(st + wsw(k0 + q, wc) + wb);
        r0[q] = static_cast<int>(v.x);
        r1[q] = static_cast<int>(v.y);
      }
      transpose_quads(r0, c0);
      transpose_quads(r1, c1);
    };
    // lo: k-rows 4t .. 4t + 3 of the k-step, hi: 16 + 4t ..
    int lo[2][4], hi[2][4];
    kpack(ks * 32 + 4 * t, lo[0], lo[1]);
    kpack(ks * 32 + 16 + 4 * t, hi[0], hi[1]);
    // B fragment: x rows g, k-rows 4t.. and 16 + 4t.. of the k-step
    const int8_t* xb = xq_s + g * xpitch + i * kKS + ks * 32 + 4 * t;
    const int b[2] = {*reinterpret_cast<const int*>(xb),
                      *reinterpret_cast<const int*>(xb + 16)};
    // A fragment j: column 8g + 2j of the half is its row g, 8g + 2j + 1
    // its row g + 8
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a[4] = {lo[j >> 1][2 * (j & 1)], lo[j >> 1][2 * (j & 1) + 1],
                        hi[j >> 1][2 * (j & 1)], hi[j >> 1][2 * (j & 1) + 1]};
      mma_s8(acc[j], a, b);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();   // the ring is free: the warps' sums go there

  // red[k-step][x row][column]; fragment j's d0..d3 = (column 8g + 2j,
  // x rows 2t, 2t + 1), (column 8g + 2j + 1, x rows 2t, 2t + 1)
  int* red = reinterpret_cast<int*>(smem_tc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int* rw = red + (ks * kMT + 2 * t) * kBN + half * 64 + 8 * g + 2 * j;
    rw[0] = acc[j][0];
    rw[kBN] = acc[j][1];
    rw[1] = acc[j][2];
    rw[kBN + 1] = acc[j][3];
  }
  __syncthreads();
  int* bsum = red + 2 * kMT * kBN;       // this k-range's sums
  for (int e = tid; e < kMT * kBN; e += kThreads)
    bsum[e] = red[e] + red[kMT * kBN + e];
  // the cluster's k-ranges added in range order: each block takes every
  // n-th group of 128 outputs
  cl.sync();
  for (int e = split * kThreads + tid; e < kMT * kBN;
       e += n_split * kThreads) {
    const int r = e / kBN, m = m0 + r, n = n0 + e % kBN;
    if (m >= M || n >= N) continue;
    int part[8];   // every range's sum in flight at once, then added
#pragma unroll
    for (int p = 0; p < 8; ++p)
      part[p] = p < n_split ? cl.map_shared_rank(bsum, p)[e] : 0;
    int sum = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) sum += part[p];
    out[static_cast<size_t>(m) * N + n] =
        epilogue<OT>(sum, xs_s[r], ws[n], bias, bias_bf16, n);
  }
  cl.sync();   // no block leaves while another reads its shared memory
}

// The ring, the quantized x slice and the raw one
inline size_t smem_bytes(int stages, int k_per_split, int x_bytes) {
  return static_cast<size_t>(stages) * kWBytes +
         static_cast<size_t>(kMT) * (k_per_split + 16) +
         static_cast<size_t>(kMT) * k_per_split * x_bytes;
}

template <typename XT, typename OT, int kStages>
int launch_stages(const void* x, const int8_t* wq, const float* ws,
                  const void* bias, int bias_bf16, void* out, int M, int K,
                  int N, int n_split, int k_per_split, cudaStream_t st) {
  const size_t smem = smem_bytes(kStages, k_per_split, sizeof(XT));
  if (smem > static_cast<size_t>(kMaxSmem)) return -1;
  auto kernel = w8a8_decode_tc<XT, OT, kStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, n_split, (M + kMT - 1) / kMT);
  err = launch_clusters(kernel, grid, dim3(1, n_split, 1), kThreads, smem,
                        st, static_cast<const XT*>(x), wq, ws, bias,
                        bias_bf16, static_cast<OT*>(out), M, K, N,
                        k_per_split);
  return static_cast<int>(err);
}

// A k-range of at most 3 stages takes a 4-slot ring (all its stages in
// flight at once), a longer one the 8-slot ring (7 in flight)
template <typename XT, typename OT>
int launch_tc(const void* x, const int8_t* wq, const float* ws,
              const void* bias, int bias_bf16, void* out, int M, int K,
              int N, int n_split, int k_per_split, cudaStream_t st) {
  if (n_split > 8 || k_per_split % kKS != 0) return -1;
  if (k_per_split <= 3 * kKS)
    return launch_stages<XT, OT, 4>(x, wq, ws, bias, bias_bf16, out, M, K,
                                    N, n_split, k_per_split, st);
  return launch_stages<XT, OT, 8>(x, wq, ws, bias, bias_bf16, out, M, K, N,
                                  n_split, k_per_split, st);
}

}  // namespace tc_step

}  // namespace
}  // namespace repro

extern "C" {

// Which step a launch takes: 1 for the tensor-core step (x fp32 or bf16,
// N a multiple of 16, K of 32 and at most 16,384, x, wq and out 16-byte
// aligned: ``aligned16``), 0 for the ragged step.  w8a8_decode_matmul
// dispatches on it; the Python wrapper plans the split with it and counts
// the tensor-core launches.
int w8a8_decode_tc_step(int x_dtype, int K, int N, int aligned16) {
  using namespace repro;
  return (x_dtype == kBF16 || x_dtype == kF32) && K > 0 && K % 32 == 0 &&
         K <= tc_step::kMaxK && N % 16 == 0 && aligned16 != 0;
}

// One launch of the W8A8 decode matmul on ``stream``.  ``bias`` may be
// null.  The tensor-core step takes k-ranges in whole 64-row stages, at
// most 8 of them, and no ``partial`` or ``counters``.  The ragged step
// uses ``partial`` (n_split x M x N int32) and ``counters`` (one int32
// per 128-column tile, zero on entry and left zero) when n_split > 1;
// ``vec``: N % 4 == 0 and wq 4-byte aligned; ``x_vec``: K a multiple of
// 16 bytes of x and x 16-byte aligned.  Returns 0, a CUDA error code from
// the launch, or -1 for a shape or dtype it does not take.
int w8a8_decode_matmul(const void* x, const int8_t* wq, const float* ws,
                       const void* bias, void* out, int* partial,
                       int* counters, int M, int K, int N, int n_split,
                       int k_per_split, int x_dtype, int out_dtype,
                       int bias_dtype, int vec, int x_vec, int aligned16,
                       void* stream) {
  using namespace repro;
  if (M <= 0 || M > kMaxM || K <= 0 || N <= 0 || n_split <= 0 ||
      k_per_split <= 0 || k_per_split % 4 != 0 ||
      static_cast<long long>(n_split) * k_per_split < K)
    return -1;
  if (bias != nullptr && bias_dtype != kF32 && bias_dtype != kBF16) return -1;
  const int bias_bf16 = bias_dtype == kBF16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (w8a8_decode_tc_step(x_dtype, K, N, aligned16)) {
    if (x_dtype == kBF16 && out_dtype == kBF16)
      rc = tc_step::launch_tc<__nv_bfloat16, __nv_bfloat16>(x, wq, ws, bias, bias_bf16, out, M, K, N, n_split, k_per_split, st);
    else if (x_dtype == kF32 && out_dtype == kF32)
      rc = tc_step::launch_tc<float, float>(x, wq, ws, bias, bias_bf16, out, M, K, N, n_split, k_per_split, st);
    else if (x_dtype == kBF16 && out_dtype == kF32)
      rc = tc_step::launch_tc<__nv_bfloat16, float>(x, wq, ws, bias, bias_bf16, out, M, K, N, n_split, k_per_split, st);
    else if (x_dtype == kF32 && out_dtype == kBF16)
      rc = tc_step::launch_tc<float, __nv_bfloat16>(x, wq, ws, bias, bias_bf16, out, M, K, N, n_split, k_per_split, st);
    else
      rc = -1;
  } else if (n_split > 1 && (partial == nullptr || counters == nullptr))
    rc = -1;
  else if (x_dtype == kBF16 && out_dtype == kBF16)
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

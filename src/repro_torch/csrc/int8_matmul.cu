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
// Two steps, chosen by shape and alignment alone (int8_matmul_tc_step):
//
// The tensor-core step (namespace tc_step; K % 16 == 0, N % 16 == 0,
// xq / wq / out 16-byte aligned: every linear of the port's configs)
// runs wgmma, Hopper's warpgroup product, s8 x s8 -> s32.  For 8-bit
// types wgmma takes K-major operands only, and wq is (K, N) row major:
// N-major.  So the roles are swapped, y^T = wq^T xq^T: the weight is the
// product's A side (64 rows a wgmma = weight columns), fed from
// registers, and x its B side (x rows = the wgmma's N), read from shared
// memory through a matrix descriptor, since x rows are K-major as they
// are.  A block is two consumer warpgroups and a producer warp, over
// output tiles of 128 columns x 2 BX rows (BX 128, or 64 where
// 256-row tiles would leave SMs idle); the grid is one block an SM and
// each block walks tiles blockIdx.x, + gridDim.x, ..., so the next
// tile's stages land while the consumers store the last one.
//  * The producer is one thread.  For each 128-deep stage it issues two
//    TMA copies (cp.async.bulk.tensor) into a 4-stage ring: the weight's
//    128 k-rows x 128 columns and x's 2 BX rows x 128 k, both in TMA's
//    128-byte swizzle (row r's 16-byte chunk c at c ^ (r % 8)), which is
//    also the layout x's descriptor names.  The "full" mbarrier of the
//    slot expects the stage's bytes; rows and columns past the matrix
//    land as zeros.  The tensor maps are encoded per launch by
//    cuTensorMapEncodeTiled (libcuda, reached with
//    cudaGetDriverEntryPoint) and passed as __grid_constant__ parameters.
//  * Each consumer warpgroup owns BX x rows and all 128 columns: two
//    m64nBXk32 wgmmas a 32-deep k-step.  Its threads build the weight's A
//    fragments from the raw stage: four 32-bit shared loads of four
//    k-rows, one 4 x 4 byte transpose (transpose_quads, prmt) and the
//    four columns are the fragment rows of both wgmmas.  This is the
//    transposing pass, straight into registers: the transposed tile never
//    goes back through shared memory, so a stage costs 112 KB of shared
//    traffic (copies in, fragment loads, wgmma's reads of x) against
//    192 KB had the transpose been written back for a second descriptor.
//  * Waits, in order: the full mbarrier (the stage landed: TMA writes
//    through the async proxy, which wgmma reads, and the wait orders the
//    fragment loads after the writes).  A consumer builds a batch's A
//    fragments first (one k-step at BX 128, four at BX 64: what the
//    registers hold), then wgmma.fence (the A registers were just
//    written), the batch's wgmmas, commit_group and wait_group 0 before
//    the next batch's fragments overwrite those registers (ptxas
//    serialises every wgmma of a kernel that redefines a wgmma's input
//    registers while one is in flight); the other consumer warpgroup
//    keeps the tensor cores busy meanwhile.  After the stage's last
//    batch the slot goes back to the producer (its "empty" mbarrier, one
//    arrival a consumer warp).  An mbarrier wait that spins too long
//    traps instead of hanging the card.  At BX 128 a batch is one k-step:
//    with 128 int32 sums a thread, ptxas has registers for one k-step's
//    fragments only (more spill and serialise, and so do setmaxnreg and
//    224-register blocks), so each k-step costs a wgmma.fence, a commit
//    and a wait of the warpgroup.
//  * Epilogue: each thread holds four consecutive columns of 2 x BX / 8
//    rows, scaled as the reference rounds (fp32, x scale first) and
//    stored 8 or 16 bytes at a time.
//
// The ragged step (every other shape, unchanged) is the first version:
// 128 x 128 output tiles of one block, K walked in steps of 64, the next
// tile's plain 32-bit global loads held in registers while the current
// one is multiplied on mma.sync m16n8k32 (s8 x s8 -> s32), the B tile
// byte-transposed on its way into shared memory; ragged M, N and K
// masked in the loads and stores.
#include <cuda.h>

#include "attn_tile_tc.cuh"
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


namespace tc_step {   // the tensor-core step

using tc::mbar_arrive_tx;
using tc::mbar_init;
using tc::smem_u32;

constexpr int kThreads = 288;           // two consumer warpgroups, a producer
                                        // warp: 224 registers a thread
constexpr int kBN = 128;                // weight columns a block (2 x m64)
constexpr int kBK = 128;                // k a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kWBytes = kBK * kBN;      // weight stage

template <int BX>
struct Ring {
  static constexpr int kStageBytes = kWBytes + 2 * BX * kBK;
  static constexpr size_t kSmem = kStages * kStageBytes + 1024;  // + align
};

// Byte offset of column byte ``col`` of k-row ``kr`` in a weight stage as
// TMA's 128-byte swizzle lays it out: chunk c of row kr at c ^ (kr % 8).
__device__ __forceinline__ int wsw(int kr, int col) {
  return kr * kBN + (((col >> 4) ^ (kr & 7)) << 4) + (col & 15);
}

// Descriptor of a K-major operand tile in the 128-byte swizzle: 8-row
// groups 1,024 bytes apart (SBO), rows of 128 bytes, chunk c of row r at
// c ^ (r % 8); the tile starts 1,024-byte aligned.  Adding 2 steps the
// start 32 bytes (one k32 slice) along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Waits for the phase of ``bar`` with this parity to complete.  A wait
// that spins 2^24 times traps (a CUDA error at the next synchronisation)
// instead of hanging the card: a ring that never fills is a fault.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) asm volatile("trap;\n");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One TMA copy of the box at (c0 inner, c1 outer) of ``map`` into shared
// memory at ``dst``, its bytes counted on ``bar``; the box's part outside
// the matrix lands as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses to ``r`` across a wgmma wait
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d += a (64 x 32 from registers) x b (32 x 128 from shared memory,
// through its descriptor), s8 x s8 -> s32: one warpgroup's m64n128k32
__device__ __forceinline__ void wgmma_n128(int (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += a (64 x 32 from registers) x b (32 x 64 from shared memory,
// through its descriptor), s8 x s8 -> s32: one warpgroup's m64n64k32
__device__ __forceinline__ void wgmma_n64(int (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int BX>
__device__ __forceinline__ void wgmma_x(int (&d)[BX / 2],
                                        const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (BX == 128)
    wgmma_n128(d, a, desc);
  else
    wgmma_n64(d, a, desc);
}

template <typename OT>
__device__ __forceinline__ void store4(OT* p, const float (&y)[4]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&y)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&y)[4]) {
  uint2 w;
  w.x = tc::as_u32(__floats2bfloat162_rn(y[0], y[1]));
  w.y = tc::as_u32(__floats2bfloat162_rn(y[2], y[3]));
  *reinterpret_cast<uint2*>(p) = w;
}

// BX x rows a consumer
template <typename OT, int BX>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_tc(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ xs, const float* __restrict__ ws,
               OT* __restrict__ out, int M, int K, int N) {
  using R = Ring<BX>;
  // k32-steps a batch of wgmmas: as many A fragments as the registers
  // hold beside the sums (one k-step at BX 128, a whole stage at 64)
  constexpr int KB = BX == 128 ? 1 : kBK / 32;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;     // the ring, 1 KB aligned
  unsigned char* ring = smem_raw + (base - raw);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n_k = (K + kBK - 1) / kBK;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int n_tiles = tiles_n * ((M + 2 * BX - 1) / (2 * BX));
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                // the producer's arrival + bytes
      mbar_init(&empty[s], 8);               // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer, one thread: the block's it-th stage (over all its tiles)
    // into slot it % kStages by two TMA copies, once the consumers have
    // released the slot's previous stage
    if (tid == 2 * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * kBN, m0 = (tile / tiles_n) * 2 * BX;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int slot = it % kStages;
          if (it >= kStages)
            mbar_wait(&empty[slot], ((it / kStages) & 1) ^ 1);
          unsigned char* st = ring + slot * R::kStageBytes;
          mbar_arrive_tx(&full[slot], R::kStageBytes);
          tma_load(st, &tm_w, n0, kt * kBK, &full[slot]);
          tma_load(st + kWBytes, &tm_x, kt * kBK, m0, &full[slot]);
        }
      }
    }
  } else {
    const int cw = wg;                         // x rows m0 + BX cw ..
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int cc = 8 * warp + g;               // columns n0 + 4 cc .. + 3
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int n0 = (tile % tiles_n) * kBN, m0 = (tile / tiles_n) * 2 * BX;
      int acc0[BX / 2], acc1[BX / 2];            // wgmma rows 2 x (16 warp + g)
#pragma unroll
      for (int i = 0; i < BX / 2; ++i) {
        acc0[i] = 0;
        acc1[i] = 0;
        fence_operand(acc0[i]);
        fence_operand(acc1[i]);
      }
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int slot = it % kStages;
        // the stage landed (TMA writes through the async proxy, as wgmma
        // reads; the wait also orders the fragment loads after them)
        mbar_wait(&full[slot], (it / kStages) & 1);
        const unsigned char* st = ring + slot * R::kStageBytes;
        const uint64_t desc = sw128_desc(base + slot * R::kStageBytes +
                                         kWBytes + cw * BX * kBK);
#pragma unroll
        for (int k0 = 0; k0 < kBK / 32; k0 += KB) {
          // A batch's A fragments, all of them before its first wgmma:
          // ptxas serialises every wgmma of a kernel that writes a wgmma's
          // input registers while one is in flight.  k-rows 32 kk + 4t + i
          // (fragment k 4t..) and 32 kk + 16 + 4t + i (k 16 + 4t..) of
          // columns 4 cc.., transposed to k-packed words: column 4 cc + q
          // is row (q & 1) * 8 + 16 warp + g of wgmma q / 2.
          uint32_t a[KB][2][4];
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            const int kk = k0 + kb;
            int lo[4], hi[4], clo[4], chi[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              lo[i] = *reinterpret_cast<const int*>(
                  st + wsw(32 * kk + 4 * t + i, 4 * cc));
              hi[i] = *reinterpret_cast<const int*>(
                  st + wsw(32 * kk + 16 + 4 * t + i, 4 * cc));
            }
            transpose_quads(lo, clo);
            transpose_quads(hi, chi);
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              a[kb][w][0] = static_cast<uint32_t>(clo[2 * w]);
              a[kb][w][1] = static_cast<uint32_t>(clo[2 * w + 1]);
              a[kb][w][2] = static_cast<uint32_t>(chi[2 * w]);
              a[kb][w][3] = static_cast<uint32_t>(chi[2 * w + 1]);
            }
          }
          wgmma_fence();                         // A registers just written
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            wgmma_x<BX>(acc0, a[kb][0], desc + 2 * (k0 + kb));
            wgmma_x<BX>(acc1, a[kb][1], desc + 2 * (k0 + kb));
          }
          wgmma_commit();
          // the batch's products are done before the next batch's fragments
          // overwrite the A registers (and, after the last batch, before the
          // slot is released); the other consumer warpgroup keeps the tensor
          // cores busy meanwhile
          wgmma_wait0();
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
#pragma unroll
      for (int i = 0; i < BX / 2; ++i) {
        fence_operand(acc0[i]);
        fence_operand(acc1[i]);
      }
      // sums d[4 j + e] of a wgmma: row 16 warp + g + 8 (e >> 1), x row
      // 8 j + 2 t + (e & 1); wgmma w's rows g / g + 8 are columns 4 cc + 2w
      // and 4 cc + 2w + 1
      const int n = n0 + 4 * cc;
      if (n < N) {
        const float w4[4] = {ws[n], ws[n + 1], ws[n + 2], ws[n + 3]};
#pragma unroll
        for (int j = 0; j < BX / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + cw * BX + 8 * j + 2 * t + e;
            if (m >= M) continue;
            const float sx = xs[m];
            const int v[4] = {acc0[4 * j + e], acc0[4 * j + 2 + e],
                              acc1[4 * j + e], acc1[4 * j + 2 + e]};
            float y[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              y[q] = __fmul_rn(__fmul_rn(__int2float_rn(v[q]), sx), w4[q]);
            store4<OT>(out + static_cast<size_t>(m) * N + n, y);
          }
      }
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (the
// libraries link against the runtime only)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major int8 matrix (rows x cols bytes) in boxes
// of box_cols x box_rows, 128-byte swizzled; false if it cannot be made
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the card's SM count, read once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename OT, int BX>
int launch_tc(const int8_t* xq, const int8_t* wq, const float* xs,
              const float* ws, void* out, int M, int K, int N,
              cudaStream_t st) {
  CUtensorMap tm_x, tm_w;
  if (!tensor_map(&tm_x, xq, M, K, kBK, 2 * BX) ||
      !tensor_map(&tm_w, wq, K, N, kBN, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Ring<BX>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_tc<OT, BX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  const long long tiles = static_cast<long long>((N + kBN - 1) / kBN) *
                          ((M + 2 * BX - 1) / (2 * BX));
  if (tiles > (1LL << 31) - 1) return -1;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  int8_matmul_tc<OT, BX><<<grid, kThreads, smem, st>>>(
      tm_x, tm_w, xs, ws, static_cast<OT*>(out), M, K, N);
  return 0;
}

// BX 128 where its tiles fill every SM, else 64 (twice the tiles)
template <typename OT>
int dispatch_tc(const int8_t* xq, const int8_t* wq, const float* xs,
                const float* ws, void* out, int M, int K, int N,
                cudaStream_t st) {
  const long long tiles128 = static_cast<long long>((N + kBN - 1) / kBN) *
                             ((M + 255) / 256);
  if (tiles128 >= sm_count())
    return launch_tc<OT, 128>(xq, wq, xs, ws, out, M, K, N, st);
  return launch_tc<OT, 64>(xq, wq, xs, ws, out, M, K, N, st);
}

}  // namespace tc_step

}  // namespace
}  // namespace repro

extern "C" {

// Which step a launch takes: 1 for the tensor-core step (K and N
// multiples of 16, xq / wq / out 16-byte aligned: ``aligned16``), 0 for
// the ragged step.  int8_matmul dispatches on it; the Python wrapper
// counts the tensor-core launches with it.
int int8_matmul_tc_step(int K, int N, int aligned16) {
  return K % 16 == 0 && N % 16 == 0 && aligned16;
}

// One launch of the tiled W8A8 matmul on ``stream``.  ``vec``: K % 4 == 0,
// N % 4 == 0 and both operands 4-byte aligned (the ragged step's loads).
// Returns 0, a CUDA error code from the launch, or -1 for a shape or
// dtype it does not take.
int int8_matmul(const int8_t* xq, const int8_t* wq, const float* xs,
                const float* ws, void* out, int M, int K, int N,
                int out_dtype, int vec, int aligned16, void* stream) {
  using namespace repro;
  if (M <= 0 || K <= 0 || N <= 0) return -1;
  if (out_dtype != kBF16 && out_dtype != kF32) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (int8_matmul_tc_step(K, N, aligned16)) {
    rc = out_dtype == kBF16
             ? tc_step::dispatch_tc<__nv_bfloat16>(xq, wq, xs, ws, out, M, K, N,
                                                 st)
             : tc_step::dispatch_tc<float>(xq, wq, xs, ws, out, M, K, N, st);
  } else {
    if ((M + kBM - 1) / kBM > 65535) return -1;
    if (out_dtype == kBF16)
      launch<__nv_bfloat16>(xq, wq, xs, ws, out, M, K, N, vec, st);
    else
      launch<float>(xq, wq, xs, ws, out, M, K, N, vec, st);
    rc = 0;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

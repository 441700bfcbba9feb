// Chunked RWKV-6 WKV recurrence in three passes (chunk-parallel state
// increments, the carry along the chunks, a chunk-parallel output pass),
// their products on Hopper's tensor cores.
//
// Replaces the TPU kernel repro/kernels/wkv6/wkv6.py: wkv6_pallas
// (_wkv6_kernel).  Same function: r, k, v, logw (B,S,H,D), u (H,D) and a
// carried fp32 state s0 (B,H,D,D) -> o (B,S,H,D) fp32 and the final state.
// Per (b, h), chunk after chunk of C = 64 tokens, all sums in fp32:
//   cw  = inclusive cumsum of logw over the chunk, cwe = cw - logw
//   scores[t,q] = sum_d r[t,d] k[q,d] exp(cwe[t,d] - cw[q,d])   (q < t)
//   scores[t,t] = sum_d r[t,d] k[t,d] u[d]
//   o = scores @ v + (r * exp(cwe)) @ S
//   S <- exp(cw_end) * S + (k * exp(cw_end - cw))^T @ v
// Every exponent is a difference of cumulative log-decays (<= 0), as in
// the reference.
//
// What bounds it on an H100: at the engine's admission shapes (B = 1, H =
// 32, D = 64) the bytes (r/k/v bf16, logw and o fp32: 14 bytes a
// token-channel, about 17 us for 2,048 tokens at 3.35 TB/s; the passes
// below also move the 64 x 64 state of every chunk through a workspace),
// and the exponentials on the special function units.  The products are
// small next to either once they run on the tensor cores.
//
// What the design does about it.  Only the state depends on the previous
// chunk, and only through S <- exp(cw_end) * S + increment, so the work
// is split by that:
//  * Increment pass (wkv6_increment, grid (n_chunks, B H)): every chunk
//    on its own, a block a (chunk, head): the chunk's k / logw / v land by
//    cp.async, then the cumsum of the 64 channels, k * exp(cw_end - cw),
//    and the 64 x 64 increment (k * exp(cw_end - cw))^T v on mma.sync,
//    written to a workspace (B, H, n_chunks, 64, 64) beside the decays
//    exp(cw_end).
//  * Carry pass (wkv6_carry): one thread an element of a head's state
//    walks the chunks in order, S <- exp(cw_end) * S + increment, one
//    fused multiply-add a chunk; it leaves the state entering each chunk
//    in the workspace (where the chunk's increment was) and the last one
//    in s_out.  The serial chain is 32 multiply-adds at S 2,048.
//  * Output pass (wkv6_out, grid (n_chunks, H, B): 1,024 blocks at S
//    2,048 instead of 128): every chunk on its own, from its tokens and
//    the workspace's entering state.  Scores go in 16-token sub-chunks:
//    block (i, j < i) is R'_i K'_ij^T on the tensor cores, with
//    R'_i = r * exp(cwe - A_i) and K'_ij = k * exp(A_(j+1) - cw) *
//    exp(A_i - A_(j+1)), A_i the cwe of sub-chunk i's first token: every
//    exponent <= 0, so strong decays underflow toward 0 and never
//    overflow; the two warps of a row block split its columns and meet
//    at a named barrier.  The four diagonal 16 x 16 blocks (per-channel
//    decay and the u bonus) stay on fp32 FMAs, 4 x 4 tiles with one
//    anchor a tile below the diagonal.  Then o = scores v + (r * exp(cwe)) S_entering,
//    both on the tensor cores, a warp for 16 tokens and 32 value columns.
//  * Precision: every product is mma.sync m16n8k8 on TF32 operands, each
//    fp32 operand fed as hi = tf32(x) and lo = tf32(x - hi), three
//    products hi·hi + hi·lo + lo·hi (an operand exact in TF32, as bf16
//    v is, has no lo term).  One bf16 term a factor would miss the
//    1e-4 x rms bar by two orders of magnitude; the three TF32 terms keep
//    about 21 bits (tests/test_torch_wkv6.py emulates the plan).
//  * bf16 r/k/v are read as they are and widened in registers (exact).
//    The tail chunk is masked as the plain version pads it (r = k = v =
//    0, logw = 0), so any S works, S = 1 included; s0 is always read.
#include "attn_tile_tc.cuh"

namespace repro {
namespace {
namespace tc_step {

using tc::cp_async16;

constexpr int kC = 64;                  // tokens per chunk
constexpr int kD = 64;                  // head dim
constexpr int kSub = 16;                // tokens per sub-chunk
constexpr int kThreads = 256;
// fp32 tile pitches: 68 (= 4 mod 32) for tiles read as [row][k] fragments,
// 72 (= 8 mod 32) for tiles read as [k][column] fragments; either way the
// 32 lanes of a fragment load hit 32 different banks
constexpr int kAP = 68;
constexpr int kBP = 72;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as two TF32 terms, hi + lo
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) x b (8 x 8, col), TF32 operands, fp32 sums.
// Fragments (lane = 4g + t): a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, c = {C[g][2t], C[g][2t+1],
// C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of four fp32 values, as hi and lo terms
__device__ __forceinline__ void split_a(const float (&x)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[e], lo[e]);
}

// c += a b with a as hi + lo and b = (b0, b1): hi·hi + lo·hi, plus hi·lo
// when kBLo; without it b must be exact in TF32 (a bf16 value widened),
// and its bits go in as they are
template <bool kBLo>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  if (kBLo) {
    uint32_t h0, h1, l0, l1;
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
    mma_tf32(c, ah, h0, h1);
    mma_tf32(c, al, h0, h1);
    mma_tf32(c, ah, l0, l1);
  } else {
    mma_tf32(c, ah, __float_as_uint(b0), __float_as_uint(b1));
    mma_tf32(c, al, __float_as_uint(b0), __float_as_uint(b1));
  }
}

// The cumulative log-decay of a chunk, thread (q = tid / 64, d = tid %
// 64) for tokens 16q.. of channel d (logw at lw[t * pitch + d]): run[i]
// = this quarter's inclusive sums, off = the quarters before it, end =
// cw_end (for the last token off + run[15] is the same sum in the same
// order, so its exponent cw_end - cw is 0).  tot is [4][64] scratch; all
// 256 threads must call it (it holds a barrier).
__device__ __forceinline__ void chunk_cumsum(const float* lw, int pitch,
                                             float* tot, int tid,
                                             float (&run)[kSub], float& off,
                                             float& end) {
  const int d = tid & (kD - 1), q = tid >> 6;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    acc += lw[(kSub * q + i) * pitch + d];
    run[i] = acc;
  }
  tot[q * kD + d] = acc;
  __syncthreads();
  off = 0.f;
  end = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float x = tot[p * kD + d];
    if (p < q) off += x;
    end += x;
  }
}

// ---------------------------------------------------------------------------
// state: the increment pass (every chunk on its own), then the carry pass

// The increment pass's shared memory: the chunk's k, logw and v as they
// are in memory ([token][channel]), k * exp(cw_end - cw) as [channel]
// [token], and the scan's partial sums
template <typename T>
struct IncSmem {
  static constexpr int kKBytes = kC * kD * sizeof(T);
  static constexpr int kLBytes = kC * kD * 4;
  static constexpr int kVBytes = kC * kBP * sizeof(T);
  static constexpr int kKCh = kD * sizeof(T) / 16;     // 16-byte chunks a row
  static constexpr int kLCh = kD * 4 / 16;
  static constexpr int kPer = 2 * kKCh + kLCh;         // k, v, logw
  static constexpr size_t kBytes =
      kKBytes + kLBytes + kVBytes + (kD * kAP + 4 * kD) * sizeof(float);
};

// Block (chunk c, (b, h)): the chunk's increment to the state, (k *
// exp(cw_end - cw))^T v, into the workspace's slot c, and its decays
// exp(cw_end) into ``decay``.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_increment(const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ logw, float* __restrict__ ws,
               float* __restrict__ decay, int S, int H) {
  using L = IncSmem<T>;
  extern __shared__ __align__(16) unsigned char smem_inc[];
  const T* ks = reinterpret_cast<const T*>(smem_inc);
  const float* lw = reinterpret_cast<const float*>(smem_inc + L::kKBytes);
  const T* vs = reinterpret_cast<const T*>(smem_inc + L::kKBytes + L::kLBytes);
  float* kdT = reinterpret_cast<float*>(smem_inc + L::kKBytes + L::kLBytes +
                                        L::kVBytes);
  float* tot = kdT + kD * kAP;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  // the chunk's rows; tokens past S land as zeros
  for (int e = tid; e < kC * L::kPer; e += kThreads) {
    const int t = e / L::kPer, x = e % L::kPer, tt = c * kC + t;
    const bool ok = tt < S;
    const size_t row = ((static_cast<size_t>(b) * S + (ok ? tt : 0)) * H + h) *
                       kD;
    if (x < L::kKCh)
      cp_async16(smem_inc + t * kD * sizeof(T) + x * 16,
                 k + row + x * (16 / sizeof(T)), ok);
    else if (x < 2 * L::kKCh)
      cp_async16(smem_inc + L::kKBytes + L::kLBytes + t * kBP * sizeof(T) +
                     (x - L::kKCh) * 16,
                 v + row + (x - L::kKCh) * (16 / sizeof(T)), ok);
    else
      cp_async16(smem_inc + L::kKBytes + t * kD * 4 + (x - 2 * L::kKCh) * 16,
                 logw + row + (x - 2 * L::kKCh) * 4, ok);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // cumulative log-decay: thread (q, d) sums tokens 16q.. of channel d,
  // then k * exp(cw_end - cw) for them
  {
    const int d = tid & (kD - 1), q = tid >> 6;
    float run[kSub], off, end;
    chunk_cumsum(lw, kD, tot, tid, run, off, end);
#pragma unroll
    for (int i = 0; i < kSub; i += 4) {
      float4 x;
      x.x = to_f32<T>(ks[(kSub * q + i) * kD + d]) *
            __expf(end - (off + run[i]));
      x.y = to_f32<T>(ks[(kSub * q + i + 1) * kD + d]) *
            __expf(end - (off + run[i + 1]));
      x.z = to_f32<T>(ks[(kSub * q + i + 2) * kD + d]) *
            __expf(end - (off + run[i + 2]));
      x.w = to_f32<T>(ks[(kSub * q + i + 3) * kD + d]) *
            __expf(end - (off + run[i + 3]));
      *reinterpret_cast<float4*>(kdT + d * kAP + kSub * q + i) = x;
    }
    if (q == 0)
      decay[(static_cast<size_t>(bh) * n_chunks + c) * kD + d] = __expf(end);
  }
  __syncthreads();
  // warp (mt, nh): state rows 16 mt.., columns 32 nh.. (4 n-tiles); 8
  // k-steps of tokens, the three products in three accumulators (short
  // dependency chains)
  const int mt = warp & 3, nh = warp >> 2;
  float acc[4][3][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < kC / 8; ++kk) {
    const int t = 8 * kk + tq, r0 = 16 * mt + g;
    const float a[4] = {kdT[r0 * kAP + t], kdT[(r0 + 8) * kAP + t],
                        kdT[r0 * kAP + t + 4], kdT[(r0 + 8) * kAP + t + 4]};
    uint32_t ah[4], al[4];
    split_a(a, ah, al);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = 32 * nh + 8 * n + g;
      const float b0 = to_f32<T>(vs[t * kBP + j]);
      const float b1 = to_f32<T>(vs[(t + 4) * kBP + j]);
      if (sizeof(T) == 4) {
        uint32_t bh0, bh1, bl0, bl1;
        split_tf32(b0, bh0, bl0);
        split_tf32(b1, bh1, bl1);
        mma_tf32(acc[n][0], ah, bh0, bh1);
        mma_tf32(acc[n][1], al, bh0, bh1);
        mma_tf32(acc[n][2], ah, bl0, bl1);
      } else {                               // bf16 v: exact in TF32
        mma_tf32(acc[n][0], ah, __float_as_uint(b0), __float_as_uint(b1));
        mma_tf32(acc[n][1], al, __float_as_uint(b0), __float_as_uint(b1));
      }
    }
  }
  float* w = ws + (static_cast<size_t>(bh) * n_chunks + c) * kD * kD;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int jc = 32 * nh + 8 * n + 2 * tq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(w + (16 * mt + g + 8 * hh) * kD + jc) =
          make_float2(
              (acc[n][0][2 * hh] + acc[n][1][2 * hh]) + acc[n][2][2 * hh],
              (acc[n][0][2 * hh + 1] + acc[n][1][2 * hh + 1]) +
                  acc[n][2][2 * hh + 1]);
  }
}

// The carry pass: one thread an element (d, j) of a (b, h) state walks
// the chunks in order, S <- decay * S + increment, leaving in slot c the
// state entering chunk c (where the increment was) and the last in s_out
__global__ void __launch_bounds__(kThreads)
wkv6_carry(const float* __restrict__ s0, float* __restrict__ ws,
           const float* __restrict__ decay, float* __restrict__ s_out,
           int n_chunks) {
  const int e = blockIdx.x * kThreads + threadIdx.x;   // (d, j) of the state
  const size_t bh = blockIdx.y;
  const int d = e / kD;
  float st = s0[bh * kD * kD + e];
  float* w = ws + bh * n_chunks * kD * kD + e;
  const float* a = decay + bh * n_chunks * kD + d;
  constexpr int kU = 4;                 // chunks whose loads go out together
  int c = 0;
  for (; c + kU <= n_chunks; c += kU) {
    float inc[kU], dec[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      inc[u] = w[static_cast<size_t>(c + u) * kD * kD];
      dec[u] = a[(c + u) * kD];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      w[static_cast<size_t>(c + u) * kD * kD] = st;
      st = dec[u] * st + inc[u];
    }
  }
  for (; c < n_chunks; ++c) {
    const float inc = w[static_cast<size_t>(c) * kD * kD];
    w[static_cast<size_t>(c) * kD * kD] = st;
    st = a[c * kD] * st + inc;
  }
  s_out[bh * kD * kD + e] = st;
}

// ---------------------------------------------------------------------------
// output pass

// Shared memory of an output-pass block, in floats
struct OutSmem {
  float* rs;    // [kC][kAP] r, then r * exp(cwe)
  float* ks;    // [kC][kAP] k, then k * exp(A_(j+1) - cw) (sub-chunks 0-2)
  float* cw;    // [kC][kAP] inclusive cumsum of logw, then the scores
  float* ce;    // [kC][kAP] logw, then cwe, then r * exp(cwe - A_i)
  float* vs;    // [kC][kBP] v
  float* ss;    // [kD][kBP] the entering state
  float* dsc;   // [4][kSub][kSub] the diagonal blocks' scores
  float* tot;   // [4][kD] scan totals
  float* us;    // [kD] u
  float* anc;   // [4][kD] A_i = cwe of sub-chunk i's first token
  float* dfac;  // [6][kD] exp(A_i - A_(j+1)) of block (i, j < i)
  __device__ explicit OutSmem(float* p)
      : rs(p), ks(rs + kC * kAP), cw(ks + kC * kAP), ce(cw + kC * kAP),
        vs(ce + kC * kAP), ss(vs + kC * kBP), dsc(ss + kD * kBP),
        tot(dsc + 4 * kSub * kSub), us(tot + 4 * kD), anc(us + kD),
        dfac(anc + 4 * kD) {}
  static constexpr size_t bytes() {
    return sizeof(float) * (4 * kC * kAP + 2 * kD * kBP + 4 * kSub * kSub +
                            4 * kD + kD + 4 * kD + 6 * kD);
  }
};

// index of block (i, j < i) among the six below the diagonal
__device__ __forceinline__ int pair_index(int i, int j) {
  return i * (i - 1) / 2 + j;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_out(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ logw,
         const float* __restrict__ u, const float* __restrict__ ws,
         float* __restrict__ o, int S, int H) {
  extern __shared__ __align__(16) float smem_out[];
  const OutSmem sm(smem_out);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * kC, n_chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t bh = static_cast<size_t>(b) * H + h;

  // logw and the entering state land by cp.async while r, k and v are
  // read and widened to fp32; tokens past S as zeros
  for (int e = tid; e < kC * (kD / 4); e += kThreads) {
    const int t = e >> 4, x = (e & 15) * 4, tt = c0 + t;
    const bool ok = tt < S;
    cp_async16(sm.ce + t * kAP + x,
               logw + ((static_cast<size_t>(b) * S + (ok ? tt : 0)) * H + h) *
                              kD + x,
               ok);
    cp_async16(sm.ss + t * kBP + x,
               ws + ((bh * n_chunks + c) * kD + t) * kD + x, true);
  }
  tc::cp_async_commit();
  constexpr int kPerU = 16 / sizeof(T);          // elements a 16-byte unit
  constexpr int kU = kD / kPerU;
#pragma unroll
  for (int it = 0; it < kC * kU / kThreads; ++it) {
    const int e = tid + it * kThreads;
    const int t = e / kU, x = (e % kU) * kPerU, tt = c0 + t;
    float fr[kPerU], fk[kPerU], fv[kPerU];
    if (tt < S) {
      const size_t off = ((static_cast<size_t>(b) * S + tt) * H + h) * kD + x;
      load_f32<T, kPerU>(r + off, fr);
      load_f32<T, kPerU>(k + off, fk);
      load_f32<T, kPerU>(v + off, fv);
    } else {
#pragma unroll
      for (int i = 0; i < kPerU; ++i) fr[i] = fk[i] = fv[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPerU; i += 4) {
      *reinterpret_cast<float4*>(sm.rs + t * kAP + x + i) =
          make_float4(fr[i], fr[i + 1], fr[i + 2], fr[i + 3]);
      *reinterpret_cast<float4*>(sm.ks + t * kAP + x + i) =
          make_float4(fk[i], fk[i + 1], fk[i + 2], fk[i + 3]);
      *reinterpret_cast<float4*>(sm.vs + t * kBP + x + i) =
          make_float4(fv[i], fv[i + 1], fv[i + 2], fv[i + 3]);
    }
  }
  if (tid < kD) sm.us[tid] = u[static_cast<size_t>(h) * kD + tid];
  tc::cp_async_wait<0>();
  __syncthreads();

  // cumulative log-decay: thread (q, d) sums tokens 16q.. of channel d
  {
    const int d = tid & (kD - 1), q = tid >> 6;
    float run[kSub], off, end;
    chunk_cumsum(sm.ce, kAP, sm.tot, tid, run, off, end);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int idx = (kSub * q + i) * kAP + d;
      const float cwv = off + run[i];
      const float lw = sm.ce[idx];
      sm.cw[idx] = cwv;
      sm.ce[idx] = cwv - lw;
    }
  }
  __syncthreads();

  if (tid < 160) {
    // the diagonal blocks on FMAs: task (block i, 4 x 4 tile tau) over a
    // quarter of the channels (d = 4 dd + dq), summed over 4 lanes
    const int task = tid >> 2, dq = tid & 3;
    const int i = task / 10, tau = task % 10;
    const int tt = tau < 1 ? 0 : tau < 3 ? 1 : tau < 6 ? 2 : 3;
    const int tqq = tau - tt * (tt + 1) / 2;
    const int t0 = kSub * i + 4 * tt, q0 = kSub * i + 4 * tqq;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
    for (int dd = 0; dd < kD / 4; ++dd) {
      const int d = 4 * dd + dq;
      float rv[4], ev[4], kv[4], cv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        rv[x] = sm.rs[(t0 + x) * kAP + d];
        ev[x] = sm.ce[(t0 + x) * kAP + d];
        kv[x] = sm.ks[(q0 + x) * kAP + d];
        cv[x] = sm.cw[(q0 + x) * kAP + d];
      }
      if (tqq < tt) {
        // exp(cwe_t - cw_q) = exp(cwe_t - a) exp(a - cw_q), a the tile's
        // last cw: cw falls with q and cwe_t <= a for t > q0 + 3
        const float a = cv[3];
        float ra[4], kb[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          ra[x] = rv[x] * __expf(ev[x] - a);
          kb[x] = kv[x] * __expf(a - cv[x]);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] += ra[x] * kb[y];
      } else {
        const float ud = sm.us[d];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int y = 0; y < x; ++y)
            acc[x][y] += rv[x] * kv[y] * __expf(ev[x] - cv[y]);
          acc[x][x] += rv[x] * kv[x] * ud;
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        float s = acc[x][y];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        acc[x][y] = s;
      }
    if (dq == 0)
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
          sm.dsc[(i * kSub + 4 * tt + x) * kSub + 4 * tqq + y] = acc[x][y];
  } else {
    // the anchors A_i, and exp(A_i - A_(j+1)) for the blocks below the
    // diagonal (both anchors <= 0, A_i <= A_(j+1))
    for (int e = tid - 160; e < 4 * kD; e += kThreads - 160)
      sm.anc[e] = sm.ce[(kSub * (e / kD)) * kAP + e % kD];
    for (int e = tid - 160; e < 6 * kD; e += kThreads - 160) {
      const int p = e / kD, d = e % kD;
      const int i = p < 1 ? 1 : p < 3 ? 2 : 3, j = p - i * (i - 1) / 2;
      sm.dfac[e] = __expf(sm.ce[kSub * i * kAP + d] -
                          sm.ce[kSub * (j + 1) * kAP + d]);
    }
  }
  __syncthreads();

  // the operands of the products, in place: r * exp(cwe) (rs), r *
  // exp(cwe - A_i) (ce), k * exp(A_(j+1) - cw) (ks, sub-chunks 0-2)
  for (int e = tid; e < kC * kD; e += kThreads) {
    const int t = e >> 6, d = e & 63, idx = t * kAP + d;
    const int sub = t / kSub;
    const float rv = sm.rs[idx], ev = sm.ce[idx];
    sm.rs[idx] = rv * __expf(ev);
    sm.ce[idx] = rv * __expf(ev - sm.anc[sub * kD + d]);
    if (sub < 3)
      sm.ks[idx] = sm.ks[idx] * __expf(sm.anc[(sub + 1) * kD + d] - sm.cw[idx]);
  }
  __syncthreads();

  // warp (i, hn): tokens 16 i.. of the chunk, and first the 8 score
  // columns 16 jb + 8 hn.. of each block (i, jb < i), into the scores
  // tile (cw's space: cw is dead now), the diagonal block beside them
  const int i = warp >> 1, hn = warp & 1;
  const int ta = kSub * i + g;                 // rows ta and ta + 8
  float* sc_s = sm.cw;                         // [kC][kAP] scores
  for (int jb = 0; jb < i; ++jb) {
    const float* df = sm.dfac + pair_index(i, jb) * kD;
    const int q = kSub * jb + 8 * hn + g;
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int kk = 0; kk < kD / 8; ++kk) {
      const int d = 8 * kk + tq;
      const float a[4] = {sm.ce[ta * kAP + d], sm.ce[(ta + 8) * kAP + d],
                          sm.ce[ta * kAP + d + 4],
                          sm.ce[(ta + 8) * kAP + d + 4]};
      uint32_t ah[4], al[4];
      split_a(a, ah, al);
      mma3<true>(sc, ah, al, sm.ks[q * kAP + d] * df[d],
                 sm.ks[q * kAP + d + 4] * df[d + 4]);
    }
    const int col = kSub * jb + 8 * hn + 2 * tq;
    *reinterpret_cast<float2*>(sc_s + ta * kAP + col) =
        make_float2(sc[0], sc[1]);
    *reinterpret_cast<float2*>(sc_s + (ta + 8) * kAP + col) =
        make_float2(sc[2], sc[3]);
  }
  for (int e = lane + 32 * hn; e < kSub * kSub; e += 64) {
    const int tl = e >> 4, ql = e & 15;
    sc_s[(kSub * i + tl) * kAP + kSub * i + ql] =
        ql <= tl ? sm.dsc[(i * kSub + tl) * kSub + ql] : 0.f;
  }
  // the two warps of row block i meet (named barrier 1 + i, 64 threads)
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + i) : "memory");

  // o for columns 32 hn..: (r * exp(cwe)) S_entering, 8 k-steps over the
  // key channels, then scores @ v over the tokens up to the block's last
  float oacc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kD / 8; ++kk) {
    const int d = 8 * kk + tq;
    const float a[4] = {sm.rs[ta * kAP + d], sm.rs[(ta + 8) * kAP + d],
                        sm.rs[ta * kAP + d + 4],
                        sm.rs[(ta + 8) * kAP + d + 4]};
    uint32_t ah[4], al[4];
    split_a(a, ah, al);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = 32 * hn + 8 * n + g;
      mma3<true>(oacc[n], ah, al, sm.ss[d * kBP + j], sm.ss[(d + 4) * kBP + j]);
    }
  }
  for (int kk = 0; kk < 2 * (i + 1); ++kk) {
    const int q = 8 * kk + tq;
    const float a[4] = {sc_s[ta * kAP + q], sc_s[(ta + 8) * kAP + q],
                        sc_s[ta * kAP + q + 4], sc_s[(ta + 8) * kAP + q + 4]};
    uint32_t ah[4], al[4];
    split_a(a, ah, al);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = 32 * hn + 8 * n + g;
      mma3<sizeof(T) == 4>(oacc[n], ah, al, sm.vs[q * kBP + j],
                           sm.vs[(q + 4) * kBP + j]);
    }
  }

#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tt = c0 + ta + 8 * hh;
      if (tt < S)
        *reinterpret_cast<float2*>(
            o + ((static_cast<size_t>(b) * S + tt) * H + h) * kD + 32 * hn +
            8 * n + 2 * tq) = make_float2(oacc[n][2 * hh], oacc[n][2 * hh + 1]);
    }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* o, void* s_out, void* ws,
           int B, int S, int H, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_out<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(OutSmem::bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(wkv6_increment<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(IncSmem<T>::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (S + kC - 1) / kC;
  float* wsf = static_cast<float*>(ws);
  float* decay = wsf + static_cast<size_t>(B) * H * n_chunks * kD * kD;
  wkv6_increment<T><<<dim3(n_chunks, B * H), kThreads, IncSmem<T>::kBytes,
                      stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), wsf, decay, S, H);
  wkv6_carry<<<dim3(kD * kD / kThreads, B * H), kThreads, 0, stream>>>(
      static_cast<const float*>(s0), wsf, decay, static_cast<float*>(s_out),
      n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_out<T><<<dim3(n_chunks, H, B), kThreads, OutSmem::bytes(), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), wsf, static_cast<float*>(o), S, H);
  return 0;
}

}  // namespace tc_step
}  // namespace
}  // namespace repro

extern "C" {

// Launches the three kernels on ``stream``: r/k/v of type ``dtype`` (fp32
// or bf16), logw, u, s0, o, s_out and the workspace ``ws``, (B, H,
// ceil(S / 64), 64, 64) fp32 states followed by (B, H, ceil(S / 64), 64)
// fp32 decays.  r, k, v and logw must be 16-byte aligned.  s_out may be
// s0: each carry-pass thread reads its element of the state before it
// writes it, and no other.  Returns 0, a CUDA error code, or
// -1 for a shape or dtype it does not take.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* logw,
             const void* u, const void* s0, void* o, void* s_out, void* ws,
             int B, int S, int H, int D, int dtype, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || H <= 0 || D != tc_step::kD || H > 65535 ||
      static_cast<long long>(B) * H > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kF32)
    rc = tc_step::launch<float>(r, k, v, logw, u, s0, o, s_out, ws, B, S, H,
                                st);
  else if (dtype == kBF16)
    rc = tc_step::launch<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_out, ws, B,
                                        S, H, st);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Chunked RWKV-6 WKV recurrence.
//
// Replaces the TPU kernel repro/kernels/wkv6/wkv6.py: wkv6_pallas
// (_wkv6_kernel).  Same function: r, k, v, logw (B,S,H,D), u (H,D) and a
// carried fp32 state s0 (B,H,D,D) -> o (B,S,H,D) fp32 and the final state.
// Per (b, h), chunk after chunk of C = 64 tokens, all in fp32:
//   cw  = inclusive cumsum of logw over the chunk, cwe = cw - logw
//   scores[t,q] = sum_d r[t,d] k[q,d] exp(cwe[t,d] - cw[q,d])   (q < t)
//   scores[t,t] = sum_d r[t,d] k[t,d] u[d]
//   o = scores @ v + (r * exp(cwe)) @ S
//   S <- exp(cw_end) * S + (k * exp(cw_end - cw))^T @ v
// Every exponent is a difference of cumulative log-decays (<= 0), as in
// the reference.
//
// What bounds it on an H100: at the engine's admission shapes (B = 1, H =
// 32, D = 64) the bytes are r/k/v in bf16, logw and o in fp32 (14 bytes a
// token-channel), about 17 us for 2,048 tokens at 3.35 TB/s.  The score
// products need C/2 exponentials per (token, channel) on the special
// function units, and this first version also runs the products on the
// fp32 FMA units, so in practice the exponentials and FMAs bound it;
// tensor cores (sub-chunk factorisation) and TMA are later work.
//
// What the design does about it:
//  * The Pallas grid walks the chunk axis in order with the state in VMEM.
//    Here one block owns a (value-column slice, head, batch) and loops
//    over the chunks itself, the state slice in shared memory.  The state's
//    value columns are independent (o[:, j] and S[:, j] need only v[:, j]),
//    so the D = 64 columns are split over kSplit = 4 blocks of kDV = 16:
//    at batch 1 that gives 4 x 32 = 128 blocks for the 132 SMs, one wave,
//    at the price of computing each chunk's C x C scores in all 4 blocks.
//  * The (C,C,D) decay tensor (1 MiB) is never formed: each thread owns a
//    4 x 4 tile of scores and loops over d.  Tiles wholly above the
//    diagonal are skipped; below it one anchor a tile splits
//    exp(cwe_t - cw_q) into two factors whose exponents are both <= 0, 8
//    exponentials for 16 terms.  r, k, cw and cwe sit in shared memory
//    transposed ([d][t]), so a thread reads 4 tokens of one channel as one
//    float4; about 93 KB of dynamic shared memory a block (opted in with
//    cudaFuncSetAttribute).
//  * bf16 r/k/v are read as they are and upcast in registers (exact).  The
//    tail chunk is masked as the plain version pads it (r = k = v = 0,
//    logw = 0), so any S works, S = 1 included; s0 is always read.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kC = 64;                  // tokens per chunk
constexpr int kD = 64;                  // head dim
constexpr int kDV = 16;                 // value columns per block
constexpr int kSplit = kD / kDV;        // blocks per (b, h)
constexpr int kThreads = 256;
constexpr int kTP = kC + 4;             // [d][t] row pitch (float4 aligned)
constexpr int kSP = kC + 1;             // scores row pitch
constexpr int kLower = (kC / 4) * (kC / 4 - 1) / 2;   // 120 tiles, q < t
constexpr int kDiag0 = 128;             // first thread of the diagonal

struct Smem {
  float* rT;    // [kD][kTP]  r, then r * exp(cwe)
  float* kT;    // [kD][kTP]  k, then k * exp(cw_end - cw)
  float* cwT;   // [kD][kTP]  inclusive cumsum of logw
  float* ceT;   // [kD][kTP]  logw, then cwe
  float* sc;    // [kC][kSP]  scores
  float* vs;    // [kC][kDV]  this block's value columns
  float* st;    // [kD][kDV]  this block's state slice
  float* us;    // [kD]
  __device__ explicit Smem(float* p)
      : rT(p), kT(p + kD * kTP), cwT(p + 2 * kD * kTP),
        ceT(p + 3 * kD * kTP), sc(p + 4 * kD * kTP),
        vs(p + 4 * kD * kTP + kC * kSP),
        st(p + 4 * kD * kTP + kC * kSP + kC * kDV),
        us(p + 4 * kD * kTP + kC * kSP + kC * kDV + kD * kDV) {}
  static constexpr size_t bytes() {
    return sizeof(float) *
           (4 * kD * kTP + kC * kSP + kC * kDV + kD * kDV + kD);
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ logw,
         const float* __restrict__ u, const float* __restrict__ s0,
         float* __restrict__ o, float* __restrict__ s_out, int S, int H) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem);
  const int j0 = blockIdx.x * kDV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  // 4 x 4 tiles: rows (tokens t, or channels d) g*4.., value column jj
  const int jj = tid % kDV, g = tid / kDV;
  // this thread's score tile below the diagonal: rows lt*4.., cols lq*4..
  int lt = 1, lq = tid;
  while (lq >= lt && lt < kC / 4) {
    lq -= lt;
    ++lt;
  }

  const size_t sbase = ((size_t)b * H + h) * kD * kD;
  for (int idx = tid; idx < kD * kDV; idx += kThreads) {
    const int d = idx / kDV, j = idx % kDV;
    sm.st[idx] = s0[sbase + (size_t)d * kD + j0 + j];
  }
  if (tid < kD) sm.us[tid] = u[(size_t)h * kD + tid];

  const int n_chunks = (S + kC - 1) / kC;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kC;
    __syncthreads();   // the previous chunk's readers are done
    // load the chunk: pad tokens past S as r = k = v = 0, logw = 0
    for (int idx = tid; idx < kC * kD; idx += kThreads) {
      const int t = idx / kD, d = idx % kD, tt = c0 + t;
      float rv = 0.f, kv = 0.f, lw = 0.f;
      if (tt < S) {
        const size_t off = (((size_t)b * S + tt) * H + h) * kD + d;
        rv = to_f32<T>(r[off]);
        kv = to_f32<T>(k[off]);
        lw = logw[off];
      }
      sm.rT[d * kTP + t] = rv;
      sm.kT[d * kTP + t] = kv;
      sm.ceT[d * kTP + t] = lw;
    }
    for (int idx = tid; idx < kC * kDV; idx += kThreads) {
      const int t = idx / kDV, j = idx % kDV, tt = c0 + t;
      sm.vs[idx] = tt < S ? to_f32<T>(
          v[(((size_t)b * S + tt) * H + h) * kD + j0 + j]) : 0.f;
    }
    __syncthreads();
    // cumulative log-decay, one channel a thread, in token order
    if (tid < kD) {
      float run = 0.f;
      float* cw = sm.cwT + tid * kTP;
      float* ce = sm.ceT + tid * kTP;
      for (int t = 0; t < kC; ++t) {
        const float lw = ce[t];
        run += lw;
        cw[t] = run;
        ce[t] = run - lw;
      }
    }
    __syncthreads();
    // scores: a 4 x 4 tile a thread.  Threads 0-119 take the 120 tiles
    // below the diagonal, threads 128-143 the 16 on it, so each warp
    // takes one branch; tiles above the diagonal are never computed.
    if (tid < kLower) {                  // every pair has q < t
      float acc[4][4] = {};
      const int t0 = lt * 4, q0 = lq * 4;
      for (int d = 0; d < kD; ++d) {
        const float4 rv = ld4(sm.rT + d * kTP + t0);
        const float4 ev = ld4(sm.ceT + d * kTP + t0);
        const float4 kv = ld4(sm.kT + d * kTP + q0);
        const float4 cv = ld4(sm.cwT + d * kTP + q0);
        // exp(cwe_t - cw_q) = exp(cwe_t - a) exp(a - cw_q) with a the
        // tile's last cw: cw falls with q and cwe_t <= a for t > q0 + 3,
        // so both exponents stay <= 0; 8 exponentials for 16 pairs
        const float a = cv.w;
        float ra[4], kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ra[i] = at(rv, i) * __expf(at(ev, i) - a);
          kb[i] = at(kv, i) * __expf(a - at(cv, i));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] += ra[i] * kb[q];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) sm.sc[(t0 + i) * kSP + q0 + q] = acc[i][q];
    } else if (tid >= kDiag0 && tid < kDiag0 + kC / 4) {   // the diagonal
      float acc[4][4] = {};
      const int t0 = (tid - kDiag0) * 4;
      for (int d = 0; d < kD; ++d) {
        const float4 rv = ld4(sm.rT + d * kTP + t0);
        const float4 ev = ld4(sm.ceT + d * kTP + t0);
        const float4 kv = ld4(sm.kT + d * kTP + t0);
        const float4 cv = ld4(sm.cwT + d * kTP + t0);
        const float ud = sm.us[d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q < i)
              acc[i][q] += at(rv, i) * at(kv, q) *
                           __expf(at(ev, i) - at(cv, q));
            else if (q == i)
              acc[i][q] += at(rv, i) * at(kv, q) * ud;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) sm.sc[(t0 + i) * kSP + t0 + q] = acc[i][q];
    }
    __syncthreads();
    // r * exp(cwe) and k * exp(cw_end - cw), in place
    for (int idx = tid; idx < kC * kD; idx += kThreads) {
      const int d = idx / kC, t = idx % kC;
      const float cw_end = sm.cwT[d * kTP + kC - 1];
      sm.rT[d * kTP + t] *= __expf(sm.ceT[d * kTP + t]);
      sm.kT[d * kTP + t] *= __expf(cw_end - sm.cwT[d * kTP + t]);
    }
    __syncthreads();
    // o[t, j] for tokens g*4.. and this thread's column: intra-chunk
    // scores @ v, then the carried state
    {
      const int t0 = g * 4;
      float acc[4] = {};
      // scores above the diagonal of this row block were stored as 0
      for (int q = 0; q <= t0 + 3; ++q) {
        const float vq = sm.vs[q * kDV + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += sm.sc[(t0 + i) * kSP + q] * vq;
      }
      for (int d = 0; d < kD; ++d) {
        const float4 rw = ld4(sm.rT + d * kTP + t0);
        const float sv = sm.st[d * kDV + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += at(rw, i) * sv;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tt = c0 + t0 + i;
        if (tt < S) o[(((size_t)b * S + tt) * H + h) * kD + j0 + jj] = acc[i];
      }
    }
    // S[d, j] for channels g*4..: decay, plus the chunk's k-v products
    {
      const int d0 = g * 4;
      float ns[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ns[i] = __expf(sm.cwT[(d0 + i) * kTP + kC - 1]) *
                sm.st[(d0 + i) * kDV + jj];
      for (int q = 0; q < kC; ++q) {
        const float vq = sm.vs[q * kDV + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) ns[i] += sm.kT[(d0 + i) * kTP + q] * vq;
      }
      __syncthreads();   // every reader of the old state is done
#pragma unroll
      for (int i = 0; i < 4; ++i) sm.st[(d0 + i) * kDV + jj] = ns[i];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kD * kDV; idx += kThreads) {
    const int d = idx / kDV, j = idx % kDV;
    s_out[sbase + (size_t)d * kD + j0 + j] = sm.st[idx];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* o, void* s_out, int B, int S,
           int H, cudaStream_t stream) {
  const size_t smem = Smem::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(kSplit, H, B);
  wkv6_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(s_out), S, H);
  return 0;
}

}  // namespace
}  // namespace repro

extern "C" {

// Launches the kernel on ``stream``: r/k/v of type ``dtype`` (fp32 or
// bf16), logw, u, s0, o and s_out fp32.  s_out may be s0: each block
// reads its own slice of the state before it writes it, and no other.
// Returns 0, a CUDA error code, or -1 for a shape or dtype it does not take.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* logw,
             const void* u, const void* s0, void* o, void* s_out, int B,
             int S, int H, int D, int dtype, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || H <= 0 || D != kD) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kF32)
    rc = launch<float>(r, k, v, logw, u, s0, o, s_out, B, S, H, st);
  else if (dtype == kBF16)
    rc = launch<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_out, B, S, H, st);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

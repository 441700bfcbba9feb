// FlashAttention-2 forward: causal / sliding-window attention, GQA.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py:
// flash_attention_pallas (_flash_kernel).  Same function: q (B,S,H,D),
// k/v (B,T,KH,D) -> o (B,S,H,D); query head h reads kv head h // G;
// query i sits at position i and sees key j when j <= i (causal) and
// j > i - window (window > 0); fp32 online softmax and fp32 p·v, output
// rounded once to the input type.
//
// What bounds it on an H100: at the admission shapes (B = 8, S = 512,
// H = 12, D = 128, bf16) the floor is the q/k/v/o bytes over 3.35 TB/s,
// about 8.8 µs, against about 6.5 µs for the causal products at the bf16
// tensor-core peak (989 TFLOP/s); chip_smoke.py computes both.  This
// first version runs the two products on the fp32 FMA units
// (67 TFLOP/s), where the same operations need about 96 µs, so in
// practice FMA throughput bounds it; moving the products to mma/wgmma is
// later work.
//
// What the design does about it:
//  * The Pallas grid carries (m, l, acc) in VMEM across a sequential kv
//    axis.  Here one block owns a (q tile of 64 rows, head, batch) and
//    loops over kv tiles inside the block, from the window's lower edge
//    to the causal edge, so fully masked tiles are never visited.
//  * K (transposed) and V tiles live in shared memory as fp32; each of
//    the 256 threads holds a 4x4 block of scores and a 4 x D/16 block of
//    the output accumulator in registers.  Row max and row sum reduce
//    across the 16 threads of a row with shuffles.
//  * Ragged S and T are masked inside the kernel (rows past S are not
//    written, keys past T are masked), so any length works: the engine's
//    power-of-two buckets need no padding to a tile multiple.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64, kBK = 64;       // q rows / kv rows per tile
constexpr int kTX = 16, kTY = 16;       // 256 threads
constexpr int kThreads = kTX * kTY;
constexpr int kRQ = kBQ / kTY;          // score rows per thread
constexpr int kRK = kBK / kTX;          // score cols per thread (= 4)
constexpr int kPad = 4;                 // keeps float4 alignment, spreads banks

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (D + kPad) + (size_t)D * (kBK + kPad)
                          + (size_t)kBK * D + (size_t)kBQ * (kBK + kPad));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
          int KH, int causal, int window, float scale) {
  constexpr int QS = D + kPad, KTS = kBK + kPad, PS = kBK + kPad;
  constexpr int DC = D / kTX;           // output cols per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][QS]
  float* Kt = Qs + kBQ * QS;             // [D][KTS]   (K transposed)
  float* Vs = Kt + D * KTS;              // [kBK][D]
  float* Ps = Vs + kBK * D;              // [kBQ][PS]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, kh = h / G;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D, qi = q0 + i;
    Qs[i * QS + d] =
        qi < S ? to_f32<T>(q[(((size_t)b * S + qi) * H + h) * D + d]) : 0.f;
  }

  int kv_hi = Tk;
  if (causal) kv_hi = min(Tk, q0 + kBQ);          // keys j <= i < q0 + kBQ
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);  // keys j > i - window
  kv_lo = (kv_lo / kBK) * kBK;

  float m[kRQ], l[kRQ], acc[kRQ][DC];
#pragma unroll
  for (int a = 0; a < kRQ; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Tk) {
        const size_t off = (((size_t)b * Tk + kj) * KH + kh) * D + d;
        kv = to_f32<T>(k[off]);
        vv = to_f32<T>(v[off]);
      }
      Kt[d * KTS + j] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    float sc[kRQ][kRK];
#pragma unroll
    for (int a = 0; a < kRQ; ++a)
#pragma unroll
      for (int c = 0; c < kRK; ++c) sc[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 k4 = *reinterpret_cast<const float4*>(&Kt[d * KTS + tx * kRK]);
#pragma unroll
      for (int a = 0; a < kRQ; ++a) {
        const float qv = Qs[(ty * kRQ + a) * QS + d];
        sc[a][0] = fmaf(qv, k4.x, sc[a][0]);
        sc[a][1] = fmaf(qv, k4.y, sc[a][1]);
        sc[a][2] = fmaf(qv, k4.z, sc[a][2]);
        sc[a][3] = fmaf(qv, k4.w, sc[a][3]);
      }
    }

#pragma unroll
    for (int a = 0; a < kRQ; ++a) {
      const int qi = q0 + ty * kRQ + a;
      bool ok[kRK];
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kRK; ++c) {
        const int kj = k0 + tx * kRK + c;
        bool valid = kj < Tk && qi < S;
        if (causal) valid = valid && kj <= qi;
        if (window > 0) valid = valid && kj > qi - window;
        ok[c] = valid;
        sc[a][c] = valid ? sc[a][c] * scale : kNegInf;
        if (valid) rmax = fmaxf(rmax, sc[a][c]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[a], rmax);
      const float corr = expf(m[a] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < kRK; ++c) {
        const float p = ok[c] ? expf(sc[a][c] - m_new) : 0.f;
        rsum += p;
        Ps[(ty * kRQ + a) * PS + tx * kRK + c] = p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[a] = l[a] * corr + rsum;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= corr;
      m[a] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRQ];
#pragma unroll
      for (int a = 0; a < kRQ; ++a) pv[a] = Ps[(ty * kRQ + a) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + c * kTX];
#pragma unroll
        for (int a = 0; a < kRQ; ++a) acc[a][c] = fmaf(pv[a], vv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kRQ; ++a) {
    const int qi = q0 + ty * kRQ + a;
    if (qi >= S) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    T* orow = o + (((size_t)b * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + c * kTX] = from_f32<T>(acc[a][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int H, int KH, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, KH, causal,
      window, scale);
  return 0;
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int S, int Tk, int H, int KH, int causal, int window,
               float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    default: return -1;
  }
}

}  // namespace
}  // namespace repro

extern "C" {

// Launches the kernel on ``stream``.  ``window`` <= 0 means no window.
// Returns 0, a CUDA error code, or -1 for a shape or dtype it does not take.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KH, int D, int causal,
                        int window, float scale, int dtype, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kF32)
    rc = dispatch_d<float>(D, q, k, v, o, B, S, T, H, KH, causal, window, scale, st);
  else if (dtype == kBF16)
    rc = dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, T, H, KH, causal, window, scale, st);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

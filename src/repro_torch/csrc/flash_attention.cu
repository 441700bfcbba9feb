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
// tensor-core peak (989 TFLOP/s); chip_smoke.py computes both.  Run on
// the fp32 FMA units (67 TFLOP/s) the same products need about 96 µs, so
// bf16 operands take the tensor cores.
//
// What the design does about it:
//  * The Pallas grid carries (m, l, acc) in VMEM across a sequential kv
//    axis.  Here one block owns a (q tile of 64 rows, head, batch) and
//    loops over kv tiles inside the block, from the window's lower edge
//    to the causal edge, so fully masked tiles are never visited; masks
//    apply only on tiles that touch the diagonal, the window or T.  The
//    q tiles with the most keys are launched first.
//  * bf16 operands (flash_fwd_tc): the tile step of attn_tile_tc.cuh,
//    mma.sync m16n8k16 products from swizzled bf16 tiles in shared memory
//    (Q 16 KB, a two-stage K/V ring of 2 x 32 KB at D 128: two blocks an
//    SM), the K/V tiles of step n+1 in flight as cp.async copies while
//    step n computes, online softmax on the accumulator fragments.
//  * fp32 operands (flash_fwd) keep the FMA step of attn_tile.cuh: the
//    fp32 outputs are held to 1e-5, which TF32 or bf16 products cannot
//    meet.  K (transposed) and V tiles live in shared memory as fp32;
//    each of the 256 threads holds a 4x4 block of scores and a 4 x D/16
//    block of the output accumulator.
//  * Ragged S and T are masked inside the kernel (rows past S are not
//    written, keys past T are masked and never read), so any length
//    works: the engine's power-of-two buckets need no padding to a tile
//    multiple.
#include "attn_tile.cuh"
#include "attn_tile_tc.cuh"

namespace repro {
namespace {

namespace fma_step {   // fp32 operands: the FMA tile step

using namespace tile;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
          int KH, int causal, int window, float scale) {
  constexpr int QS = Smem<D>::QS, KTS = Smem<D>::KTS;
  constexpr int DC = State<D>::DC;
  extern __shared__ float smem[];
  const Smem<D> sm(smem);

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, kh = h / G;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D, qi = q0 + i;
    sm.Qs[i * QS + d] =
        qi < S ? to_f32<T>(q[(((size_t)b * S + qi) * H + h) * D + d]) : 0.f;
  }

  int kv_hi = Tk;
  if (causal) kv_hi = min(Tk, q0 + kBQ);          // keys j <= i < q0 + kBQ
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);  // keys j > i - window
  kv_lo = (kv_lo / kBK) * kBK;

  State<D> st;
  st.init();
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
      sm.Kt[d * KTS + j] = kv;
      sm.Vs[j * D + d] = vv;
    }
    __syncthreads();
    step<D>(sm, st, tx, ty, scale, [&](int a, int c) {
      const int qi = q0 + ty * kRQ + a, kj = k0 + tx * kRK + c;
      bool valid = kj < Tk && qi < S;
      if (causal) valid = valid && kj <= qi;
      if (window > 0) valid = valid && kj > qi - window;
      return valid;
    });
  }

#pragma unroll
  for (int a = 0; a < kRQ; ++a) {
    const int qi = q0 + ty * kRQ + a;
    if (qi >= S) continue;
    const float denom = fmaxf(st.l[a], 1e-30f);
    T* orow = o + (((size_t)b * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + c * kTX] = from_f32<T>(st.acc[a][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int H, int KH, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes();
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


}  // namespace fma_step

namespace tc_step {   // bf16 operands: the tensor-core tile step

using namespace tc;

template <int D>
__global__ void __launch_bounds__(tc::kThreads, 2)
flash_fwd_tc(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
             const tc::bf16* __restrict__ v, tc::bf16* __restrict__ o,
             int S, int Tk, int H, int KH, int causal, int window,
             float scale_log2) {
  constexpr int C = D / 8;               // 16-byte chunks of a row
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);   // [kBQ][D]
  bf16* Ks = Qs + kBQ * D;                        // [2][kBK][D]
  bf16* Vs = Ks + 2 * kBK * D;                    // [2][kBK][D]

  // the q tiles with the most keys first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ, h = blockIdx.y,
            b = blockIdx.z;
  const int G = H / KH, kh = h / G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < kBQ * C; i += kThreads) {
    const int r = i / C, c = i % C, qi = q0 + r;
    cp_async16(Qs + swz<D>(r, c),
               q + (((size_t)b * S + min(qi, S - 1)) * H + h) * D + c * 8,
               qi < S);
  }

  int kv_hi = Tk;
  if (causal) kv_hi = min(Tk, q0 + kBQ);          // keys j <= i < q0 + kBQ
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);  // keys j > i - window
  kv_lo = (kv_lo / kBK) * kBK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kBK - 1) / kBK : 0;

  auto load_kv = [&](int n) {
    const int k0 = kv_lo + n * kBK, stage = n & 1;
    bf16* kd = Ks + stage * kBK * D;
    bf16* vd = Vs + stage * kBK * D;
    for (int i = tid; i < kBK * C; i += kThreads) {
      const int j = i / C, c = i % C, kj = k0 + j;
      const size_t off = (((size_t)b * Tk + min(kj, Tk - 1)) * KH + kh) * D
                         + c * 8;
      cp_async16(kd + swz<D>(j, c), k + off, kj < Tk);
      cp_async16(vd + swz<D>(j, c), v + off, kj < Tk);
    }
  };

  if (n_tiles > 0) load_kv(0);
  cp_async_commit();                              // Q and tile 0
  State<D> st;
  st.init();
  auto kscale = [&](int) { return scale_log2; };
  auto vscale = [](int) { return 1.f; };
  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();
    // tile n has landed for every thread, and every warp is done with
    // tile n - 1, whose stage the next copies overwrite
    __syncthreads();
    if (n == 0) st.load_q(Qs, warp, lane);
    if (n + 1 < n_tiles) load_kv(n + 1);
    cp_async_commit();
    const int k0 = kv_lo + n * kBK;
    const bf16* kt = Ks + (n & 1) * kBK * D;
    const bf16* vt = Vs + (n & 1) * kBK * D;
    const bool edge = k0 + kBK > Tk || (causal && k0 + kBK - 1 > q0)
                      || (window > 0 && k0 <= q0 + kBQ - 1 - window);
    if (edge) {
      step<D, true>(st, kt, vt, warp, lane, kscale, vscale,
                    [&](int r, int c) {
                      const int qi = q0 + r, kj = k0 + c;
                      bool ok = kj < Tk;
                      if (causal) ok = ok && kj <= qi;
                      if (window > 0) ok = ok && kj > qi - window;
                      return ok;
                    });
    } else {
      step<D, false>(st, kt, vt, warp, lane, kscale, vscale,
                     [](int, int) { return true; });
    }
  }
  cp_async_wait<0>();

  finish<D>(st, warp, lane, [&](int r, int c, float x0, float x1) {
    const int qi = q0 + r;
    if (qi < S) store_bf16x2(o + (((size_t)b * S + qi) * H + h) * D + c, x0, x1);
  });
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int Tk, int H, int KH, int causal, int window,
              float scale, cudaStream_t stream) {
  // Q, then two stages of K and of V: 80 KB at D 128
  const size_t smem = sizeof(tc::bf16) * 5 * tc::kBQ * D;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + tc::kBQ - 1) / tc::kBQ, H, B);
  flash_fwd_tc<D><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), S, Tk, H,
      KH, causal, window, scale * tc::kLog2e);
  return 0;
}

int dispatch_tc(int D, const void* q, const void* k, const void* v, void* o,
                int B, int S, int Tk, int H, int KH, int causal, int window,
                float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    case 64: return launch_tc<64>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    case 128: return launch_tc<128>(q, k, v, o, B, S, Tk, H, KH, causal, window, scale, st);
    default: return -1;
  }
}

}  // namespace tc_step

}  // namespace
}  // namespace repro

extern "C" {

// Which tile step a launch of this dtype takes: 1 for the tensor-core step
// (bf16), 0 for the FMA step (fp32).  flash_attention_fwd dispatches on
// it; the Python wrapper counts the launches that took the tensor cores.
int flash_attention_tc_step(int dtype) { return dtype == repro::kBF16; }

// Launches the kernel on ``stream``.  ``window`` <= 0 means no window.
// Returns 0, a CUDA error code, or -1 for a shape or dtype it does not take.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KH, int D, int causal,
                        int window, float scale, int dtype, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (flash_attention_tc_step(dtype))
    rc = tc_step::dispatch_tc(D, q, k, v, o, B, S, T, H, KH, causal, window, scale, st);
  else if (dtype == kF32)
    rc = fma_step::dispatch_d<float>(D, q, k, v, o, B, S, T, H, KH, causal, window, scale, st);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

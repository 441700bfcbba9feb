// Row RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 math, y in
// x's type.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/rmsnorm.py: rmsnorm_pallas
// (_rmsnorm_kernel).  Same function over rows of d <= 8192: the mean of
// squares and the rsqrt in fp32, the product (x * r) * scale rounded once.
//
// What bounds it on an H100: bytes.  It reads each row and writes it once
// (4 bytes an element in bf16) and does 4 operations an element, far below
// the 295 operations a byte at which the card stops being bound by its
// memory: at (4,096, 1,536) bf16 the floor is 25 MB over 3.35 TB/s, about
// 7.5 us.
//
// What the first design lost (it is kept below as the long-row step):
// one 256-thread block a row, so at d 1,536 bf16 only 192 threads load
// anything, each one 16-byte load, before the block stalls on two
// __syncthreads and a serial sum of the 8 warp sums by thread 0, with no
// load in flight; then a second pass re-reads x and reads the scale one
// element at a time, on every row.  Two passes, a stall, and the scale
// reloaded for each of the 4,096 rows, for a pure byte stream.
//
// The warp step (rows of d <= 2,048 whose length and bases allow 16-byte
// vectors; qwen2's 1,536 and llama3.2-1b's 2,048 in both types):
//  * One warp a row, the row held in registers: a lane holds up to 256
//    bytes of it (96 at d 1,536 bf16), so the sum of squares and the
//    scaling use one read of x from device memory and no second pass.
//  * Loads in flight across rows.  Blocks are persistent, sized to the
//    SMs (as many as fit at once), and their warps walk the rows; each
//    warp issues the next row's 16-byte loads before it reduces and
//    stores the current one, so the memory system always has a row's
//    bytes in flight.  The scale is loaded once a warp, vectorised, and
//    kept in registers for every row the warp takes.
//  * The reduction is a butterfly of warp shuffles in a fixed order: each
//    lane adds its elements in index order, then xor steps 16, 8, 4, 2,
//    1.  Every lane of the butterfly ends with the same bits (each step
//    adds the same two values on both partners), and no __syncthreads or
//    atomic is involved, so the same row gives the same bits on every run
//    and in every block: the drives' logit checks compare two forwards
//    that both take this kernel bit for bit.
// Longer rows (up to 8,192) and rows that rule out 16-byte vectors take
// the long-row step, which sums in the same fixed way within its block.
#include "common.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// The long-row step: one block of 256 threads a row, 16-byte loads where
// the row length allows (8 bf16 or 4 fp32); the second pass (the scaling)
// re-reads the row from L1/L2, which a 16 KB row fits.  Each thread adds
// its elements in index order, then a butterfly of warp shuffles, then
// thread 0 adds the 8 warp sums in order.

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, typename W, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows(const T* __restrict__ x, const W* __restrict__ scale,
             T* __restrict__ y, int d, float eps) {
  __shared__ float warp_sums[kWarps];
  __shared__ float inv_rms;
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int tid = threadIdx.x;

  float ss = 0.f;
  for (int i = tid * V; i < d; i += kThreads * V) {
    float xv[V];
    load_f32<T, V>(xr + i, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) ss += xv[e] * xv[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tid % 32 == 0) warp_sums[tid / 32] = ss;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    inv_rms = rsqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = tid * V; i < d; i += kThreads * V) {
    float xv[V], wv[V];
    load_f32<T, V>(xr + i, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) wv[e] = to_f32<W>(scale[i + e]);
    VecT<T, V> out;
#pragma unroll
    for (int e = 0; e < V; ++e) out.v[e] = from_f32<T>(xv[e] * r * wv[e]);
    *reinterpret_cast<VecT<T, V>*>(yr + i) = out;
  }
}

template <typename T, typename W>
int launch_rows(const void* x, const void* scale, void* y, int rows, int d,
                float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(scale);
  T* yp = static_cast<T*>(y);
  const bool wide = d % V == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (wide)
    rmsnorm_rows<T, W, V><<<rows, kThreads, 0, stream>>>(xp, wp, yp, d, eps);
  else
    rmsnorm_rows<T, W, 1><<<rows, kThreads, 0, stream>>>(xp, wp, yp, d, eps);
  return 0;
}

// ---------------------------------------------------------------------------
// The warp step.

namespace warp_step {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 2048;          // longest row held in registers

// Lane ``lane`` holds vectors lane, lane + 32, ... (NV of them at most) of
// a row of d / V 16-byte vectors: x's raw vectors of the current and the
// next row, and the scale's matching V elements in W.
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_warp(const T* __restrict__ x, const W* __restrict__ scale,
             T* __restrict__ y, int rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  using XV = VecT<T, V>;
  using WV = VecT<W, V>;
  const int lane = threadIdx.x % 32;
  const int nvec = d / V;
  const int n_warps = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;

  XV cur[NV], nxt[NV];
  auto load_row = [&](XV (&buf)[NV], int r) {
    const XV* src = reinterpret_cast<const XV*>(x + static_cast<size_t>(r) * d);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) buf[j] = src[lane + 32 * j];
  };
  load_row(cur, row);
  WV w[NV];
  const WV* wsrc = reinterpret_cast<const WV*>(scale);
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (lane + 32 * j < nvec) w[j] = wsrc[lane + 32 * j];

  for (; row < rows; row += n_warps) {
    if (row + n_warps < rows) load_row(nxt, row + n_warps);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float f = to_f32<T>(cur[j].v[e]);
          ss += f * f;
        }
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    XV* dst = reinterpret_cast<XV*>(y + static_cast<size_t>(row) * d);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) {
        XV out;
#pragma unroll
        for (int e = 0; e < V; ++e)
          out.v[e] = from_f32<T>(to_f32<T>(cur[j].v[e]) * r *
                                 to_f32<W>(w[j].v[e]));
        dst[lane + 32 * j] = out;
      }
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }
}

// Blocks of rmsnorm_warp<T, W, NV> that fit on the card at once, in
// ``fit`` (per device and per instantiation, computed at its first launch
// there).  Returns 0 or the CUDA error of a query.
template <typename T, typename W, int NV>
int resident_blocks(int& fit) {
  static int cached[64] = {};
  auto kernel = rmsnorm_warp<T, W, NV>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return -1;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[dev] = max(1, sms * per_sm);
  }
  fit = cached[dev];
  return 0;
}

template <typename T, typename W, int NV>
int launch_nv(const void* x, const void* scale, void* y, int rows, int d,
              float eps, cudaStream_t st) {
  auto kernel = rmsnorm_warp<T, W, NV>;
  int fit = 0;
  const int rc = resident_blocks<T, W, NV>(fit);
  if (rc != 0) return rc;
  const int grid = min(fit, (rows + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, 0, st>>>(static_cast<const T*>(x),
                                    static_cast<const W*>(scale),
                                    static_cast<T*>(y), rows, d, eps);
  return 0;
}

// The smallest instantiation whose NV vectors a lane cover the row
template <typename T, typename W>
int launch_warp(const void* x, const void* scale, void* y, int rows, int d,
                float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int per_lane = (d / V + 31) / 32;
  if (per_lane <= 1) return launch_nv<T, W, 1>(x, scale, y, rows, d, eps, st);
  if (per_lane <= 2) return launch_nv<T, W, 2>(x, scale, y, rows, d, eps, st);
  if (per_lane <= 4) return launch_nv<T, W, 4>(x, scale, y, rows, d, eps, st);
  if (per_lane <= 6) return launch_nv<T, W, 6>(x, scale, y, rows, d, eps, st);
  if (per_lane <= 8) return launch_nv<T, W, 8>(x, scale, y, rows, d, eps, st);
  if constexpr (kMaxD / (32 * V) > 8) {
    if (per_lane <= 12)
      return launch_nv<T, W, 12>(x, scale, y, rows, d, eps, st);
    if (per_lane <= 16)
      return launch_nv<T, W, 16>(x, scale, y, rows, d, eps, st);
  }
  return -1;
}

}  // namespace warp_step

int is_warp_step(int dtype, int d, int aligned16) {
  const int v = dtype == kF32 ? 4 : dtype == kBF16 ? 8 : 0;
  return v > 0 && d % v == 0 && d <= warp_step::kMaxD && aligned16 != 0;
}

template <typename T, typename W>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, int warp, cudaStream_t st) {
  if (warp) return warp_step::launch_warp<T, W>(x, scale, y, rows, d, eps, st);
  return launch_rows<T, W>(x, scale, y, rows, d, eps, st);
}

template <typename T>
int dispatch_scale(int scale_dtype, const void* x, const void* scale,
                   void* y, int rows, int d, float eps, int warp,
                   cudaStream_t st) {
  if (scale_dtype == kF32)
    return launch<T, float>(x, scale, y, rows, d, eps, warp, st);
  if (scale_dtype == kBF16)
    return launch<T, __nv_bfloat16>(x, scale, y, rows, d, eps, warp, st);
  return -1;
}

}  // namespace
}  // namespace repro

extern "C" {

// Which step a launch takes: 1 for the warp step (x of dtype ``dtype``,
// fp32 or bf16, rows of d <= 2,048 with d a whole number of 16-byte
// vectors, and x, y and the scale 16-byte aligned: ``aligned16``), 0 for
// the long-row step.  rmsnorm_fwd dispatches on it; the Python wrapper
// counts the warp-step launches with it.
int rmsnorm_warp_step(int dtype, int d, int aligned16) {
  return repro::is_warp_step(dtype, d, aligned16);
}

// Launches the kernel on ``stream`` over ``rows`` rows of ``d`` elements:
// x and y of type ``dtype``, scale of type ``scale_dtype`` (fp32 or bf16);
// ``aligned16`` as for rmsnorm_warp_step.  Returns 0, a CUDA error code,
// or -1 for a shape or dtype it does not take.
int rmsnorm_fwd(const void* x, const void* scale, void* y, int rows, int d,
                float eps, int dtype, int scale_dtype, int aligned16,
                void* stream) {
  using namespace repro;
  if (rows <= 0 || d <= 0 || d > 8192) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warp = is_warp_step(dtype, d, aligned16);
  int rc;
  if (dtype == kF32)
    rc = dispatch_scale<float>(scale_dtype, x, scale, y, rows, d, eps, warp, st);
  else if (dtype == kBF16)
    rc = dispatch_scale<__nv_bfloat16>(scale_dtype, x, scale, y, rows, d, eps,
                                       warp, st);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

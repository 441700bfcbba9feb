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
// What the design does about it:
//  * One block of 256 threads a row, 16-byte vector loads where the row
//    length allows (8 bf16 or 4 fp32), so a row is one pass of wide,
//    coalesced reads; the second pass (the scaling) re-reads the row from
//    L1/L2, which a 16 KB row fits.
//  * The sum of squares reduces in a fixed order: each thread adds its
//    elements in index order, then a butterfly of warp shuffles, then warp
//    0 adds the 8 warp sums in order.  No atomics, so the same row gives
//    the same bits on every run: the drives' logit checks compare two
//    forwards that both take this kernel bit for bit.
#include "common.cuh"

namespace repro {
namespace {

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
int launch(const void* x, const void* scale, void* y, int rows, int d,
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

template <typename T>
int dispatch_scale(int scale_dtype, const void* x, const void* scale,
                   void* y, int rows, int d, float eps, cudaStream_t st) {
  if (scale_dtype == kF32) return launch<T, float>(x, scale, y, rows, d, eps, st);
  if (scale_dtype == kBF16)
    return launch<T, __nv_bfloat16>(x, scale, y, rows, d, eps, st);
  return -1;
}

}  // namespace
}  // namespace repro

extern "C" {

// Launches the kernel on ``stream`` over ``rows`` rows of ``d`` elements:
// x and y of type ``dtype``, scale of type ``scale_dtype`` (fp32 or bf16).
// Returns 0, a CUDA error code, or -1 for a shape or dtype it does not take.
int rmsnorm_fwd(const void* x, const void* scale, void* y, int rows, int d,
                float eps, int dtype, int scale_dtype, void* stream) {
  using namespace repro;
  if (rows <= 0 || d <= 0 || d > 8192) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kF32)
    rc = dispatch_scale<float>(scale_dtype, x, scale, y, rows, d, eps, st);
  else if (dtype == kBF16)
    rc = dispatch_scale<__nv_bfloat16>(scale_dtype, x, scale, y, rows, d, eps, st);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Shared helpers of the port's CUDA kernels: element conversions and
// vectorised row loads.  Every kernel computes in fp32; storage types are
// fp32, bf16, int8 and fp8 e4m3 (the "fn" variant: no infinities, max 448).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

constexpr float kNegInf = -1e30f;   // the reference kernels' NEG_INF

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);   // round to nearest even, as astype(bf16)
}

// N contiguous elements as one aligned vector load (N * sizeof(T) is a
// power of two up to 16 bytes for every instantiation used here).
template <typename T, int N>
struct alignas(sizeof(T) * N) VecT {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const VecT<T, N> v = *reinterpret_cast<const VecT<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32<T>(v.v[i]);
}

// Launches ``kernel`` over ``grid`` in thread block clusters of
// ``cluster`` blocks: the blocks of a cluster run at once on neighbouring
// SMs and can read each other's shared memory (at most 8 a cluster).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid,
                            dim3 cluster, int threads, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace repro

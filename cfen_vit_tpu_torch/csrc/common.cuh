// Shared helpers for the sm_90a kernels: float <-> storage-type conversion
// and the per-op rounding that lets a kernel reproduce where the plain
// PyTorch version materialises a bfloat16 tensor.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cfen {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// v rounded to T's precision (identity for float)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// A convolution's output in T as the plain version forms it: the f32 sum
// rounded to T, then the bias added and rounded again (F.conv2d adds the
// bias to its T-typed output, as the JAX package's conv2d does).
template <typename T> __device__ __forceinline__ float add_bias(float acc, float bias) {
  return round_to<T>(round_to<T>(acc) + bias);
}

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace cfen

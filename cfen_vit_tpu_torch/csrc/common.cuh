// Shared helpers for the sm_90a kernels: float <-> storage-type conversion
// and the per-op rounding that lets a kernel reproduce where the plain
// PyTorch version materialises a bfloat16 tensor.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// element e of a 16-byte vector of T (8 bf16 or 4 float32), as float
template <typename T> __device__ __forceinline__ float vec_elem(const uint4& v, int e) {
  const int i = sizeof(T) == 4 ? e : e >> 1;   // its 32-bit word
  const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  if (sizeof(T) == 4) return __uint_as_float(w);
  return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);   // a bf16 is a float's high half
}

// cp.async's 16-byte copies need 16-byte aligned global addresses
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the dynamic shared memory one block may opt into on sm_90 (227 KB)
constexpr size_t kSmemMax = 232448;

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Opts a kernel into all of kSmemMax once per device (the first launch on
// each device pays the attribute call); `allowed` is the kernel's own flags.
template <typename K>
inline cudaError_t allow_smem_once(K kernel, bool (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemMax));
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

}  // namespace cfen

// Element access of the port's kernels: the dtype codes shared with the
// Python wrappers and conversions through f32 (also for the flash tile
// kernels, flash_tiles.cuh), and the 8-element vector loads and stores of
// the elementwise kernels (quantizer.cu, rms_norm.cu: 16 bytes of bf16 or
// fp16, 32 of f32, 8 of int8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ds_vec {

// dtype codes shared with the Python wrappers
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

constexpr int kVec = 8;  // elements per vector access

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One round-to-nearest-even cast from f32.
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kVec elements of T from p, which must be 16-byte aligned, as f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[kVec]) {
  constexpr int kWords = kVec * (int)sizeof(T) / 16;
  uint4 raw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    raw[w] = reinterpret_cast<const uint4*>(p)[w];
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int u = 0; u < kVec; ++u) v[u] = to_f32<T>(e[u]);
}

// kVec f32 values to p (16-byte aligned), each cast once to T.
template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[kVec]) {
  constexpr int kWords = kVec * (int)sizeof(T) / 16;
  uint4 raw[kWords];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int u = 0; u < kVec; ++u) e[u] = from_f32<T>(v[u]);
#pragma unroll
  for (int w = 0; w < kWords; ++w) reinterpret_cast<uint4*>(p)[w] = raw[w];
}

}  // namespace ds_vec

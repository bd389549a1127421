// RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/norms.py: rms_norm_pallas (:30)
// -> _rms_kernel (:23).
//
// x [rows, h] (the leading dims flattened) in f32, bf16 or fp16 and the
// weight [h] in any of the three -> out [rows, h] in x's dtype:
// var = mean(x^2) in f32, then out = (x * rsqrt(var + eps)) * w in f32, in
// that order, cast once to x's dtype. One block of kThreads threads per row:
// pass 1 reads the row (converted to f32 in registers) and sums the squares
// per thread, then a shuffle tree inside each warp and a fixed-order fold
// of the warps' sums; pass 2 reads the row again (from the cache) with the
// weight and writes the output. 16-byte vector accesses where h is a
// multiple of 8 and the pointers are aligned; any h otherwise.
//
// Bound on an H100: bytes. Each element is read once and written once, and
// the weight read once: [4608, 4096] bf16 moves 75.5 MB, 22.5 us at
// 3.35 TB/s. The row's second read is served by L1/L2, so device memory
// sees each byte once.
#include "vec_io.cuh"

namespace ds_rms {

using namespace ds_vec;

constexpr int kThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    T* __restrict__ out, int h, float eps, bool vec) {
  __shared__ float red[kThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * h;
  T* orow = out + (size_t)blockIdx.x * h;

  float ss = 0.0f;
  if (vec) {
    for (int c = threadIdx.x; c < h / kVec; c += kThreads) {
      float v[kVec];
      load_vec<T>(xr + c * kVec, v);
#pragma unroll
      for (int u = 0; u < kVec; ++u) ss += v[u] * v[u];
    }
  } else {
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const float v = to_f32<T>(xr[i]);
      ss += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = red[0];
#pragma unroll
  for (int k = 1; k < kThreads / 32; ++k) total += red[k];
  const float inv = rsqrtf(__fdiv_rn(total, (float)h) + eps);

  if (vec) {
    for (int c = threadIdx.x; c < h / kVec; c += kThreads) {
      float v[kVec], g[kVec];
      load_vec<T>(xr + c * kVec, v);
      load_vec<W>(w + c * kVec, g);
#pragma unroll
      for (int u = 0; u < kVec; ++u)
        v[u] = __fmul_rn(__fmul_rn(v[u], inv), g[u]);
      store_vec<T>(orow + c * kVec, v);
    }
  } else {
    for (int i = threadIdx.x; i < h; i += kThreads)
      orow[i] = from_f32<T>(
          __fmul_rn(__fmul_rn(to_f32<T>(xr[i]), inv), to_f32<W>(w[i])));
  }
}

template <typename T, typename W>
static int launch(const void* x, const void* w, void* out, int rows, int h,
                  float eps, void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(w) |
                      reinterpret_cast<uintptr_t>(out);
  const bool vec = h % kVec == 0 && a % 16 == 0;
  rms_norm_kernel<T, W>
      <<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const W*>(w),
          static_cast<T*>(out), h, eps, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_w(const void* x, const void* w, void* out, int rows, int h,
                    int w_dtype, float eps, void* stream) {
  switch (w_dtype) {
    case kF32:
      return launch<T, float>(x, w, out, rows, h, eps, stream);
    case kF16:
      return launch<T, __half>(x, w, out, rows, h, eps, stream);
    case kBF16:
      return launch<T, __nv_bfloat16>(x, w, out, rows, h, eps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ds_rms

// x, out: [rows, h] in x_dtype; w: [h] in w_dtype. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int ds_rms_norm(const void* x, const void* w, void* out, int rows,
                           int h, int x_dtype, int w_dtype, float eps,
                           void* stream) {
  using namespace ds_rms;
  if (rows == 0) return 0;
  if (h < 1) return (int)cudaErrorInvalidValue;
  switch (x_dtype) {
    case kF32:
      return launch_w<float>(x, w, out, rows, h, w_dtype, eps, stream);
    case kF16:
      return launch_w<__half>(x, w, out, rows, h, w_dtype, eps, stream);
    case kBF16:
      return launch_w<__nv_bfloat16>(x, w, out, rows, h, w_dtype, eps,
                                     stream);
  }
  return (int)cudaErrorInvalidValue;
}

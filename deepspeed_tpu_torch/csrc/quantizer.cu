// Blockwise symmetric quantize / dequantize for Hopper (sm_90a): the weights
// of weight-only quantized serving (quant_bits 8 and 4).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/quantizer_kernels.py:
// quantize_blocks_pallas (:50) -> _quant_kernel (:28), and
// dequantize_blocks_pallas (:71) -> _dequant_kernel (:37).
//
// Layout: a tensor of n logical elements read flat, in nb = ceil(n / block)
// blocks of `block` consecutive elements: q [nb, block] int8 and one f32
// scale per block, s [nb] (the [nb, 1] of the Python side).
//
// ds_quantize_blocks: one thread block per quant block. Pass 1 reads the
// block in its source dtype (f32, bf16 or fp16, converted to f32 in
// registers, which is exact; elements at index n and beyond read as 0) and
// reduces |x| to the absmax with warp shuffles, then shared memory. The
// scale is absmax * f32(1 / qrange), what XLA compiles absmax / qrange
// into, and 1.0 for an all-zero block. Pass 2 reads the block again (a few
// KB, served by the cache) and writes q = clamp(rint(x / scale), -qrange,
// qrange): a true IEEE division and round-half-even, as jnp.round. The
// padded tail is written as 0.
//
// ds_dequantize_blocks: one thread block per quant block writes
// from_f32<T>(f32(q) * s), one round-to-nearest-even cast, in the target
// dtype directly, and stops at the logical end n.
//
// Bound on an H100: bytes. Quantize reads each element once in its source
// dtype and writes one int8 per element and one f32 per block; dequantize
// reads the int8 values and scales and writes the target dtype. For a
// Mistral-7B w_gate ([4096, 14336] bf16) either direction moves 176 MB:
// 53 us at 3.35 TB/s. Each byte crosses device memory once, with 16-byte
// loads of the source and 8-byte int8 accesses where the block's alignment
// allows. What it does not do yet: unpack packed int4 in the kernel (the
// caller unpacks in torch), or fuse the dequantization into the consuming
// matrix product.
#include "vec_io.cuh"

namespace ds_quant {

using namespace ds_vec;

constexpr int kThreads = 256;

// Elements [start, start + len) of the flat input as f32, zeros at and past
// n and past len. `vec`: 16-byte aligned full chunks load as one vector.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x,
                                           size_t start, int64_t n, int len,
                                           bool vec, float (&v)[kVec]) {
  if (vec && len == kVec && (int64_t)start + kVec <= n) {
    load_vec<T>(x + start, v);
    return;
  }
#pragma unroll
  for (int u = 0; u < kVec; ++u)
    v[u] = (u < len && (int64_t)start + u < n) ? to_f32<T>(x[start + u])
                                                : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ s, int64_t n, int block, float qrange,
                    bool vec) {
  __shared__ float red[kThreads / 32];
  const size_t row0 = (size_t)blockIdx.x * block;
  const int chunks = (block + kVec - 1) / kVec;

  float amax = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    float v[kVec];
    load_chunk<T>(x, row0 + (size_t)c * kVec, n, min(kVec, block - c * kVec),
                  vec, v);
#pragma unroll
    for (int u = 0; u < kVec; ++u) amax = fmaxf(amax, fabsf(v[u]));
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  // every thread folds the warps' maxima in the same order
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale =
      amax > 0.0f ? __fmul_rn(amax, __fdiv_rn(1.0f, qrange)) : 1.0f;
  if (threadIdx.x == 0) s[blockIdx.x] = scale;

  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const size_t start = row0 + (size_t)c * kVec;
    const int len = min(kVec, block - c * kVec);
    float v[kVec];
    load_chunk<T>(x, start, n, len, vec, v);
    alignas(8) int8_t o[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const float r = rintf(__fdiv_rn(v[u], scale));
      o[u] = (int8_t)(int)fminf(fmaxf(r, -qrange), qrange);
    }
    if (vec && len == kVec) {
      *reinterpret_cast<uint2*>(q + start) = *reinterpret_cast<uint2*>(o);
    } else {
      for (int u = 0; u < len; ++u) q[start + u] = o[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ s, T* __restrict__ out,
                      int64_t n, int block, bool vec) {
  const size_t row0 = (size_t)blockIdx.x * block;
  const int chunks = (block + kVec - 1) / kVec;
  const float scale = s[blockIdx.x];
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const size_t start = row0 + (size_t)c * kVec;
    const int len = min(kVec, block - c * kVec);
    if (vec && len == kVec && (int64_t)start + kVec <= n) {
      const uint2 raw = *reinterpret_cast<const uint2*>(q + start);
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
      float v[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) v[u] = __fmul_rn((float)e[u], scale);
      store_vec<T>(out + start, v);
    } else {
      for (int u = 0; u < len && (int64_t)start + u < n; ++u)
        out[start + u] = from_f32<T>(__fmul_rn((float)q[start + u], scale));
    }
  }
}

template <typename T>
static int launch_quantize(const void* x, void* q, void* s, int64_t n, int nb,
                           int block, float qrange, bool vec, void* stream) {
  quantize_kernel<T>
      <<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(s), n, block, qrange, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dequantize(const void* q, const void* s, void* out,
                             int64_t n, int nb, int block, bool vec,
                             void* stream) {
  dequantize_kernel<T>
      <<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(q), static_cast<const float*>(s),
          static_cast<T*>(out), n, block, vec);
  return (int)cudaGetLastError();
}

static bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

}  // namespace ds_quant

// x: n elements of `dtype`; q: [nb, block] int8; s: [nb] f32. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ds_quantize_blocks(const void* x, void* q, void* s, int64_t n,
                                  int nb, int block, int dtype, int bits,
                                  void* stream) {
  using namespace ds_quant;
  if (nb == 0) return 0;
  if (block < 1 || (bits != 8 && bits != 4)) return (int)cudaErrorInvalidValue;
  const float qrange = bits == 8 ? 127.0f : 7.0f;
  const bool vec = block % kVec == 0 && aligned(x, 16) && aligned(q, 8);
  switch (dtype) {
    case kF32:
      return launch_quantize<float>(x, q, s, n, nb, block, qrange, vec,
                                    stream);
    case kF16:
      return launch_quantize<__half>(x, q, s, n, nb, block, qrange, vec,
                                     stream);
    case kBF16:
      return launch_quantize<__nv_bfloat16>(x, q, s, n, nb, block, qrange,
                                            vec, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// q: [nb, block] int8; s: [nb] f32; out: the first n elements, in `dtype`.
extern "C" int ds_dequantize_blocks(const void* q, const void* s, void* out,
                                    int64_t n, int nb, int block, int dtype,
                                    void* stream) {
  using namespace ds_quant;
  if (nb == 0 || n == 0) return 0;
  if (block < 1) return (int)cudaErrorInvalidValue;
  const bool vec = block % kVec == 0 && aligned(q, 8) && aligned(out, 16);
  switch (dtype) {
    case kF32:
      return launch_dequantize<float>(q, s, out, n, nb, block, vec, stream);
    case kF16:
      return launch_dequantize<__half>(q, s, out, n, nb, block, vec, stream);
    case kBF16:
      return launch_dequantize<__nv_bfloat16>(q, s, out, n, nb, block, vec,
                                              stream);
  }
  return (int)cudaErrorInvalidValue;
}

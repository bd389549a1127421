// Dense-cache decode attention for Hopper (sm_90a): the v1 engine's decode.
//
// Replaces the TPU kernel deepspeed_tpu/ops/decode_attention.py:
// dense_decode_attention (:80) -> _kernel (:35).
//
// One query token per sequence attends over its dense cache: q [B, nh, hd],
// k/v_cache [B, kvh, M, hd], lengths [B] int32 (valid cache tokens including
// the current one, at most M) -> out [B, nh, hd]. One block per (row, kv
// head) holds the GQA group's q rows and streams that head's cache rows
// [0, length) once, in tiles of kTile contiguous slots, through the page
// walk the paged kernels share (page_walk.cuh, DenseSlots): no GQA repeat,
// nothing read past `length`, an f32 online softmax, and a row of length 0
// writes zeros. M need not be a multiple of the tile; lengths may differ
// per row.
//
// Bound on an H100: bytes. Each (row, kv head) must read 2 * length * hd
// elements of K and V once at 3.35 TB/s; the score and P.V work is
// 4 * group * hd flops per slot, far below the tensor-core line. The tile
// walk reads each used cache row once and keeps scores, softmax state and
// accumulator in shared memory. What it does not do yet: split a long cache
// over several blocks (B * kvh blocks leave SMs idle at small batch), or
// overlap the next tile's loads with the current tile's math.
#include "page_walk.cuh"

namespace ds_paged {

constexpr int kTile = 64;  // cache slots per walked tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_decode_attention_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k_cache,
                                  const T* __restrict__ v_cache,
                                  const int* __restrict__ lengths,
                                  T* __restrict__ out, int nh, int kvh, int hd,
                                  int m, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = nh / kvh;
  const size_t rows = ((size_t)b * nh + (size_t)h * group) * hd;
  int length = lengths[b];
  if (length > m) length = m;  // a bound past the cache has no slots
  const DenseSlots slots{((size_t)b * kvh + h) * m * hd, hd, kTile};
  attend_row<T, T>(q + rows, k_cache, v_cache, nullptr, nullptr, slots,
                   length, (m + kTile - 1) / kTile, hd, kTile, group, scale,
                   out + rows);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, int b, int nh, int kvh,
                  int hd, int m, float scale, void* stream) {
  const size_t smem = smem_bytes<T>(hd, kTile, nh / kvh);
  cudaError_t err = prepare_smem(dense_decode_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dense_decode_attention_kernel<T>
      <<<dim3(b, kvh), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(lengths),
          static_cast<T*>(out), nh, kvh, hd, m, scale);
  return (int)cudaGetLastError();
}

}  // namespace ds_paged

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ds_dense_decode_attention(const void* q, const void* k_cache,
                                         const void* v_cache,
                                         const void* lengths, void* out, int b,
                                         int nh, int kvh, int hd, int m,
                                         int dtype, float scale,
                                         void* stream) {
  using namespace ds_paged;
  if (b == 0) return 0;
  switch (dtype) {
    case kF32:
      return launch<float>(q, k_cache, v_cache, lengths, out, b, nh, kvh, hd,
                           m, scale, stream);
    case kF16:
      return launch<__half>(q, k_cache, v_cache, lengths, out, b, nh, kvh, hd,
                            m, scale, stream);
    case kBF16:
      return launch<__nv_bfloat16>(q, k_cache, v_cache, lengths, out, b, nh,
                                   kvh, hd, m, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

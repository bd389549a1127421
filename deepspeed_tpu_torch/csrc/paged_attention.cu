// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/inference/v2/kernels/
// paged_attention.py: paged_attention (:260) -> _dma_kernel (:126), with
// its shared _page_update (:62) and _finalize (:92); the BlockSpec variant
// paged_attention_pipelined (:337) computes the same function.
//
// One query token per sequence attends over its block table: q [N, nh, hd],
// pool [nb, bs, kvh, hd], block_tables [N, MB] int32, lengths [N] int32
// (valid tokens including the current one) -> out [N, nh, hd].
//
// Bound on an H100: bytes. Each (sequence, kv head) must read its used K
// and V pages once, 2 * length * hd * sizeof(T) bytes, at 3.35 TB/s; the
// score and P.V work is 4 * group * hd flops per slot, far below the
// tensor-core line. The design reads every used page exactly once per
// (sequence, kv head), never the null-padded table tail, and keeps the
// scores, softmax state and accumulator in shared memory, so nothing but
// the output goes back to device memory. What it does not do yet: split
// the page walk of a long sequence over several blocks (one block per
// (sequence, kv head) leaves most SMs idle at small batch), or pipeline the
// next page's loads under the current page's math (cp.async / TMA).
#include "page_walk.cuh"

namespace ds_paged {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_attention_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k_cache,
                                  const T* __restrict__ v_cache,
                                  const int* __restrict__ block_tables,
                                  const int* __restrict__ lengths,
                                  T* __restrict__ out, int nh, int kvh, int hd,
                                  int bs, int mb, float scale) {
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int group = nh / kvh;
  const size_t rows = ((size_t)n * nh + (size_t)h * group) * hd;
  attend_row<T>(q + rows, k_cache, v_cache, block_tables + (size_t)n * mb,
                lengths[n], mb, h, kvh, hd, bs, group, scale, out + rows);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const int* tables, const int* lengths, void* out, int n,
                  int nh, int kvh, int hd, int bs, int mb, float scale,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(hd, bs, nh / kvh);
  cudaError_t err = prepare_smem(paged_decode_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_attention_kernel<T>
      <<<dim3(n, kvh), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), tables, lengths, static_cast<T*>(out), nh,
          kvh, hd, bs, mb, scale);
  return (int)cudaGetLastError();
}

}  // namespace ds_paged

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ds_paged_decode_attention(const void* q, const void* k_cache,
                                         const void* v_cache,
                                         const void* block_tables,
                                         const void* lengths, void* out, int n,
                                         int nh, int kvh, int hd, int bs,
                                         int mb, int dtype, float scale,
                                         void* stream) {
  using namespace ds_paged;
  if (n == 0) return 0;
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(q, k_cache, v_cache, tables, lens, out, n, nh, kvh,
                           hd, bs, mb, scale, s);
    case kF16:
      return launch<__half>(q, k_cache, v_cache, tables, lens, out, n, nh,
                            kvh, hd, bs, mb, scale, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, k_cache, v_cache, tables, lens, out, n,
                                   nh, kvh, hd, bs, mb, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

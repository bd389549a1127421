// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/inference/v2/kernels/
// paged_attention.py: paged_attention (:260) -> _dma_kernel (:126), with
// its shared _page_update (:62) and _finalize (:92), and for the int8
// kv_quant pool _dma_kernel_quant (:175) with _dequant_tile (:51); the
// BlockSpec variants paged_attention_pipelined (:337) -> _kernel (:101) /
// _kernel_quant (:230) compute the same functions.
//
// One query token per sequence attends over its block table: q [N, nh, hd],
// pool [nb, bs, kvh, hd], block_tables [N, MB] int32, lengths [N] int32
// (valid tokens including the current one) -> out [N, nh, hd]. The int8
// entry point takes an int8 pool and its per-(block, head) f32 scales
// [nb, kvh], and dequantizes each page tile on load (page_walk.cuh).
//
// Bound on an H100: bytes. Each (sequence, kv head) must read its used K
// and V pages once, 2 * length * hd * sizeof(pool element) bytes (plus one
// f32 scale per page and head for int8), at 3.35 TB/s; the score and P.V
// work is 4 * group * hd flops per slot, far below the tensor-core line.
// The design reads every used page exactly once per (sequence, kv head),
// never the null-padded table tail, and keeps the scores, softmax state and
// accumulator in shared memory, so nothing but the output goes back to
// device memory; int8 pages halve the bytes of a bf16 pool. What it does
// not do yet: split the page walk of a long sequence over several blocks
// (one block per (sequence, kv head) leaves most SMs idle at small batch),
// or pipeline the next page's loads under the current page's math
// (cp.async / TMA).
#include "page_walk.cuh"

namespace ds_paged {

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    paged_decode_attention_kernel(const T* __restrict__ q,
                                  const S* __restrict__ k_cache,
                                  const S* __restrict__ v_cache,
                                  const float* __restrict__ k_scale,
                                  const float* __restrict__ v_scale,
                                  const int* __restrict__ block_tables,
                                  const int* __restrict__ lengths,
                                  T* __restrict__ out, int nh, int kvh, int hd,
                                  int bs, int mb, float scale) {
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int group = nh / kvh;
  const size_t rows = ((size_t)n * nh + (size_t)h * group) * hd;
  const PagedSlots slots{block_tables + (size_t)n * mb, h, kvh, hd, bs};
  attend_row<T, S>(q + rows, k_cache, v_cache, k_scale, v_scale, slots,
                   lengths[n], mb, hd, bs, group, scale, out + rows);
}

template <typename T, typename S>
static int launch(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* tables,
                  const void* lengths, void* out, int n, int nh, int kvh,
                  int hd, int bs, int mb, float scale, void* stream) {
  const size_t smem = smem_bytes<T>(hd, bs, nh / kvh);
  cudaError_t err = prepare_smem(paged_decode_attention_kernel<T, S>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_attention_kernel<T, S>
      <<<dim3(n, kvh), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const S*>(k),
          static_cast<const S*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(tables),
          static_cast<const int*>(lengths), static_cast<T*>(out), nh, kvh, hd,
          bs, mb, scale);
  return (int)cudaGetLastError();
}

template <bool Q8>
static int dispatch(int dtype, const void* q, const void* k, const void* v,
                    const void* ks, const void* vs, const void* tables,
                    const void* lengths, void* out, int n, int nh, int kvh,
                    int hd, int bs, int mb, float scale, void* stream) {
  if (n == 0) return 0;
  switch (dtype) {
    case kF32:
      return launch<float, Pool<float, Q8>>(q, k, v, ks, vs, tables, lengths,
                                            out, n, nh, kvh, hd, bs, mb, scale,
                                            stream);
    case kF16:
      return launch<__half, Pool<__half, Q8>>(q, k, v, ks, vs, tables,
                                              lengths, out, n, nh, kvh, hd, bs,
                                              mb, scale, stream);
    case kBF16:
      return launch<__nv_bfloat16, Pool<__nv_bfloat16, Q8>>(
          q, k, v, ks, vs, tables, lengths, out, n, nh, kvh, hd, bs, mb, scale,
          stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ds_paged

// Returns the cudaError_t of the launch (0 on success). Pool in q's dtype.
extern "C" int ds_paged_decode_attention(const void* q, const void* k_cache,
                                         const void* v_cache,
                                         const void* block_tables,
                                         const void* lengths, void* out, int n,
                                         int nh, int kvh, int hd, int bs,
                                         int mb, int dtype, float scale,
                                         void* stream) {
  return ds_paged::dispatch<false>(dtype, q, k_cache, v_cache, nullptr,
                                   nullptr, block_tables, lengths, out, n, nh,
                                   kvh, hd, bs, mb, scale, stream);
}

// The int8 kv_quant pool: k/v_cache int8 [nb, bs, kvh, hd], k/v_scale f32
// [nb, kvh]; q and out in the io dtype.
extern "C" int ds_paged_decode_attention_q8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, int n, int nh, int kvh, int hd, int bs,
    int mb, int dtype, float scale, void* stream) {
  return ds_paged::dispatch<true>(dtype, q, k_cache, v_cache, k_scale,
                                  v_scale, block_tables, lengths, out, n, nh,
                                  kvh, hd, bs, mb, scale, stream);
}

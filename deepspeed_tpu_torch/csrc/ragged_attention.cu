// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/inference/v2/kernels/
// ragged_attention.py: ragged_attention (:234) -> _ragged_dma_kernel (:99),
// and for the int8 kv_quant pool _ragged_dma_kernel_quant (:150); the
// BlockSpec variants ragged_attention_pipelined (:314) -> _ragged_kernel
// (:72) / _ragged_kernel_quant (:205) compute the same functions.
//
// A flat token buffer of mixed prefill, continuation and decode rows:
// q [T, nh, hd], row_ids [T] (token -> batch row), lengths [T] (per-token
// causal bound, 0 = padding), block_tables [R, MB] int32, pool
// [nb, bs, kvh, hd] -> out [T, nh, hd]. Each token walks the pages of its
// row's table that its own bound covers, so in-chunk causality and the
// cached prefix are one page walk; padding tokens write exact zeros. The
// int8 entry point takes an int8 pool and its per-(block, head) f32 scales
// [nb, kvh] and dequantizes each page tile on load.
//
// Bound on an H100: bytes for decode-heavy batches (each row's used K/V
// pages, read once per (row, kv head), at 3.35 TB/s); a long prefill chunk
// adds 4 * nh * hd flops per (token, attended slot) and can cross to the
// operation side. The design walks the pages of page_walk.cuh, one block
// per (token, kv head). A pure-decode batch agrees with the paged decode
// kernel (a split-K walk, split_walk.cuh) to f32 rounding, not bit for
// bit: the two reduce in another order. Its known waste: a prefill chunk
// re-reads its row's shared prefix once per token; tiling the queries of
// one row into one block (the lever named in the TPU kernel's note,
// :50-58) would read it once per tile.
#include "page_walk.cuh"

namespace ds_paged {

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    ragged_paged_attention_kernel(const T* __restrict__ q,
                                  const S* __restrict__ k_cache,
                                  const S* __restrict__ v_cache,
                                  const float* __restrict__ k_scale,
                                  const float* __restrict__ v_scale,
                                  const int* __restrict__ row_ids,
                                  const int* __restrict__ lengths,
                                  const int* __restrict__ block_tables,
                                  T* __restrict__ out, int nh, int kvh, int hd,
                                  int bs, int mb, float scale) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int group = nh / kvh;
  const size_t rows = ((size_t)t * nh + (size_t)h * group) * hd;
  const PagedSlots slots{block_tables + (size_t)row_ids[t] * mb, h, kvh, hd,
                         bs};
  attend_row<T, S>(q + rows, k_cache, v_cache, k_scale, v_scale, slots,
                   lengths[t], mb, hd, bs, group, scale, out + rows);
}

template <typename T, typename S>
static int launch(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* row_ids,
                  const void* lengths, const void* tables, void* out, int n,
                  int nh, int kvh, int hd, int bs, int mb, float scale,
                  void* stream) {
  const size_t smem = smem_bytes<T>(hd, bs, nh / kvh);
  cudaError_t err = prepare_smem(ragged_paged_attention_kernel<T, S>, smem);
  if (err != cudaSuccess) return (int)err;
  ragged_paged_attention_kernel<T, S>
      <<<dim3(n, kvh), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const S*>(k),
          static_cast<const S*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(row_ids),
          static_cast<const int*>(lengths), static_cast<const int*>(tables),
          static_cast<T*>(out), nh, kvh, hd, bs, mb, scale);
  return (int)cudaGetLastError();
}

template <bool Q8>
static int dispatch(int dtype, const void* q, const void* k, const void* v,
                    const void* ks, const void* vs, const void* row_ids,
                    const void* lengths, const void* tables, void* out, int n,
                    int nh, int kvh, int hd, int bs, int mb, float scale,
                    void* stream) {
  if (n == 0) return 0;
  switch (dtype) {
    case ds_vec::kF32:
      return launch<float, Pool<float, Q8>>(q, k, v, ks, vs, row_ids, lengths,
                                            tables, out, n, nh, kvh, hd, bs,
                                            mb, scale, stream);
    case ds_vec::kF16:
      return launch<__half, Pool<__half, Q8>>(q, k, v, ks, vs, row_ids,
                                              lengths, tables, out, n, nh, kvh,
                                              hd, bs, mb, scale, stream);
    case ds_vec::kBF16:
      return launch<__nv_bfloat16, Pool<__nv_bfloat16, Q8>>(
          q, k, v, ks, vs, row_ids, lengths, tables, out, n, nh, kvh, hd, bs,
          mb, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ds_paged

// Returns the cudaError_t of the launch (0 on success). Pool in q's dtype.
extern "C" int ds_ragged_paged_attention(const void* q, const void* k_cache,
                                         const void* v_cache,
                                         const void* row_ids,
                                         const void* lengths,
                                         const void* block_tables, void* out,
                                         int n, int nh, int kvh, int hd,
                                         int bs, int mb, int dtype,
                                         float scale, void* stream) {
  return ds_paged::dispatch<false>(dtype, q, k_cache, v_cache, nullptr,
                                   nullptr, row_ids, lengths, block_tables,
                                   out, n, nh, kvh, hd, bs, mb, scale, stream);
}

// The int8 kv_quant pool: k/v_cache int8 [nb, bs, kvh, hd], k/v_scale f32
// [nb, kvh]; q and out in the io dtype.
extern "C" int ds_ragged_paged_attention_q8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* row_ids,
    const void* lengths, const void* block_tables, void* out, int n, int nh,
    int kvh, int hd, int bs, int mb, int dtype, float scale, void* stream) {
  return ds_paged::dispatch<true>(dtype, q, k_cache, v_cache, k_scale,
                                  v_scale, row_ids, lengths, block_tables, out,
                                  n, nh, kvh, hd, bs, mb, scale, stream);
}

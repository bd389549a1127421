// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/inference/v2/kernels/
// ragged_attention.py: ragged_attention (:234) -> _ragged_dma_kernel (:99);
// the BlockSpec variant ragged_attention_pipelined (:314) computes the same
// function.
//
// A flat token buffer of mixed prefill, continuation and decode rows:
// q [T, nh, hd], row_ids [T] (token -> batch row), lengths [T] (per-token
// causal bound, 0 = padding), block_tables [R, MB] int32, pool
// [nb, bs, kvh, hd] -> out [T, nh, hd]. Each token walks the pages of its
// row's table that its own bound covers, so in-chunk causality and the
// cached prefix are one page walk; padding tokens write exact zeros.
//
// Bound on an H100: bytes for decode-heavy batches (each row's used K/V
// pages, read once per (row, kv head), at 3.35 TB/s); a long prefill chunk
// adds 4 * nh * hd flops per (token, attended slot) and can cross to the
// operation side. The design shares the decode kernel's page walk
// (page_walk.cuh) and launch geometry, one block per (token, kv head), so a
// decode row costs exactly what the decode kernel costs and a pure-decode
// batch is bit-identical to it. Its known waste: a prefill chunk re-reads
// its row's shared prefix once per token; tiling the queries of one row
// into one block (the lever named in the TPU kernel's note, :50-58) would
// read it once per tile.
#include "page_walk.cuh"

namespace ds_paged {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ragged_paged_attention_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k_cache,
                                  const T* __restrict__ v_cache,
                                  const int* __restrict__ row_ids,
                                  const int* __restrict__ lengths,
                                  const int* __restrict__ block_tables,
                                  T* __restrict__ out, int nh, int kvh, int hd,
                                  int bs, int mb, float scale) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int group = nh / kvh;
  const size_t rows = ((size_t)t * nh + (size_t)h * group) * hd;
  attend_row<T>(q + rows, k_cache, v_cache,
                block_tables + (size_t)row_ids[t] * mb, lengths[t], mb, h, kvh,
                hd, bs, group, scale, out + rows);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const int* row_ids, const int* lengths, const int* tables,
                  void* out, int n, int nh, int kvh, int hd, int bs, int mb,
                  float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(hd, bs, nh / kvh);
  cudaError_t err = prepare_smem(ragged_paged_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ragged_paged_attention_kernel<T>
      <<<dim3(n, kvh), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), row_ids, lengths, tables,
          static_cast<T*>(out), nh, kvh, hd, bs, mb, scale);
  return (int)cudaGetLastError();
}

}  // namespace ds_paged

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ds_ragged_paged_attention(const void* q, const void* k_cache,
                                         const void* v_cache,
                                         const void* row_ids,
                                         const void* lengths,
                                         const void* block_tables, void* out,
                                         int n, int nh, int kvh, int hd,
                                         int bs, int mb, int dtype,
                                         float scale, void* stream) {
  using namespace ds_paged;
  if (n == 0) return 0;
  const int* rows = static_cast<const int*>(row_ids);
  const int* lens = static_cast<const int*>(lengths);
  const int* tables = static_cast<const int*>(block_tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(q, k_cache, v_cache, rows, lens, tables, out, n,
                           nh, kvh, hd, bs, mb, scale, s);
    case kF16:
      return launch<__half>(q, k_cache, v_cache, rows, lens, tables, out, n,
                            nh, kvh, hd, bs, mb, scale, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, k_cache, v_cache, rows, lens, tables,
                                   out, n, nh, kvh, hd, bs, mb, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

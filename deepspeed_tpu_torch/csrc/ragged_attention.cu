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
// [nb, bs, kvh, hd] -> out [T, nh, hd]. Each token attends to slots
// [0, lengths[t]) of its row's table, capped at the table width; padding
// tokens write exact zeros. The int8 entry points take an int8 pool and
// its per-(block, head) f32 scales [nb, kvh] and dequantize each page tile
// on load.
//
// Bound on an H100: a prefill-heavy batch is bound by operations and
// bytes alike (4 * nh * hd flops per (token, attended slot); q, out and
// each row's used K/V once); a decode-heavy one by bytes. Two routes, the
// wrapper's choice (ragged_attention.py, ragged_route):
//
//   * tiles (bf16 / fp16 q, head_dim 64 or 128, bs a multiple of 8, both
//     pools): two launches a call. The tokens of runs of two or more
//     tokens go to the tensor-core query tiles of ragged_hopper.cuh
//     (ds_ragged_tiles, here), which read a row's prefix once per 64-token
//     tile, not once per token, and write the padding tokens' zeros; the
//     runs of one token (decode rows) go to the paged decode kernel's
//     split-K walk (paged_attention.cu, ragged_singleton_kernel through
//     ds_paged_decode_rows). Which token goes where is decided on the card
//     from each token and its neighbours (ragged_runs.cuh), so a call reads
//     nothing back. A single-token run takes the decode plan for the
//     table's R rows, so a pure-decode batch gets the paged decode
//     kernel's arithmetic bit for bit, as the JAX docstring's invariant
//     asks (ragged_attention.py:46-48), and a long decode row in a mixed
//     batch is split over blocks. The tile launch's first block scans the
//     buffer for each single-token run's rank among them (a rank >= R,
//     which ragged.batch.pack never lays out, takes the plan for T).
//   * page walk (f32 q, and the shapes the tiles do not take): one launch
//     of the kernel below, one block per (token, kv head) walking its pages
//     (page_walk.cuh). It agrees with the paged decode kernel to f32
//     rounding, not bit for bit (another reduction order), and re-reads a
//     chunk's shared prefix once per token.
#include "page_walk.cuh"
#include "ragged_hopper.cuh"

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

namespace ds_ragged {

// A [rows, heads, D] tensor as the 3-D map {D, heads, rows} with boxes of
// `inner` columns x 1 head x `box_rows` rows: 16-bit (128-byte swizzle) or
// int8 (no swizzle). Returns false if the encoding is refused.
static bool make_map3(CUtensorMap* map, const void* ptr, int elem, int d,
                      int heads, long long rows, int inner, int box_rows,
                      CUtensorMapDataType type, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * elem,
                                 (cuuint64_t)d * elem * heads};
  const cuuint32_t box[3] = {(cuuint32_t)inner, 1, (cuuint32_t)box_rows};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Slots per pool box: the largest power of two that divides bs, at most a
// tile (bs a multiple of 8).
static int box_rows(int bs) {
  int b = bs & -bs;
  return b > kWin ? kWin : b;
}

// Two q heads per block where the group is even, else one.
static int heads_per_block(int nh, int kvh) {
  return (nh / kvh) % 2 == 0 ? 2 : 1;
}

template <typename T, typename S, int D>
static int tiles(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* row_ids, const void* lengths,
                 const void* tables, void* out, void* rank, void* scan, int n,
                 int nh, int kvh, int bs, int mb, int nb, float scale,
                 cudaStream_t stream) {
  constexpr bool kQ8 = std::is_same<S, int8_t>::value;
  const CUtensorMapDataType t16 = std::is_same<T, __half>::value
                                      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int box = box_rows(bs);
  const long long slots = (long long)nb * bs;
  CUtensorMap tq, tk, tv;
  bool ok = make_map3(&tq, q, 2, D, nh, n, 64, kWin, t16,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (kQ8) {
    ok = ok && make_map3(&tk, k, 1, D, kvh, slots, D, box,
                         CU_TENSOR_MAP_DATA_TYPE_UINT8,
                         CU_TENSOR_MAP_SWIZZLE_NONE)
         && make_map3(&tv, v, 1, D, kvh, slots, D, box,
                      CU_TENSOR_MAP_DATA_TYPE_UINT8,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    ok = ok && make_map3(&tk, k, 2, D, kvh, slots, 64, box, t16,
                         CU_TENSOR_MAP_SWIZZLE_128B)
         && make_map3(&tv, v, 2, D, kvh, slots, 64, box, t16,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = ragged_tile_kernel<T, S, D>;
  constexpr int smem = TileSmem<D, kQ8>::kBytes;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int heads = heads_per_block(nh, kvh);
  // one row of blocks per 64-token window, and the scan block's row
  kernel<<<dim3(nh / heads, (n + kWin - 1) / kWin + 1), kRaggedThreads, smem,
           stream>>>(tq, tk, tv, static_cast<const float*>(ks),
                     static_cast<const float*>(vs),
                     static_cast<const int*>(row_ids),
                     static_cast<const int*>(lengths),
                     static_cast<const int*>(tables), static_cast<T*>(out),
                     static_cast<int*>(rank), static_cast<int*>(scan), n, nh,
                     kvh, heads, bs, mb, box, scale);
  return (int)cudaGetLastError();
}

// Calls run(T(), S(), std::integral_constant<int, D>()) for the tile
// route's io dtype, pool and head_dim.
template <bool Q8, typename Run>
static int with_tile_types(int dtype, int hd, Run run) {
  auto pick = [&](auto t) {
    using T = decltype(t);
    using S = typename std::conditional<Q8, int8_t, T>::type;
    if (hd == 64) return run(T(), S(), std::integral_constant<int, 64>());
    if (hd == 128) return run(T(), S(), std::integral_constant<int, 128>());
    return (int)cudaErrorInvalidValue;
  };
  switch (dtype) {
    case ds_vec::kF16: return pick(__half());
    case ds_vec::kBF16: return pick(__nv_bfloat16());
  }
  return (int)cudaErrorInvalidValue;
}

template <bool Q8>
static int dispatch_tiles(int dtype, const void* q, const void* k,
                          const void* v, const void* ks, const void* vs,
                          const void* row_ids, const void* lengths,
                          const void* tables, void* out, void* rank,
                          void* scan, int n, int nh, int kvh, int hd, int bs,
                          int mb, int nb, float scale, void* stream) {
  if (n == 0) return 0;
  if (bs <= 0 || bs % 8 || nh % kvh) return (int)cudaErrorInvalidValue;
  return with_tile_types<Q8>(dtype, hd, [&](auto t, auto s, auto d) {
    return tiles<decltype(t), decltype(s), decltype(d)::value>(
        q, k, v, ks, vs, row_ids, lengths, tables, out, rank, scan, n, nh,
        kvh, bs, mb, nb, scale, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace ds_ragged

// The page walk route. Returns the cudaError_t of the launch (0 on
// success). Pool in q's dtype.
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

// The tile route's query tiles (the tokens of runs of two or more tokens,
// and the padding tokens' zeros; the single-token runs are
// ds_paged_decode_rows's) and the scan that launch reads (rank int32 [n],
// scan int32 [1]; ds_ragged::scan_runs): q / out bf16 or fp16 [n, nh, hd],
// hd 64 or 128, bs a multiple of 8, nb the pool's blocks; k_scale /
// v_scale null for a pool in q's dtype, else the int8 pool's [nb, kvh]
// scales. Returns a cudaError_t.
extern "C" int ds_ragged_tiles(const void* q, const void* k_cache,
                               const void* v_cache, const void* k_scale,
                               const void* v_scale, const void* row_ids,
                               const void* lengths, const void* block_tables,
                               void* out, void* rank, void* scan, int n,
                               int nh, int kvh, int hd, int bs, int mb, int nb,
                               int dtype, float scale, void* stream) {
  if (k_scale != nullptr)
    return ds_ragged::dispatch_tiles<true>(
        dtype, q, k_cache, v_cache, k_scale, v_scale, row_ids, lengths,
        block_tables, out, rank, scan, n, nh, kvh, hd, bs, mb, nb, scale,
        stream);
  return ds_ragged::dispatch_tiles<false>(
      dtype, q, k_cache, v_cache, nullptr, nullptr, row_ids, lengths,
      block_tables, out, rank, scan, n, nh, kvh, hd, bs, mb, nb, scale,
      stream);
}

// The tile kernel's resources for (dtype, hd, pool): out[0] registers,
// [1] local (spilled) bytes per thread, [2] dynamic shared memory bytes,
// [3] blocks per SM. Returns a cudaError_t.
extern "C" int ds_ragged_tiles_info(int dtype, int hd, int q8, int* out) {
  auto run = [&](auto t, auto s, auto d) {
    using T = decltype(t);
    using S = decltype(s);
    constexpr int D = decltype(d)::value;
    auto kernel = ds_ragged::ragged_tile_kernel<T, S, D>;
    constexpr int smem =
        ds_ragged::TileSmem<D, std::is_same<S, int8_t>::value>::kBytes;
    int info[3];
    cudaError_t err = ds_hopper::kernel_info(kernel, smem, info);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = info[0];
    out[1] = (int)attr.localSizeBytes;
    out[2] = info[1];
    out[3] = info[2];
    return 0;
  };
  return q8 ? ds_ragged::with_tile_types<true>(dtype, hd, run)
            : ds_ragged::with_tile_types<false>(dtype, hd, run);
}

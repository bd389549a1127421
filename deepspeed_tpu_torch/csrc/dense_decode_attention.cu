// Dense-cache decode attention for Hopper (sm_90a): the v1 engine's decode.
//
// Replaces the TPU kernel deepspeed_tpu/ops/decode_attention.py:
// dense_decode_attention (:80) -> _kernel (:35).
//
// One query token per sequence attends over its dense cache: q [B, nh, hd],
// k/v_cache [B, kvh, M, hd], lengths [B] int32 (valid cache tokens including
// the current one, clamped to M) -> out [B, nh, hd]. The `group` q heads
// that share kv head h are served together (no GQA repeat); scores are f32
// times `scale` with an f32 online softmax; nothing is read past `length`,
// and a row of length 0 writes zeros. M need not be a multiple of the tile;
// lengths may differ per row.
//
// Bound on an H100: bytes (2 * length * hd elements of K and V per (row,
// kv head), read once at 3.35 TB/s). The kernel is the split-K walk of
// split_walk.cuh (grid (B * kvh, n_split) from ops/decode_attention.py's
// split_plan, a cp.async.bulk K/V ring, lane and generic routes, an
// in-launch combine in split order); this file says where a row's slots
// lie: a chunk of one (row, kv head) is one contiguous span of the cache,
// so one lane of the producer warp copies a tile's K and its V with one
// cp.async.bulk each.
#include "split_walk.cuh"

namespace ds_decode {

using namespace ds_split;

// One (row, kv head) of a dense cache: `base` is the cache row of its slot 0.
template <typename T>
struct DenseSource {
  static constexpr int kProducerLanes = 1;  // one thread copies
  static constexpr int kArrivals = 1;       // its expect_tx
  const T* k;
  const T* v;
  size_t base;
  int hd;
  __device__ __forceinline__ void issue(int slot0, int n_valid, T* k_dst,
                                        T* v_dst, float*, uint64_t* bar,
                                        int) const {
    const uint32_t bytes = (uint32_t)n_valid * hd * sizeof(T);
    const size_t row = (base + slot0) * hd;
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(k_dst, k + row, bytes, bar);
    bulk_load(v_dst, v + row, bytes, bar);
  }
};

// G: the group size on the lane route, 0 on the generic route.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    dense_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_cache,
                              const T* __restrict__ v_cache,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, float* __restrict__ ws_ml,
                              float* __restrict__ ws_acc,
                              int* __restrict__ tickets, int nh, int kvh,
                              int hd, int m, int chunk, float scale) {
  const int pair = blockIdx.x;
  int length = lengths[pair / kvh];
  length = length < 0 ? 0 : length > m ? m : length;
  const DenseSource<T> src{k_cache, v_cache, (size_t)pair * m, hd};
  split_walk<T, T, G>(src, q, out, ws_ml, ws_acc, tickets, pair, pair,
                      blockIdx.y, gridDim.y, nh, kvh, hd, kTile, length,
                      chunk, scale);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, void* ws_ml, void* ws_acc,
                  void* tickets, int b, int nh, int kvh, int hd, int m,
                  int chunk, int n_split, float scale, void* stream) {
  const int group = nh / kvh;
  const Layout L = layout(hd, group, (int)sizeof(T), (int)sizeof(T), kTile);
  return dispatch_group<T>(group, hd, [&](auto g) {
    return launch_walk(dense_decode_split_kernel<T, decltype(g)::value>, L,
                       b * kvh, n_split, stream, static_cast<const T*>(q),
                       static_cast<const T*>(k), static_cast<const T*>(v),
                       static_cast<const int*>(lengths), static_cast<T*>(out),
                       static_cast<float*>(ws_ml), static_cast<float*>(ws_acc),
                       static_cast<int*>(tickets), nh, kvh, hd, m, chunk,
                       scale);
  });
}

}  // namespace ds_decode

// Returns the cudaError_t of the launch (0 on success). chunk is a multiple
// of 64 slots and n_split * chunk >= m (the wrapper's split_plan).
extern "C" int ds_dense_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* out, void* ws_ml, void* ws_acc, void* tickets,
    int b, int nh, int kvh, int hd, int m, int chunk, int n_split, int dtype,
    float scale, void* stream) {
  using namespace ds_decode;
  if (b == 0) return 0;
  if (chunk <= 0 || chunk % kTile || n_split < 1
      || (long long)n_split * chunk < m)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case ds_vec::kF32:
      return launch<float>(q, k_cache, v_cache, lengths, out, ws_ml, ws_acc,
                           tickets, b, nh, kvh, hd, m, chunk, n_split, scale,
                           stream);
    case ds_vec::kF16:
      return launch<__half>(q, k_cache, v_cache, lengths, out, ws_ml, ws_acc,
                            tickets, b, nh, kvh, hd, m, chunk, n_split, scale,
                            stream);
    case ds_vec::kBF16:
      return launch<__nv_bfloat16>(q, k_cache, v_cache, lengths, out, ws_ml,
                                   ws_acc, tickets, b, nh, kvh, hd, m, chunk,
                                   n_split, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

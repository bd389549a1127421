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
// (valid tokens including the current one, clamped to MB * bs) -> out
// [N, nh, hd]. The int8 entry point takes an int8 pool and its
// per-(block, head) f32 scales [nb, kvh].
//
// Bound on an H100: bytes. Each (sequence, kv head) must read its used K
// and V slots once, 2 * length * hd * sizeof(pool element) bytes (plus one
// f32 scale per page and head for int8), at 3.35 TB/s; the score and P.V
// work is 4 * group * hd flops per slot, far below the tensor-core line.
// The kernel is the split-K walk of split_walk.cuh, shared with the dense
// decode kernel: grid (N * kvh, n_split) from the wrapper's
// page_split_plan (chunks of whole pages, ~5 blocks per SM if every row
// filled its table; 704 blocks at N 8, kvh 8, MB 32, bs 64, of which the
// chunks past a row's length return at once), a two-stage K/V ring filled
// by one producer warp, q and the accumulator in registers on the lane
// route (Mistral-7B's group 4 at head_dim 128), and the last block of a
// (sequence, kv head) combining the chunks' partials in split order in the
// same launch, so a call is one launch and a repeat is bit-identical. A
// block never reads the table past its chunk, nor a slot past `length`:
// only the valid slots of a row's last page are copied. The same walk
// serves the single-token runs of a ragged batch (ragged_singleton_kernel,
// ds_paged_decode_rows: the tile route of ragged_attention.cu), reading
// each token's table through its row id.
//
// How a page arrives. A page's tile for one kv head is `bs` rows of hd
// elements at a stride of kvh * hd: not contiguous. The 32 lanes of the
// producer warp copy its rows in 16-byte pieces with cp.async, each lane
// arriving on the stage's full barrier when its pieces have landed. Two
// other ways were weighed. One cp.async.bulk per row (the first version)
// hands the copy engine one request per 256-byte row, and the engine takes
// them one at a time: on an H100 that copied a page slower than the
// cp.async pieces do. One TMA load per page over a
// 3-D tensor map of the pool would be one request a page, but the map
// must be encoded on the host for each layer's pool, which adds host time
// to a decode step that is already bound by the host, and its fixed box
// would read a last page's slots past `length`. A row is 16-byte aligned
// (the wrapper checks hd * element size % 16 == 0): 256 bytes for bf16 at
// hd 128, 128 for int8. An int8 pool's tile carries one K and one V scale
// (its page and kv head): lane 0 of the producer reads them and stages
// them in shared memory, then arrives on the full barrier itself (a
// release that publishes them); the consumers read them there and
// dequantize as they read K and V (_dequant_tile's rounding through T).
#include "ragged_runs.cuh"
#include "split_walk.cuh"

namespace ds_paged_decode {

using namespace ds_split;

// One (sequence, kv head) of a paged pool [nb, bs, kvh, hd], through the
// sequence's block table. S: the stored element (T, or int8_t with scales
// [nb, kvh]).
template <typename S>
struct PagedSource {
  static constexpr int kProducerLanes = 32;
  // the producer lanes' cp.async arrivals and lane 0's own, which
  // publishes the stage's scales
  static constexpr int kArrivals = 33;
  const S* k;
  const S* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  int kv_head, kvh, hd, bs;
  __device__ __forceinline__ void issue(int slot0, int n_valid, S* k_dst,
                                        S* v_dst, float* scl, uint64_t* bar,
                                        int lane) const {
    const int j = slot0 / bs;  // a tile lies within one page
    const size_t page = (size_t)table[j];
    if (lane == 0) {
      if constexpr (std::is_same<S, int8_t>::value) {
        scl[0] = k_scale[page * kvh + kv_head];
        scl[1] = v_scale[page * kvh + kv_head];
      }
      mbar_arrive(bar);
    }
    // slot r of the tile is pool row (page * bs + slot0 % bs + r), whose
    // 16-byte pieces the lanes copy in turn; rows land back to back
    const int pieces = hd * (int)sizeof(S) / 16;  // per row
    const size_t row0 = (page * bs + (slot0 - j * bs)) * kvh + kv_head;
    const char* kg = reinterpret_cast<const char*>(k);
    const char* vg = reinterpret_cast<const char*>(v);
    char* kd = reinterpret_cast<char*>(k_dst);
    char* vd = reinterpret_cast<char*>(v_dst);
    for (int i = lane; i < n_valid * pieces; i += 32) {
      const int r = i / pieces;
      const size_t off = (row0 + (size_t)r * kvh) * hd * sizeof(S) +
                         (size_t)(i - r * pieces) * 16;
      cp_async16(kd + (size_t)i * 16, kg + off);
      cp_async16(vd + (size_t)i * 16, vg + off);
    }
    cp_async_arrive(bar);
  }
};

// G: the group size on the lane route, 0 on the generic route.
template <typename T, typename S, int G>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(const T* __restrict__ q,
                              const S* __restrict__ k_cache,
                              const S* __restrict__ v_cache,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, float* __restrict__ ws_ml,
                              float* __restrict__ ws_acc,
                              int* __restrict__ tickets, int nh, int kvh,
                              int hd, int bs, int mb, int chunk,
                              float scale) {
  const int pair = blockIdx.x;
  const int n = pair / kvh;
  int length = lengths[n];
  length = length < 0 ? 0 : length > mb * bs ? mb * bs : length;
  const PagedSource<S> src{k_cache, v_cache,  k_scale,    v_scale,
                           block_tables + (size_t)n * mb, pair % kvh,
                           kvh,     hd,       bs};
  split_walk<T, S, G>(src, q, out, ws_ml, ws_acc, tickets, pair, pair,
                      blockIdx.y, gridDim.y, nh, kvh, hd, bs, length, chunk,
                      scale);
}

// The single-token runs of a ragged batch (ragged_attention.cu's tile
// route; ragged_runs.cuh): the walk above for buffer token t with row
// row_ids[t]'s table, over grid (blocks, max(n_split, fine.n_split)).
// Each block takes the (token, kv head) pairs blockIdx.x + i * gridDim.x:
// its 160 threads classify 160 candidates at a time, and the block walks
// the single-token ones in order, chunk blockIdx.y of each, with the
// ring's barriers invalidated after each walk that initialized them.
//
// Chunks. A single-token run of rank r (its place among the batch's
// single-token runs, from the tile launch's scan) takes the plan for the
// table's R rows (`fine`) at the workspace slot r * kvh + head: the plan
// paged_attention uses for those R rows, so a pure-decode batch gets the
// decode kernel's arithmetic bit for bit, and a mixed batch's few decode
// rows are split over blocks as decode rows are. A rank >= R (more
// single-token runs than rows, which ragged.batch.pack never lays out)
// takes the plan for T rows (`chunk`, `n_split`) at the slot of its pair.
// (The minimum of one block per SM in the launch bounds keeps ptxas from
// capping registers: without it eleven variants spilled 8-48 bytes.)
struct FinePlan {
  const int* rank;   // [T]: place among the single-token runs, else -1
  const int* scan;   // [1]: the number of single-token runs
  int rows, chunk, n_split;
  float* ws_ml;
  float* ws_acc;
  int* tickets;
};

template <typename T, typename S, int G>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_singleton_kernel(const T* __restrict__ q,
                            const S* __restrict__ k_cache,
                            const S* __restrict__ v_cache,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, float* __restrict__ ws_ml,
                            float* __restrict__ ws_acc,
                            int* __restrict__ tickets, int nh, int kvh,
                            int hd, int bs, int mb, int chunk, float scale,
                            const int* __restrict__ row_ids, int n,
                            int n_split, const FinePlan fine) {
  // the picked pairs, then one count per warp (768 bytes, so that the
  // dynamic shared memory after it keeps its 128-byte alignment)
  __shared__ __align__(128) int picked[kThreads + 32];
  int* counts = picked + kThreads;
  const Layout L = layout(hd, G > 0 ? G : nh / kvh, (int)sizeof(T),
                          (int)sizeof(S), bs);
  if (fine.scan[0] == 0) return;  // no single-token run (a prefill step)
  const int pairs = n * kvh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int first = blockIdx.x; first < pairs;
       first += gridDim.x * kThreads) {
    const long long cand = first + (long long)tid * gridDim.x;
    bool keep = false;
    if (cand < pairs) {
      const int t = (int)(cand / kvh);
      keep = lengths[t] > 0 &&
             !ds_ragged_runs::in_multi_run(row_ids, lengths, n, t);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int at = __popc(ballot & ((1u << lane) - 1)), total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      at += w < warp ? counts[w] : 0;
      total += counts[w];
    }
    if (keep) picked[at] = (int)cand;
    __syncthreads();
    for (int i = 0; i < total; ++i) {
      const int pair = picked[i];
      const int t = pair / kvh, head = pair % kvh;
      const int r = fine.rank[t];
      const bool f = r < fine.rows;
      int length = lengths[t];
      length = length > mb * bs ? mb * bs : length;
      const PagedSource<S> src{k_cache, v_cache, k_scale, v_scale,
                               block_tables + (size_t)row_ids[t] * mb, head,
                               kvh, hd, bs};
      // one call site for both plans keeps the kernel's registers down
      const bool walked = split_walk<T, S, G>(
          src, q, out, f ? fine.ws_ml : ws_ml, f ? fine.ws_acc : ws_acc,
          f ? fine.tickets : tickets, pair, f ? r * kvh + head : pair,
          blockIdx.y, f ? fine.n_split : n_split, nh, kvh, hd, bs, length,
          f ? fine.chunk : chunk, scale);
      __syncthreads();  // every thread has left the walk
      if (walked) release_ring(L);
    }
  }
}

template <typename T, typename S>
static Layout layout_of(int nh, int kvh, int hd, int bs) {
  return layout(hd, nh / kvh, (int)sizeof(T), (int)sizeof(S), bs);
}

template <typename T, typename S>
static int launch(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* tables,
                  const void* lengths, const void* row_ids, void* out,
                  void* ws_ml, void* ws_acc, void* tickets, int n, int nh,
                  int kvh, int hd, int bs, int mb, int chunk_pages,
                  int n_split, int blocks, const FinePlan& fine, float scale,
                  void* stream) {
  const Layout L = layout_of<T, S>(nh, kvh, hd, bs);
  return dispatch_group<T>(nh / kvh, hd, [&](auto g) {
    constexpr int G = decltype(g)::value;
    auto go = [&](auto kernel, int grid_x, int grid_y, auto... rows) {
      return launch_walk(
          kernel, L, grid_x, grid_y, stream, static_cast<const T*>(q),
          static_cast<const S*>(k), static_cast<const S*>(v),
          static_cast<const float*>(ks), static_cast<const float*>(vs),
          static_cast<const int*>(tables), static_cast<const int*>(lengths),
          static_cast<T*>(out), static_cast<float*>(ws_ml),
          static_cast<float*>(ws_acc), static_cast<int*>(tickets), nh, kvh,
          hd, bs, mb, chunk_pages * bs, scale, rows...);
    };
    if (row_ids == nullptr)
      return go(paged_decode_split_kernel<T, S, G>, n * kvh, n_split);
    return go(ragged_singleton_kernel<T, S, G>, blocks,
              n_split > fine.n_split ? n_split : fine.n_split,
              static_cast<const int*>(row_ids), n, n_split, fine);
  });
}

template <bool Q8, typename Run>
static int with_types(int dtype, Run run) {
  auto pick = [&](auto t) {
    using T = decltype(t);
    using S = typename std::conditional<Q8, int8_t, T>::type;
    return run(T(), S());
  };
  switch (dtype) {
    case ds_vec::kF32: return pick(float());
    case ds_vec::kF16: return pick(__half());
    case ds_vec::kBF16: return pick(__nv_bfloat16());
  }
  return (int)cudaErrorInvalidValue;
}

template <bool Q8>
static int dispatch(int dtype, const void* q, const void* k, const void* v,
                    const void* ks, const void* vs, const void* tables,
                    const void* lengths, const void* row_ids, void* out,
                    void* ws_ml, void* ws_acc, void* tickets, int n, int nh,
                    int kvh, int hd, int bs, int mb, int chunk_pages,
                    int n_split, int blocks, FinePlan fine, float scale,
                    void* stream) {
  if (n == 0) return 0;
  if (bs <= 0 || chunk_pages <= 0 || n_split < 1 || blocks < 1
      || (long long)n_split * chunk_pages < mb
      || (row_ids != nullptr
          && (fine.chunk <= 0 || fine.n_split < 1
              || (long long)fine.n_split * fine.chunk < mb)))
    return (int)cudaErrorInvalidValue;
  fine.chunk *= bs;  // pages to slots
  return with_types<Q8>(dtype, [&](auto t, auto s) {
    return launch<decltype(t), decltype(s)>(
        q, k, v, ks, vs, tables, lengths, row_ids, out, ws_ml, ws_acc,
        tickets, n, nh, kvh, hd, bs, mb, chunk_pages, n_split, blocks, fine,
        scale, stream);
  });
}

// The kernel's resources for these shapes: out[0] dynamic shared memory
// bytes, [1] slots per stage, [2] 1 on the lane route, [3] blocks per SM
// (occupancy API), [4] registers per thread, [5] local (spilled) bytes per
// thread.
template <typename T, typename S>
static int info(int nh, int kvh, int hd, int bs, bool rows, int* out) {
  const Layout L = layout_of<T, S>(nh, kvh, hd, bs);
  return dispatch_group<T>(nh / kvh, hd, [&](auto g) {
    constexpr int G = decltype(g)::value;
    auto query = [&](auto kernel) {
      if (L.bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)L.bytes);
        if (err != cudaSuccess) return (int)err;
      }
      cudaFuncAttributes attr;
      cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) return (int)err;
      int blocks = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          kThreads, L.bytes);
      if (err != cudaSuccess) return (int)err;
      out[0] = (int)L.bytes;
      out[1] = L.tile;
      out[2] = G > 0;
      out[3] = blocks;
      out[4] = attr.numRegs;
      out[5] = (int)attr.localSizeBytes;
      return 0;
    };
    return rows ? query(ragged_singleton_kernel<T, S, G>)
                : query(paged_decode_split_kernel<T, S, G>);
  });
}

}  // namespace ds_paged_decode

// Returns the cudaError_t of the launch (0 on success). Pool in q's dtype.
// ws_ml / ws_acc / tickets: the split workspace (f32 [N * kvh * n_split *
// 2 * group], f32 [N * kvh * n_split * group * hd], int32 [N * kvh], the
// tickets zero); chunk_pages * n_split >= mb (the wrapper's
// page_split_plan).
extern "C" int ds_paged_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* lengths, void* out, void* ws_ml,
    void* ws_acc, void* tickets, int n, int nh, int kvh, int hd, int bs,
    int mb, int chunk_pages, int n_split, int dtype, float scale,
    void* stream) {
  return ds_paged_decode::dispatch<false>(
      dtype, q, k_cache, v_cache, nullptr, nullptr, block_tables, lengths,
      nullptr, out, ws_ml, ws_acc, tickets, n, nh, kvh, hd, bs, mb,
      chunk_pages, n_split, n * kvh, ds_paged_decode::FinePlan{}, scale,
      stream);
}

// The int8 kv_quant pool: k/v_cache int8 [nb, bs, kvh, hd], k/v_scale f32
// [nb, kvh]; q and out in the io dtype.
extern "C" int ds_paged_decode_attention_q8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, void* ws_ml, void* ws_acc, void* tickets,
    int n, int nh, int kvh, int hd, int bs, int mb, int chunk_pages,
    int n_split, int dtype, float scale, void* stream) {
  return ds_paged_decode::dispatch<true>(
      dtype, q, k_cache, v_cache, k_scale, v_scale, block_tables, lengths,
      nullptr, out, ws_ml, ws_acc, tickets, n, nh, kvh, hd, bs, mb,
      chunk_pages, n_split, n * kvh, ds_paged_decode::FinePlan{}, scale,
      stream);
}

// The single-token runs of a ragged batch (ragged_attention.cu;
// ragged_singleton_kernel): q / out [n, nh, hd] over n buffer tokens,
// token t reading row row_ids[t]'s table [R, mb] and its own lengths[t];
// tokens of longer runs and of length <= 0 are left to the tile kernel.
// The first fine_rows single-token runs (by the tile launch's scan: rank
// [n], scan [1]) take the fine plan (fine_chunk_pages, fine_n_split;
// workspace ws_ml_f / ws_acc_f / tickets_f for fine_rows * kvh slots), any
// later one the coarse plan (chunk_pages, n_split; workspace ws_ml /
// ws_acc / tickets as for the decode entry points with N = n). blocks: the
// grid's x (each block takes the pairs blockIdx.x + i * blocks). k_scale /
// v_scale null for a pool in q's dtype.
extern "C" int ds_paged_decode_rows(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, const void* row_ids, void* out, void* ws_ml,
    void* ws_acc, void* tickets, const void* rank, const void* scan,
    void* ws_ml_f, void* ws_acc_f, void* tickets_f, int n, int nh, int kvh,
    int hd, int bs, int mb, int chunk_pages, int n_split, int fine_rows,
    int fine_chunk_pages, int fine_n_split, int blocks, int dtype,
    float scale, void* stream) {
  using ds_paged_decode::FinePlan;
  const FinePlan fine{static_cast<const int*>(rank),
                      static_cast<const int*>(scan),
                      fine_rows,
                      fine_chunk_pages,
                      fine_n_split,
                      static_cast<float*>(ws_ml_f),
                      static_cast<float*>(ws_acc_f),
                      static_cast<int*>(tickets_f)};
  if (k_scale != nullptr)
    return ds_paged_decode::dispatch<true>(
        dtype, q, k_cache, v_cache, k_scale, v_scale, block_tables, lengths,
        row_ids, out, ws_ml, ws_acc, tickets, n, nh, kvh, hd, bs, mb,
        chunk_pages, n_split, blocks, fine, scale, stream);
  return ds_paged_decode::dispatch<false>(
      dtype, q, k_cache, v_cache, nullptr, nullptr, block_tables, lengths,
      row_ids, out, ws_ml, ws_acc, tickets, n, nh, kvh, hd, bs, mb,
      chunk_pages, n_split, blocks, fine, scale, stream);
}

// The resources of the kernel that a call with these shapes launches
// (int8 pool when q8 != 0; the ragged batch's single-token walk,
// ragged_singleton_kernel, when rows != 0); see ds_paged_decode::info.
// Returns a cudaError_t.
extern "C" int ds_paged_decode_info(int nh, int kvh, int hd, int bs,
                                    int dtype, int q8, int rows, int* out) {
  using namespace ds_paged_decode;
  auto run = [&](auto t, auto s) {
    return info<decltype(t), decltype(s)>(nh, kvh, hd, bs, rows != 0, out);
  };
  return q8 ? with_types<true>(dtype, run) : with_types<false>(dtype, run);
}

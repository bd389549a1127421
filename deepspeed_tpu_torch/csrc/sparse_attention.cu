// Block-sparse flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/sparse_kernels.py:
//   sparse_fwd      <- _fwd_kernel (:105), via _sparse_fwd (:149)
//   sparse_bwd_dq   <- _bwd_dq_kernel (:190), via _sparse_bwd (:259)
//   sparse_bwd_dkv  <- _bwd_dkv_kernel (:222), via _sparse_bwd (:259)
// and computes the same functions over q/k/v [B*H, S, D] (no GQA) and a
// static per-head block layout, compiled on the host into int32 tables
// (ops/sparse_kernels.py, uploaded to the card once per layout). Row b of
// the folded [B*H, ...] tensors reads head b % H of the tables. Only active
// blocks are loaded and multiplied; inside a block the causal mask is the
// TPU kernels' top-left q_pos >= k_pos (q_pos = qi * block + r). Here
// Sq = Skv, so the tile kernels' bottom-right mask (off = Skv - Sq = 0) is
// the same mask.
//
// Routes (the Python wrapper picks the entry point by the same rule):
//   * the forward, dq and dk/dv for bf16 / fp16 with S a multiple of 64:
//     the tensor-core kernels of sparse_hopper.cuh (ds_sparse_fwd_hopper,
//     ds_sparse_bwd_dq_hopper, ds_sparse_bwd_dkv_hopper) over the 64-row
//     tile tables of build_tile_tables (work items and their step lists
//     with 16-bit sub-block masks; the forward walks dq's); their bound and
//     design are described there;
//   * f32 inputs, and an S that is not a multiple of 64 (a layout of
//     block 16 or 32 whose last 64-row tile would be ragged): the f32
//     CUDA-core tile kernels of flash_tiles.cuh over a TableWalk of the
//     per-block tables
//       kv_idx/kv_valid [H, n, Jmax]: the active kv blocks of each q block
//         (forward, dq), padded slots with valid 0;
//       q_idx/q_valid [H, n, Imax]: the active q blocks of each kv block.
//     Under the causal flag the tables hold only blocks on or below the
//     diagonal.
//
// The TableWalk tile has TILE = min(block, 64) rows, so a 16- or 32-row
// block gets a 16- or 32-row tile instead of leaving most of a 64-row one
// idle; a 128-row block is two tiles: its q rows go to two CUDA blocks, and
// each active kv block is read as two kv tiles. A kv tile that lies wholly
// above a q tile's diagonal is skipped: its scores are all -1e30 and add
// exactly nothing.
//
//   forward / dq: one CUDA block per (row b, q tile) walks its q block's
//     Jmax table slots in table order (the online softmax of the TPU
//     kernel's j axis), skipping slots with valid 0. A q block with no
//     active block writes o = 0, lse = -1e30 and dq = 0.
//   dk/dv: one CUDA block per (row b, kv tile) walks its kv block's Imax
//     q-table slots; a kv block with no active q block writes zeros. No
//     atomics, so a repeated backward is bit-identical.
//
// Bound on an H100: operations. At the Fixed layout of chip_smoke.py
// (32 heads, S 8192, D 128, block 64, 2304 of 8256 causal blocks active)
// the work is 2 flops per visible (q, k) pair and head dim per product, 2
// products in the forward, 3 in dq, 4 in dk/dv: 0.152 / 0.228 / 0.304 ms at
// 989 TFLOP/s, against ~2 bytes moved per 64 flops. Known costs of the tile
// route, beyond the CUDA-core products: a row's work is its number of
// active blocks, so global rows and columns (Jmax, Imax up to n) finish
// long after the median row's ~5 blocks; and a 16-row tile leaves each
// thread one score and little reuse.
#include "flash_tiles.cuh"
#include "sparse_hopper.cuh"

namespace ds_flash {

template <int TILE> struct TableWalk {
  const int* idx;    // [nheads, n, width] block ids
  const int* valid;  // [nheads, n, width] 1 = active, 0 = padding
  int nheads, n, width, block, causal;

  __device__ __forceinline__ int steps() const {
    return width * (block / TILE);
  }
  // table slot of step e for row `row` (q block or kv block `blk`)
  __device__ __forceinline__ int slot(int row, int blk, int e) const {
    return ((row % nheads) * n + blk) * width + e / (block / TILE);
  }
  __device__ __forceinline__ int kv_steps(int, int) const { return steps(); }
  __device__ __forceinline__ bool kv_tile(int bh, int q0, int e,
                                          int& k0) const {
    const int s = slot(bh, q0 / block, e);
    if (!__ldg(valid + s)) return false;
    k0 = __ldg(idx + s) * block + (e % (block / TILE)) * TILE;
    return !(causal && k0 > q0 + TILE - 1);
  }
  __device__ __forceinline__ int q_steps(int, int) const { return steps(); }
  __device__ __forceinline__ bool q_tile(int bhk, int k0, int e, int& bh,
                                         int& q0) const {
    const int s = slot(bhk, k0 / block, e);
    bh = bhk;
    if (!__ldg(valid + s)) return false;
    q0 = __ldg(idx + s) * block + (e % (block / TILE)) * TILE;
    return !(causal && q0 + TILE - 1 < k0);
  }
};

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *idx, *valid;
  void *o, *lse_out, *dq, *dk, *dv;
  int bh, nheads, s, d, block, width, dtype;
  float scale;
  int causal;
  cudaStream_t stream;

  template <int TILE> TableWalk<TILE> walk() const {
    return TableWalk<TILE>{static_cast<const int*>(idx),
                           static_cast<const int*>(valid), nheads, s / block,
                           width, block, causal};
  }
};

template <typename T, int D, int TILE> struct FwdOp {
  static int run(const Args& a) {
    auto kernel = flash_fwd_kernel<T, D, TILE, TableWalk<TILE>>;
    const size_t smem = fwd_smem<D, TILE>();
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(a.s / TILE, a.bh), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o),
        static_cast<float*>(a.lse_out), a.s, a.s, 1, a.scale, a.causal,
        a.walk<TILE>());
    return (int)cudaGetLastError();
  }
};

template <typename T, int D, int TILE> struct DqOp {
  static int run(const Args& a) {
    auto kernel = flash_bwd_dq_kernel<T, D, TILE, TableWalk<TILE>>;
    const size_t smem = dq_smem<D, TILE>();
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(a.s / TILE, a.bh), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dq), a.s, a.s, 1, a.scale, a.causal,
        a.walk<TILE>());
    return (int)cudaGetLastError();
  }
};

template <typename T, int D, int TILE> struct DkvOp {
  static int run(const Args& a) {
    auto kernel = flash_bwd_dkv_kernel<T, D, TILE, TableWalk<TILE>>;
    const size_t smem = dkv_smem<D, TILE>();
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(a.s / TILE, a.bh), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s, a.s, a.scale,
        a.causal, a.walk<TILE>());
    return (int)cudaGetLastError();
  }
};

template <template <typename, int, int> class Op, int TILE>
static int by_dtype(const Args& a) {
  const bool d64 = a.d == 64;
  switch (a.dtype) {
    case kF32:
      return d64 ? Op<float, 64, TILE>::run(a) : Op<float, 128, TILE>::run(a);
    case kF16:
      return d64 ? Op<__half, 64, TILE>::run(a)
                 : Op<__half, 128, TILE>::run(a);
    case kBF16:
      return d64 ? Op<__nv_bfloat16, 64, TILE>::run(a)
                 : Op<__nv_bfloat16, 128, TILE>::run(a);
  }
  return (int)cudaErrorInvalidValue;
}

// block x dtype x head_dim dispatch; the tile has min(block, 64) rows
template <template <typename, int, int> class Op>
static int dispatch(const Args& a) {
  if (a.bh == 0 || a.s == 0) return 0;
  if ((a.d != 64 && a.d != 128) || a.block <= 0 || a.s % a.block ||
      a.nheads <= 0 || a.bh % a.nheads)
    return (int)cudaErrorInvalidValue;
  switch (a.block) {
    case 16:
      return by_dtype<Op, 16>(a);
    case 32:
      return by_dtype<Op, 32>(a);
    case 64:
    case 128:
      return by_dtype<Op, 64>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ds_flash

// Each entry point returns the cudaError_t of its launch (0 on success).
// q/k/v/o/do/dq/dk/dv: [bh, s, d]; lse/delta: [bh, s] f32; idx/valid:
// [nheads, s / block, width] int32 (width = Jmax or Imax).
extern "C" int ds_sparse_fwd(const void* q, const void* k, const void* v,
                             const void* kv_idx, const void* kv_valid,
                             void* o, void* lse, int bh, int nheads, int s,
                             int d, int block, int jmax, int dtype,
                             float scale, int causal, void* stream) {
  using namespace ds_flash;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.idx = kv_idx, a.valid = kv_valid;
  a.o = o, a.lse_out = lse, a.bh = bh, a.nheads = nheads, a.s = s, a.d = d;
  a.block = block, a.width = jmax, a.dtype = dtype, a.scale = scale;
  a.causal = causal, a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<FwdOp>(a);
}

extern "C" int ds_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* kv_idx,
                                const void* kv_valid, void* dq, int bh,
                                int nheads, int s, int d, int block, int jmax,
                                int dtype, float scale, int causal,
                                void* stream) {
  using namespace ds_flash;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.idx = kv_idx, a.valid = kv_valid, a.dq = dq, a.bh = bh;
  a.nheads = nheads, a.s = s, a.d = d, a.block = block, a.width = jmax;
  a.dtype = dtype, a.scale = scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<DqOp>(a);
}

extern "C" int ds_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_idx,
                                 const void* q_valid, void* dk, void* dv,
                                 int bh, int nheads, int s, int d, int block,
                                 int imax, int dtype, float scale, int causal,
                                 void* stream) {
  using namespace ds_flash;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.idx = q_idx, a.valid = q_valid, a.dk = dk, a.dv = dv, a.bh = bh;
  a.nheads = nheads, a.s = s, a.d = d, a.block = block, a.width = imax;
  a.dtype = dtype, a.scale = scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<DkvOp>(a);
}

// The tensor-core kernels (sparse_hopper.cuh): bf16 / fp16, d 64 / 128,
// s % 64 == 0. items [n_items, 5] int32 (head, tile0, tile1 or -1, step
// start, step count), heaviest first; steps [*, 2] int32 (other tile, mask
// of tile0 | mask of tile1 << 16); max_steps: the longest step list. The
// forward takes dq's items and steps. Each returns the cudaError_t of its
// launch (0 on success).
namespace ds_sparse {

static bool hopper_shape(int bh, int nheads, int s, int d, int max_steps) {
  return (d == 64 || d == 128) && nheads > 0 && bh % nheads == 0 &&
         s % kRows == 0 && max_steps >= 0;
}

}  // namespace ds_sparse

#define DS_SPARSE_HOPPER_DISPATCH(CALL)                                      \
  switch (dtype) {                                                           \
    case ds_flash::kF16:                                                     \
      return d == 64 ? CALL(__half, 64) : CALL(__half, 128);                 \
    case ds_flash::kBF16:                                                    \
      return d == 64 ? CALL(__nv_bfloat16, 64) : CALL(__nv_bfloat16, 128);   \
  }                                                                          \
  return (int)cudaErrorInvalidValue;

extern "C" int ds_sparse_fwd_hopper(const void* q, const void* k,
                                    const void* v, const void* items,
                                    const void* steps, void* o, void* lse,
                                    int bh, int nheads, int s, int d,
                                    int n_items, int max_steps, int dtype,
                                    float scale, int causal, void* stream) {
  if (bh == 0 || s == 0 || n_items == 0) return 0;
  if (!ds_sparse::hopper_shape(bh, nheads, s, d, max_steps))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
#define DS_CALL(T, D)                                                        \
  ds_sparse::fwd<T, D>(q, k, v, o, lse, items, steps, n_items, max_steps, bh, \
                       nheads, s, scale, causal, st)
  DS_SPARSE_HOPPER_DISPATCH(DS_CALL)
#undef DS_CALL
}

extern "C" int ds_sparse_bwd_dq_hopper(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* items, const void* steps,
    void* dq, int bh, int nheads, int s, int d, int n_items, int max_steps,
    int dtype, float scale, int causal, void* stream) {
  if (bh == 0 || s == 0 || n_items == 0) return 0;
  if (!ds_sparse::hopper_shape(bh, nheads, s, d, max_steps))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
#define DS_CALL(T, D)                                                     \
  ds_sparse::bwd_dq<T, D>(q, k, v, dout, lse, delta, dq, items, steps,    \
                          n_items, max_steps, bh, nheads, s, scale, causal, \
                          st)
  DS_SPARSE_HOPPER_DISPATCH(DS_CALL)
#undef DS_CALL
}

extern "C" int ds_sparse_bwd_dkv_hopper(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* items, const void* steps,
    void* dk, void* dv, int bh, int nheads, int s, int d, int n_items,
    int max_steps, int dtype, float scale, int causal, void* stream) {
  if (bh == 0 || s == 0 || n_items == 0) return 0;
  if (!ds_sparse::hopper_shape(bh, nheads, s, d, max_steps))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
#define DS_CALL(T, D)                                                      \
  ds_sparse::bwd_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, items, steps, \
                           n_items, max_steps, bh, nheads, s, scale, causal, \
                           st)
  DS_SPARSE_HOPPER_DISPATCH(DS_CALL)
#undef DS_CALL
}

// Registers, dynamic shared memory and resident blocks per SM of the
// tensor-core dq (out[0..2]), dk/dv (out[3..5]) and forward (out[6..8])
// for a 16-bit dtype, head_dim d and step lists of up to max_steps entries.
extern "C" int ds_sparse_hopper_info(int d, int dtype, int max_steps,
                                     int* out) {
  if ((d != 64 && d != 128) || max_steps < 0)
    return (int)cudaErrorInvalidValue;
#define DS_CALL(T, D) ds_sparse::info<T, D>(max_steps, out)
  DS_SPARSE_HOPPER_DISPATCH(DS_CALL)
#undef DS_CALL
}

#undef DS_SPARSE_HOPPER_DISPATCH

// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   flash_fwd      <- _fwd_kernel (:63), via _flash_fwd (:115)
//   flash_bwd_dq   <- _bwd_dq_kernel (:155), via _flash_bwd (:243)
//   flash_bwd_dkv  <- _bwd_dkv_kernel (:196), via _flash_bwd (:243)
// The dtype picks the kernels:
//   * bf16 and fp16: every entry runs the tensor-core kernels of
//     flash_hopper.cuh (wgmma fed by a TMA ring);
//   * f32: every entry runs the tile kernels of flash_tiles.cuh, which
//     multiply in f32 on the CUDA cores. The tensor cores take f32 only as
//     TF32 (~3 decimal digits), which would break the f32 checks (kernel
//     against plain within 1e-4, f32 training losses within 1e-5).
// The tile kernels (what they compute, their bound and design are described
// in flash_tiles.cuh) tile by 64 rows over a RangeWalk: a q tile reads
// every kv tile of its kv head row, or under the causal mask only those
// that start at or left of its last row's diagonal (the TPU grid's pl.when
// skips); a kv tile of kv head row bhk is fed by every q tile of every q
// head of its GQA group, so dk/dv reduce the group inside one block. The
// tensor-core kernels walk the same ranges.
#include <type_traits>

#include "flash_hopper.cuh"
#include "flash_tiles.cuh"

namespace ds_flash {

constexpr int kTileRows = 64;            // q rows and kv rows per tile

struct RangeWalk {
  int sq, skv, group, causal;

  __device__ __forceinline__ int kv_steps(int, int q0) const {
    const int n = skv / kTileRows;
    if (!causal) return n;
    const int last = q0 + kTileRows - 1 + (skv - sq);
    return last < 0 ? 0 : min(n, last / kTileRows + 1);
  }
  __device__ __forceinline__ bool kv_tile(int, int, int e, int& k0) const {
    k0 = e * kTileRows;
    return true;
  }
  __device__ __forceinline__ int q_steps(int, int) const {
    return group * (sq / kTileRows);
  }
  // causal: skip q tiles whose last row sees none of this kv tile
  __device__ __forceinline__ bool q_tile(int bhk, int k0, int e, int& bh,
                                         int& q0) const {
    const int n_q = sq / kTileRows;
    bh = bhk * group + e / n_q;
    q0 = (e % n_q) * kTileRows;
    return !(causal && q0 + kTileRows - 1 + (skv - sq) < k0);
  }
};

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  int bh, bhk, sq, skv;
  float scale;
  int causal;
  cudaStream_t stream;

  RangeWalk walk() const { return RangeWalk{sq, skv, bh / bhk, causal}; }
};

template <typename T, int D> static int tile_fwd(const Args& a) {
  auto kernel = flash_fwd_kernel<T, D, kTileRows, RangeWalk>;
  const size_t smem = fwd_smem<D, kTileRows>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.sq / kTileRows, a.bh), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse_out), a.sq, a.skv, a.bh / a.bhk, a.scale,
      a.causal, a.walk());
  return (int)cudaGetLastError();
}

template <typename T, int D> static int tile_bwd_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<T, D, kTileRows, RangeWalk>;
  const size_t smem = dq_smem<D, kTileRows>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.sq / kTileRows, a.bh), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.sq, a.skv, a.bh / a.bhk, a.scale, a.causal,
      a.walk());
  return (int)cudaGetLastError();
}

template <typename T, int D> static int tile_bwd_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<T, D, kTileRows, RangeWalk>;
  const size_t smem = dkv_smem<D, kTileRows>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.skv / kTileRows, a.bhk), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.skv, a.scale,
      a.causal, a.walk());
  return (int)cudaGetLastError();
}

// f32 on the tile kernels, bf16 / fp16 on the tensor cores
template <typename T, int D> static int fwd(const Args& a) {
  if constexpr (std::is_same<T, float>::value)
    return tile_fwd<T, D>(a);
  else
    return ds_hopper::fwd<T, D>(a.q, a.k, a.v, a.o, a.lse_out, a.bh, a.bhk,
                                a.sq, a.skv, a.scale, a.causal, a.stream);
}

template <typename T, int D> static int bwd_dq(const Args& a) {
  if constexpr (std::is_same<T, float>::value)
    return tile_bwd_dq<T, D>(a);
  else
    return ds_hopper::bwd_dq<T, D>(a.q, a.k, a.v, a.dout, a.lse, a.delta,
                                   a.dq, a.bh, a.bhk, a.sq, a.skv, a.scale,
                                   a.causal, a.stream);
}

template <typename T, int D> static int bwd_dkv(const Args& a) {
  if constexpr (std::is_same<T, float>::value)
    return tile_bwd_dkv<T, D>(a);
  else
    return ds_hopper::bwd_dkv<T, D>(a.q, a.k, a.v, a.dout, a.lse, a.delta,
                                    a.dk, a.dv, a.bh, a.bhk, a.sq, a.skv,
                                    a.scale, a.causal, a.stream);
}

// dtype x head_dim dispatch of one of the launchers above
template <template <typename, int> class Op>
static int dispatch(const Args& a, int d, int dtype) {
  if (a.sq == 0 || a.skv == 0 || a.bh == 0) return 0;
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return d == 64 ? Op<float, 64>::run(a) : Op<float, 128>::run(a);
    case kF16:
      return d == 64 ? Op<__half, 64>::run(a) : Op<__half, 128>::run(a);
    case kBF16:
      return d == 64 ? Op<__nv_bfloat16, 64>::run(a)
                     : Op<__nv_bfloat16, 128>::run(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D> struct FwdOp {
  static int run(const Args& a) { return fwd<T, D>(a); }
};
template <typename T, int D> struct DqOp {
  static int run(const Args& a) { return bwd_dq<T, D>(a); }
};
template <typename T, int D> struct DkvOp {
  static int run(const Args& a) { return bwd_dkv<T, D>(a); }
};

}  // namespace ds_flash

// Each entry point returns the cudaError_t of its launch (0 on success).
// q/o/dq: [bh, sq, d]; k/v/dk/dv: [bhk, skv, d]; lse/delta: [bh, sq] f32.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int bhk, int sq,
                            int skv, int d, int dtype, float scale, int causal,
                            void* stream) {
  using namespace ds_flash;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse_out = lse;
  a.bh = bh, a.bhk = bhk, a.sq = sq, a.skv = skv, a.scale = scale;
  a.causal = causal, a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<FwdOp>(a, d, dtype);
}

extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int bhk,
                               int sq, int skv, int d, int dtype, float scale,
                               int causal, void* stream) {
  using namespace ds_flash;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.dq = dq, a.bh = bh, a.bhk = bhk, a.sq = sq, a.skv = skv, a.scale = scale;
  a.causal = causal, a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<DqOp>(a, d, dtype);
}

extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int bhk, int sq, int skv, int d, int dtype,
                                float scale, int causal, void* stream) {
  using namespace ds_flash;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.dk = dk, a.dv = dv, a.bh = bh, a.bhk = bhk, a.sq = sq, a.skv = skv;
  a.scale = scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<DkvOp>(a, d, dtype);
}

// Registers, dynamic shared memory and resident blocks per SM of the
// tensor-core forward (out[0..2]), dk/dv (out[3..5]) and dq (out[6..8]) for
// a 16-bit dtype and head_dim d; returns the cudaError_t of the queries.
extern "C" int ds_flash_hopper_info(int d, int dtype, int* out) {
  using namespace ds_flash;
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  if (dtype == kF16)
    return d == 64 ? ds_hopper::info<__half, 64>(out)
                   : ds_hopper::info<__half, 128>(out);
  if (dtype == kBF16)
    return d == 64 ? ds_hopper::info<__nv_bfloat16, 64>(out)
                   : ds_hopper::info<__nv_bfloat16, 128>(out);
  return (int)cudaErrorInvalidValue;
}

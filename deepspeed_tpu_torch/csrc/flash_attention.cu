// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   flash_fwd      <- _fwd_kernel (:63), via _flash_fwd (:115)
//   flash_bwd_dq   <- _bwd_dq_kernel (:155), via _flash_bwd (:243)
//   flash_bwd_dkv  <- _bwd_dkv_kernel (:196), via _flash_bwd (:243)
// and computes the same functions: q [BH, Sq, D], k/v [BHk, Skv, D] with
// batch folded into the head axis (q head row b reads kv row b / group),
// scores in f32 scaled by `scale`, causal mask bottom-right aligned
// (off = Skv - Sq; key c is visible to query r iff off + r >= c), masked
// scores -1e30, and the TPU kernels' dtype casts: p is rounded to the input
// dtype before P.V and before the dv product, ds before the dq and dk
// products. The forward returns o (input dtype) and lse [BH, Sq] in f32; a
// fully masked row (Sq > Skv) gives o = 0 and lse = -1e30 (m_safe / l == 0
// substitutions of :97 and :110), and zero gradients in the backward
// (lse_safe, :183).
//
// Bound on an H100: operations. At the training shapes (S = 2048, D = 128)
// the four products of the backward and two of the forward are ~S / 2
// multiply-adds per byte moved, far above the 295 flop/byte line, so the
// least time is the tensor-core time of the products. This first version
// does not reach it: it multiplies on the CUDA cores in f32 (FMA), from
// f32 tiles in shared memory. Its design is the plain one that is easy to
// hold right against the TPU kernels:
//
//   * one block of 256 threads (a 16 x 16 grid) per (head row, 64-row
//     tile); each thread owns a 4 x 4 block of the 64 x 64 score tile and a
//     4 x (D / 16) block of the output tile, in registers;
//   * tiles live in shared memory as f32 with rows padded by one word, so
//     the score loop (16 different key rows at one column) and the P.V
//     loop (16 consecutive columns) read without bank conflicts;
//   * the online softmax keeps m and l per row, reduced over the row's 16
//     threads with a fixed shuffle tree;
//   * the causal mask skips whole tiles above the diagonal, as the TPU
//     grid's pl.when does;
//   * dk/dv: one block per (kv head row, 64-row kv tile) walks every q tile
//     of every q head of its GQA group and accumulates dk and dv in
//     registers. No atomics anywhere, so a repeated backward is
//     bit-identical.
//
// The kernels do not use the tensor cores (wgmma / mma.sync), TMA or
// cp.async, and hold one block per SM at D = 128 (116-166 KB of shared
// memory): that is the work of the PRs that make them fast.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ds_flash {

constexpr int kTileRows = 64;            // q rows and kv rows per tile
constexpr int kGrid = 16;                // threads per tile side
constexpr int kThreads = kGrid * kGrid;  // 256
constexpr int kPer = kTileRows / kGrid;  // 4 rows (and score cols) per thread
constexpr int kPLd = kTileRows + 1;      // padded stride of a score tile
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrappers
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the input dtype and back (the TPU kernels' .astype casts)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// Reductions over the 16 threads of one tile row (a half warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kGrid / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kGrid / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [0, kTileRows) of a row-major [*, D] matrix into an f32 tile with
// row stride D + 1.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src) {
  for (int e = threadIdx.x; e < kTileRows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = to_f32<T>(src[(size_t)r * D + c]);
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two padded tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[kPer][kPer],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kPer], b[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = A[(ty + kGrid * i) * LD + d];
#pragma unroll
    for (int j = 0; j < kPer; ++j) b[j] = B[(tx + kGrid * j) * LD + d];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// Number of kv tiles a q tile starting at q0 reads: under the causal mask
// only the tiles that start at or left of its last row's diagonal.
__device__ __forceinline__ int kv_tiles(int q0, int sq, int skv, int causal) {
  const int n = skv / kTileRows;
  if (!causal) return n;
  const int last = q0 + kTileRows - 1 + (skv - sq);
  return last < 0 ? 0 : min(n, last / kTileRows + 1);
}

// ---------------------------------------------------------------------------
// forward: grid (Sq / 64, BH)
// ---------------------------------------------------------------------------
template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTileRows * (D + 1) + kTileRows * kPLd);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, int group,
                     float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int kCols = D / kGrid;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTileRows * LD;
  float* Vs = Ks + kTileRows * LD;
  float* Ps = Vs + kTileRows * LD;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTileRows;
  const int off = skv - sq;
  const T* kp = k + (size_t)(bh / group) * skv * D;
  const T* vp = v + (size_t)(bh / group) * skv * D;
  load_tile<T, D>(Qs, q + ((size_t)bh * sq + q0) * D);

  float acc[kPer][kCols], m[kPer], l[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = kv_tiles(q0, sq, skv, causal);
  for (int jt = 0; jt < n_kv; ++jt) {
    const int k0 = jt * kTileRows;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, kp + (size_t)k0 * D);
    load_tile<T, D>(Vs, vp + (size_t)k0 * D);
    __syncthreads();
    float s[kPer][kPer];
    tile_dot<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qpos = off + q0 + ty + kGrid * i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float x = s[i][j] * scale;
        if (causal && qpos < k0 + tx + kGrid * j) x = kNegInf;
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
      mc = row_max(mc);
      const float m_new = fmaxf(m[i], mc);
      // rows masked so far keep m == -1e30: exp(s - 0) underflows to 0
      const float m_safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m_safe);
        rs += p;
        Ps[(ty + kGrid * i) * kPLd + tx + kGrid * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTileRows; ++c) {
      float p[kPer], vv[kCols];
#pragma unroll
      for (int i = 0; i < kPer; ++i) p[i] = Ps[(ty + kGrid * i) * kPLd + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) vv[cc] = Vs[c * LD + tx + kGrid * cc];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(p[i], vv[cc], acc[i][cc]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const size_t row = (size_t)bh * sq + q0 + ty + kGrid * i;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      o[row * D + tx + kGrid * cc] = from_f32<T>(acc[i][cc] / l_safe);
    if (tx == 0) lse[row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward dq: grid (Sq / 64, BH)
// ---------------------------------------------------------------------------
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTileRows * (D + 1) + kTileRows * kPLd);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int skv, int group, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int kCols = D / kGrid;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTileRows * LD;
  float* Ks = dOs + kTileRows * LD;
  float* Vs = Ks + kTileRows * LD;
  float* DSs = Vs + kTileRows * LD;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTileRows;
  const int off = skv - sq;
  const T* kp = k + (size_t)(bh / group) * skv * D;
  const T* vp = v + (size_t)(bh / group) * skv * D;
  load_tile<T, D>(Qs, q + ((size_t)bh * sq + q0) * D);
  load_tile<T, D>(dOs, dout + ((size_t)bh * sq + q0) * D);

  float lse_safe[kPer], dl[kPer], acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const size_t row = (size_t)bh * sq + q0 + ty + kGrid * i;
    // fully masked rows carry lse == -1e30; exp(s - lse) would be 1
    lse_safe[i] = lse[row] <= kNegInf * 0.5f ? 0.f : lse[row];
    dl[i] = delta[row];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = kv_tiles(q0, sq, skv, causal);
  for (int jt = 0; jt < n_kv; ++jt) {
    const int k0 = jt * kTileRows;
    __syncthreads();
    load_tile<T, D>(Ks, kp + (size_t)k0 * D);
    load_tile<T, D>(Vs, vp + (size_t)k0 * D);
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer];
    tile_dot<D>(s, Qs, Ks, ty, tx);
    tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qpos = off + q0 + ty + kGrid * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float x = s[i][j] * scale;
        if (causal && qpos < k0 + tx + kGrid * j) x = kNegInf;
        const float p = expf(x - lse_safe[i]);
        DSs[(ty + kGrid * i) * kPLd + tx + kGrid * j] =
            round_to<T>(p * (dp[i][j] - dl[i]) * scale);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTileRows; ++c) {
      float ds[kPer], kv[kCols];
#pragma unroll
      for (int i = 0; i < kPer; ++i) ds[i] = DSs[(ty + kGrid * i) * kPLd + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) kv[cc] = Ks[c * LD + tx + kGrid * cc];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(ds[i], kv[cc], acc[i][cc]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const size_t row = (size_t)bh * sq + q0 + ty + kGrid * i;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      dq[row * D + tx + kGrid * cc] = from_f32<T>(acc[i][cc]);
  }
}

// ---------------------------------------------------------------------------
// backward dk/dv: grid (Skv / 64, BHk); walks every q tile of every q head
// of the kv head's GQA group
// ---------------------------------------------------------------------------
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * kTileRows * (D + 1) + 2 * kTileRows * kPLd + 2 * kTileRows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int skv, int group,
                         float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int kCols = D / kGrid;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTileRows * LD;
  float* Qs = Vs + kTileRows * LD;
  float* dOs = Qs + kTileRows * LD;
  float* Ps = dOs + kTileRows * LD;
  float* DSs = Ps + kTileRows * kPLd;
  float* Ls = DSs + kTileRows * kPLd;
  float* Dl = Ls + kTileRows;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int bhk = blockIdx.y, k0 = blockIdx.x * kTileRows;
  const int off = skv - sq;
  load_tile<T, D>(Ks, k + ((size_t)bhk * skv + k0) * D);
  load_tile<T, D>(Vs, v + ((size_t)bhk * skv + k0) * D);

  float dka[kPer][kCols], dva[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int n_q = sq / kTileRows;
  for (int g = 0; g < group; ++g) {
    const int bh = bhk * group + g;
    for (int t = 0; t < n_q; ++t) {
      const int q0 = t * kTileRows;
      // causal: skip q tiles whose last row sees none of this kv tile
      if (causal && q0 + kTileRows - 1 + off < k0) continue;
      __syncthreads();
      load_tile<T, D>(Qs, q + ((size_t)bh * sq + q0) * D);
      load_tile<T, D>(dOs, dout + ((size_t)bh * sq + q0) * D);
      if (threadIdx.x < kTileRows) {
        const size_t row = (size_t)bh * sq + q0 + threadIdx.x;
        Ls[threadIdx.x] = lse[row] <= kNegInf * 0.5f ? 0.f : lse[row];
        Dl[threadIdx.x] = delta[row];
      }
      __syncthreads();
      // score tile with q rows ty + 16 i and kv rows tx + 16 j
      float s[kPer][kPer], dp[kPer][kPer];
      tile_dot<D>(s, Qs, Ks, ty, tx);
      tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = ty + kGrid * i;
        const int qpos = off + q0 + r;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          float x = s[i][j] * scale;
          if (causal && qpos < k0 + tx + kGrid * j) x = kNegInf;
          const float p = expf(x - Ls[r]);
          Ps[r * kPLd + tx + kGrid * j] = round_to<T>(p);
          DSs[r * kPLd + tx + kGrid * j] =
              round_to<T>(p * (dp[i][j] - Dl[r]) * scale);
        }
      }
      __syncthreads();
      // dv += pc^T dO and dk += ds^T Q, for kv rows ty + 16 i
#pragma unroll 2
      for (int r = 0; r < kTileRows; ++r) {
        float pc[kPer], ds[kPer], dov[kCols], qv[kCols];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          pc[i] = Ps[r * kPLd + ty + kGrid * i];
          ds[i] = DSs[r * kPLd + ty + kGrid * i];
        }
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          dov[cc] = dOs[r * LD + tx + kGrid * cc];
          qv[cc] = Qs[r * LD + tx + kGrid * cc];
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            dva[i][cc] = fmaf(pc[i], dov[cc], dva[i][cc]);
            dka[i][cc] = fmaf(ds[i], qv[cc], dka[i][cc]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const size_t row = (size_t)bhk * skv + k0 + ty + kGrid * i;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      dk[row * D + tx + kGrid * cc] = from_f32<T>(dka[i][cc]);
      dv[row * D + tx + kGrid * cc] = from_f32<T>(dva[i][cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename Kernel>
static cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  int bh, bhk, sq, skv;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D> static int fwd(const Args& a) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T, D><<<dim3(a.sq / kTileRows, a.bh), kThreads, smem,
                           a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse_out), a.sq, a.skv, a.bh / a.bhk, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D> static int bwd_dq(const Args& a) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, D><<<dim3(a.sq / kTileRows, a.bh), kThreads, smem,
                              a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.sq, a.skv, a.bh / a.bhk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D> static int bwd_dkv(const Args& a) {
  const size_t smem = dkv_smem<D>();
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, D><<<dim3(a.skv / kTileRows, a.bhk), kThreads,
                               smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.skv,
      a.bh / a.bhk, a.scale, a.causal);
  return (int)cudaGetLastError();
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

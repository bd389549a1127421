// Tile kernels of flash attention for Hopper (sm_90a), shared by the dense
// flash entry points (flash_attention.cu) and the block-sparse ones
// (sparse_attention.cu).
//
// The three kernels compute the TPU flash kernels' functions: q [BH, Sq, D],
// k/v [BHk, Skv, D] with batch folded into the head axis (q head row b reads
// kv row b / group), scores in f32 scaled by `scale`, a causal mask aligned
// bottom-right (off = Skv - Sq; key c is visible to query r iff
// off + r >= c), masked scores -1e30, and the TPU kernels' dtype casts: p
// is rounded to the input dtype before P.V and before the dv product, ds
// before the dq and dk products. The forward returns o (input dtype) and
// lse [BH, Sq] in f32; a row that sees no key gives o = 0 and lse = -1e30
// (the m_safe / l == 0 substitutions), and zero gradients in the backward
// (lse_safe).
//
// Which tiles a block visits is a Walk policy, so one set of kernels serves
// the dense causal range (RangeWalk, flash_attention.cu) and the active
// blocks of a sparse layout (TableWalk, sparse_attention.cu):
//
//   kv_steps(bh, q0) / kv_tile(bh, q0, e, k0): the kv tiles that the q tile
//     at row q0 of q head row bh reads (forward, dq); false skips step e;
//   q_steps(bhk, k0) / q_tile(bhk, k0, e, bh, q0): the (q head row, q tile)
//     pairs that feed the kv tile at row k0 of kv head row bhk (dk/dv).
//
// A walk answers from blockIdx-level values only, so a skipped step is
// skipped by the whole block and the __syncthreads() stay uniform.
//
// Bound on an H100: operations. At the training and sparse shapes the
// products are ~TILE / 2 multiply-adds per byte moved or more, far above the
// 295 flop/byte line, so the least time is the tensor-core time of the
// products. These kernels do not reach it: they multiply on the CUDA cores
// in f32 (FMA), from f32 tiles in shared memory. They serve what has not
// moved to the tensor-core kernels of flash_hopper.cuh yet: the dense
// forward, dq and dk/dv for f32 inputs (the tensor cores take f32 only as
// TF32), and the three block-sparse kernels (sparse_attention.cu). Their design is the plain one that is easy to hold
// right against the TPU kernels:
//
//   * one block of 256 threads (a 16 x 16 grid) per (head row, TILE-row
//     tile), TILE in {16, 32, 64}; each thread owns a PER x PER block
//     (PER = TILE / 16) of the TILE x TILE score tile and a PER x (D / 16)
//     block of the output tile, in registers;
//   * tiles live in shared memory as f32 with rows padded by one word, so
//     the score loop (16 different key rows at one column) and the P.V
//     loop (16 consecutive columns) read without bank conflicts;
//   * the online softmax keeps m and l per row, reduced over the row's 16
//     threads with a fixed shuffle tree;
//   * dk/dv: one block per (kv head row, kv tile) walks its q tiles and
//     accumulates dk and dv in registers. No atomics anywhere, so a repeated
//     backward is bit-identical.
//
// They use neither the tensor cores nor asynchronous copies, and hold one
// block per SM at TILE 64, D = 128 (116-166 KB of shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace ds_flash {

constexpr int kGrid = 16;                // threads per tile side
constexpr int kThreads = kGrid * kGrid;  // 256
constexpr float kNegInf = -1e30f;

// dtype codes and conversions through f32 (vec_io.cuh)
using ds_vec::DType;
using ds_vec::from_f32;
using ds_vec::kBF16;
using ds_vec::kF16;
using ds_vec::kF32;
using ds_vec::to_f32;

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

// Rows [0, ROWS) of a row-major [*, D] matrix into an f32 tile with row
// stride D + 1.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src) {
  for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = to_f32<T>(src[(size_t)r * D + c]);
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two padded tiles.
template <int D, int PER>
__device__ __forceinline__ void tile_dot(float (&s)[PER][PER], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int j = 0; j < PER; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[PER], b[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) a[i] = A[(ty + kGrid * i) * LD + d];
#pragma unroll
    for (int j = 0; j < PER; ++j) b[j] = B[(tx + kGrid * j) * LD + d];
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int j = 0; j < PER; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// ---------------------------------------------------------------------------
// forward: grid (Sq / TILE, BH)
// ---------------------------------------------------------------------------
template <int D, int TILE> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * TILE * (D + 1) + TILE * (TILE + 1));
}

template <typename T, int D, int TILE, class Walk>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, int group,
                     float scale, int causal, Walk walk) {
  constexpr int LD = D + 1;
  constexpr int PLD = TILE + 1;
  constexpr int PER = TILE / kGrid;
  constexpr int kCols = D / kGrid;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int bh = blockIdx.y, q0 = blockIdx.x * TILE;
  const int off = skv - sq;
  const T* kp = k + (size_t)(bh / group) * skv * D;
  const T* vp = v + (size_t)(bh / group) * skv * D;
  load_tile<T, D, TILE>(Qs, q + ((size_t)bh * sq + q0) * D);

  float acc[PER][kCols], m[PER], l[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = walk.kv_steps(bh, q0);
  for (int e = 0; e < n_kv; ++e) {
    int k0;
    if (!walk.kv_tile(bh, q0, e, k0)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, TILE>(Ks, kp + (size_t)k0 * D);
    load_tile<T, D, TILE>(Vs, vp + (size_t)k0 * D);
    __syncthreads();
    float s[PER][PER];
    tile_dot<D, PER>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int qpos = off + q0 + ty + kGrid * i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
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
      for (int j = 0; j < PER; ++j) {
        const float p = expf(s[i][j] - m_safe);
        rs += p;
        Ps[(ty + kGrid * i) * PLD + tx + kGrid * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float p[PER], vv[kCols];
#pragma unroll
      for (int i = 0; i < PER; ++i) p[i] = Ps[(ty + kGrid * i) * PLD + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) vv[cc] = Vs[c * LD + tx + kGrid * cc];
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(p[i], vv[cc], acc[i][cc]);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const size_t row = (size_t)bh * sq + q0 + ty + kGrid * i;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      o[row * D + tx + kGrid * cc] = from_f32<T>(acc[i][cc] / l_safe);
    // a row that saw no key keeps m == -1e30 and l == 0: lse = -1e30
    if (tx == 0) lse[row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward dq: grid (Sq / TILE, BH)
// ---------------------------------------------------------------------------
template <int D, int TILE> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * TILE * (D + 1) + TILE * (TILE + 1));
}

template <typename T, int D, int TILE, class Walk>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int skv, int group, float scale, int causal,
                        Walk walk) {
  constexpr int LD = D + 1;
  constexpr int PLD = TILE + 1;
  constexpr int PER = TILE / kGrid;
  constexpr int kCols = D / kGrid;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TILE * LD;
  float* Ks = dOs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* DSs = Vs + TILE * LD;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int bh = blockIdx.y, q0 = blockIdx.x * TILE;
  const int off = skv - sq;
  const T* kp = k + (size_t)(bh / group) * skv * D;
  const T* vp = v + (size_t)(bh / group) * skv * D;
  load_tile<T, D, TILE>(Qs, q + ((size_t)bh * sq + q0) * D);
  load_tile<T, D, TILE>(dOs, dout + ((size_t)bh * sq + q0) * D);

  float lse_safe[PER], dl[PER], acc[PER][kCols];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const size_t row = (size_t)bh * sq + q0 + ty + kGrid * i;
    // fully masked rows carry lse == -1e30; exp(s - lse) would be 1
    lse_safe[i] = lse[row] <= kNegInf * 0.5f ? 0.f : lse[row];
    dl[i] = delta[row];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = walk.kv_steps(bh, q0);
  for (int e = 0; e < n_kv; ++e) {
    int k0;
    if (!walk.kv_tile(bh, q0, e, k0)) continue;
    __syncthreads();
    load_tile<T, D, TILE>(Ks, kp + (size_t)k0 * D);
    load_tile<T, D, TILE>(Vs, vp + (size_t)k0 * D);
    __syncthreads();
    float s[PER][PER], dp[PER][PER];
    tile_dot<D, PER>(s, Qs, Ks, ty, tx);
    tile_dot<D, PER>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int qpos = off + q0 + ty + kGrid * i;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        float x = s[i][j] * scale;
        if (causal && qpos < k0 + tx + kGrid * j) x = kNegInf;
        const float p = expf(x - lse_safe[i]);
        DSs[(ty + kGrid * i) * PLD + tx + kGrid * j] =
            round_to<T>(p * (dp[i][j] - dl[i]) * scale);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float ds[PER], kv[kCols];
#pragma unroll
      for (int i = 0; i < PER; ++i) ds[i] = DSs[(ty + kGrid * i) * PLD + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) kv[cc] = Ks[c * LD + tx + kGrid * cc];
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(ds[i], kv[cc], acc[i][cc]);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const size_t row = (size_t)bh * sq + q0 + ty + kGrid * i;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      dq[row * D + tx + kGrid * cc] = from_f32<T>(acc[i][cc]);
  }
}

// ---------------------------------------------------------------------------
// backward dk/dv: grid (Skv / TILE, BHk)
// ---------------------------------------------------------------------------
template <int D, int TILE> constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * TILE * (D + 1) + 2 * TILE * (TILE + 1) + 2 * TILE);
}

template <typename T, int D, int TILE, class Walk>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int skv, float scale,
                         int causal, Walk walk) {
  constexpr int LD = D + 1;
  constexpr int PLD = TILE + 1;
  constexpr int PER = TILE / kGrid;
  constexpr int kCols = D / kGrid;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* dOs = Qs + TILE * LD;
  float* Ps = dOs + TILE * LD;
  float* DSs = Ps + TILE * PLD;
  float* Ls = DSs + TILE * PLD;
  float* Dl = Ls + TILE;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int bhk = blockIdx.y, k0 = blockIdx.x * TILE;
  const int off = skv - sq;
  load_tile<T, D, TILE>(Ks, k + ((size_t)bhk * skv + k0) * D);
  load_tile<T, D, TILE>(Vs, v + ((size_t)bhk * skv + k0) * D);

  float dka[PER][kCols], dva[PER][kCols];
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int n_q = walk.q_steps(bhk, k0);
  for (int e = 0; e < n_q; ++e) {
    int bh, q0;
    if (!walk.q_tile(bhk, k0, e, bh, q0)) continue;
    __syncthreads();
    load_tile<T, D, TILE>(Qs, q + ((size_t)bh * sq + q0) * D);
    load_tile<T, D, TILE>(dOs, dout + ((size_t)bh * sq + q0) * D);
    if (threadIdx.x < TILE) {
      const size_t row = (size_t)bh * sq + q0 + threadIdx.x;
      Ls[threadIdx.x] = lse[row] <= kNegInf * 0.5f ? 0.f : lse[row];
      Dl[threadIdx.x] = delta[row];
    }
    __syncthreads();
    // score tile with q rows ty + 16 i and kv rows tx + 16 j
    float s[PER][PER], dp[PER][PER];
    tile_dot<D, PER>(s, Qs, Ks, ty, tx);
    tile_dot<D, PER>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = ty + kGrid * i;
      const int qpos = off + q0 + r;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        float x = s[i][j] * scale;
        if (causal && qpos < k0 + tx + kGrid * j) x = kNegInf;
        const float p = expf(x - Ls[r]);
        Ps[r * PLD + tx + kGrid * j] = round_to<T>(p);
        DSs[r * PLD + tx + kGrid * j] =
            round_to<T>(p * (dp[i][j] - Dl[r]) * scale);
      }
    }
    __syncthreads();
    // dv += pc^T dO and dk += ds^T Q, for kv rows ty + 16 i
#pragma unroll 2
    for (int r = 0; r < TILE; ++r) {
      float pc[PER], ds[PER], dov[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        pc[i] = Ps[r * PLD + ty + kGrid * i];
        ds[i] = DSs[r * PLD + ty + kGrid * i];
      }
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        dov[cc] = dOs[r * LD + tx + kGrid * cc];
        qv[cc] = Qs[r * LD + tx + kGrid * cc];
      }
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          dva[i][cc] = fmaf(pc[i], dov[cc], dva[i][cc]);
          dka[i][cc] = fmaf(ds[i], qv[cc], dka[i][cc]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const size_t row = (size_t)bhk * skv + k0 + ty + kGrid * i;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      dk[row * D + tx + kGrid * cc] = from_f32<T>(dka[i][cc]);
      dv[row * D + tx + kGrid * cc] = from_f32<T>(dva[i][cc]);
    }
  }
}

// Sets the kernel's dynamic shared memory limit to `smem` bytes.
template <typename Kernel>
static cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace ds_flash

// The page walk of the ragged paged attention kernel (ragged_attention.cu):
// its route for f32 q and for the shapes the tensor-core tiles do not take
// (ragged_attention.py, ragged_route).
//
// One thread block serves one (query token, kv head) pair: the `group`
// query heads that share kv head `h` (q head i reads kv head i / group, the
// JAX layout q.reshape(N, kvh, group, hd)). The block walks only the
// ceil(length / bs) pages that hold context, never the table width, so
// null-padded tables cost nothing past `length`. Per page it:
//
//   1. copies the page's K and V tiles for its kv head ([n_valid, hd] each)
//      into shared memory in the io dtype T, rows padded by 16 bytes so that
//      the row-per-thread score loop reads without bank conflicts. A pool
//      stored in T is copied with 16-byte loads; an int8 pool is loaded 16
//      bytes at a time and dequantized on the way in, exactly as the TPU
//      kernels' _dequant_tile does it: f32(q8) * scale, rounded to T (the
//      tile is then read back as f32 like any T tile);
//   2. scores every (query head, slot) pair in f32 and scales by 1/sqrt(hd);
//   3. updates the online softmax (running max m, running sum l) with one
//      warp per query head, reducing with a fixed shuffle tree;
//   4. folds P.V into the f32 accumulator: acc = acc * exp(m_prev - m_new)
//      + sum_s p_s v_s.
//
// Slots past `length` on the last page are never loaded, scored or summed,
// which equals the -1e30 mask of the TPU kernels (their exp underflows to an
// exact 0). The output is acc / l (acc / 1 when l == 0), so a token with
// length 0 walks no page and writes exact zeros.
//
// Where a row's pages lie is a Slots policy: PagedSlots reads a block table
// over the pool [nb, bs, kvh, hd]. The paged decode kernel walks pages
// otherwise (the split-K walk of split_walk.cuh, another reduction order),
// so on this route a pure-decode ragged batch agrees with it to rounding,
// not bit for bit; on the tile route its single-token runs are the paged
// kernel's own walk, bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "vec_io.cuh"

namespace ds_paged {

using ds_vec::from_f32;
using ds_vec::to_f32;

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// What a KV pool of io dtype T stores: T, or int8 under kv_quant.
template <typename T, bool Q8>
using Pool = typename std::conditional<Q8, int8_t, T>::type;

// Elements per 16-byte vector, and the padded row stride of a tile.
template <typename T> __host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(T);
}
template <typename T> __host__ __device__ inline int tile_ld(int hd) {
  return hd + vec_elems<T>();
}

// Dynamic shared memory one block needs: K and V tiles, the group's q rows,
// scores, accumulator and the per-head softmax state.
template <typename T>
inline size_t smem_bytes(int hd, int bs, int group) {
  return 2 * (size_t)bs * tile_ld<T>(hd) * sizeof(T) +
         sizeof(float) * ((size_t)group * hd * 2 + (size_t)group * bs +
                          (size_t)group * 3);
}

// One (row, kv head) of a paged pool [nb, bs, kvh, hd], through the row's
// block table. The int8 pool's scales are [nb, kvh].
struct PagedSlots {
  const int* table;
  int kv_head, kvh, hd, bs;
  __device__ __forceinline__ size_t page_offset(int j) const {
    return ((size_t)table[j] * bs * kvh + kv_head) * hd;
  }
  __device__ __forceinline__ size_t slot_stride() const {
    return (size_t)kvh * hd;
  }
  __device__ __forceinline__ size_t scale_index(int j) const {
    return (size_t)table[j] * kvh + kv_head;
  }
};

// Copy n_valid slots of one page into a padded shared tile. A pool stored in
// the io dtype T moves in 16-byte vectors.
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int n_valid, int hd, size_t stride,
                                          int ld, float) {
  constexpr int V = vec_elems<T>();
  const int row_vecs = hd / V;
  for (int i = threadIdx.x; i < n_valid * row_vecs; i += kThreads) {
    const int s = i / row_vecs;
    const int c = (i - s * row_vecs) * V;
    *reinterpret_cast<uint4*>(dst + s * ld + c) =
        *reinterpret_cast<const uint4*>(src + s * stride + c);
  }
}

// An int8 pool moves 16 values per 16-byte load and is dequantized into the
// tile: f32 product with the page's scale, rounded once to T (_dequant_tile).
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const int8_t* __restrict__ src,
                                          int n_valid, int hd, size_t stride,
                                          int ld, float scale) {
  constexpr int V = 16;
  const int row_vecs = hd / V;
  for (int i = threadIdx.x; i < n_valid * row_vecs; i += kThreads) {
    const int s = i / row_vecs;
    const int c = (i - s * row_vecs) * V;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + s * stride + c);
    const int8_t* q8 = reinterpret_cast<const int8_t*>(&raw);
    T* d = dst + s * ld + c;
#pragma unroll
    for (int u = 0; u < V; ++u) d[u] = from_f32<T>((float)q8[u] * scale);
  }
}

// q_rows / out_rows: the block's [group, hd] query and output rows, in T.
// k_pool / v_pool: one layer's K and V storage (T, or int8 with per-page
// scales k_scale / v_scale; the scales are not read for a T pool).
// slots: where this (row, kv head)'s pages lie; max_pages caps the walk.
template <typename T, typename S, typename Slots>
__device__ __forceinline__ void attend_row(
    const T* __restrict__ q_rows, const S* __restrict__ k_pool,
    const S* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const Slots& slots, int length,
    int max_pages, int hd, int bs, int group, float scale,
    T* __restrict__ out_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile_ld<T>(hd);
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)bs * ld;
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)bs * ld);
  float* acc = q_s + group * hd;
  float* sc = acc + group * hd;
  float* m_s = sc + group * bs;
  float* l_s = m_s + group;
  float* corr_s = l_s + group;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gh = group * hd;
  constexpr int V = vec_elems<T>();

  for (int e = tid; e < gh; e += kThreads) {
    q_s[e] = to_f32<T>(q_rows[e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  int n_pages = (length + bs - 1) / bs;
  if (n_pages > max_pages) n_pages = max_pages;  // no pages past the table
  const size_t stride = slots.slot_stride();

  for (int j = 0; j < n_pages; ++j) {
    int n_valid = length - j * bs;
    if (n_valid > bs) n_valid = bs;
    const size_t off = slots.page_offset(j);
    float ks = 1.f, vs = 1.f;
    if (k_scale != nullptr) {
      ks = k_scale[slots.scale_index(j)];
      vs = v_scale[slots.scale_index(j)];
    }

    __syncthreads();  // the previous page's tiles and scores are consumed
    load_tile(k_s, k_pool + off, n_valid, hd, stride, ld, ks);
    load_tile(v_s, v_pool + off, n_valid, hd, stride, ld, vs);
    __syncthreads();

    // scores: one (query head, slot) pair per thread and pass
    for (int p = tid; p < group * bs; p += kThreads) {
      const int g = p / bs;
      const int s = p - g * bs;
      if (s < n_valid) {
        const float* qg = q_s + g * hd;
        const T* kr = k_s + s * ld;
        float dot = 0.f;
        for (int c = 0; c < hd; c += V) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
          const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int u = 0; u < V; ++u) dot += qg[c + u] * to_f32<T>(kv[u]);
        }
        sc[p] = dot * scale;
      }
    }
    __syncthreads();

    // online softmax state: one warp per query head
    for (int g = warp; g < group; g += kThreads / 32) {
      float* sg = sc + g * bs;
      float mx = kNegInf;
      for (int s = lane; s < n_valid; s += 32) mx = fmaxf(mx, sg[s]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < n_valid; s += 32) {
        const float pv = expf(sg[s] - m_new);
        sg[s] = pv;
        sum += pv;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P.V into the accumulator: one (query head, dim) element per thread
    for (int e = tid; e < gh; e += kThreads) {
      const int g = e / hd;
      const int d = e - g * hd;
      const float* pg = sc + g * bs;
      float pv = 0.f;
      for (int s = 0; s < n_valid; ++s)
        pv += pg[s] * to_f32<T>(v_s[s * ld + d]);
      acc[e] = acc[e] * corr_s[g] + pv;
    }
  }
  __syncthreads();
  for (int e = tid; e < gh; e += kThreads) {
    const float l = l_s[e / hd];
    out_rows[e] = from_f32<T>(acc[e] / (l == 0.f ? 1.f : l));
  }
}

// Launch helper shared by the entry points: raises the dynamic shared
// memory cap when a tile needs more than the default 48 KB.
template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

}  // namespace ds_paged

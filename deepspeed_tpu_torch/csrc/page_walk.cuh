// Shared page walk of the paged decode and ragged paged attention kernels.
//
// One thread block serves one (query row, kv head) pair: the `group` query
// heads that share kv head `h` (q head i reads kv head i / group, the JAX
// layout q.reshape(N, kvh, group, hd)). The block walks only the
// ceil(length / bs) pages of its block table that hold context, never the
// table width, so null-padded tables cost nothing. Per page it:
//
//   1. copies the page's K and V tiles for its kv head ([n_valid, hd] each,
//      16-byte loads) into shared memory, rows padded by 16 bytes so that
//      the row-per-thread score loop reads without bank conflicts;
//   2. scores every (query head, slot) pair in f32 and scales by 1/sqrt(hd);
//   3. updates the online softmax (running max m, running sum l) with one
//      warp per query head, reducing with a fixed shuffle tree;
//   4. folds P.V into the f32 accumulator: acc = acc * exp(m_prev - m_new)
//      + sum_s p_s v_s.
//
// Slots past `length` on the last page are never loaded, scored or summed,
// which equals the -1e30 mask of the TPU kernel (their exp underflows to an
// exact 0). The output is acc / l (acc / 1 when l == 0), so a token with
// length 0 walks no page and writes exact zeros.
//
// Both entry points call attend_row with the same launch geometry
// (kThreads threads, one block per (row, kv head)), so their reductions run
// in one order and a pure-decode ragged batch is bit-identical to the decode
// kernel on the same inputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ds_paged {

constexpr int kThreads = 128;
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

// q_rows / out_rows: the block's [group, hd] query and output rows.
// k_cache / v_cache: one layer's pool, [nb, bs, kvh, hd].
// table: this row's block table, [mb].
template <typename T>
__device__ __forceinline__ void attend_row(
    const T* __restrict__ q_rows, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ table, int length,
    int mb, int kv_head, int kvh, int hd, int bs, int group, float scale,
    T* __restrict__ out_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile_ld<T>(hd);
  constexpr int V = vec_elems<T>();
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

  for (int e = tid; e < gh; e += kThreads) {
    q_s[e] = to_f32<T>(q_rows[e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  int n_pages = (length + bs - 1) / bs;
  if (n_pages > mb) n_pages = mb;  // a bound past the table has no pages
  const int row_vecs = hd / V;
  const size_t slot_stride = (size_t)kvh * hd;
  const size_t page_stride = (size_t)bs * slot_stride;

  for (int j = 0; j < n_pages; ++j) {
    const size_t page = (size_t)table[j];
    int n_valid = length - j * bs;
    if (n_valid > bs) n_valid = bs;
    const T* kp = k_cache + page * page_stride + (size_t)kv_head * hd;
    const T* vp = v_cache + page * page_stride + (size_t)kv_head * hd;

    __syncthreads();  // the previous page's tiles and scores are consumed
    for (int i = tid; i < n_valid * row_vecs; i += kThreads) {
      const int s = i / row_vecs;
      const int c = (i - s * row_vecs) * V;
      *reinterpret_cast<uint4*>(k_s + s * ld + c) =
          *reinterpret_cast<const uint4*>(kp + s * slot_stride + c);
      *reinterpret_cast<uint4*>(v_s + s * ld + c) =
          *reinterpret_cast<const uint4*>(vp + s * slot_stride + c);
    }
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

// Launch helper shared by both entry points: raises the dynamic shared
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

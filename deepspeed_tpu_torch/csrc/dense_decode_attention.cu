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
// Bound on an H100: bytes. Each (row, kv head) must read 2 * length * hd
// elements of K and V once at 3.35 TB/s; the score and P.V work is
// 4 * group * hd flops per slot, far below the tensor-core line, so the
// math stays on the CUDA cores. The design is a split-K walk:
//
//   * grid (B * kvh, n_split): each block takes one chunk of `chunk` slots
//     (a multiple of the tile) of one (row, kv head). The wrapper's plan
//     (ops/decode_attention.py, split_plan) picks the chunk so that the
//     grid holds several blocks per SM even at small batch. A block whose
//     chunk starts at or past `length` returns before it copies anything;
//   * a chunk of one (row, kv head) is one contiguous span of the cache,
//     so one producer thread fills a ring of two K/V stages with
//     cp.async.bulk (hopper_async.cuh), a tile of 64 slots a stage (32 or
//     16 for long rows), only the valid slots of the last tile, each stage
//     guarded by a full / empty mbarrier pair. Four consumer warps score,
//     update the softmax and fold in P.V on one stage while the next one
//     is in flight;
//   * lane route (a group of 1, 2, 4 or 8 q heads and rows of 1, 2, 4,
//     ..., 32 16-byte vectors, as Mistral-7B's group 4 at head_dim 128):
//     lane c of a row's lanes owns the row's 16-byte vector c, holds the
//     group's q for it in f32 registers and its slice of the group's
//     accumulator; a warp takes 32 / vecs slots a step, so K and V are
//     read from shared memory once, conflict-free. Scores are the lanes'
//     partial dots summed by a fixed shuffle tree; P.V accumulates in
//     registers, and the warp's lanes and then the four warps are summed
//     in a fixed order at the end of the chunk;
//   * generic route (any other group or head_dim): one (q head, slot) pair
//     per thread, walking the row in 16-byte vectors from a per-slot
//     rotation, against q in f32 in shared memory (its float4 halves
//     swapped on every other group of four vectors), so neither read has
//     bank conflicts; P.V: one 16-byte vector of one q head's output per
//     thread, the slots split over `parts` accumulators when the output
//     has fewer vectors than threads;
//   * both: the online softmax with one warp per q head, as the paged
//     kernels, between two barriers of the consumer warps;
//   * combine in the same launch, in a fixed order: a chunk that is the
//     row's only one writes out directly. Otherwise each split writes its
//     partial (m, l, acc[group, hd]) in f32 to the workspace, and the last
//     block of the (row, kv head) to finish (an atomic ticket taken after
//     __threadfence()) combines the partials in split index order, writes
//     out and resets its ticket to 0. The result is the same every run.
//     The workspace and the tickets persist per device (the wrapper zeroes
//     the tickets once, when it makes them), so a call is one launch.
#include "hopper_async.cuh"
#include "vec_io.cuh"

#include <type_traits>

namespace ds_decode {

using namespace ds_async;
using ds_vec::from_f32;
using ds_vec::to_f32;

constexpr int kTile = 64;                    // slots per stage and chunk unit
constexpr int kConsumers = 128;              // threads that score and sum
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;    // + one producer warp
constexpr int kStages = 2;                   // K/V ring depth
constexpr int kMaxRingBytes = 128 * 1024;    // the ring at most this
constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// The lane route serves a group of 1, 2, 4 or 8 q heads and rows of 1 to
// 32 16-byte vectors; every other shape takes the generic route.
__host__ __device__ inline bool lane_route(int group, int vecs) {
  return (group == 1 || group == 2 || group == 4 || group == 8) && vecs <= 32
         && (vecs & (vecs - 1)) == 0;
}

// Dynamic shared memory of one block, the same on host and device.
// A stage holds `tile` slots of K and of V: kTile, or 32 / 16 for rows so
// long that a ring of kTile would not fit kMaxRingBytes.
struct Layout {
  int tile, row_bytes, parts;
  size_t k, v, q, sc, corr, m, l, acc, bar, flag, bytes;
};

__host__ __device__ inline Layout layout(int hd, int group, int elem) {
  Layout L;
  L.row_bytes = hd * elem;
  const int vecs = L.row_bytes / 16;  // 16-byte vectors per row
  const bool lanes = lane_route(group, vecs);
  L.tile = kTile;
  while (L.tile > 16 && 2 * kStages * L.tile * L.row_bytes > kMaxRingBytes)
    L.tile /= 2;
  // partial accumulators: one per warp on the lane route; on the generic
  // route the slots are split over `parts` when the output has fewer
  // 16-byte vectors than there are threads
  L.parts = lanes ? kWarps
            : group * vecs >= kConsumers ? 1 : kConsumers / (group * vecs);
  size_t o = 0;
  L.k = o;
  o += (size_t)kStages * L.tile * L.row_bytes;
  L.v = o;
  o += (size_t)kStages * L.tile * L.row_bytes;
  L.q = o;  // the group's q rows in f32 (generic route)
  o += lanes ? 0 : round16(sizeof(float) * group * hd);
  L.sc = o;  // two score buffers (tile parity)
  o += round16(2 * sizeof(float) * group * L.tile);
  L.corr = o;  // two correction buffers
  o += round16(2 * sizeof(float) * group);
  L.m = o;
  o += round16(sizeof(float) * group);
  L.l = o;
  o += round16(sizeof(float) * group);
  L.acc = o;
  o += round16(sizeof(float) * L.parts * group * hd);
  L.bar = o;
  o += 16 * kStages;
  L.flag = o;
  o += 16;
  L.bytes = o;
  return L;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// V elements of T (one 16-byte vector) as f32.
template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[V]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < V; ++u) f[u] = to_f32<T>(e[u]);
}

// ws_ml: [B * kvh, n_split, 2, group] (m, then l); ws_acc: [B * kvh,
// n_split, group, hd]; tickets: [B * kvh], zero between launches.
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
  constexpr int V = 16 / (int)sizeof(T);
  const int group = G > 0 ? G : nh / kvh;
  const Layout L = layout(hd, group, (int)sizeof(T));
  extern __shared__ __align__(128) uint8_t smem[];
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* corr = reinterpret_cast<float*>(smem + L.corr);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + kStages;
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  const int pair = blockIdx.x;  // b * kvh + kv head
  const int b = pair / kvh;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  int length = lengths[b];
  length = length < 0 ? 0 : length > m ? m : length;
  const int active = length == 0 ? 1 : (length + chunk - 1) / chunk;
  if (split >= active) return;  // past `length`: no copy, no partial
  const int start = split * chunk;
  const int end = min(length, start + chunk);
  const int tile = L.tile;
  const int n_tiles = end > start ? (end - start + tile - 1) / tile : 0;
  const size_t slot0 = (size_t)pair * m + start;  // first cache row
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread issues every copy -------------------------
    if (tid != kConsumers) return;
    for (int e = 0; e < n_tiles; ++e) {
      const int s = e % kStages;
      if (e >= kStages) mbar_wait(&empty[s], ((e / kStages) - 1) & 1);
      const int n_valid = min(tile, end - start - e * tile);
      const uint32_t bytes = (uint32_t)n_valid * L.row_bytes;
      const size_t row = (slot0 + (size_t)e * tile) * hd;
      mbar_expect_tx(&full[s], 2 * bytes);
      bulk_load(k_s + (size_t)s * tile * hd, k_cache + row, bytes, &full[s]);
      bulk_load(v_s + (size_t)s * tile * hd, v_cache + row, bytes, &full[s]);
    }
    return;
  }

  // ---- consumers --------------------------------------------------------
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gh = group * hd;
  const int vecs = L.row_bytes / 16;  // 16-byte vectors per row
  const size_t rows = ((size_t)b * nh + (size_t)(pair % kvh) * group) * hd;
  // lane route: lane `lane` holds vector c of one slot's row, for
  // 32 / vecs slots per warp step, and its q vectors and accumulators of
  // all G heads in registers
  constexpr int GR = G > 0 ? G : 1;
  const int c = lane % vecs;
  const int sub = lane / vecs;
  const int per_step = 32 / vecs;
  float qr[GR][V], ar[GR][V];
  if constexpr (G > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      load_f32<T, V>(q + rows + g * hd + c * V, qr[g]);
#pragma unroll
      for (int u = 0; u < V; ++u) ar[g][u] = 0.f;
    }
  } else {
    // q in f32, each row's 16-byte vectors of T as V floats; for V == 8
    // the two float4 halves of vector c swap places when bit 2 of c is
    // set, so that 8 threads at 8 consecutive (rotated) vectors read 8
    // different bank groups
    for (int i = tid; i < gh; i += kConsumers) {
      const int g = i / hd, d = i - g * hd, cv = d / V, j = d - cv * V;
      const int half = V == 8 ? ((j >> 2) ^ ((cv >> 2) & 1)) : 0;
      q_s[g * hd + cv * V + half * 4 + (j & 3)] = to_f32<T>(q[rows + i]);
    }
    for (int i = tid; i < L.parts * gh; i += kConsumers) acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kConsumers) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  consumer_sync();

  for (int e = 0; e < n_tiles; ++e) {
    const int s = e % kStages;
    const int n_valid = min(tile, end - start - e * tile);
    const T* kt = k_s + (size_t)s * tile * hd;
    const T* vt = v_s + (size_t)s * tile * hd;
    // the previous tile's P.V still reads the other buffers
    float* sct = sc + (e & 1) * group * tile;
    float* cr = corr + (e & 1) * group;
    mbar_wait(&full[s], (e / kStages) & 1);

    if constexpr (G > 0) {
      // scores: each lane's partial dots over its vector, summed over the
      // row's lanes by a fixed shuffle tree
      for (int base = warp * per_step; base < n_valid;
           base += kWarps * per_step) {
        const int sl = base + sub;
        const bool valid = sl < n_valid;
        float kf[V], dot[G];
        if (valid) load_f32<T, V>(kt + sl * hd + c * V, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.f;
#pragma unroll
          for (int u = 0; u < V; ++u) d = fmaf(qr[g][u], valid ? kf[u] : 0.f, d);
          dot[g] = d;
        }
        for (int o = vecs / 2; o > 0; o >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
        if (valid && c == 0)
#pragma unroll
          for (int g = 0; g < G; ++g) sct[g * tile + sl] = dot[g] * scale;
      }
    } else {
      // scores: one (q head, slot) pair per thread and pass, walking the
      // row from a per-slot rotation
      for (int p = tid; p < group * tile; p += kConsumers) {
        const int g = p / tile;
        const int sl = p - g * tile;
        if (sl < n_valid) {
          const T* kr = kt + sl * hd;
          const float4* qf = reinterpret_cast<const float4*>(q_s + g * hd);
          float dot[V];  // V independent sums, added in a fixed order
#pragma unroll
          for (int u = 0; u < V; ++u) dot[u] = 0.f;
          int cv = sl % vecs;
#pragma unroll 2
          for (int i = 0; i < vecs; ++i) {
            float kf[V], qv[V];
            load_f32<T, V>(kr + cv * V, kf);
            const int sw = V == 8 ? (cv >> 2) & 1 : 0;
            *reinterpret_cast<float4*>(qv) = qf[cv * (V / 4) + sw];
            if (V == 8)
              *reinterpret_cast<float4*>(qv + 4 * (V / 8)) =
                  qf[cv * (V / 4) + (sw ^ 1)];
#pragma unroll
            for (int u = 0; u < V; ++u) dot[u] = fmaf(qv[u], kf[u], dot[u]);
            cv = cv + 1 == vecs ? 0 : cv + 1;
          }
#pragma unroll
          for (int w = V / 2; w > 0; w /= 2)
#pragma unroll
            for (int u = 0; u < w; ++u) dot[u] += dot[u + w];
          sct[p] = dot[0] * scale;
        }
      }
    }
    consumer_sync();

    // online softmax state: one warp per q head
    for (int g = warp; g < group; g += kWarps) {
      float* sg = sct + g * tile;
      float mx = kNegInf;
      for (int i = lane; i < n_valid; i += 32) mx = fmaxf(mx, sg[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int i = lane; i < n_valid; i += 32) {
        const float pv = expf(sg[i] - m_new);
        sg[i] = pv;
        sum += pv;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float cf = expf(m_prev - m_new);
        cr[g] = cf;
        l_s[g] = l_s[g] * cf + sum;
        m_s[g] = m_new;
      }
    }
    consumer_sync();

    if constexpr (G > 0) {
      // P.V into the lane's registers, the same slots as its scores
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float cf = cr[g];
#pragma unroll
        for (int u = 0; u < V; ++u) ar[g][u] *= cf;
      }
      for (int sl = warp * per_step + sub; sl < n_valid;
           sl += kWarps * per_step) {
        float vf[V];
        load_f32<T, V>(vt + sl * hd + c * V, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float w = sct[g * tile + sl];
#pragma unroll
          for (int u = 0; u < V; ++u) ar[g][u] = fmaf(w, vf[u], ar[g][u]);
        }
      }
    } else {
      // P.V: one (part, q head, 16-byte vector) item per thread and pass
      for (int it = tid; it < L.parts * group * vecs; it += kConsumers) {
        const int part = it / (group * vecs);
        const int r = it - part * group * vecs;
        const int g = r / vecs;
        const int cv = r - g * vecs;
        const float* pg = sct + g * tile;
        float pv[V];
#pragma unroll
        for (int u = 0; u < V; ++u) pv[u] = 0.f;
#pragma unroll 4
        for (int sl = part; sl < n_valid; sl += L.parts) {
          float vf[V];
          load_f32<T, V>(vt + sl * hd + cv * V, vf);
          const float w = pg[sl];
#pragma unroll
          for (int u = 0; u < V; ++u) pv[u] = fmaf(w, vf[u], pv[u]);
        }
        float* a = acc + (size_t)part * gh + g * hd + cv * V;
        const float cf = cr[g];
#pragma unroll
        for (int u = 0; u < V; ++u) a[u] = a[u] * cf + pv[u];
      }
    }
    mbar_arrive(&empty[s]);  // K and V of this stage are consumed
  }
  if constexpr (G > 0) {
    // the warp's slot groups summed by a fixed shuffle tree; one partial
    // per warp
    for (int o = vecs; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < V; ++u)
          ar[g][u] += __shfl_xor_sync(0xffffffffu, ar[g][u], o);
    if (sub == 0)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < V; ++u)
          acc[(size_t)warp * gh + g * hd + c * V + u] = ar[g][u];
  }
  consumer_sync();
  if (active == 1) {  // the row's only chunk: out = acc / l
    for (int i = tid; i < gh; i += kConsumers) {
      float a = acc[i];
      for (int p = 1; p < L.parts; ++p) a += acc[(size_t)p * gh + i];
      const float l = l_s[i / hd];
      out[rows + i] = from_f32<T>(a / (l == 0.f ? 1.f : l));
    }
    return;
  }

  // this split's partial, then the ticket
  const size_t part_ix = (size_t)pair * n_split + split;
  float* wm = ws_ml + part_ix * 2 * group;
  for (int i = tid; i < gh; i += kConsumers) {
    float a = acc[i];
    for (int p = 1; p < L.parts; ++p) a += acc[(size_t)p * gh + i];
    ws_acc[part_ix * gh + i] = a;
  }
  for (int g = tid; g < group; g += kConsumers) {
    wm[g] = m_s[g];
    wm[group + g] = l_s[g];
  }
  __threadfence();
  consumer_sync();
  if (tid == 0) *flag = atomicAdd(&tickets[pair], 1);
  consumer_sync();
  if (*flag != active - 1) return;
  __threadfence();

  // the last split of this (row, kv head): combine in split index order
  const size_t first = (size_t)pair * n_split;
  for (int i = tid; i < gh; i += kConsumers) {
    const int g = i / hd;
    float mx = kNegInf, l = 0.f, a = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < active; ++sp) {  // one pass, rescaling as it goes
      const float* pm = ws_ml + (first + sp) * 2 * group;
      const float ms = __ldcg(pm + g);
      const float mn = fmaxf(mx, ms);
      const float keep = expf(mx - mn), w = expf(ms - mn);
      l = l * keep + __ldcg(pm + group + g) * w;
      a = a * keep + __ldcg(ws_acc + (first + sp) * gh + i) * w;
      mx = mn;
    }
    // every split holds a valid slot, so l >= 1
    out[rows + i] = from_f32<T>(a / l);
  }
  if (tid == 0) tickets[pair] = 0;
}

template <typename T, int G>
static int launch_g(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, void* ws_ml, void* ws_acc,
                  void* tickets, int b, int nh, int kvh, int hd, int m,
                  int chunk, int n_split, float scale, void* stream) {
  const Layout L = layout(hd, nh / kvh, (int)sizeof(T));
  if (L.bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = dense_decode_split_kernel<T, G>;
  if (L.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(b * kvh, n_split), kThreads, L.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), static_cast<float*>(ws_ml),
      static_cast<float*>(ws_acc), static_cast<int*>(tickets), nh, kvh, hd,
      m, chunk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, void* ws_ml, void* ws_acc,
                  void* tickets, int b, int nh, int kvh, int hd, int m,
                  int chunk, int n_split, float scale, void* stream) {
  const int group = nh / kvh;
  auto run = [&](auto g) {
    return launch_g<T, decltype(g)::value>(q, k, v, lengths, out, ws_ml,
                                          ws_acc, tickets, b, nh, kvh, hd,
                                          m, chunk, n_split, scale, stream);
  };
  if (!lane_route(group, hd * (int)sizeof(T) / 16))
    return run(std::integral_constant<int, 0>());
  switch (group) {
    case 1: return run(std::integral_constant<int, 1>());
    case 2: return run(std::integral_constant<int, 2>());
    case 4: return run(std::integral_constant<int, 4>());
    default: return run(std::integral_constant<int, 8>());
  }
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

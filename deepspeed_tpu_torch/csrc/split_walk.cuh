// The split-K decode walk shared by the dense decode kernel
// (dense_decode_attention.cu) and the paged decode kernel
// (paged_attention.cu): one query token per row attends over the slots of
// its (row, kv head), and the two kernels differ only in where a row's
// slots lie. A Source policy says that: it copies one tile of slots into
// the ring. Everything else is this file's.
//
// Bound on an H100: bytes. Each (row, kv head) must read its used K and V
// slots once at 3.35 TB/s; the score and P.V work is 4 * group * hd flops
// per slot, far below the tensor-core line, so the math stays on the CUDA
// cores. The walk:
//
//   * grid (rows * kvh, n_split): each block takes one chunk of `chunk`
//     slots (a multiple of the tile) of one (row, kv head); the wrappers'
//     plans pick the chunk so that the grid holds several blocks per SM
//     even at small batch. A block whose chunk starts at or past the row's
//     length returns before it copies anything. (The ragged kernel's
//     single-token runs launch fewer blocks, each taking several (row, kv
//     head) pairs in turn with the same chunks: paged_attention.cu);
//   * one producer warp fills a ring of kStages K/V stages, each stage one
//     tile of `tile` slots (64, fewer for long rows or small pages), only
//     the valid slots of the last tile, guarded by a full / empty mbarrier
//     pair (hopper_async.cuh); the Source decides how the bytes move. Four
//     consumer warps score, update the softmax and fold in P.V on one
//     stage while the next is in flight;
//   * a pool stored in int8 (kv_quant) moves int8 rows and is dequantized
//     as the consumers read it, exactly as the TPU kernels' _dequant_tile
//     does: f32(q8) * scale, rounded to the io dtype T, read back as f32.
//     The source stages the tile's per-(page, head) f32 scales in shared
//     memory before it arrives on the stage's full barrier;
//   * lane route (a group of 1, 2, 4 or 8 q heads and rows of 1, 2, 4,
//     ..., 32 16-byte vectors of T, as Mistral-7B's group 4 at head_dim
//     128): lane c of a row's lanes owns the row's elements
//     [c * V, (c + 1) * V) (V = 16 / sizeof(T)), holds the group's q for
//     them in f32 registers and its slice of the group's accumulator; a
//     warp takes 32 / vecs slots a step, so K and V are read from shared
//     memory once, conflict-free (rows land back to back). Scores are the
//     lanes' partial dots summed by a fixed shuffle tree; P.V accumulates
//     in registers, and the warp's lanes and then the four warps are
//     summed in a fixed order at the end of the chunk;
//   * generic route (any other group or head_dim): one (q head, slot)
//     pair per thread, walking the row in vectors from a per-slot
//     rotation, against q in f32 in shared memory (its float4 halves
//     swapped on every other group of four vectors), so neither read has
//     bank conflicts; P.V: one vector of one q head's output per thread,
//     the slots split over `parts` accumulators when the output has fewer
//     vectors than threads;
//   * both: the online softmax with one warp per q head between two
//     barriers of the consumer warps. A softmax state per warp, folded at
//     the end, would need no barrier inside the walk, but it measured
//     slower on an H100: every warp then reduces all the group's heads;
//   * combine in the same launch, in a fixed order: a chunk that is the
//     row's only one writes out directly. Otherwise each split writes its
//     partial (m, l, acc[group, hd]) in f32 to the workspace, and the last
//     block of the (row, kv head) to finish (an atomic ticket taken after
//     __threadfence()) combines the partials in split index order, writes
//     out and resets its ticket to 0. The result is the same every run.
//     The workspace and the tickets persist per device (the wrappers zero
//     the tickets once, when they make them), so a call is one launch.
//
// Slots past `length` are never copied, scored or summed, which equals the
// -1e30 mask of the TPU kernels (their exp underflows to an exact 0); a
// row of length 0 writes exact zeros.
#pragma once

#include "hopper_async.cuh"
#include "vec_io.cuh"

#include <type_traits>

namespace ds_split {

using namespace ds_async;
using ds_vec::from_f32;
using ds_vec::to_f32;

constexpr int kTile = 64;                    // slots per stage at most
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
// 32 16-byte vectors of the io dtype; every other shape takes the generic
// route.
__host__ __device__ inline bool lane_route(int group, int vecs) {
  return (group == 1 || group == 2 || group == 4 || group == 8) && vecs <= 32
         && (vecs & (vecs - 1)) == 0;
}

// Dynamic shared memory of one block, the same on host and device.
// elem: bytes of the io dtype T; pool_elem: bytes of a stored K/V element
// (T, or 1 for int8); page: slots per page, which a tile never crosses
// (the dense cache passes kTile). A stage holds `tile` slots of K and of
// V: the largest power of two up to kTile that divides `page`, halved
// (not below 16) while the ring would exceed kMaxRingBytes.
struct Layout {
  int tile, row_bytes, parts;
  size_t k, v, q, sc, corr, m, l, acc, scl, bar, flag, bytes;
};

__host__ __device__ inline Layout layout(int hd, int group, int elem,
                                         int pool_elem, int page) {
  Layout L;
  L.row_bytes = hd * pool_elem;
  const int vecs = hd * elem / 16;  // 16-byte vectors of T per row
  const bool lanes = lane_route(group, vecs);
  L.tile = kTile;
  while (L.tile > 1 && page % L.tile) L.tile /= 2;
  while (L.tile > 16 && 2 * kStages * L.tile * L.row_bytes > kMaxRingBytes)
    L.tile /= 2;
  // partial accumulators: one per warp on the lane route; on the generic
  // route the slots are split over `parts` when the output has fewer
  // vectors than there are threads
  L.parts = lanes ? kWarps
            : group * vecs >= kConsumers ? 1 : kConsumers / (group * vecs);
  size_t o = 0;
  L.k = o;
  o += round16((size_t)kStages * L.tile * L.row_bytes);
  L.v = o;
  o += round16((size_t)kStages * L.tile * L.row_bytes);
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
  L.scl = o;  // the K and V scale of each stage (int8 pools)
  o += round16(sizeof(float) * 2 * kStages);
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

// V stored K/V elements from the ring as f32. A pool in the io dtype is
// read as it is (the scale is not used).
template <typename T, int V>
__device__ __forceinline__ void load_kv(const T* p, float, float (&f)[V]) {
  load_f32<T, V>(p, f);
}

// An int8 pool: V bytes (8 for a 16-bit T, 4 for f32), dequantized as
// _dequant_tile does: f32(q8) * scale, rounded once to T, read as f32. A
// byte becomes f32 exactly through the bits of 2^23 + 128 + q8 (one byte
// permute and one subtraction, no conversion unit), and a 16-bit T rounds
// two values at a time.
template <typename T, int V>
__device__ __forceinline__ void load_kv(const int8_t* p, float scale,
                                        float (&f)[V]) {
  static_assert(V == 4 || V == 8, "int8 rows are read 4 or 8 bytes a lane");
  uint32_t w[V / 4];
  if constexpr (V == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    w[0] = raw.x;
    w[1] = raw.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int j = 0; j < V / 4; ++j) {
    const uint32_t x = w[j] ^ 0x80808080u;  // q8 + 128 in each byte
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * j + b] = (__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + b))
                      - 8388736.f) * scale;
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int u = 0; u < V; u += 2) {
      const float2 r =
          __bfloat1622float2(__floats2bfloat162_rn(f[u], f[u + 1]));
      f[u] = r.x;
      f[u + 1] = r.y;
    }
  } else if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
    for (int u = 0; u < V; u += 2) {
      const float2 r = __half22float2(__floats2half2_rn(f[u], f[u + 1]));
      f[u] = r.x;
      f[u + 1] = r.y;
    }
  }
}

// One block's walk of the chunk `split` (of n_split) of the (row, kv head)
// `pair` (row = pair / kvh: its q and out rows), whose partials and ticket
// sit at index `slot` of the workspace: the kernels pass (blockIdx.x,
// blockIdx.x, blockIdx.y, gridDim.y), or, where one block takes several
// pairs in turn, each pair with blockIdx.y and its own workspace slot; the
// ring's barriers are then invalidated between two walks (release_ring).
// Returns false, the same in every thread, where the chunk lies past
// `length` and the walk returned before it initialized the ring.
// T: io dtype of q and out; S: the
// stored K/V element (T, or int8_t); G: the group on the lane route, 0 on
// the generic route. `length` is the row's valid slot count, already
// clamped to the row's capacity. The Source says where the slots lie:
// `src.issue(slot0, n_valid, k_dst, v_dst, scl, bar, lane)` runs on lanes
// [0, Source::kProducerLanes) of the producer warp and copies slots
// [slot0, slot0 + n_valid) of this (row, kv head) into k_dst / v_dst
// (rows of hd elements back to back), completing the full barrier `bar`
// (initialized for Source::kArrivals arrivals); for an int8 pool it writes
// the slots' K and V scales to scl[0], scl[1] and publishes them with an
// arrival of its own.
// ws_ml: [slots, n_split, 2, group] (m, then l); ws_acc: [slots, n_split,
// group, hd]; tickets: [slots], zero between launches.
template <typename T, typename S, int G, typename Source>
__device__ __forceinline__ bool split_walk(
    const Source& src, const T* __restrict__ q, T* __restrict__ out,
    float* __restrict__ ws_ml, float* __restrict__ ws_acc,
    int* __restrict__ tickets, int pair, int slot, int split, int n_split,
    int nh, int kvh, int hd, int page, int length, int chunk, float scale) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr bool kQ8 = std::is_same<S, int8_t>::value;
  const int group = G > 0 ? G : nh / kvh;
  const Layout L = layout(hd, group, (int)sizeof(T), (int)sizeof(S), page);
  extern __shared__ __align__(128) uint8_t smem[];
  S* k_s = reinterpret_cast<S*>(smem + L.k);
  S* v_s = reinterpret_cast<S*>(smem + L.v);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* corr = reinterpret_cast<float*>(smem + L.corr);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* scl = reinterpret_cast<float*>(smem + L.scl);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + kStages;
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  const int b = pair / kvh;
  const int active = length == 0 ? 1 : (length + chunk - 1) / chunk;
  if (split >= active) return false;  // past `length`: no copy, no partial
  const int start = split * chunk;
  const int end = min(length, start + chunk);
  const int tile = L.tile;
  const int n_tiles = end > start ? (end - start + tile - 1) / tile : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], Source::kArrivals);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp ----------------------------------------------------
    const int lane = tid - kConsumers;
    if (lane >= Source::kProducerLanes) return true;
    for (int e = 0; e < n_tiles; ++e) {
      const int s = e % kStages;
      if (e >= kStages) mbar_wait(&empty[s], ((e / kStages) - 1) & 1);
      const int slot0 = start + e * tile;
      src.issue(slot0, min(tile, end - slot0), k_s + (size_t)s * tile * hd,
                v_s + (size_t)s * tile * hd, scl + 2 * s, &full[s], lane);
    }
    return true;
  }

  // ---- consumers --------------------------------------------------------
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gh = group * hd;
  const int vecs = hd / V;  // 16-byte vectors of T per row
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
    const S* kt = k_s + (size_t)s * tile * hd;
    const S* vt = v_s + (size_t)s * tile * hd;
    // the previous tile's P.V still reads the other buffers
    float* sct = sc + (e & 1) * group * tile;
    float* cr = corr + (e & 1) * group;
    mbar_wait(&full[s], (e / kStages) & 1);
    const float ks = kQ8 ? scl[2 * s] : 1.f;
    const float vs = kQ8 ? scl[2 * s + 1] : 1.f;

    if constexpr (G > 0) {
      // scores: each lane's partial dots over its vector, summed over the
      // row's lanes by a fixed shuffle tree
      for (int base = warp * per_step; base < n_valid;
           base += kWarps * per_step) {
        const int sl = base + sub;
        const bool valid = sl < n_valid;
        float kf[V], dot[G];
        if (valid) load_kv<T, V>(kt + sl * hd + c * V, ks, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.f;
#pragma unroll
          for (int u = 0; u < V; ++u)
            d = fmaf(qr[g][u], valid ? kf[u] : 0.f, d);
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
          const S* kr = kt + sl * hd;
          const float4* qf = reinterpret_cast<const float4*>(q_s + g * hd);
          float dot[V];  // V independent sums, added in a fixed order
#pragma unroll
          for (int u = 0; u < V; ++u) dot[u] = 0.f;
          int cv = sl % vecs;
#pragma unroll 2
          for (int i = 0; i < vecs; ++i) {
            float kf[V], qv[V];
            load_kv<T, V>(kr + cv * V, ks, kf);
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
        load_kv<T, V>(vt + sl * hd + c * V, vs, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float w = sct[g * tile + sl];
#pragma unroll
          for (int u = 0; u < V; ++u) ar[g][u] = fmaf(w, vf[u], ar[g][u]);
        }
      }
    } else {
      // P.V: one (part, q head, vector) item per thread and pass
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
          load_kv<T, V>(vt + sl * hd + cv * V, vs, vf);
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
    mbar_arrive(&empty[s]);  // K, V and scales of this stage are consumed
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
    return true;
  }

  // this split's partial, then the ticket
  const size_t part_ix = (size_t)slot * n_split + split;
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
  if (tid == 0) *flag = atomicAdd(&tickets[slot], 1);
  consumer_sync();
  if (*flag != active - 1) return true;
  __threadfence();

  // the last split of this (row, kv head): combine in split index order
  const size_t first = (size_t)slot * n_split;
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
  if (tid == 0) tickets[slot] = 0;
  return true;
}

// Ends the ring barriers' life after a walk that initialized them
// (split_walk returned true, and every thread of the block has left it), so
// that the next walk of the block may initialize them again.
__device__ __forceinline__ void release_ring(const Layout& L) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x == 0)
    for (int s = 0; s < 2 * kStages; ++s)
      mbar_inval(reinterpret_cast<uint64_t*>(smem + L.bar) + s);
}

// Raises the kernel's dynamic shared memory cap to the layout's size and
// launches it on grid (pairs, n_split); returns the launch's error code.
template <typename Kernel, typename... Args>
inline int launch_walk(Kernel kernel, const Layout& L, int pairs,
                       int n_split, void* stream, Args... args) {
  if (L.bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (L.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(pairs, n_split), kThreads, L.bytes,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// Calls run(std::integral_constant<int, G>()) with the lane route's group,
// or G = 0 for the generic route.
template <typename T, typename Run>
inline int dispatch_group(int group, int hd, Run run) {
  if (!lane_route(group, hd * (int)sizeof(T) / 16))
    return run(std::integral_constant<int, 0>());
  switch (group) {
    case 1: return run(std::integral_constant<int, 1>());
    case 2: return run(std::integral_constant<int, 2>());
    case 4: return run(std::integral_constant<int, 4>());
    default: return run(std::integral_constant<int, 8>());
  }
}

}  // namespace ds_split

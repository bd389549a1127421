// Tensor-core block-sparse attention for Hopper (sm_90a): the forward, dq
// and dk/dv for 16-bit inputs (bf16, fp16), head_dim 64 or 128, S a
// multiple of 64, over host-built 64-row tile tables.
//
// They compute the functions of the TPU kernels _fwd_kernel,
// _bwd_dq_kernel and _bwd_dkv_kernel (deepspeed_tpu/ops/
// sparse_kernels.py:105,190,222), which the tile kernels of
// flash_tiles.cuh compute for f32 inputs: q/k/v/do [B*H, S, D], row b
// reading head b % H of a static per-head block layout; f32 scores times
// `scale`; a (q, k) pair is visible iff its layout block is active AND
// (non-causal OR q_pos >= k_pos); masked scores -1e30; the online softmax
// with m_safe (0 where m <= -1e30 / 2); p and ds rounded to the input dtype
// before the products (here the conversion of the register A operand);
// o = acc / l_safe and lse = m + log(l_safe) f32 [B*H, S, 1]; lse_safe in
// the backward. A q row with no visible key gets o = 0, lse = -1e30 and
// dq = 0, a kv row with none dk = dv = 0, exactly.
//
// Bound on an H100: operations. At layout (i) of chip_smoke.py (32 heads,
// S 8192, D 128, Fixed block 64 causal, 2304 of 8256 blocks active) the
// forward's two products are 0.152 ms, dq's three 0.228 ms and dk/dv's
// four 0.304 ms at 989 TFLOP/s, against ~2 bytes moved per 64 flops. So
// the design is the one of flash_hopper.cuh's flash_fwd / flash_bwd_dq /
// flash_bwd_dkv (wgmma m64n64k16 with f32 accumulators in registers, P and
// dS (or P^T, dS^T) as the register A operand of the next product, 64-row
// x 128-byte TMA boxes with 128-byte swizzle into a ring fed by one
// producer thread, 2 consumer warpgroups of 64 rows), over a walk of
// 64 x 64 tiles:
//
//   * the tile tables (build_tile_tables in ops/sparse_kernels.py, numpy,
//     once per layout): a tile pair (q tile t, kv tile u) is a step if any
//     of its (q, k) pairs is visible; it carries a 16-bit mask of its
//     active 16 x 16 sub-blocks, bit 4 a + b for q sub-block a, kv
//     sub-block b (a block of 16 or 32 is 1 or 2 x 2 sub-blocks, a block of
//     64 or 128 sets all 16 bits). A step whose mask is all ones is wholly
//     visible and skips the mask arithmetic; otherwise an element is
//     visible iff its sub-block bit is set and, on a causal diagonal tile
//     (t == u), q_pos >= k_pos. Under the causal flag the tables hold only
//     sub-blocks on or below the diagonal.
//   * work items: one CUDA block per (batch row, item), an item being two
//     64-row tiles of one head (tile1 = -1: one tile) and its list of
//     steps in ascending tile order, the union of the two tiles' lists
//     with both masks, so each step loads one tile for both consumers and
//     a consumer whose mask is 0 skips the products (but still arrives on
//     the ring's barriers). The forward and dq walk one list, which pairs
//     neighbouring q tiles (their kv lists are alike); dk/dv pairs kv
//     tiles of alike q lists (sorted by list length): a global column's
//     list sits beside another global column's, not beside a local one.
//     Items run heaviest first (longest list first), so a Fixed layout's
//     global rows and columns do not finish last. Every tile of every head
//     is in exactly one item, also a tile with an empty list, which stores
//     zeros (and the forward lse = -1e30).
//   * the block copies its step list into shared memory before the ring
//     starts: the producer issues no dependent global load per step.
//   * forward: a consumer owns one q tile (Q loaded once) and keeps O, m
//     and l in registers; per step S = Q K^T, the mask, the online-softmax
//     update of flash_fwd_hopper_kernel, then O += P V; o and lse are
//     written once, at the end of the item.
//   * dq: a consumer owns one q tile (Q, dO, lse, delta loaded once) and
//     keeps dQ in registers; per step S = Q K^T and dP = dO V^T, then
//     dQ += dS K. dk/dv: a consumer owns one kv tile (K, V loaded once) and
//     keeps dK, dV in registers; per step S^T = K Q^T and dP^T = V dO^T,
//     then dV += P^T dO and dK += dS^T Q.
//
// No atomics: a repeated forward or backward is bit-identical. f32 inputs
// stay on flash_tiles.cuh (TF32 would fail the f32 checks, 1e-4), and so
// does an S that is not a multiple of 64 (possible at blocks 16 and 32):
// the rule is in sparse_attention.cu.
#pragma once

#include "flash_hopper.cuh"

namespace ds_sparse {

using namespace ds_async;
using namespace ds_hopper;

constexpr int kItemInts = 5;       // head, tile0, tile1 (-1: none), start, n
constexpr int kFullMask = 0xFFFF;  // all 16 sub-blocks of a tile pair active
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block can use
// Register budgets (setmaxnreg): the producer thread needs few, and the
// dk/dv consumers hold dK, dV, S^T and dP^T (192 f32) at once, so they
// take 240 (the most that 24 in the producer leaves).
constexpr int kProducerRegsSparse = 24, kConsumerRegsSparse = 240;

struct Item {
  int head, tile0, tile1, start, n;
};

__device__ __forceinline__ Item load_item(const int* items, int rank) {
  const int* it = items + kItemInts * rank;
  return Item{__ldg(it), __ldg(it + 1), __ldg(it + 2), __ldg(it + 3),
              __ldg(it + 4)};
}

// The block's steps (tile, mask of tile0 | mask of tile1 << 16) into shared
// memory, by all threads, before the block's first __syncthreads().
__device__ __forceinline__ void stage_steps(int2* dst, const int2* steps,
                                            const Item& it) {
  for (int e = threadIdx.x; e < it.n; e += kThreads)
    dst[e] = __ldg(steps + it.start + e);
}

// Bytes of dynamic shared memory: the fixed layout, a step list of up to
// max_steps entries, and the slack for 1024-byte alignment.
template <typename L> constexpr size_t smem_bytes(int max_steps) {
  return L::kSteps + 8 * (size_t)max_steps + 1024;
}

// ---------------------------------------------------------------------------
// forward: grid (items * batch), block (item rank, batch row); the dq walk
// ---------------------------------------------------------------------------
template <int D> struct SparseFwdSmem {
  static constexpr int kAtoms = D / 64;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kConsumers * kAtoms * kBoxBytes;
  static constexpr int kV = kK + kFwdStages * kAtoms * kBoxBytes;
  static constexpr int kBar = kV + kFwdStages * kAtoms * kBoxBytes;
  static constexpr int kSteps = kBar + 8 * (2 * kFwdStages + 1 + 3);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             T* __restrict__ o, float* __restrict__ lse,
                             const int* __restrict__ items,
                             const int2* __restrict__ steps, int batch,
                             int nheads, int s, float scale, int causal) {
  using L = SparseFwdSmem<D>;
  constexpr int A = L::kAtoms;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kFwdStages;
  uint64_t* qbar = empty + kFwdStages;
  int2* st = reinterpret_cast<int2*>(sm + L::kSteps);
  const Item it = load_item(items, blockIdx.x / batch);
  const int bh = (blockIdx.x % batch) * nheads + it.head;
  const int n_tiles = it.tile1 < 0 ? 1 : 2;
  stage_steps(st, steps, it);
  if (threadIdx.x == 0) init_ring(full, empty, kFwdStages, qbar);
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ---- producer: Q once, then the K/V ring ------------------------------
    regs_dec<kProducerRegsSparse>();
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(qbar, n_tiles * A * kBoxBytes);
    for (int w = 0; w < n_tiles; ++w) {
      const int qrow = bh * s + (w ? it.tile1 : it.tile0) * kRows;
      for (int at = 0; at < A; ++at)
        tma_load(sm + L::kQ + (w * A + at) * kBoxBytes, &tq, qbar, at * 64,
                 qrow);
    }
    for (int e = 0; e < it.n; ++e) {
      const int sg = e % kFwdStages;
      const int krow = bh * s + st[e].x * kRows;
      if (e >= kFwdStages) mbar_wait(&empty[sg], ((e / kFwdStages) - 1) & 1);
      mbar_expect_tx(&full[sg], 2 * A * kBoxBytes);
      for (int at = 0; at < A; ++at) {
        tma_load(sm + L::kK + (sg * A + at) * kBoxBytes, &tk, &full[sg],
                 at * 64, krow);
        tma_load(sm + L::kV + (sg * A + at) * kBoxBytes, &tv, &full[sg],
                 at * 64, krow);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q tile `tile` (none if -1) -----------
  regs_inc<kConsumerRegsSparse>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;   // q sub-block of its rows
  const int row0 = 16 * warp + lane / 4;       // rows row0, row0 + 8
  const int cq = 2 * (lane % 4);
  const int tile = wg ? it.tile1 : it.tile0;
  const uint8_t* Qw = sm + L::kQ + wg * A * kBoxBytes;
  float acc[A][32];
#pragma unroll
  for (int at = 0; at < A; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[at][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  for (int e = 0; e < it.n; ++e) {
    const int sg = e % kFwdStages;
    mbar_wait(&full[sg], (e / kFwdStages) & 1);
    const int2 step = st[e];
    const int mask = (step.y >> (16 * wg)) & kFullMask;
    if (mask == 0) {  // this q tile sees none of this kv tile
      mbar_arrive(&empty[sg]);
      continue;
    }
    float sc[32];
    wg_fence();
    mma_kmajor<T, D>(sc, Qw, sm + L::kK + sg * A * kBoxBytes);
    wg_commit();
    wg_wait();
    pin(sc);
    // wholly visible steps skip the mask; else the sub-block bits of this
    // warp's q sub-block (kv sub-block = column / 16 = j / 2), and on a
    // causal diagonal tile q_pos >= k_pos
    const bool masked = mask != kFullMask;
    const int row_bits = mask >> (4 * warp);
    const bool diag = causal && step.x == tile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * r + c;
          float x = sc[i] * scale;
          if (masked && (!((row_bits >> (j / 2)) & 1) ||
                         (diag && row0 + 8 * r < 8 * j + cq + c)))
            x = kNegInf;
          sc[i] = x;
        }
    softmax_step(sc, m, l, acc);
    // P, rounded to T as the register A operand; V read N-major
    uint32_t pa[4][4];
    to_a_operand<T>(sc, pa);
    wg_fence();
    mma_nmajor<T, D>(acc, pa, sm + L::kV + sg * A * kBoxBytes);  // O += P V
    wg_commit();
    wg_wait();
#pragma unroll
    for (int at = 0; at < A; ++at) pin(acc[at]);
    pin(pa);
    mbar_arrive(&empty[sg]);
  }
  if (tile >= 0)
    store_fwd_rows<T, D>(o, lse, (size_t)bh * s + (size_t)tile * kRows + row0,
                         lane, acc, m, l);
}

// ---------------------------------------------------------------------------
// dq: grid (items * batch), block (item rank, batch row)
// ---------------------------------------------------------------------------
template <int D> struct SparseDqSmem {
  static constexpr int kAtoms = D / 64;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kConsumers * kAtoms * kBoxBytes;
  static constexpr int kK = kDO + kConsumers * kAtoms * kBoxBytes;
  static constexpr int kV = kK + kDqStages * kAtoms * kBoxBytes;
  static constexpr int kLse = kV + kDqStages * kAtoms * kBoxBytes;
  static constexpr int kDelta = kLse + kBlockRows * 4;
  static constexpr int kBar = kDelta + kBlockRows * 4;
  static constexpr int kSteps = kBar + 8 * (2 * kDqStages + 1 + 3);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dq,
                                const int* __restrict__ items,
                                const int2* __restrict__ steps, int batch,
                                int nheads, int s, float scale, int causal) {
  using L = SparseDqSmem<D>;
  constexpr int A = L::kAtoms;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kDqStages;
  uint64_t* qbar = empty + kDqStages;
  int2* st = reinterpret_cast<int2*>(sm + L::kSteps);
  const Item it = load_item(items, blockIdx.x / batch);
  const int bh = (blockIdx.x % batch) * nheads + it.head;
  const int n_tiles = it.tile1 < 0 ? 1 : 2;
  stage_steps(st, steps, it);
  if (threadIdx.x == 0) init_ring(full, empty, kDqStages, qbar);
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ---- producer: Q, dO, lse and delta once, then the K/V ring ----------
    regs_dec<kProducerRegsSparse>();
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(qbar, n_tiles * (2 * A * kBoxBytes + 2 * kRows * 4));
    for (int w = 0; w < n_tiles; ++w) {
      const int qrow = bh * s + (w ? it.tile1 : it.tile0) * kRows;
      for (int at = 0; at < A; ++at) {
        tma_load(sm + L::kQ + (w * A + at) * kBoxBytes, &tq, qbar, at * 64,
                 qrow);
        tma_load(sm + L::kDO + (w * A + at) * kBoxBytes, &tdo, qbar,
                 at * 64, qrow);
      }
      bulk_load(sm + L::kLse + w * kRows * 4, lse + qrow, kRows * 4, qbar);
      bulk_load(sm + L::kDelta + w * kRows * 4, delta + qrow, kRows * 4,
                qbar);
    }
    for (int e = 0; e < it.n; ++e) {
      const int sg = e % kDqStages;
      const int krow = bh * s + st[e].x * kRows;
      if (e >= kDqStages) mbar_wait(&empty[sg], ((e / kDqStages) - 1) & 1);
      mbar_expect_tx(&full[sg], 2 * A * kBoxBytes);
      for (int at = 0; at < A; ++at) {
        tma_load(sm + L::kK + (sg * A + at) * kBoxBytes, &tk, &full[sg],
                 at * 64, krow);
        tma_load(sm + L::kV + (sg * A + at) * kBoxBytes, &tv, &full[sg],
                 at * 64, krow);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q tile `tile` (none if -1) -----------
  regs_inc<kConsumerRegsSparse>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;   // q sub-block of its rows
  const int row0 = 16 * warp + lane / 4;       // rows row0, row0 + 8
  const int cq = 2 * (lane % 4);
  const int tile = wg ? it.tile1 : it.tile0;
  const uint8_t* Qw = sm + L::kQ + wg * A * kBoxBytes;
  const uint8_t* dOw = sm + L::kDO + wg * A * kBoxBytes;
  float dqa[A][32];
#pragma unroll
  for (int at = 0; at < A; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[at][i] = 0.f;
  mbar_wait(qbar, 0);
  float ls[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (tile >= 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kRows * wg + row0 + 8 * r;
      const float lraw = reinterpret_cast<const float*>(sm + L::kLse)[row];
      // a row that sees no key carries lse == -1e30: every score of it is
      // masked, so p = exp(-1e30 - 0) = 0 and its dq is exactly 0
      ls[r] = (lraw <= kNegInf * 0.5f ? 0.f : lraw) * kLog2e;
      dl[r] = reinterpret_cast<const float*>(sm + L::kDelta)[row];
    }
  }
  for (int e = 0; e < it.n; ++e) {
    const int sg = e % kDqStages;
    mbar_wait(&full[sg], (e / kDqStages) & 1);
    const int2 step = st[e];
    const int mask = (step.y >> (16 * wg)) & kFullMask;
    if (mask == 0) {  // this q tile sees none of this kv tile
      mbar_arrive(&empty[sg]);
      continue;
    }
    const uint8_t* Ks = sm + L::kK + sg * A * kBoxBytes;
    const uint8_t* Vs = sm + L::kV + sg * A * kBoxBytes;
    // S = Q K^T and dP = dO V^T: q rows as M, kv rows as N
    float sc[32], dp[32];
    wg_fence();
    mma_kmajor<T, D>(sc, Qw, Ks);
    mma_kmajor<T, D>(dp, dOw, Vs);
    wg_commit();
    wg_wait();
    pin(sc);
    pin(dp);
    // wholly visible steps skip the mask; else the sub-block bits of this
    // warp's q sub-block (kv sub-block = column / 16 = j / 2), and on a
    // causal diagonal tile q_pos >= k_pos
    const bool masked = mask != kFullMask;
    const int row_bits = mask >> (4 * warp);
    const bool diag = causal && step.x == tile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * r + c;
          float x = sc[i] * scale;
          if (masked && (!((row_bits >> (j / 2)) & 1) ||
                         (diag && row0 + 8 * r < 8 * j + cq + c)))
            x = kNegInf;
          const float p = exp2f(fmaf(x, kLog2e, -ls[r]));
          dp[i] = p * (dp[i] - dl[r]) * scale;
        }
    // dS, rounded to T as the register A operand; K read N-major
    uint32_t dsa[4][4];
    to_a_operand<T>(dp, dsa);
    wg_fence();
    mma_nmajor<T, D>(dqa, dsa, Ks);  // dQ += dS K
    wg_commit();
    wg_wait();
#pragma unroll
    for (int at = 0; at < A; ++at) pin(dqa[at]);
    pin(dsa);
    mbar_arrive(&empty[sg]);
  }
  if (tile < 0) return;
  const size_t qrow = (size_t)bh * s + (size_t)tile * kRows + row0;
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int at = 0; at < A; ++at)
    store_tile<T, D>(dq, qrow, 64 * at, lane, dqa[at], one);
}

// ---------------------------------------------------------------------------
// dk/dv: grid (items * batch), block (item rank, batch row)
// ---------------------------------------------------------------------------
template <int D> struct SparseDkvSmem {
  static constexpr int kAtoms = D / 64;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kConsumers * kAtoms * kBoxBytes;
  static constexpr int kQ = kV + kConsumers * kAtoms * kBoxBytes;
  static constexpr int kDO = kQ + kDkvStages * kAtoms * kBoxBytes;
  static constexpr int kLse = kDO + kDkvStages * kAtoms * kBoxBytes;
  static constexpr int kDelta = kLse + kDkvStages * kRows * 4;
  static constexpr int kBar = kDelta + kDkvStages * kRows * 4;
  static constexpr int kSteps = kBar + 8 * (2 * kDkvStages + 1 + 3);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_bwd_dkv_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 const int* __restrict__ items,
                                 const int2* __restrict__ steps, int batch,
                                 int nheads, int s, float scale, int causal) {
  using L = SparseDkvSmem<D>;
  constexpr int A = L::kAtoms;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kDkvStages;
  uint64_t* kvbar = empty + kDkvStages;
  int2* st = reinterpret_cast<int2*>(sm + L::kSteps);
  const Item it = load_item(items, blockIdx.x / batch);
  const int bh = (blockIdx.x % batch) * nheads + it.head;
  const int n_tiles = it.tile1 < 0 ? 1 : 2;
  stage_steps(st, steps, it);
  if (threadIdx.x == 0) init_ring(full, empty, kDkvStages, kvbar);
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ---- producer: K and V once, then the Q/dO/lse/delta ring ------------
    regs_dec<kProducerRegsSparse>();
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(kvbar, n_tiles * 2 * A * kBoxBytes);
    for (int w = 0; w < n_tiles; ++w) {
      const int krow = bh * s + (w ? it.tile1 : it.tile0) * kRows;
      for (int at = 0; at < A; ++at) {
        tma_load(sm + L::kK + (w * A + at) * kBoxBytes, &tk, kvbar, at * 64,
                 krow);
        tma_load(sm + L::kV + (w * A + at) * kBoxBytes, &tv, kvbar, at * 64,
                 krow);
      }
    }
    for (int e = 0; e < it.n; ++e) {
      const int sg = e % kDkvStages;
      const int qrow = bh * s + st[e].x * kRows;
      if (e >= kDkvStages) mbar_wait(&empty[sg], ((e / kDkvStages) - 1) & 1);
      mbar_expect_tx(&full[sg], 2 * A * kBoxBytes + 2 * kRows * 4);
      for (int at = 0; at < A; ++at) {
        tma_load(sm + L::kQ + (sg * A + at) * kBoxBytes, &tq, &full[sg],
                 at * 64, qrow);
        tma_load(sm + L::kDO + (sg * A + at) * kBoxBytes, &tdo, &full[sg],
                 at * 64, qrow);
      }
      bulk_load(sm + L::kLse + sg * kRows * 4, lse + qrow, kRows * 4,
                &full[sg]);
      bulk_load(sm + L::kDelta + sg * kRows * 4, delta + qrow, kRows * 4,
                &full[sg]);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns kv tile `tile` (none if -1) ----------
  regs_inc<kConsumerRegsSparse>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;   // kv sub-block of its rows
  const int row0 = 16 * warp + lane / 4;       // kv rows row0, row0 + 8
  const int cq = 2 * (lane % 4);
  const int tile = wg ? it.tile1 : it.tile0;
  const uint8_t* Kw = sm + L::kK + wg * A * kBoxBytes;
  const uint8_t* Vw = sm + L::kV + wg * A * kBoxBytes;
  float dka[A][32], dva[A][32];
#pragma unroll
  for (int at = 0; at < A; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[at][i] = dva[at][i] = 0.f;
  mbar_wait(kvbar, 0);
  for (int e = 0; e < it.n; ++e) {
    const int sg = e % kDkvStages;
    mbar_wait(&full[sg], (e / kDkvStages) & 1);
    const int2 step = st[e];
    const int mask = (step.y >> (16 * wg)) & kFullMask;
    if (mask == 0) {  // no q row of this q tile sees this kv tile
      mbar_arrive(&empty[sg]);
      continue;
    }
    const uint8_t* Qs = sm + L::kQ + sg * A * kBoxBytes;
    const uint8_t* dOs = sm + L::kDO + sg * A * kBoxBytes;
    const float* Ls = reinterpret_cast<const float*>(sm + L::kLse) + sg * kRows;
    const float* Dl =
        reinterpret_cast<const float*>(sm + L::kDelta) + sg * kRows;
    // S^T = K Q^T and dP^T = V dO^T: kv rows as M, q rows as N
    float sct[32], dpt[32];
    wg_fence();
    mma_kmajor<T, D>(sct, Kw, Qs);
    mma_kmajor<T, D>(dpt, Vw, dOs);
    wg_commit();
    wg_wait();
    pin(sct);
    pin(dpt);
    // the sub-block bits of this warp's kv sub-block: bit 4 a + warp for q
    // sub-block a = column / 16 = j / 2
    const bool masked = mask != kFullMask;
    const int col_bits = mask >> warp;
    const bool diag = causal && step.x == tile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + cq + c;  // q row in the q tile
        const float lraw = Ls[col];
        // fully masked rows carry lse == -1e30; exp(s - lse) would be 1
        const float lsc = (lraw <= kNegInf * 0.5f ? 0.f : lraw) * kLog2e;
        const float dlc = Dl[col];
        const bool col_off = !((col_bits >> (4 * (j / 2))) & 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + c;
          float x = sct[i] * scale;
          if (masked && (col_off || (diag && col < row0 + 8 * r)))
            x = kNegInf;
          const float p = exp2f(fmaf(x, kLog2e, -lsc));
          sct[i] = p;
          dpt[i] = p * (dpt[i] - dlc) * scale;
        }
      }
    uint32_t pa[4][4], dsa[4][4];
    to_a_operand<T>(sct, pa);
    to_a_operand<T>(dpt, dsa);
    wg_fence();
    mma_nmajor<T, D>(dva, pa, dOs);  // dV += P^T dO
    mma_nmajor<T, D>(dka, dsa, Qs);  // dK += dS^T Q
    wg_commit();
    wg_wait();
#pragma unroll
    for (int at = 0; at < A; ++at) {
      pin(dva[at]);
      pin(dka[at]);
    }
    pin(pa);
    pin(dsa);
    mbar_arrive(&empty[sg]);
  }
  if (tile < 0) return;
  const size_t krow = (size_t)bh * s + (size_t)tile * kRows + row0;
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int at = 0; at < A; ++at) {
    store_tile<T, D>(dk, krow, 64 * at, lane, dka[at], one);
    store_tile<T, D>(dv, krow, 64 * at, lane, dva[at], one);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// TMA maps of q, k, v and do, each viewed as [rows, D].
template <typename T, int D>
static bool make_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                      const void* v, const void* dout, int rows) {
  return make_map<T, D>(&m[0], q, rows) && make_map<T, D>(&m[1], k, rows) &&
         make_map<T, D>(&m[2], v, rows) && make_map<T, D>(&m[3], dout, rows);
}

// Each launch: one block per (item, batch row), the step lists' shared
// memory on top of the fixed layout. The forward walks the dq items.
template <typename T, int D>
static int fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const void* items, const void* steps, int n_items,
               int max_steps, int bh, int nheads, int s, float scale,
               int causal, cudaStream_t stream) {
  CUtensorMap m[3];
  const size_t smem = smem_bytes<SparseFwdSmem<D>>(max_steps);
  if (smem > kMaxSmem || !make_map<T, D>(&m[0], q, bh * s) ||
      !make_map<T, D>(&m[1], k, bh * s) || !make_map<T, D>(&m[2], v, bh * s))
    return (int)cudaErrorInvalidValue;
  auto kernel = sparse_fwd_hopper_kernel<T, D>;
  cudaError_t err = set_smem(kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int batch = bh / nheads;
  kernel<<<n_items * batch, kThreads, smem, stream>>>(
      m[0], m[1], m[2], static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(items), static_cast<const int2*>(steps), batch,
      nheads, s, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, const void* items, const void* steps, int n_items,
                  int max_steps, int bh, int nheads, int s, float scale,
                  int causal, cudaStream_t stream) {
  CUtensorMap m[4];
  const size_t smem = smem_bytes<SparseDqSmem<D>>(max_steps);
  if (smem > kMaxSmem || !make_maps<T, D>(m, q, k, v, dout, bh * s))
    return (int)cudaErrorInvalidValue;
  auto kernel = sparse_bwd_dq_hopper_kernel<T, D>;
  cudaError_t err = set_smem(kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int batch = bh / nheads;
  kernel<<<n_items * batch, kThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<const int*>(items), static_cast<const int2*>(steps), batch,
      nheads, s, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, const void* items, const void* steps,
                   int n_items, int max_steps, int bh, int nheads, int s,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap m[4];
  const size_t smem = smem_bytes<SparseDkvSmem<D>>(max_steps);
  if (smem > kMaxSmem || !make_maps<T, D>(m, q, k, v, dout, bh * s))
    return (int)cudaErrorInvalidValue;
  auto kernel = sparse_bwd_dkv_hopper_kernel<T, D>;
  cudaError_t err = set_smem(kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int batch = bh / nheads;
  kernel<<<n_items * batch, kThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<const int*>(items),
      static_cast<const int2*>(steps), batch, nheads, s, scale, causal);
  return (int)cudaGetLastError();
}

// The three kernels for (T, D) with step lists of up to max_steps
// entries: out[0..2] dq, out[3..5] dk/dv, out[6..8] the forward, each
// (registers, dynamic shared memory, blocks per SM).
template <typename T, int D> static int info(int max_steps, int* out) {
  cudaError_t err =
      kernel_info(sparse_bwd_dq_hopper_kernel<T, D>,
                  (int)smem_bytes<SparseDqSmem<D>>(max_steps), out);
  if (err == cudaSuccess)
    err = kernel_info(sparse_bwd_dkv_hopper_kernel<T, D>,
                      (int)smem_bytes<SparseDkvSmem<D>>(max_steps), out + 3);
  if (err == cudaSuccess)
    err = kernel_info(sparse_fwd_hopper_kernel<T, D>,
                      (int)smem_bytes<SparseFwdSmem<D>>(max_steps), out + 6);
  return (int)err;
}

}  // namespace ds_sparse

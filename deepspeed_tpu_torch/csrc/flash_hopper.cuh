// Tensor-core flash attention kernels for Hopper (sm_90a): the forward, the
// dq backward and the dk/dv backward for 16-bit inputs (bf16, fp16),
// head_dim 64 or 128.
//
// They compute the functions of flash_tiles.cuh's flash_fwd_kernel,
// flash_bwd_dq_kernel and flash_bwd_dkv_kernel (and of the TPU kernels
// _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel,
// deepspeed_tpu/ops/flash_attention.py:63,155,196): q [BH, Sq, D], k/v
// [BHk, Skv, D], q head row b reading kv row b / group; f32 scores times
// `scale`, the bottom-right causal mask (off = Skv - Sq, key c visible to
// query r iff off + r >= c), masked scores -1e30; p rounded to the input
// dtype before P.V and dV, ds before dQ and dK (here the rounding is the
// conversion of the register A operand); the m_safe / l_safe / lse_safe
// substitutions, so a row that sees no key gives o = 0, lse = -1e30 and
// no gradient. lse is [BH, Sq, 1] f32. Sq and Skv are multiples of 128.
//
// Bound on an H100: operations. At the training shape (B 2, 32 / 8 heads,
// D 128, S 2048, causal) the forward's two products are 68.7 GFLOP, dq's
// three 103.1 and dk/dv's four 137.5 GFLOP, against ~2 bytes moved per 64
// flops: 0.069, 0.104 and 0.139 ms at 989 TFLOP/s. Only the tensor cores
// can approach that, so:
//
//   * products run on wgmma (m64n64k16, f32 accumulate). Q.K^T, dO.V^T
//     and, in dk/dv, K.Q^T and V.dO^T read both operands from shared
//     memory (K-major); P.V, dS.K, P^T.dO and dS^T.Q take P, dS, P^T or
//     dS^T from registers: the accumulator of a 64 x 64 score tile,
//     rounded to bf16 / fp16 in place, is wgmma's register A operand for
//     the next product, and the B operand (V, K, dO or Q, stored [rows,
//     D]) is read N-major with the transpose bit set;
//   * tiles arrive by TMA (cp.async.bulk.tensor, 64-row x 128-byte boxes,
//     128-byte swizzle, which is the layout the wgmma descriptors name) into
//     a ring of stages, each guarded by a full / empty mbarrier pair
//     (hopper_async.cuh); one thread of a producer warpgroup issues every
//     copy, and the producer gives its registers to the two consumer
//     warpgroups (setmaxnreg);
//   * the online softmax runs on the accumulator registers: a row's 64
//     scores sit in the 4 threads of a quad, reduced by two shuffles;
//   * forward and dq: one block per (q head row, 128 q rows), 64 rows per
//     consumer warpgroup, walking the kv tiles in order (the causal range
//     only); blocks are issued heaviest first (the causal tail), and a tile
//     wholly under the diagonal skips the mask arithmetic. dq loads its Q,
//     dO, lse and delta once, computes S and dP per kv tile, P and dS on
//     the accumulator registers, and keeps dQ in registers until one store;
//   * dk/dv: one block per (kv head row, 128 kv rows), 64 per consumer
//     warpgroup, K and V loaded once; it walks the (q head of the GQA group,
//     64-row q tile) pairs that see its rows, in a fixed order, and keeps
//     dK and dV in registers. The first kv tiles see the most q tiles under
//     the causal mask and are issued first.
//
// No kernel uses atomics, so a repeated backward is bit-identical. f32
// inputs stay on flash_tiles.cuh: the tensor cores take f32 only as TF32
// (~3 decimal digits), which the f32 checks (1e-4) would not pass.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_async.cuh"

namespace ds_hopper {

using namespace ds_async;

constexpr int kRows = 64;                    // rows per TMA box and per wgmma
constexpr int kBoxBytes = kRows * 128;       // one 64 x 128-byte swizzled box
constexpr int kConsumers = 2;                // consumer warpgroups per block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockRows = kRows * kConsumers;
constexpr int kFwdStages = 3;                // K/V ring depth (forward)
constexpr int kDkvStages = 2;                // Q/dO/lse/delta ring depth
constexpr int kDqStages = 2;                 // K/V ring depth (dq)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// register budgets (barriers and copies: hopper_async.cuh)
// ---------------------------------------------------------------------------
template <int R> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Descriptor of a 128-byte-swizzled tile (the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B: 128-byte rows, 8-row groups 1024 bytes apart).
// K-major operands step through a row 32 bytes (16 elements) per k-step;
// N-major ones (V, dO, Q as B of P.V, P^T.dO, dS^T.Q) 16 rows (2048 bytes)
// per k-step, with N = 64 columns per instruction, so the stride between
// 64-column groups is never read; both offsets are set to the 8-row stride.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = (smem_u32(p) & 0x3FFFF) >> 4;
  constexpr uint64_t kStride = 1024 >> 4;
  return addr | (kStride << 16) | (kStride << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of r across a wgmma boundary.
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define DS_ACC32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define DS_ACC32_OPS(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A and B K-major in shared memory
// (SS), or A from registers and B N-major in shared memory (RS).
#define DS_WGMMA(TY)                                                        \
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,   \
                                            uint64_t db, int acc) {        \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DS_ACC32 \
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                   \
        : DS_ACC32_OPS(d)                                                   \
        : "l"(da), "l"(db), "r"(acc));                                      \
  }                                                                         \
  static __device__ __forceinline__ void rs(float (&d)[32],                \
                                            const uint32_t (&a)[4],         \
                                            uint64_t db, int acc) {         \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DS_ACC32 \
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                     \
        : DS_ACC32_OPS(d)                                                   \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));   \
  }

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  DS_WGMMA("bf16")
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Mma<__half> {
  DS_WGMMA("f16")
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
#undef DS_WGMMA
#undef DS_ACC32_OPS
#undef DS_ACC32

// The register layout of a 64 x 64 f32 accumulator: thread `lane` of warp
// w holds, for j < 8, r < 2, c < 2, element [4j + 2r + c] at row
// 16 w + lane / 4 + 8 r, column 8 j + 2 (lane % 4) + c. The register A
// operand of k-step kk (columns 16 kk .. 16 kk + 15) is then elements
// 8 kk .. 8 kk + 7 in pairs.
template <typename T>
__device__ __forceinline__ void to_a_operand(const float (&s)[32],
                                             uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = Mma<T>::pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// s (+)= A . B^T over D for two row-major [64, D] tiles stored as D / 64
// swizzled boxes (K-major both).
template <typename T, int D>
__device__ __forceinline__ void mma_kmajor(float (&s)[32], const uint8_t* a,
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int at = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    Mma<T>::ss(s, desc_sw128(a + at), desc_sw128(b + at), kk > 0);
  }
}

// acc[a] += P . B[:, 64 a .. 64 a + 63] for P in registers (64 x 64) and B
// a row-major [64, D] tile of D / 64 swizzled boxes (N-major).
template <typename T, int D>
__device__ __forceinline__ void mma_nmajor(float (&acc)[D / 64][32],
                                           const uint32_t (&p)[4][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int at = 0; at < D / 64; ++at)
      Mma<T>::rs(acc[at], p[kk], desc_sw128(b + at * kBoxBytes + kk * 2048),
                 1);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The dynamic shared memory's first 1024-byte boundary, as an offset from
// the array itself, so that the compiler keeps the shared state space for
// every access through it (32-bit addresses, ld.shared) instead of generic
// 64-bit pointers, which had cost the sparse dk/dv consumers a spill.
__device__ __forceinline__ uint8_t* smem_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages, uint64_t* once) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], kConsumers * 128);
  }
  mbar_init(once, 1);
  mbar_fence_init();
}

// Writes a 64 x 64 accumulator tile as T pairs at rows `row0`, `row0 + 8`
// of a row-major [*, D] matrix, column offset col0.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* out, size_t row0, int col0,
                                           int lane, const float (&v)[32],
                                           const float (&mul)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<uint32_t*>(
          out + (row0 + 8 * r) * D + col0 + 8 * j + 2 * (lane % 4)) =
          Mma<T>::pack(v[i] * mul[r], v[i + 1] * mul[r]);
    }
}

// One kv tile of the forward's online softmax, on a 64 x 64 score tile
// already scaled and masked (masked scores -1e30): each row's maximum over
// its quad (two shuffles), m and l updated with the m_safe substitution,
// acc rescaled, and the scores turned into p.
template <int A>
__device__ __forceinline__ void softmax_step(float (&sc)[32], float (&m)[2],
                                             float (&l)[2],
                                             float (&acc)[A][32]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  float corr[2], ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // rows masked so far keep m == -1e30: exp(s - 0) underflows to 0
    ms[r] = (m_new <= kNegInf * 0.5f ? 0.f : m_new) * kLog2e;
    corr[r] = exp2f((m[r] - m_new) * kLog2e);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    const float p = exp2f(fmaf(sc[i], kLog2e, -ms[r]));
    sc[i] = p;
    rs[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
  for (int at = 0; at < A; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[at][i] *= corr[(i / 2) % 2];
}

// The forward's end of a 64-row tile whose thread rows start at global row
// `row` (rows row, row + 8): l summed over the quad, o = acc / l_safe in T
// and lse = m + log(l_safe). A row that saw no key keeps m == -1e30 and
// l == 0: o = 0, lse = -1e30.
template <typename T, int D>
__device__ __forceinline__ void store_fwd_rows(T* o, float* lse, size_t row,
                                               int lane,
                                               const float (&acc)[D / 64][32],
                                               const float (&m)[2],
                                               float (&l)[2]) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    inv[r] = 1.f / l_safe;
    if (lane % 4 == 0) lse[row + 8 * r] = m[r] + logf(l_safe);
  }
#pragma unroll
  for (int at = 0; at < D / 64; ++at)
    store_tile<T, D>(o, row, 64 * at, lane, acc[at], inv);
}

// ---------------------------------------------------------------------------
// forward: grid (BH, Sq / 128)
// ---------------------------------------------------------------------------
template <int D> struct FwdSmem {
  static constexpr int kAtoms = D / 64;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kConsumers * kAtoms * kBoxBytes;
  static constexpr int kV = kK + kFwdStages * kAtoms * kBoxBytes;
  static constexpr int kBar = kV + kFwdStages * kAtoms * kBoxBytes;
  static constexpr int kBytes = kBar + 8 * (2 * kFwdStages + 1) + 1024;
};

// kv tiles a causal q block at q0 reads: those starting at or left of its
// last row's diagonal
__device__ __forceinline__ int fwd_kv_tiles(int q0, int sq, int skv,
                                            int causal) {
  const int n = skv / kRows;
  if (!causal) return n;
  const int last = q0 + kBlockRows - 1 + (skv - sq);
  return last < 0 ? 0 : min(n, last / kRows + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            T* __restrict__ o, float* __restrict__ lse,
                            int sq, int skv, int group, float scale,
                            int causal) {
  using L = FwdSmem<D>;
  constexpr int A = L::kAtoms;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kFwdStages;
  uint64_t* qbar = empty + kFwdStages;
  const int bh = blockIdx.x;
  // the last q blocks read the most kv tiles under the causal mask
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int off = skv - sq;
  const int n_kv = fwd_kv_tiles(q0, sq, skv, causal);
  if (threadIdx.x == 0) init_ring(full, empty, kFwdStages, qbar);
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy -------------------------
    regs_dec<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(qbar, kConsumers * A * kBoxBytes);
    for (int w = 0; w < kConsumers; ++w)
      for (int at = 0; at < A; ++at)
        tma_load(sm + L::kQ + (w * A + at) * kBoxBytes, &tq, qbar, at * 64,
                 bh * sq + q0 + kRows * w);
    const int kv_row = (bh / group) * skv;
    for (int e = 0; e < n_kv; ++e) {
      const int s = e % kFwdStages;
      if (e >= kFwdStages) mbar_wait(&empty[s], ((e / kFwdStages) - 1) & 1);
      mbar_expect_tx(&full[s], 2 * A * kBoxBytes);
      for (int at = 0; at < A; ++at) {
        tma_load(sm + L::kK + (s * A + at) * kBoxBytes, &tk, &full[s],
                 at * 64, kv_row + e * kRows);
        tma_load(sm + L::kV + (s * A + at) * kBoxBytes, &tv, &full[s],
                 at * 64, kv_row + e * kRows);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0w .. q0w + 63 ---------------
  regs_inc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int q0w = q0 + kRows * wg;
  const int qpos = off + q0w + row0;  // row r of the thread: qpos + 8 r
  const uint8_t* Qw = sm + L::kQ + wg * A * kBoxBytes;
  float acc[A][32];
#pragma unroll
  for (int at = 0; at < A; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[at][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  for (int e = 0; e < n_kv; ++e) {
    const int s = e % kFwdStages;
    mbar_wait(&full[s], (e / kFwdStages) & 1);
    const int k0 = e * kRows;
    if (causal && off + q0w + kRows - 1 < k0) {  // sees none of this tile
      mbar_arrive(&empty[s]);
      continue;
    }
    float sc[32];
    wg_fence();
    mma_kmajor<T, D>(sc, Qw, sm + L::kK + s * A * kBoxBytes);
    wg_commit();
    wg_wait();
    pin(sc);
    // tiles wholly under the diagonal skip the mask
    const bool mask = causal && off + q0w < k0 + kRows - 1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * r + c;
          float x = sc[i] * scale;
          if (mask && qpos + 8 * r < k0 + 8 * j + cq + c) x = kNegInf;
          sc[i] = x;
        }
    softmax_step(sc, m, l, acc);
    uint32_t pa[4][4];
    to_a_operand<T>(sc, pa);
    wg_fence();
    mma_nmajor<T, D>(acc, pa, sm + L::kV + s * A * kBoxBytes);
    wg_commit();
    wg_wait();
#pragma unroll
    for (int at = 0; at < A; ++at) pin(acc[at]);
    pin(pa);
    mbar_arrive(&empty[s]);
  }
  store_fwd_rows<T, D>(o, lse, (size_t)bh * sq + q0w + row0, lane, acc, m, l);
}

// ---------------------------------------------------------------------------
// backward dk/dv: grid (BHk, Skv / 128)
// ---------------------------------------------------------------------------
template <int D> struct DkvSmem {
  static constexpr int kAtoms = D / 64;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kConsumers * kAtoms * kBoxBytes;
  static constexpr int kQ = kV + kConsumers * kAtoms * kBoxBytes;
  static constexpr int kDO = kQ + kDkvStages * kAtoms * kBoxBytes;
  static constexpr int kLse = kDO + kDkvStages * kAtoms * kBoxBytes;
  static constexpr int kDelta = kLse + kDkvStages * kRows * 4;
  static constexpr int kBar = kDelta + kDkvStages * kRows * 4;
  static constexpr int kBytes = kBar + 8 * (2 * kDkvStages + 1) + 1024;
};

// First 64-row q tile that sees kv row k0 under the causal mask (its last
// row's diagonal reaches k0); Skv - Sq and k0 are multiples of 64.
__device__ __forceinline__ int dkv_first_q_tile(int k0, int sq, int skv,
                                                int causal) {
  return causal ? max(0, (k0 - (skv - sq)) / kRows) : 0;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv,
                                int sq, int skv, int group, float scale,
                                int causal) {
  using L = DkvSmem<D>;
  constexpr int A = L::kAtoms;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kDkvStages;
  uint64_t* kvbar = empty + kDkvStages;
  const int bhk = blockIdx.x;
  const int k0 = blockIdx.y * kBlockRows;  // the first kv tiles first
  const int off = skv - sq;
  const int n_q = sq / kRows;
  const int t0 = min(n_q, dkv_first_q_tile(k0, sq, skv, causal));
  const int per_head = n_q - t0;
  if (threadIdx.x == 0) init_ring(full, empty, kDkvStages, kvbar);
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(kvbar, 2 * kConsumers * A * kBoxBytes);
    for (int w = 0; w < kConsumers; ++w)
      for (int at = 0; at < A; ++at) {
        const int row = bhk * skv + k0 + kRows * w;
        tma_load(sm + L::kK + (w * A + at) * kBoxBytes, &tk, kvbar, at * 64,
                 row);
        tma_load(sm + L::kV + (w * A + at) * kBoxBytes, &tv, kvbar, at * 64,
                 row);
      }
    for (int e = 0; e < group * per_head; ++e) {
      const int s = e % kDkvStages;
      const int bh = bhk * group + e / per_head;
      const int row = bh * sq + (t0 + e % per_head) * kRows;
      if (e >= kDkvStages) mbar_wait(&empty[s], ((e / kDkvStages) - 1) & 1);
      mbar_expect_tx(&full[s], 2 * A * kBoxBytes + 2 * kRows * 4);
      for (int at = 0; at < A; ++at) {
        tma_load(sm + L::kQ + (s * A + at) * kBoxBytes, &tq, &full[s],
                 at * 64, row);
        tma_load(sm + L::kDO + (s * A + at) * kBoxBytes, &tdo, &full[s],
                 at * 64, row);
      }
      bulk_load(sm + L::kLse + s * kRows * 4, lse + row, kRows * 4, &full[s]);
      bulk_load(sm + L::kDelta + s * kRows * 4, delta + row, kRows * 4,
                &full[s]);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns kv rows k0w .. k0w + 63 --------------
  regs_inc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int k0w = k0 + kRows * wg;
  const uint8_t* Kw = sm + L::kK + wg * A * kBoxBytes;
  const uint8_t* Vw = sm + L::kV + wg * A * kBoxBytes;
  float dka[A][32], dva[A][32];
#pragma unroll
  for (int at = 0; at < A; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[at][i] = dva[at][i] = 0.f;
  mbar_wait(kvbar, 0);
  for (int e = 0; e < group * per_head; ++e) {
    const int s = e % kDkvStages;
    const int q0 = (t0 + e % per_head) * kRows;
    mbar_wait(&full[s], (e / kDkvStages) & 1);
    if (causal && q0 + kRows - 1 + off < k0w) {  // no q row sees k0w..
      mbar_arrive(&empty[s]);
      continue;
    }
    const uint8_t* Qs = sm + L::kQ + s * A * kBoxBytes;
    const uint8_t* dOs = sm + L::kDO + s * A * kBoxBytes;
    const float* Ls = reinterpret_cast<const float*>(sm + L::kLse) + s * kRows;
    const float* Dl =
        reinterpret_cast<const float*>(sm + L::kDelta) + s * kRows;
    // S^T = K Q^T and dP^T = V dO^T: kv rows as M, q rows as N
    float st[32], dpt[32];
    wg_fence();
    mma_kmajor<T, D>(st, Kw, Qs);
    mma_kmajor<T, D>(dpt, Vw, dOs);
    wg_commit();
    wg_wait();
    pin(st);
    pin(dpt);
    const bool mask = causal && q0 + off < k0w + kRows - 1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + cq + c;  // q row in the tile
        const float lraw = Ls[col];
        // fully masked rows carry lse == -1e30; exp(s - lse) would be 1
        const float ls = (lraw <= kNegInf * 0.5f ? 0.f : lraw) * kLog2e;
        const float dl = Dl[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + c;
          float x = st[i] * scale;
          if (mask && off + q0 + col < k0w + row0 + 8 * r) x = kNegInf;
          const float p = exp2f(fmaf(x, kLog2e, -ls));
          st[i] = p;
          dpt[i] = p * (dpt[i] - dl) * scale;
        }
      }
    uint32_t pa[4][4], dsa[4][4];
    to_a_operand<T>(st, pa);
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
    mbar_arrive(&empty[s]);
  }
  const size_t krow = (size_t)bhk * skv + k0w + row0;
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int at = 0; at < A; ++at) {
    store_tile<T, D>(dk, krow, 64 * at, lane, dka[at], one);
    store_tile<T, D>(dv, krow, 64 * at, lane, dva[at], one);
  }
}

// ---------------------------------------------------------------------------
// backward dq: grid (BH, Sq / 128)
// ---------------------------------------------------------------------------
template <int D> struct DqSmem {
  static constexpr int kAtoms = D / 64;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kConsumers * kAtoms * kBoxBytes;
  static constexpr int kK = kDO + kConsumers * kAtoms * kBoxBytes;
  static constexpr int kV = kK + kDqStages * kAtoms * kBoxBytes;
  static constexpr int kLse = kV + kDqStages * kAtoms * kBoxBytes;
  static constexpr int kDelta = kLse + kBlockRows * 4;
  static constexpr int kBar = kDelta + kBlockRows * 4;
  static constexpr int kBytes = kBar + 8 * (2 * kDqStages + 1) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dq, int sq, int skv,
                               int group, float scale, int causal) {
  using L = DqSmem<D>;
  constexpr int A = L::kAtoms;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kDqStages;
  uint64_t* qbar = empty + kDqStages;
  const int bh = blockIdx.x;
  // the last q blocks read the most kv tiles under the causal mask
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int off = skv - sq;
  const int n_kv = fwd_kv_tiles(q0, sq, skv, causal);
  if (threadIdx.x == 0) init_ring(full, empty, kDqStages, qbar);
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ---- producer: Q, dO, lse and delta once, then the K/V ring ----------
    regs_dec<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    const int qrow = bh * sq + q0;
    mbar_expect_tx(qbar, 2 * kConsumers * A * kBoxBytes + 2 * kBlockRows * 4);
    for (int w = 0; w < kConsumers; ++w)
      for (int at = 0; at < A; ++at) {
        tma_load(sm + L::kQ + (w * A + at) * kBoxBytes, &tq, qbar, at * 64,
                 qrow + kRows * w);
        tma_load(sm + L::kDO + (w * A + at) * kBoxBytes, &tdo, qbar,
                 at * 64, qrow + kRows * w);
      }
    bulk_load(sm + L::kLse, lse + qrow, kBlockRows * 4, qbar);
    bulk_load(sm + L::kDelta, delta + qrow, kBlockRows * 4, qbar);
    const int kv_row = (bh / group) * skv;
    for (int e = 0; e < n_kv; ++e) {
      const int s = e % kDqStages;
      if (e >= kDqStages) mbar_wait(&empty[s], ((e / kDqStages) - 1) & 1);
      mbar_expect_tx(&full[s], 2 * A * kBoxBytes);
      for (int at = 0; at < A; ++at) {
        tma_load(sm + L::kK + (s * A + at) * kBoxBytes, &tk, &full[s],
                 at * 64, kv_row + e * kRows);
        tma_load(sm + L::kV + (s * A + at) * kBoxBytes, &tv, &full[s],
                 at * 64, kv_row + e * kRows);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0w .. q0w + 63 ---------------
  regs_inc<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int q0w = q0 + kRows * wg;
  const int qpos = off + q0w + row0;  // row r of the thread: qpos + 8 r
  const uint8_t* Qw = sm + L::kQ + wg * A * kBoxBytes;
  const uint8_t* dOw = sm + L::kDO + wg * A * kBoxBytes;
  float dqa[A][32];
#pragma unroll
  for (int at = 0; at < A; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[at][i] = 0.f;
  mbar_wait(qbar, 0);
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kRows * wg + row0 + 8 * r;
    const float lraw = reinterpret_cast<const float*>(sm + L::kLse)[row];
    // a row that sees no key carries lse == -1e30: its scores are all
    // masked, so p = exp(-1e30 - 0) = 0 and its dq is exactly 0
    ls[r] = (lraw <= kNegInf * 0.5f ? 0.f : lraw) * kLog2e;
    dl[r] = reinterpret_cast<const float*>(sm + L::kDelta)[row];
  }
  for (int e = 0; e < n_kv; ++e) {
    const int s = e % kDqStages;
    mbar_wait(&full[s], (e / kDqStages) & 1);
    const int k0 = e * kRows;
    if (causal && off + q0w + kRows - 1 < k0) {  // sees none of this tile
      mbar_arrive(&empty[s]);
      continue;
    }
    const uint8_t* Ks = sm + L::kK + s * A * kBoxBytes;
    const uint8_t* Vs = sm + L::kV + s * A * kBoxBytes;
    // S = Q K^T and dP = dO V^T: q rows as M, kv rows as N
    float sc[32], dp[32];
    wg_fence();
    mma_kmajor<T, D>(sc, Qw, Ks);
    mma_kmajor<T, D>(dp, dOw, Vs);
    wg_commit();
    wg_wait();
    pin(sc);
    pin(dp);
    // tiles wholly under the diagonal skip the mask
    const bool mask = causal && off + q0w < k0 + kRows - 1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * r + c;
          float x = sc[i] * scale;
          if (mask && qpos + 8 * r < k0 + 8 * j + cq + c) x = kNegInf;
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
    mbar_arrive(&empty[s]);
  }
  const size_t qrow = (size_t)bh * sq + q0w + row0;
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int at = 0; at < A; ++at)
    store_tile<T, D>(dq, qrow, 64 * at, lane, dqa[at], one);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded (the kernels' libraries link only the runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A [rows, D] row-major 16-bit matrix cut into 64-row x 64-column boxes,
// swizzled 128 bytes. Returns false if the encoding is refused.
template <typename T, int D>
static bool make_map(CUtensorMap* map, const void* ptr, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {64, (cuuint32_t)kRows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
static cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
static int fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int bhk, int sq, int skv, float scale,
               int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<T, D>(&tq, q, bh * sq) || !make_map<T, D>(&tk, k, bhk * skv)
      || !make_map<T, D>(&tv, v, bhk * skv))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_hopper_kernel<T, D>;
  constexpr int smem = FwdSmem<D>::kBytes;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(bh, sq / kBlockRows), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse), sq, skv,
      bh / bhk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int bh, int bhk, int sq, int skv,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map<T, D>(&tq, q, bh * sq) || !make_map<T, D>(&tk, k, bhk * skv)
      || !make_map<T, D>(&tv, v, bhk * skv)
      || !make_map<T, D>(&tdo, dout, bh * sq))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_hopper_kernel<T, D>;
  constexpr int smem = DkvSmem<D>::kBytes;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(bhk, skv / kBlockRows), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), sq, skv, bh / bhk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int bh, int bhk, int sq, int skv, float scale,
                  int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map<T, D>(&tq, q, bh * sq) || !make_map<T, D>(&tk, k, bhk * skv)
      || !make_map<T, D>(&tv, v, bhk * skv)
      || !make_map<T, D>(&tdo, dout, bh * sq))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_hopper_kernel<T, D>;
  constexpr int smem = DqSmem<D>::kBytes;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(bh, sq / kBlockRows), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sq, skv,
      bh / bhk, scale, causal);
  return (int)cudaGetLastError();
}

// Registers, dynamic shared memory and resident blocks per SM of one kernel.
template <typename Kernel>
static cudaError_t kernel_info(Kernel kernel, int smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = set_smem(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
  out[0] = err == cudaSuccess ? attr.numRegs : 0;
  out[1] = smem;
  out[2] = blocks;
  return err;
}

// The three kernels for (T, D): out[0..2] forward, out[3..5] dk/dv,
// out[6..8] dq, each (registers, dynamic shared memory, blocks per SM).
template <typename T, int D> static int info(int* out) {
  cudaError_t err = kernel_info(flash_fwd_hopper_kernel<T, D>,
                                FwdSmem<D>::kBytes, out);
  if (err == cudaSuccess)
    err = kernel_info(flash_bwd_dkv_hopper_kernel<T, D>, DkvSmem<D>::kBytes,
                      out + 3);
  if (err == cudaSuccess)
    err = kernel_info(flash_bwd_dq_hopper_kernel<T, D>, DqSmem<D>::kBytes,
                      out + 6);
  return (int)err;
}

}  // namespace ds_hopper

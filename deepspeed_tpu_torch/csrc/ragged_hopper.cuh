// The tensor-core query tiles of the ragged paged attention kernel
// (ragged_attention.cu): the tokens of every run of two or more tokens (a
// prefill chunk, a continuation; ragged_runs.cuh), for 16-bit q (bf16,
// fp16), head_dim 64 or 128, a pool in q's dtype or int8 with per-(block,
// head) scales.
//
// Bound on an H100: at the put() shape (8 rows of 128..1024 tokens from
// position 0, 32 / 8 heads, hd 128) operations and bytes alike, ~0.028 ms
// each: 27.4 GFLOP of scores and P.V, and q, out and each row's K/V once.
// Reading K/V once per query tile instead of once per token, and doing the
// products on the tensor cores, is what can approach it, so:
//
//   * grid (nh / heads, T / 64 + 1): a block takes one 64-token window of the
//     buffer and `heads` (2 where the GQA group is even, else 1) q heads
//     of one kv head, the windows issued last to first (a run's last tokens
//     see the most slots). It reads the window's row ids and lengths and
//     those of its two neighbours, and cuts the window into segments: the
//     stretches of one multi-token run inside it (at most 64 tokens, one
//     wgmma M). It writes the zeros of the window's padding tokens, and
//     walks its segments in turn. (A scan kernel writing a tile list for a
//     persistent grid was the other design: it adds a launch and a
//     host-sized list, and the window rule needs neither.) The first block
//     scans the whole buffer for the single-token walk that runs next
//     (scan_runs): each single-token run's rank, which picks its chunks
//     and workspace slot, and their count; it runs beside the tiles, so
//     the scan costs no launch;
//   * per segment: Q of each head as a 64-row tile by TMA from q viewed as
//     {hd, nh, T} (rows past the buffer zero-filled; rows of other runs are
//     computed and not stored), then the row's pages in 64-slot kv tiles
//     up to the segment's largest length, by TMA from the pool viewed as
//     {hd, kvh, nb * bs}: a box of 64 columns x 1 head x `box` slots (the
//     largest power of two that divides bs, at most 64) lands as `box`
//     rows of the 128-byte swizzled image that the wgmma descriptors read,
//     so a page of 64 slots is one box per 64 columns, pages of 16 or 32
//     slots fill a stage with 4 or 2 boxes, and a page of 128 slots serves
//     two stages. A box past the segment's last page re-reads that page
//     (its slots are masked): the walk reads no table entry past
//     ceil(max length / bs) nor past the table width;
//   * the products of flash_hopper.cuh: S = Q.K^T K-major from shared
//     memory, the shared online softmax step, P as the register A operand
//     of P.V (wgmma m64n64k16, f32 accumulate); a 3-stage K/V ring with
//     full / empty mbarriers, one producer thread issuing every copy, the
//     producer warpgroup giving its registers to the consumers
//     (setmaxnreg 56 / 224);
//   * the mask is per row: slot s is visible to row r iff s < lengths of
//     the token at r (capped at the table width); masked scores are -1e30;
//     a kv tile below every row's bound skips the mask. The output is
//     acc / l (a row that saw nothing would write 0);
//   * an int8 pool: TMA copies int8 boxes ({hd, kvh, nb * bs}, hd bytes a
//     row, no swizzle) into a staging ring of its own; three warps of the
//     producer warpgroup dequantize each stage into the 16-bit swizzled
//     image as _dequant_tile does (f32(q8) * scale, rounded once to T),
//     fence it for the async proxy and arrive on the stage's full barrier.
//     So the tile kernel, the split walk and the plain version's
//     gather_pages see the same 16-bit K and V.
//
// No atomics: a repeat is bit-identical.
#pragma once

#include "flash_hopper.cuh"
#include "ragged_runs.cuh"

namespace ds_ragged {

using namespace ds_async;
using namespace ds_hopper;

constexpr int kWin = 64;                  // tokens per window and tile
constexpr int kStages = 3;                // K/V ring depth
constexpr int kRaggedThreads = 384;       // 2 consumer + 1 producer WG
constexpr int kDequantThreads = 96;       // producer warps 1..3 (int8)
constexpr int kProdRegs = 56, kConsRegs = 224;

template <int D, bool Q8> struct TileSmem {
  static constexpr int kAtoms = D / 64;
  static constexpr int kQ = 0;                          // 2 heads
  static constexpr int kK = kQ + 2 * kAtoms * kBoxBytes;
  static constexpr int kV = kK + kStages * kAtoms * kBoxBytes;
  static constexpr int kRaw = kV + kStages * kAtoms * kBoxBytes;  // int8
  static constexpr int kRawBytes = Q8 ? kStages * kWin * D : 0;   // K or V
  static constexpr int kScl = kRaw + 2 * kRawBytes;   // [2][2][64] f32
  static constexpr int kTok = kScl + (Q8 ? 4 * kWin * 4 : 0);  // [2][68]
  static constexpr int kSeg = kTok + 2 * 68 * 4;      // int4 [64]
  static constexpr int kMisc = kSeg + kWin * 16;      // ballots, counts
  static constexpr int kBar = kMisc + 32;
  // full, empty, raw full, raw empty [kStages] each; Q full, Q empty
  static constexpr int kBytes = kBar + 8 * (4 * kStages + 2) + 1024;
};

// 8 int8 values (two 32-bit words) dequantized as _dequant_tile does, as
// four packed pairs of T. A byte becomes f32 exactly through the bits of
// 2^23 + 128 + q8 (one byte permute and one subtraction), as in
// split_walk.cuh's load_kv.
template <typename T>
__device__ __forceinline__ uint4 dequant8(uint32_t lo, uint32_t hi,
                                          float scale) {
  float f[8];
  const uint32_t w[2] = {lo ^ 0x80808080u, hi ^ 0x80808080u};
#pragma unroll
  for (int b = 0; b < 8; ++b)
    f[b] = (__uint_as_float(__byte_perm(w[b / 4], 0x4B000000u, 0x7540u + b % 4))
            - 8388736.f) * scale;
  uint4 r;
  r.x = Mma<T>::pack(f[0], f[1]);
  r.y = Mma<T>::pack(f[2], f[3]);
  r.z = Mma<T>::pack(f[4], f[5]);
  r.w = Mma<T>::pack(f[6], f[7]);
  return r;
}

// The bf16 values of a packed pair, as f32 (exact).
__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// P for P.V on bf16 inputs, in three register A operands whose sum is p to
// f32 precision: bf16 keeps 8 significant bits, so p rounded once would
// move a row's output by ~2^-9 of itself, and the output's own bf16
// rounding would then differ from an f32 P.V's wherever it lies near a
// rounding boundary (one bf16 step, 1.6e-2 at magnitude 2). hi = bf16(p),
// mid = bf16(p - hi), lo = bf16(p - hi - mid): 24 bits in all.
__device__ __forceinline__ void split_a_operand(const float (&s)[32],
                                                uint32_t (&hi)[4][4],
                                                uint32_t (&mid)[4][4],
                                                uint32_t (&lo)[4][4]) {
  using M = Mma<__nv_bfloat16>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a = s[8 * kk + 2 * i], b = s[8 * kk + 2 * i + 1];
      hi[kk][i] = M::pack(a, b);
      float2 h = bf16x2_to_f32(hi[kk][i]);
      a -= h.x;
      b -= h.y;
      mid[kk][i] = M::pack(a, b);
      h = bf16x2_to_f32(mid[kk][i]);
      lo[kk][i] = M::pack(a - h.x, b - h.y);
    }
}

// The buffer's runs for the single-token walk (paged_attention.cu,
// ragged_singleton_kernel), by one block: rank[t] = t's place among the
// single-token runs in buffer order (else -1), scan[0] = the number of
// single-token runs. Written whole every call, so nothing needs
// resetting.
__device__ __forceinline__ void scan_runs(const int* __restrict__ row_ids,
                                          const int* __restrict__ lengths,
                                          int n, int* __restrict__ rank,
                                          int* __restrict__ scan) {
  __shared__ int counts[kRaggedThreads / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int carry = 0;
  for (int base = 0; base < n; base += kRaggedThreads) {
    const int t = base + tid;
    const bool single = t < n && lengths[t] > 0 &&
                        !ds_ragged_runs::in_multi_run(row_ids, lengths, n, t);
    const unsigned ballot = __ballot_sync(0xffffffffu, single);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int at = carry + __popc(ballot & ((1u << lane) - 1)), total = 0;
    for (int w = 0; w < kRaggedThreads / 32; ++w) {
      at += w < warp ? counts[w] : 0;
      total += counts[w];
    }
    if (t < n) rank[t] = single ? at : -1;
    carry += total;
    __syncthreads();  // counts are rewritten next round
  }
  if (tid == 0) scan[0] = carry;
}

__device__ __forceinline__ void dequant_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kDequantThreads) : "memory");
}

// T: io dtype (bf16 / fp16); S: stored K/V element (T, or int8_t); D:
// head_dim. tq: q as {D, nh, n_tok}; tk / tv: the pool as {D, kvh, nb * bs}
// (16-bit: 64-column boxes, 128-byte swizzle; int8: D-byte rows). box:
// slots per pool box. rank / scan: scan_runs' output. A segment is (first
// token in the window, tokens, largest and smallest capped length).
template <typename T, typename S, int D>
__global__ void __launch_bounds__(kRaggedThreads, 1)
    ragged_tile_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ row_ids,
                       const int* __restrict__ lengths,
                       const int* __restrict__ block_tables,
                       T* __restrict__ out, int* __restrict__ rank,
                       int* __restrict__ scan, int n_tok, int nh, int kvh,
                       int heads, int bs, int mb, int box, float scale) {
  constexpr bool kQ8 = std::is_same<S, int8_t>::value;
  using L = TileSmem<D, kQ8>;
  constexpr int A = L::kAtoms;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_1024(smem_raw);
  int* tok_row = reinterpret_cast<int*>(sm + L::kTok);
  int* tok_len = tok_row + 68;
  int4* segs = reinterpret_cast<int4*>(sm + L::kSeg);
  int* misc = reinterpret_cast<int*>(sm + L::kMisc);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* raw_full = empty + kStages;
  uint64_t* raw_empty = raw_full + kStages;
  uint64_t* qfull = raw_empty + kStages;
  uint64_t* qempty = qfull + 1;

  if (blockIdx.y == 0) {  // the scan block
    if (blockIdx.x == 0) scan_runs(row_ids, lengths, n_tok, rank, scan);
    return;
  }
  const int t_base = (gridDim.y - 1 - blockIdx.y) * kWin;
  const int h0 = blockIdx.x * heads;
  const int kv_head = h0 / (nh / kvh);
  const int cap = mb * bs;  // the table's width in slots
  const int tid = threadIdx.x;

  // ---- the window: entry i is token t_base - 1 + i ------------------------
  if (tid < kWin + 2) {
    const int t = t_base - 1 + tid;
    const bool in = t >= 0 && t < n_tok;
    tok_row[tid] = in ? row_ids[t] : -1;
    tok_len[tid] = in ? max(lengths[t], 0) : 0;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kQ8 ? kDequantThreads : 1);
      mbar_init(&empty[s], heads * 128);
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], kDequantThreads);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, heads * 128);
    mbar_fence_init();
  }
  __syncthreads();
  // segments: a token of a multi-token run starts one where the window or
  // its run starts; its end, largest and smallest capped length by a scan
  // of at most 64 entries; compacted in window order by two ballots
  bool start = false, zero = false;
  int4 seg = make_int4(0, 0, 0, 0);
  unsigned ball = 0;
  if (tid < kWin) {
    const int i = tid + 1, r = tok_row[i], len = tok_len[i];
    const bool prev = ds_ragged_runs::joins(r, len, tok_row[i - 1],
                                            tok_len[i - 1]);
    const bool next = ds_ragged_runs::joins(r, len, tok_row[i + 1],
                                            tok_len[i + 1]);
    start = (prev || next) && (tid == 0 || !prev);
    zero = len == 0 && t_base + tid < n_tok;
    if (start) {
      int end = i + 1, mx = min(len, cap), mn = mx;
      while (end <= kWin && ds_ragged_runs::joins(tok_row[end], tok_len[end],
                                                  r, tok_len[end - 1])) {
        const int l = min(tok_len[end], cap);
        mx = max(mx, l);
        mn = min(mn, l);
        ++end;
      }
      seg = make_int4(tid, end - i, mx, mn);
    }
    ball = __ballot_sync(0xffffffffu, start);
    const unsigned bz = __ballot_sync(0xffffffffu, zero);
    if (tid % 32 == 0) {
      misc[tid / 32] = __popc(ball);
      misc[2 + tid / 32] = (int)bz;
    }
  }
  __syncthreads();
  const int n_seg = misc[0] + misc[1];
  if (start)
    segs[(tid >= 32 ? misc[0] : 0) + __popc(ball & ((1u << (tid % 32)) - 1))] =
        seg;
  // zeros of the window's padding tokens, for this block's heads
  {
    const unsigned long long zmask =
        (unsigned)misc[2] | ((unsigned long long)(unsigned)misc[3] << 32);
    constexpr int kVecs = D / 8;  // 16-byte vectors of T per head row
    for (int e = tid; e < kWin * heads * kVecs; e += kRaggedThreads) {
      const int i = e / (heads * kVecs);
      if (!((zmask >> i) & 1)) continue;
      const int c = (e / kVecs) % heads, v = e % kVecs;
      *reinterpret_cast<uint4*>(
          out + ((size_t)(t_base + i) * nh + h0 + c) * D + 8 * v) =
          make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  if (n_seg == 0) return;
  const int wg = tid / 128;

  if (wg == 2) {
    // ---- producer warpgroup ---------------------------------------------
    regs_dec<kProdRegs>();
    if (tid == 256) {  // issues every copy
      int step = 0;
      for (int k = 0; k < n_seg; ++k) {
        const int4 g = segs[k];
        const int* table = block_tables + (size_t)tok_row[g.x + 1] * mb;
        const int n_pages = (g.z + bs - 1) / bs;
        const int n_kv = (g.z + kWin - 1) / kWin;
        if (k > 0) mbar_wait(qempty, (k - 1) & 1);
        mbar_expect_tx(qfull, heads * A * kBoxBytes);
        for (int c = 0; c < heads; ++c)
          for (int at = 0; at < A; ++at)
            tma_load3(sm + L::kQ + (c * A + at) * kBoxBytes, &tq, qfull,
                      at * 64, h0 + c, t_base + g.x);
        for (int e = 0; e < n_kv; ++e, ++step) {
          const int s = step % kStages;
          uint64_t* bar = kQ8 ? &raw_full[s] : &full[s];
          if (step >= kStages)
            mbar_wait(kQ8 ? &raw_empty[s] : &empty[s],
                      ((step / kStages) - 1) & 1);
          mbar_expect_tx(bar, 2 * kWin * D * (int)sizeof(S));
          for (int b0 = 0; b0 < kWin; b0 += box) {
            const int slot = e * kWin + b0;
            const int j = min(slot / bs, n_pages - 1);
            const int prow = table[j] * bs + (slot - (slot / bs) * bs);
            if constexpr (kQ8) {
              uint8_t* rk = sm + L::kRaw + s * kWin * D + b0 * D;
              tma_load3(rk, &tk, bar, 0, kv_head, prow);
              tma_load3(rk + L::kRawBytes, &tv, bar, 0, kv_head, prow);
            } else {
              for (int at = 0; at < A; ++at) {
                const int o = (s * A + at) * kBoxBytes + b0 * 128;
                tma_load3(sm + L::kK + o, &tk, bar, at * 64, kv_head, prow);
                tma_load3(sm + L::kV + o, &tv, bar, at * 64, kv_head, prow);
              }
            }
          }
        }
      }
    } else if (kQ8 && tid >= 256 + 32) {  // dequantize each stage
      const int td = tid - 256 - 32;
      constexpr int kPieces = kWin * D / 16;  // 16-byte pieces of K (or V)
      float* scl = reinterpret_cast<float*>(sm + L::kScl);  // [2][2][64]
      int step = 0;
      for (int k = 0; k < n_seg; ++k) {
        const int4 g = segs[k];
        const int* table = block_tables + (size_t)tok_row[g.x + 1] * mb;
        const int n_pages = (g.z + bs - 1) / bs;
        const int n_kv = (g.z + kWin - 1) / kWin;
        for (int e = 0; e < n_kv; ++e, ++step) {
          const int s = step % kStages;
          // each tile row's K and V scale (its page's), once a stage; the
          // buffer of this step's parity, free since the last barrier
          float* sc2 = scl + (step & 1) * 2 * kWin;
          if (td < kWin) {
            const int j = min((e * kWin + td) / bs, n_pages - 1);
            const size_t at = (size_t)table[j] * kvh + kv_head;
            sc2[td] = __ldg(k_scale + at);
            sc2[kWin + td] = __ldg(v_scale + at);
          }
          dequant_sync();
          mbar_wait(&raw_full[s], (step / kStages) & 1);
          if (step >= kStages) mbar_wait(&empty[s], ((step / kStages) - 1) & 1);
          for (int p = td; p < 2 * kPieces; p += kDequantThreads) {
            const int is_v = p >= kPieces;
            const int pc = p - is_v * kPieces;
            const int r = pc / (D / 16), c16 = pc % (D / 16);
            const float sc = sc2[is_v * kWin + r];
            const uint4 raw = *reinterpret_cast<const uint4*>(
                sm + L::kRaw + is_v * L::kRawBytes + s * kWin * D + r * D +
                16 * c16);
            // columns 16 c16 .. +15: two 16-byte chunks of the swizzled row
            const int col = 16 * c16, at = col / 64, ch = (col % 64) / 8;
            uint8_t* row = sm + (is_v ? L::kV : L::kK) +
                           (s * A + at) * kBoxBytes + r * 128;
            *reinterpret_cast<uint4*>(row + ((ch ^ (r & 7)) * 16)) =
                dequant8<T>(raw.x, raw.y, sc);
            *reinterpret_cast<uint4*>(row + (((ch + 1) ^ (r & 7)) * 16)) =
                dequant8<T>(raw.z, raw.w, sc);
          }
          fence_proxy_async();
          mbar_arrive(&full[s]);
          mbar_arrive(&raw_empty[s]);
        }
      }
    }
    return;
  }
  if (wg >= heads) {  // an odd group: one head per block
    regs_dec<kProdRegs>();
    return;
  }

  // ---- consumers: warpgroup wg computes q head h0 + wg --------------------
  regs_inc<kConsRegs>();
  const int lane = tid % 32;
  const int row0 = 16 * ((tid % 128) / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int head = h0 + wg;
  const uint8_t* Qw = sm + L::kQ + wg * A * kBoxBytes;
  int step = 0;
  for (int k = 0; k < n_seg; ++k) {
    const int4 g = segs[k];
    const int n_kv = (g.z + kWin - 1) / kWin;
    int lr[2];  // the thread's two rows' capped lengths (0 past the segment)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row0 + 8 * r;
      lr[r] = rr < g.y ? min(tok_len[g.x + rr + 1], cap) : 0;
    }
    float acc[A][32];
#pragma unroll
    for (int at = 0; at < A; ++at)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[at][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(qfull, k & 1);
    for (int e = 0; e < n_kv; ++e, ++step) {
      const int s = step % kStages;
      mbar_wait(&full[s], (step / kStages) & 1);
      const int k0 = e * kWin;
      float sc[32];
      wg_fence();
      mma_kmajor<T, D>(sc, Qw, sm + L::kK + s * A * kBoxBytes);
      wg_commit();
      wg_wait();
      pin(sc);
      // tiles below every row's bound skip the mask
      const bool mask = k0 + kWin > g.w;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 4 * j + 2 * r + c;
            float x = sc[i] * scale;
            if (mask && k0 + 8 * j + cq + c >= lr[r]) x = kNegInf;
            sc[i] = x;
          }
      softmax_step(sc, m, l, acc);
      const uint8_t* Vs = sm + L::kV + s * A * kBoxBytes;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        uint32_t ph[4][4], pm[4][4], pl[4][4];
        split_a_operand(sc, ph, pm, pl);
        wg_fence();
        mma_nmajor<T, D>(acc, ph, Vs);
        mma_nmajor<T, D>(acc, pm, Vs);
        mma_nmajor<T, D>(acc, pl, Vs);
        wg_commit();
        wg_wait();
        pin(ph);
        pin(pm);
        pin(pl);
      } else {  // fp16 keeps 11 significant bits of p: one operand
        uint32_t pa[4][4];
        to_a_operand<T>(sc, pa);
        wg_fence();
        mma_nmajor<T, D>(acc, pa, Vs);
        wg_commit();
        wg_wait();
        pin(pa);
      }
#pragma unroll
      for (int at = 0; at < A; ++at) pin(acc[at]);
      mbar_arrive(&empty[s]);
    }
    mbar_arrive(qempty);  // Q is read by this segment's last product
    // out = acc / l_safe for the segment's rows only
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row0 + 8 * r;
      if (rr >= g.y) continue;
      T* o = out + ((size_t)(t_base + g.x + rr) * nh + head) * D + cq;
#pragma unroll
      for (int at = 0; at < A; ++at)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<uint32_t*>(o + 64 * at + 8 * j) = Mma<T>::pack(
              acc[at][i] * inv[r], acc[at][i + 1] * inv[r]);
        }
    }
  }
}

}  // namespace ds_ragged

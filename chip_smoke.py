#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (deepspeed_tpu_torch) runs on an
NVIDIA GPU: builds the hand-written kernels from this checkout, holds each
against its plain PyTorch version at the shapes of the main paths, serves
full-width Mistral-7B (seeded random weights) through ``pipeline()`` and
``generate()`` over a bf16 and an int8 KV pool and through the v1
``init_inference()`` engine, then with weight-only quantized weights
(int8 and int4 on the v2 engine, int8 on the v1 engine), trains
full-width Mistral-7B at 4 layers
through ``initialize()`` and ``train_batch()``, then at its full 32 layers
through both ZeRO-Offload backends (the host C++ optimizer and the tiered
pinned-memory state), with the NVMe tier and checkpoints at 2 layers,
runs block-sparse attention
forward and backward through ``SparseSelfAttention`` at Mistral-7B
attention width, and checks that every path ran through its kernels.

    python3 chip_smoke.py            # needs one CUDA card; exit 0 = ok
    python3 chip_smoke.py --kernels-only   # phases 1-4b only, no result

Phases, in the order they run (each raises on failure, so the run cannot
exit 0):

1. device line: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, kernel build seconds and ptxas resource lines;
2. serving kernel phases at nh 32, kvh 8, hd 128, bs 64, bf16: paged
   decode (a split-K page walk; its plan and grid logged, and its
   registers, spills, shared memory and blocks per SM for each dtype and
   pool) and a mixed ragged batch against their plain versions (max
   |diff| <= 1e-2: one bf16 rounding of an output of magnitude ~1 is
   <= 2**-8 relative, plus f32 reordering), padding outputs exactly 0,
   a repeat bit-identical, and a pure-decode ragged batch torch.equal to
   the decode kernel (its single-token runs are the decode kernel's
   walk); the ragged tile kernel's registers, spills (a spill fails),
   shared memory and blocks per SM for each dtype, head_dim and pool; the
   ragged kernels on a buffer of every kind of token (runs across 64-token
   windows, a row's two runs apart, descending lengths, padding in the
   middle, one-token continuations) at bf16, fp16, f32 (2e-5), hd 64 with
   group 1, bs 16 with group 2, bs 24, bs 128, and the int8 pool (bs 64,
   bs 16 at hd 64, and bs 24); rows 3 and 3q also at the put() shape (8 rows of
   128..1024 tokens, T 4608), each ragged time in turns with its
   yardstick, and its split between the query tiles and the single-token
   walk (torch.profiler); fp32 (2e-5) and fp16 (1e-2) on the same inputs;
   paged decode on both pools
   in all three dtypes at edge lengths 0, 1, 63, 64, 65, a chunk - 1, a
   chunk, a chunk + 1, 2047 and 2048, also at nh 12, kvh 4, hd 96 (the
   generic route), a length-0 row exactly 0, and a repeated call
   bit-identical; times (CUDA events, medians, L2 flushed before each
   launch; the paged kernels in turns with their yardstick), bound and
   library yardstick (paged: the gather of the whole table + SDPA, and,
   logged beside it, SDPA on pages gathered beforehand); the same over an
   int8 pool with random per-(block, head) scales (paged_attention_q8,
   ragged_attention_q8; the int8 pure-decode ragged batch torch.equal to
   int8 paged decode; the yardstick times
   scaled_dot_product_attention on pages gathered and dequantized
   beforehand); both paged kernels under two split-plan targets (~2.5
   and ~5 blocks per SM) in turns at the table shape, the serve decode
   shape and on full tables; the dense decode kernel of the v1 engine (a
   split-K walk; its grid logged) at B 8, M 2048 (row lengths 1536 /
   2048) and M 1000 (993 / 1000), and edge lengths at M 2048, 1000 and
   576 (0, 1, a chunk boundary +- 1, M), same dtypes and tolerances, a
   length-0 row exactly 0, a repeated call bit-identical, timed in turns
   with its yardstick scaled_dot_product_attention over
   cache[:, :, :length] at M 2048 and at the v1 serve shape (M 576);
3. flash kernel phases at Mistral-7B training geometry (B 2, nh 32, kvh
   8, hd 128, S 2048, bf16, causal): first the registers and spills
   (ptxas) and the shared memory and blocks per SM (occupancy API) of the
   tensor-core flash_fwd, flash_bwd_dq and flash_bwd_dkv; then the three
   against their plain versions (o within 1e-2 absolute, lse within 1e-3,
   the gradients within 2e-2 of max |plain|: bf16 casts of p and ds at
   other points of the summation), also at Sq 1024 < Skv 2048,
   non-causal, and in fp32 (1e-4 absolute / relative: f32 reordering
   over 2048 keys; the f32 tile kernels) and fp16 (as bf16) on the same
   inputs, and in bf16 at hd 64, group 1 (MHA), S 128 (one tile) and Sq
   256 > Skv 128 (the rows that see no key exactly o = 0, lse = -1e30
   and dq = 0); a repeated backward bit-identical; times
   (each kernel and its yardstick in turns: kernel, library, kernel),
   the operations bound at 989 TFLOP/s and the library yardstick
   (scaled_dot_product_attention forward, and its autograd backward for
   the dq + dkv pair);
4. sparse kernel phases at Mistral-7B attention width (B 1, nh 32, hd 128,
   S 8192, bf16) on three layouts: (i) Fixed, block 64, 4 local / 1
   global, causal; (ii) BigBird, block 64, window 3, 1 global, 1 random,
   non-causal; (iii) the pattern of (i) at block 16 (16 local / 4
   global). First the registers and spills (ptxas; a spill fails) and
   the shared memory and blocks per SM of the tensor-core sparse_bwd_dq,
   sparse_bwd_dkv and sparse_fwd (csrc/sparse_hopper.cuh); each layout's
   block and 64-row tile statistics (tile products, steps per head, busy
   share of the consumer slots, longest list); then sparse_fwd,
   sparse_bwd_dq and sparse_bwd_dkv against their plain versions with
   the flash tolerances at each layout (o 1e-2, lse 1e-3, grads 2e-2),
   (i) also in fp32 (the tile kernels), fp16 and at hd 64, blocks 32 and
   128 at S 2048, block 16 at S 2064 (a ragged last 64-row tile: the
   tile kernels' route), each check logging its route; q blocks with no
   active block (whole 64-row tiles) giving o = 0, lse = -1e30 and dq = 0
   (block 64), and at block 16 empty q and kv blocks inside and across
   64-row tiles giving o = dq = 0, lse = -1e30 and dk = dv = 0 exactly; a
   repeated forward and backward bit-identical; times of each layout (the
   forward in turns with its library call: kernel, library, kernel; the
   backward pair in turns with the library pair: dq, dkv, library, dq,
   dkv), the operations bound (sparse_work) and the library yardstick
   (scaled_dot_product_attention with the layout as a boolean mask, and
   its autograd backward for the dq + dkv pair);
4b. quantizer and RMSNorm kernel phases: quantize_blocks and
   dequantize_blocks on one Mistral-7B layer's w_gate and w_down (bf16,
   block 2048, bits 8 and 4, int4 through pack / unpack), on edge inputs
   (a ragged tail n = 2048 * 5 + 777, an all-zero block, values that
   land exactly on .5 after the division) in f32 / bf16 / fp16, and on
   the element-wise route (block 1000, a source off 16-byte alignment):
   q, scales and f32 / bf16 / fp16 outputs bit-equal to the plain
   versions; rms_norm(use_pallas=True) at [4608, 4096], [8, 4096] and
   [4096, 4096] bf16, [4608, 4096] fp32 and h 4100, one launch per call
   (none for use_pallas=False), within 1e-5 (fp32) or one bf16 rounding
   (2**-7 |plain| + 1e-6) of rms_norm_ref; times, bytes bound and plain
   times (library: F.rms_norm; none computes blockwise quantization);
5. small fp32 serve checks on a tiny model: kernel engine vs plain engine,
   put() logits within 1e-4 and generate() streams equal, for the bf16-
   style pool and for the int8 kv_quant pool; the v1 engine with the
   dense decode kernel vs its decode_kernel=False einsum route, decode
   logits within 1e-4 and generate() streams equal; WOQ engines (bits 8
   and 4, v2 and v1) vs dense engines built from their own dequantized
   weights, logits within 1e-4 and streams equal;
6. serve: Mistral-7B, 32 layers, bf16, pipeline() answers 8 requests
   (prompts 128-1024 tokens, 64 new tokens, greedy) and generate() runs
   them with decode_window 8; launch counts must equal 32 x steps, one
   host sync per window, identical streams on a repeat, finite logits;
   the put() logits of the kernels against the plain versions in bf16
   and against an fp32 engine (informational); the device time, busy
   share and top kernels of one ragged step and of one fused decode
   window, and the paged kernel's ms per decode step (torch.profiler over
   generate()); then, on the same weight
   tensors, the int8 KV engine (init_inference(use_ragged=True,
   kv_quant)): generate() with launch counts of 32 x steps for both int8
   kernels, one host sync per window, identical streams on a repeat by
   an engine with the same pool history (a freed block keeps its
   grow-only scale, as in the JAX package), finite put() logits, its
   pool bytes against the bf16 pool's, TTFT and decode tokens/s, its
   logit gap and token agreement with the bf16 pool and the fp32 engine
   (informational) and its profile as above; and the v1 engine
   (init_inference()): 8 prompts of 512 tokens, 64 new tokens, greedy,
   32 x 63 dense decode launches, identical tokens on a repeat, prefill
   ms and decode tokens/s, and the profile of the prefill and of 8
   decode steps; then, on the same weight tensors, the WOQ phases:
   init_inference(use_ragged=True, quant_bits=8) (8 prompts, 64 new),
   quant_bits=4 (16 new) and the v1 engine with quant_bits=8 (8 x 512,
   16 new): 9 quantized leaves, 7 x 32 + 2 quantize launches at init,
   dequantize launches as the path predicts (7 x 32 per ragged or decode
   step plus 2 per call or window), resident bytes <= 0.51 / 0.26 of
   bf16, extra peak memory in generate() within two dense layers + the
   dense embedding and head + 1.5 GiB, finite logits, a fresh engine's
   identical streams, decode tokens/s beside the bf16 engine's in the
   same call, and profiles; then the serving engines are freed;
7. a small fp32 training check: a tiny model (hd 64, flash from S 128)
   trained 3 steps by a kernel engine and by a use_flash=False engine on
   the same weights, losses within 1e-5;
8. train: Mistral-7B width at 4 layers (of 32: the fp32 master and Adam
   state of all 32 would not fit one card), bf16 over an fp32 master,
   AdamW lr 3e-4, clip 1.0, micro 2 x gas 2 x S 2048, through
   initialize() and train_batch(): five steps and one eval_batch on one
   fixed batch; losses finite and falling, and a fresh random batch's
   loss above ln(V) / 2 (no leak through the causal mask); launch counts
   2 x L x gas (forward, with the remat recompute) and L x gas (dq, dkv)
   per step, plus L x gas forwards for the eval; step time, tokens/s,
   peak memory, and the device time, busy share, top kernels and flash
   kernels of one more step (torch.profiler);
8b. offload and checkpoints (the engines of each step freed before the
   next): the host C++ ops built by g++ from csrc/host (seconds logged);
   DeepSpeedCPUAdam with f32 and bf16 gradients, Adagrad and Lion on one
   layer's w_gate (58.7 M f32 elements), 3 steps, against the port's torch
   optimizers on CPU tensors (rtol 1e-5, atol 1e-6), the bf16 copy-back
   equal to round-to-nearest-even of the f32 result, ms a call and GB/s
   beside a CPU copy_ of the same bytes, the CPU model and thread count;
   at 4 layers, on the same bf16 weights and fixed batch, 3 steps each of
   the resident (ZeRO 2), tiered (offload_optimizer {device: cpu,
   pin_memory: true}) and legacy ({device: cpu}) engines: tiered equal to
   resident bit for bit (losses, params, master, moments: torch.equal),
   legacy within rtol 0.05, atol 1e-2; then Mistral-7B at 32 layers (the
   deepest depth the host's memory holds, never below 20), bf16, AdamW,
   micro 2 x gas 2 x S 2048, remat, through the legacy and the tiered
   engine, 3 steps each on one fixed batch: losses finite, the last below
   the first, flash launches 2 x L x gas and L x gas a step, peak device
   memory under 80 GiB (beside the resident state's 18 B a parameter);
   step time, tokens/s, and one more step's split (torch.profiler where it
   records the card; the engine's CUDA events: forward+backward, update,
   host optimizer, H2D and D2H on the copy streams); the NVMe tier at 2
   layers, 2 steps, losses equal to the RAM tier's (rtol 1e-5), swap bytes
   and seconds, the swap files removed; checkpoints at 2 layers, resident
   and tiered: save after 2 steps, load into an engine of other weights,
   its next loss equal to the saving engine's; save / load seconds and
   bytes; the v1 init_inference(checkpoint=) prefill logits torch.equal to
   init_inference(params=) on the same weights;
9. sparse op: SparseSelfAttention(layout (i))(q, k, v, causal=True) and
   backward on bf16 [1, 32, 8192, 128] inputs five times: 5 launches of
   each sparse kernel, finite outputs, o and grads against the plain
   versions, forward+backward ms, tokens/s, peak memory and the device
   time of the forward and the backward (CUDA events), the forward's
   time outside the sparse_fwd wrapper on the card's and the host's
   clock, and the host cost of the table look-up's layout key (the
   cached read-only layout, a writeable copy); an fp32 check of
   impl="kernel" against impl="dense" (S 1024, hd 64, 1e-4); block 8
   under impl="auto" on the card raises;
10. the card's name and power limit, the host_ops JSON line (the host
   optimizers' times, rates, yardstick and errors), the kernels JSON line
   (the flash launches of phases 8 and 8b together), then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Everything it builds goes under build/ of the checkout. It imports nothing
of JAX and nothing of the JAX package.
"""

import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12            # f32 outside the tensor cores
TOL = 1e-2

NH, KVH, HD, BS = 32, 8, 128, 64   # Mistral-7B attention geometry
HEAD_DIMS = (64, 128)              # head dims of the flash kernels
TRAIN_B, TRAIN_S = 2, 2048         # micro-batch rows x sequence (train)
FLASH_SRC = "deepspeed_tpu_torch/csrc/flash_attention.cu"
SPARSE_SRC = "deepspeed_tpu_torch/csrc/sparse_attention.cu"
SPARSE_S = 8192                    # sparse attention sequence (B 1)
QUANT_SRC = "deepspeed_tpu_torch/csrc/quantizer.cu"
WOQ_BLOCK = 2048                   # the WOQ quant block (quantize_params)


def log(msg):
    print(msg, flush=True)


def time_samples(fn, flush, reps=20, warmup=3):
    """CUDA-event times (ms) of `reps` calls, with the 50 MB L2 flushed
    before every launch (each layer of the serving path reads its own pool
    slice cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def time_ms(fn, flush, reps=20, warmup=3):
    """Median CUDA-event time of one call (time_samples)."""
    return statistics.median(time_samples(fn, flush, reps, warmup))


def time_turns(kern, lib, flush):
    """Kernel and library timed in turns in one call (kernel, library,
    kernel): the median of the kernel's 40 samples and of the library's
    20, so that clock or power drift shows on both alike."""
    first = time_samples(kern, flush)
    lib_t = time_samples(lib, flush)
    last = time_samples(kern, flush)
    return statistics.median(first + last), statistics.median(lib_t)


def bound(bytes_moved, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def device_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------
def make_pool(gen, n_pages, dev, kvh=KVH, hd=HD):
    shape = (n_pages, BS, kvh, hd)
    k = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    return k, v


def tables_for(rng, ctx_lens, n_pages, mb):
    """Distinct random pages per row (page 0 is the null block), null
    padded to width mb."""
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((len(ctx_lens), mb), np.int32)
    cur = 0
    for r, n in enumerate(ctx_lens):
        p = -(-n // BS)
        tables[r, :p] = perm[cur:cur + p]
        cur += p
    return tables


def library_attention(q_rows, k_cache, v_cache, tables, q_lens):
    """Yardstick only (never called by the port): gather each row's pages,
    then one scaled_dot_product_attention over [R, nh, Lq, hd] with a
    causal bound per query. q_rows [R, nh, Lq, hd]; q_lens [R, Lq]."""
    return sdpa_rows(q_rows, gather_rows(k_cache, tables),
                     gather_rows(v_cache, tables), q_lens)


def other_dtypes(name, kernel, plain, q, k_cache, v_cache, *int_args):
    """The other dtypes the kernels take (fp32 engines, fp16 pools), on the
    phase's inputs: fp32 within f32 reordering (2e-5), fp16 within TOL."""
    for dt, tol in ((torch.float32, 2e-5), (torch.float16, TOL)):
        args = (q.to(dt), k_cache.to(dt), v_cache.to(dt), *int_args)
        err = (kernel(*args).float() - plain(*args).float()).abs().max()
        err = err.item()
        log(f"{name} {dt}: max_abs_err={err:.3e} (tolerance {tol})")
        if not err <= tol:
            raise AssertionError(f"{name} {dt} disagrees with its plain "
                                 f"version: {err} > {tol}")


def kernel_phases(dev, flush):
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import (
        page_split_plan, paged_attention, paged_attention_plain)
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import (
        ragged_attention, ragged_attention_plain)

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    mb = 2048 // BS
    results = {}

    # -- paged decode: 8 rows, contexts over 1..2048 -----------------------
    dec_lens = [1, 63, 64, 65, 500, 1024, 1537, 2048]
    n_pages = 1 + sum(-(-n // BS) for n in dec_lens) + 64
    k_cache, v_cache = make_pool(gen, n_pages, dev)
    tables = torch.as_tensor(tables_for(rng, dec_lens, n_pages, mb),
                             device=dev)
    lengths = torch.as_tensor(dec_lens, dtype=torch.int32, device=dev)
    N = len(dec_lens)
    q = torch.randn((N, NH, HD), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    out = paged_attention(q, k_cache, v_cache, tables, lengths)
    ref = paged_attention_plain(q, k_cache, v_cache, tables, lengths)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    log(f"paged_attention: N={N} lengths={dec_lens} max_abs_err={err:.3e}")
    if not (err <= TOL and torch.isfinite(out).all()):
        raise AssertionError(f"paged_attention disagrees with its plain "
                             f"version: {err} > {TOL}")
    # unique bytes: the used K/V slots once per (row, kv head), q read and
    # out written once, the used table entries and the lengths
    kv_bytes = 2 * sum(dec_lens) * KVH * HD * 2
    used_pages = sum(-(-n // BS) for n in dec_lens)
    io_bytes = 2 * q.numel() * 2 + used_pages * 4 + N * 4
    b_ms, b_by = bound(kv_bytes + io_bytes, 4 * sum(dec_lens) * NH * HD)
    other_dtypes("paged_attention", paged_attention, paged_attention_plain,
                 q, k_cache, v_cache, tables, lengths)
    chunk_pages, n_split = page_split_plan(N, KVH, mb, BS)
    log(f"paged_attention plan (N {N}, kvh {KVH}, MB {mb}, bs {BS}): grid "
        f"({N * KVH}, {n_split}) = {N * KVH * n_split} blocks of "
        f"{chunk_pages}-page ({chunk_pages * BS}-slot) chunks")
    paged_resources()
    paged_edge_checks(dev, gen, rng)
    repeat_identical("paged_attention",
                     lambda: paged_attention(q, k_cache, v_cache, tables,
                                             lengths))
    q_lens = lengths[:, None]
    # the yardstick on pages gathered beforehand (not timed), as row 1q's
    kg = gather_rows(k_cache, tables).contiguous()
    vg = gather_rows(v_cache, tables).contiguous()
    ms, lib_ms = time_turns(
        lambda: paged_attention(q, k_cache, v_cache, tables, lengths),
        lambda: library_attention(q[:, :, None], k_cache, v_cache, tables,
                                  q_lens), flush)
    pre_ms = time_ms(lambda: sdpa_rows(q[:, :, None], kg, vg, q_lens), flush)
    log(f"paged_attention yardsticks: gather of the whole table + SDPA "
        f"{lib_ms:.4f} ms (library_ms, in turns with the kernel's "
        f"{ms:.4f}); SDPA on pages gathered beforehand {pre_ms:.4f} ms")
    del kg, vg
    results["paged_attention"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: paged_attention_plain(
            q, k_cache, v_cache, tables, lengths), flush, reps=5),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    # -- pure decode through the ragged kernel -----------------------------
    # its single-token runs are the paged kernel's split walk under the
    # decode plan for its N rows: the same bits
    rag_dec = ragged_attention(q, k_cache, v_cache,
                               torch.arange(N, dtype=torch.int32, device=dev),
                               lengths, tables)
    torch.cuda.synchronize()
    if not torch.equal(rag_dec, out):
        raise AssertionError("ragged_attention pure-decode batch is not "
                             "paged_attention bit for bit")
    log("ragged_attention pure-decode batch: torch.equal to paged_attention")
    ragged_resources()

    # -- ragged mixed batch ------------------------------------------------
    # row 0: 512-token prefill chunk (positions 0..511); row 1: a
    # 96-token continuation (positions 704..799); rows 2..7: decode rows
    rows_pos = [list(range(512)), list(range(704, 800))] + [
        [n - 1] for n in (1, 100, 640, 1000, 1536, 2048)]
    case = ragged_case(gen, rng, dev, list(enumerate(rows_pos)), T=1024)
    args, n_tok = case["args"], case["n_tok"]
    q, k_cache, v_cache, _, _, tables = args
    out = ragged_attention(*args)
    ref = ragged_attention_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    pad_zero = bool((out[n_tok:] == 0).all().item())
    T = q.shape[0]
    log(f"ragged_attention: T={T} ({n_tok} valid: 512 prefill + 96 "
        f"continuation + 6 decode) max_abs_err={err:.3e} "
        f"padding_exact_zero={pad_zero}")
    if not (err <= TOL and pad_zero and torch.isfinite(out).all()):
        raise AssertionError(f"ragged_attention disagrees with its plain "
                             f"version: err {err}, padding zero {pad_zero}")
    repeat_identical("ragged_attention", lambda: ragged_attention(*args))
    other_dtypes("ragged_attention", ragged_attention,
                 ragged_attention_plain, *args)
    b_ms, b_by = ragged_bound(case)
    qr, ql = ragged_rows(case)
    ms, lib_ms = time_turns(
        lambda: ragged_attention(*args),
        lambda: library_attention(qr, k_cache, v_cache, tables, ql), flush)
    results["ragged_attention"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: ragged_attention_plain(*args), flush,
                         reps=5),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    _, _, kern = profiled(lambda: [ragged_attention(*args)
                                   for _ in range(5)])
    log_ragged_kernels("ragged_attention table shape, per call", kern, 5)
    log(f"ragged_attention table shape: {ms:.4f} ms, in turns with the "
        f"gather + SDPA's {lib_ms:.4f}")
    ragged_edge_checks(dev, gen, rng)
    results.update(quant_kernel_phases(dev, flush, rng, gen, rows_pos))
    ragged_put_phase(dev, flush, gen, rng)
    paged_plan_sweep(dev, flush, gen, rng)
    results.update(dense_decode_phases(dev, flush, gen))
    for name, r in results.items():
        log(f"{name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) max_abs_err={r['max_abs_err']:.3e}")
    return results


# ---------------------------------------------------------------------------
# ragged attention: inputs, bound, resources, edge cases, the put() shape
# ---------------------------------------------------------------------------
def ragged_case(gen, rng, dev, runs, T=None, nh=NH, kvh=KVH, hd=HD, bs=BS,
                q8=False):
    """A ragged buffer from `runs` in buffer order: (row, positions) for a
    run of that row's tokens (a row may have several), (None, n) for n
    padding tokens (row 0, length 0); padded with padding to T. Random
    bf16 q and pool (or an int8 pool with scales), each row's pages
    distinct and random, tables null padded to the widest row's pages."""
    ctx = {}
    for r, pos in runs:
        if r is not None:
            ctx[r] = max(ctx.get(r, 0), max(pos) + 1)
    R = max(ctx) + 1
    pages = [-(-ctx.get(r, 1) // bs) for r in range(R)]
    mb = max(pages)
    n_pages = 1 + sum(pages) + 4
    shape = (n_pages, bs, kvh, hd)
    if q8:
        pool = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2)]
        scales = [(0.5 + torch.rand((n_pages, kvh), generator=gen,
                                    device=dev)) / 127.0 for _ in range(2)]
    else:
        pool = [torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2)]
        scales = []
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((R, mb), np.int32)
    cur = 0
    for r in range(R):
        tables[r, :pages[r]] = perm[cur:cur + pages[r]]
        cur += pages[r]
    row_ids, lens = [], []
    for r, pos in runs:
        if r is None:
            row_ids += [0] * pos
            lens += [0] * pos
        else:
            row_ids += [r] * len(pos)
            lens += [p + 1 for p in pos]
    n_tok = len(row_ids)
    T = T or n_tok
    row_ids += [0] * (T - n_tok)
    lens += [0] * (T - n_tok)
    q = torch.randn((T, nh, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    args = (q, *pool, as_t(row_ids), as_t(lens), as_t(tables), *scales)
    return dict(args=args, n_tok=n_tok, runs=runs, ctx=ctx, bs=bs,
                pad=as_t(lens) == 0)


def ragged_rows(case):
    """The library yardstick's input: each row's queries [R, nh, Lq, hd]
    (zeros past its tokens) and their causal bounds [R, Lq]."""
    q, row_ids, lens = case["args"][0], case["args"][3], case["args"][4]
    R = len(case["ctx"])
    per_row = [(row_ids == r) & (lens > 0) for r in range(R)]
    Lq = max(int(m.sum()) for m in per_row)
    qr = torch.zeros((R, q.shape[1], Lq, q.shape[2]), device=q.device,
                     dtype=q.dtype)
    ql = torch.zeros((R, Lq), device=q.device, dtype=torch.int32)
    for r, m in enumerate(per_row):
        n = int(m.sum())
        qr[r, :, :n] = q[m].transpose(0, 1)
        ql[r, :n] = lens[m]
    return qr, ql


def ragged_bound(case):
    """The least time of a ragged call: bytes (q read and out written for
    the valid tokens, out for the padding, each row's used K/V slots once
    per kv head, with one f32 scale per used page and head for int8; the
    used table entries, row ids and lengths) over 3.35 TB/s, or the
    4 * nh * hd flops of each (token, attended slot) at 989 TFLOP/s."""
    args, n_tok = case["args"], case["n_tok"]
    q, kc, lens = args[0], args[1], args[4]
    T, nh, hd = q.shape
    kvh, bs = kc.shape[2], case["bs"]
    ctx = sum(case["ctx"].values())
    used_pages = sum(-(-c // bs) for c in case["ctx"].values())
    kv_bytes = 2 * ctx * kvh * hd * kc.element_size()
    if kc.dtype == torch.int8:
        kv_bytes += 2 * used_pages * kvh * 4
    io_bytes = ((n_tok + T) * nh * hd * q.element_size() + used_pages * 4
                + 2 * T * 4)
    return bound(kv_bytes + io_bytes,
                 4 * int(lens.long().sum().item()) * nh * hd)


def ragged_resources():
    """Registers, spilled bytes, dynamic shared memory and blocks per SM of
    the tile kernel for each io dtype, head_dim and pool
    (ds_ragged_tiles_info); a spill or a kernel that cannot launch fails."""
    import ctypes

    from deepspeed_tpu_torch.ops.op_builder import cuda as cuda_build

    lib = cuda_build.load("ragged_attention")
    for q8 in (0, 1):
        for dt, code in (("bf16", 2), ("fp16", 1)):
            for hd in HEAD_DIMS:
                out = (ctypes.c_int * 4)()
                cuda_build.check(lib.ds_ragged_tiles_info(
                    code, hd, q8, ctypes.addressof(out)),
                    "ds_ragged_tiles_info")
                regs, spill, smem, blocks = out
                log(f"  ragged tiles{'_q8' if q8 else ''} {dt} hd {hd}: "
                    f"{regs} registers, {spill} bytes spilled, {smem} bytes "
                    f"of dynamic shared memory, 384 threads: {blocks} "
                    f"block(s) per SM")
                if spill or blocks < 1:
                    raise AssertionError(f"ragged tiles {dt} hd {hd} q8={q8}"
                                         f": {spill} bytes spilled, {blocks} "
                                         f"blocks per SM")
    paged_resources(rows=1)


def ragged_edge_checks(dev, gen, rng):
    """Both pools through the ragged kernels on a buffer that holds every
    kind of token the descriptor allows: a 100-token run across a 64-token
    window, a 3-token continuation, a decode row, padding in the middle,
    the first row's second run behind other rows, a run with descending
    lengths, a one-token continuation, a 64-token run; within TOL of the
    plain version (f32 within 2e-5), padding exactly 0, at bf16, fp16,
    head_dim 64 with group 1, page sizes 16 (group 2), 24 (three 8-slot
    boxes a page, a 64-slot kv tile across pages) and 128, the int8 pool
    at bs 64, at bs 16 / hd 64 and at bs 24, and f32 (the page walk); then
    a mixed buffer with more single-token runs than table rows (both
    single-token plans in one call, and grid y-blocks past a row's last
    chunk), bf16 and int8."""
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import (
        ragged_attention, ragged_attention_plain, ragged_route)

    runs = [(0, list(range(100))), (1, list(range(500, 503))), (2, [77]),
            (None, 5), (0, list(range(100, 130))),
            (3, list(range(49, 39, -1))), (4, [200]), (5, list(range(64)))]
    for name, kw, dt, tol in (
            ("bf16", {}, torch.bfloat16, TOL),
            ("fp16", {}, torch.float16, TOL),
            ("f32", {}, torch.float32, 2e-5),
            ("hd 64 group 1", dict(nh=8, kvh=8, hd=64), torch.bfloat16, TOL),
            ("bs 16 group 2", dict(nh=16, bs=16), torch.bfloat16, TOL),
            ("bs 24", dict(bs=24), torch.bfloat16, TOL),
            ("bs 128", dict(bs=128), torch.bfloat16, TOL),
            ("int8", dict(q8=True), torch.bfloat16, TOL),
            ("int8 bs 16 hd 64", dict(q8=True, bs=16, nh=8, kvh=2, hd=64),
             torch.bfloat16, TOL),
            ("int8 bs 24", dict(q8=True, bs=24), torch.bfloat16, TOL)):
        case = ragged_case(gen, rng, dev, runs, T=320, **kw)
        q, k, v = case["args"][:3]
        q8 = k.dtype == torch.int8
        args = (q.to(dt), k if q8 else k.to(dt), v if q8 else v.to(dt),
                *case["args"][3:])
        out = ragged_attention(*args)
        check_close(f"ragged_attention edges {name} ({dt}, route "
                    f"{ragged_route(args[0], args[1])})", out,
                    ragged_attention_plain(*args), tol)
        if not bool((out[case["pad"]] == 0).all()):
            raise AssertionError(f"ragged_attention edges {name}: a padding "
                                 f"token's output is not exactly zero")
    # more single-token runs than table rows in a mixed batch: rows 0 and 1
    # alternate one token at a time; the first R take the rows' plan, the
    # rest the plan for T
    runs = [(r % 2, [300 + 200 * (r % 2) + r // 2]) for r in range(6)] + [
        (2, list(range(40)))]
    for name, kw in (("bf16", {}), ("int8", dict(q8=True))):
        args = ragged_case(gen, rng, dev, runs, T=64, **kw)["args"]
        check_close(f"ragged_attention interleaved single-token runs "
                    f"{name}", ragged_attention(*args),
                    ragged_attention_plain(*args), TOL)


def ragged_put_phase(dev, flush, gen, rng):
    """Rows 3 and 3q at the put() shape: 8 rows of 128, 256, ..., 1024
    tokens from position 0 (T 4608, the serve phase's prompts), bf16 and
    int8 pools: within TOL of the plain version, then timed on the card
    in turns with the library yardstick (the gather + SDPA for bf16, SDPA
    on pages dequantized and gathered beforehand for int8), bound from
    bytes and operations, and the plain version's time."""
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import (
        ragged_attention, ragged_attention_plain)

    runs = [(r, list(range(128 * (r + 1)))) for r in range(8)]
    for q8 in (False, True):
        case = ragged_case(gen, rng, dev, runs, q8=q8)
        args = case["args"]
        name = "ragged_attention_q8" if q8 else "ragged_attention"
        out = ragged_attention(*args)
        err = check_close(f"{name} put() shape (T {args[0].shape[0]})", out,
                          ragged_attention_plain(*args), TOL)
        qr, ql = ragged_rows(case)
        k, v, tables = args[1], args[2], args[5]
        if q8:
            kd, vd = (dequant_gather(k, args[6], tables),
                      dequant_gather(v, args[7], tables))
            lib = lambda: sdpa_rows(qr, kd, vd, ql)
        else:
            lib = lambda: library_attention(qr, k, v, tables, ql)
        ms, lib_ms = time_turns(lambda: ragged_attention(*args), lib, flush)
        b_ms, b_by = ragged_bound(case)
        _, _, kern = profiled(lambda: [ragged_attention(*args)
                                       for _ in range(5)])
        log_ragged_kernels(f"{name} put() shape, per call", kern, 5)
        plain_ms = time_ms(lambda: ragged_attention_plain(*args), flush,
                           reps=3)
        log(f"{name} put() shape: kernel_ms={ms:.4f} library_ms="
            f"{lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) plain_ms="
            f"{plain_ms:.4f} max_abs_err={err:.3e}")
        del lib
    # what bf16's three P operands cost: fp16 takes one, on the same
    # shapes, in turns with bf16
    args = ragged_case(gen, rng, dev, runs)["args"]
    a16 = (args[0].half(), args[1].half(), args[2].half(), *args[3:])
    bf_ms, f16_ms = time_turns(lambda: ragged_attention(*args),
                               lambda: ragged_attention(*a16), flush)
    log(f"ragged_attention put() shape, tiles' P.V: bf16 (three P operands) "
        f"{bf_ms:.4f} ms, fp16 (one) {f16_ms:.4f} ms, in turns")


def check_close(name, out, ref, tol):
    err = (out.float() - ref.float()).abs().max().item()
    log(f"{name}: max_abs_err={err:.3e} (tolerance {tol})")
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{err} > {tol}")
    return err


def repeat_identical(name, fn):
    """Two calls on the same inputs give the same bits (the split kernels
    combine their partials in split order)."""
    runs = [fn() for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(*runs):
        raise AssertionError(f"a repeated {name} is not bit-identical")
    log(f"{name} repeated: bit-identical")


def gather_rows(cache, tables):
    """[R, kvh, MB * bs, hd] pages of ``tables`` as stored (a view of the
    gathered [R, MB * bs, kvh, hd])."""
    R, mb = tables.shape
    _, bs, kvh, hd = cache.shape
    return cache[tables.long()].reshape(R, mb * bs, kvh, hd).transpose(1, 2)


def paged_resources(rows=0):
    """Registers, spilled bytes, dynamic shared memory, stage size, route
    and blocks per SM of the paged decode kernel that a call at Mistral-7B
    geometry launches, for each io dtype and pool (ds_paged_decode_info:
    cudaFuncGetAttributes and the occupancy API); rows=1: the ragged
    batch's single-token walk (ragged_singleton_kernel), which must not
    spill."""
    import ctypes

    from deepspeed_tpu_torch.ops.op_builder import cuda as cuda_build

    lib = cuda_build.load("paged_attention")
    name = "ragged singletons" if rows else "paged_attention"
    for q8 in (0, 1):
        for dt, code in (("bf16", 2), ("fp16", 1), ("fp32", 0)):
            out = (ctypes.c_int * 6)()
            cuda_build.check(lib.ds_paged_decode_info(
                NH, KVH, HD, BS, code, q8, rows, ctypes.addressof(out)),
                "ds_paged_decode_info")
            smem, tile, lanes, blocks, regs, spill = out
            log(f"  {name}{'_q8' if q8 else ''} {dt} (nh {NH}, kvh "
                f"{KVH}, hd {HD}, bs {BS}): {regs} registers, {spill} bytes "
                f"spilled, {smem} bytes of dynamic shared memory, "
                f"{tile}-slot stages, {'lane' if lanes else 'generic'} "
                f"route, 160 threads: {blocks} block(s) per SM")
            if blocks < 1 or (rows and spill):
                raise AssertionError(f"{name} {dt} q8={q8}: {blocks} blocks "
                                     f"per SM, {spill} bytes spilled")


def paged_edge_checks(dev, gen, rng):
    """Both paged decode entry points on a 32-page table at edge lengths
    (0, 1, 63, 64, 65, one chunk - 1, one chunk, one chunk + 1, 2047,
    2048; the chunk of page_split_plan for these 10 rows) at Mistral-7B
    geometry and at nh 12, kvh 4, hd 96 (the kernel's generic route): q
    and a pool in bf16 / fp32 / fp16, and an int8 pool with scales under
    each q dtype, within the phase's tolerances of the plain version; a
    length-0 row exactly zeros."""
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import (
        page_split_plan, paged_attention, paged_attention_plain)

    mb, N = 2048 // BS, 10
    chunk = page_split_plan(N, KVH, mb, BS)[0] * BS
    lens = [0, 1, 63, 64, 65, chunk - 1, chunk, chunk + 1, 2047, 2048]
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    for nh, kvh, hd in ((NH, KVH, HD), (12, 4, 96)):
        n_pages = 1 + sum(-(-n // BS) for n in lens) + 8
        kb, vb = make_pool(gen, n_pages, dev, kvh, hd)
        k8, v8, ks, vs = make_q8_pool(gen, n_pages, dev, kvh, hd)
        tables = torch.as_tensor(tables_for(rng, lens, n_pages, mb),
                                 device=dev)
        q = torch.randn((N, nh, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        chunk_pages, n_split = page_split_plan(N, kvh, mb, BS)
        log(f"paged_attention edges (nh {nh}, kvh {kvh}, hd {hd}) lengths "
            f"{lens}: grid ({N * kvh}, {n_split}) of {chunk_pages}-page "
            f"chunks")
        for dt, tol in ((torch.bfloat16, TOL), (torch.float32, 2e-5),
                        (torch.float16, TOL)):
            for pool, args in (
                    ("pool", (q.to(dt), kb.to(dt), vb.to(dt), tables,
                              lengths)),
                    ("int8 pool", (q.to(dt), k8, v8, tables, lengths, ks,
                                   vs))):
                o = paged_attention(*args)
                check_close(f"paged_attention {pool} (nh {nh}, hd {hd}) "
                            f"edges {dt}", o, paged_attention_plain(*args),
                            tol)
                if not bool((o[lengths == 0] == 0).all()):
                    raise AssertionError("paged_attention: a row of length "
                                         "0 is not zeros")


def paged_plan_sweep(dev, flush, gen, rng):
    """The paged kernels under two targets of page_split_plan
    (PAGE_BLOCKS_PER_2SM 5: the dense plan's ~2.5 blocks per SM; the
    shipped 10: ~5), timed in turns (5, shipped, shipped, 5; CUDA events,
    L2 flushed, medians) at the table shape, at the serve phase's decode
    shape (8 rows of 193 to 1089 slots in a 32-page table) and on full
    tables (8 x 2048), bf16 and int8 pools."""
    from deepspeed_tpu_torch.inference.v2.kernels import paged_attention as pa

    mb = 2048 // BS
    shipped = pa.PAGE_BLOCKS_PER_2SM
    for name, lens in (("table", [1, 63, 64, 65, 500, 1024, 1537, 2048]),
                       ("serve decode", [193 + 128 * i for i in range(8)]),
                       ("full tables", [2048] * 8)):
        n_pages = 1 + sum(-(-n // BS) for n in lens) + 8
        k, v = make_pool(gen, n_pages, dev)
        kq, vq, ks, vs = make_q8_pool(gen, n_pages, dev)
        tables = torch.as_tensor(tables_for(rng, lens, n_pages, mb),
                                 device=dev)
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((len(lens), NH, HD), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        times = {5: [], shipped: []}
        try:
            for target in (5, shipped, shipped, 5):
                pa.PAGE_BLOCKS_PER_2SM = target
                times[target].append((
                    time_ms(lambda: pa.paged_attention(q, k, v, tables,
                                                       lengths), flush),
                    time_ms(lambda: pa.paged_attention(q, kq, vq, tables,
                                                       lengths, ks, vs),
                            flush)))
        finally:
            pa.PAGE_BLOCKS_PER_2SM = shipped
        plan = pa.page_split_plan(len(lens), KVH, mb, BS)
        for target, ts in times.items():
            tag = f" (shipped: plan {plan})" if target == shipped else ""
            log(f"paged plan sweep {name} lengths {lens}: target {target} "
                f"blocks per 2 SMs{tag}: bf16 "
                f"{statistics.median(t for t, _ in ts):.4f} ms, int8 "
                f"{statistics.median(t for _, t in ts):.4f} ms")


def make_q8_pool(gen, n_pages, dev, kvh=KVH, hd=HD):
    """Random int8 K/V pool with random per-(block, head) f32 scales of
    absmax / 127 for an absmax in [0.5, 1.5): dequantized values of
    magnitude ~1, as written by _kv_write."""
    shape = (n_pages, BS, kvh, hd)
    pool = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2)]
    scales = [(0.5 + torch.rand((n_pages, kvh), generator=gen, device=dev))
              / 127.0 for _ in range(2)]
    return pool + scales


def dequant_gather(pool, scale, tables):
    """[R, KVH, MB * BS, HD] bf16 pages of ``tables``, dequantized as the
    kernels do (the library yardstick's input; not timed)."""
    R, mb = tables.shape
    pages = (pool[tables.long()].float()
             * scale[tables.long()][:, :, None, :, None]).to(torch.bfloat16)
    return pages.reshape(R, mb * BS, KVH, HD).transpose(1, 2).contiguous()


def sdpa_rows(q_rows, k, v, q_lens):
    """Library yardstick on gathered context: q_rows [R, nh, Lq, hd], k/v
    [R, kvh, ctx, hd], a causal bound per query q_lens [R, Lq]."""
    ctx = k.shape[2]
    mask = (torch.arange(ctx, device=q_rows.device)[None, None, None, :]
            < q_lens[:, None, :, None])
    return torch.nn.functional.scaled_dot_product_attention(
        q_rows, k, v, attn_mask=mask, enable_gqa=True)


def quant_kernel_phases(dev, flush, rng, gen, rows_pos):
    """The int8 kv_quant pool through paged decode and a mixed ragged batch
    (the bf16 phases' lengths and rows), q in bf16 / fp32 / fp16."""
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import (
        paged_attention, paged_attention_plain)
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import (
        ragged_attention, ragged_attention_plain)

    mb = 2048 // BS
    results = {}
    tols = ((torch.bfloat16, TOL), (torch.float32, 2e-5),
            (torch.float16, TOL))

    # -- int8 paged decode ---------------------------------------------------
    dec_lens = [1, 63, 64, 65, 500, 1024, 1537, 2048]
    n_pages = 1 + sum(-(-n // BS) for n in dec_lens) + 64
    kq, vq, ks, vs = make_q8_pool(gen, n_pages, dev)
    tables = torch.as_tensor(tables_for(rng, dec_lens, n_pages, mb),
                             device=dev)
    lengths = torch.as_tensor(dec_lens, dtype=torch.int32, device=dev)
    N = len(dec_lens)
    q = torch.randn((N, NH, HD), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    pool = (kq, vq, tables, lengths, ks, vs)
    for dt, tol in tols:
        out = paged_attention(q.to(dt), *pool)
        e = check_close(f"paged_attention_q8 {dt}", out,
                        paged_attention_plain(q.to(dt), *pool), tol)
        if dt == torch.bfloat16:
            err, out_bf16 = e, out
    rag_dec = ragged_attention(q, kq, vq,
                               torch.arange(N, dtype=torch.int32, device=dev),
                               lengths, tables, ks, vs)
    torch.cuda.synchronize()
    if not torch.equal(rag_dec, out_bf16):
        raise AssertionError("ragged_attention_q8 pure-decode batch is not "
                             "paged_attention_q8 bit for bit")
    log("ragged_attention_q8 pure-decode batch: torch.equal to "
        "paged_attention_q8")
    repeat_identical("paged_attention_q8", lambda: paged_attention(q, *pool))
    # unique bytes: the used int8 K/V slots once per (row, kv head), one f32
    # K and V scale per used page and head, q read and out written once,
    # the used table entries and the lengths
    used_pages = sum(-(-n // BS) for n in dec_lens)
    kv_bytes = 2 * sum(dec_lens) * KVH * HD + 2 * used_pages * KVH * 4
    io_bytes = 2 * q.numel() * 2 + used_pages * 4 + N * 4
    b_ms, b_by = bound(kv_bytes + io_bytes, 4 * sum(dec_lens) * NH * HD)
    kd, vd = dequant_gather(kq, ks, tables), dequant_gather(vq, vs, tables)
    ms, lib_ms = time_turns(
        lambda: paged_attention(q, *pool),
        lambda: sdpa_rows(q[:, :, None], kd, vd, lengths[:, None]), flush)
    results["paged_attention_q8"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: paged_attention_plain(q, *pool), flush,
                         reps=5),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    del kd, vd

    # -- int8 ragged mixed batch --------------------------------------------
    case = ragged_case(gen, rng, dev, list(enumerate(rows_pos)), T=1024,
                       q8=True)
    q, kq, vq, _, _, tables, ks, vs = case["args"]
    pool = case["args"][1:]
    for dt, tol in tols:
        out = ragged_attention(q.to(dt), *pool)
        e = check_close(f"ragged_attention_q8 {dt}", out,
                        ragged_attention_plain(q.to(dt), *pool), tol)
        if not bool((out[case["pad"]] == 0).all().item()):
            raise AssertionError("ragged_attention_q8: a padding token's "
                                 "output is not exactly zero")
        if dt == torch.bfloat16:
            err = e
    repeat_identical("ragged_attention_q8",
                     lambda: ragged_attention(q, *pool))
    b_ms, b_by = ragged_bound(case)
    qr, ql = ragged_rows(case)
    kd, vd = dequant_gather(kq, ks, tables), dequant_gather(vq, vs, tables)
    ms, lib_ms = time_turns(lambda: ragged_attention(q, *pool),
                            lambda: sdpa_rows(qr, kd, vd, ql), flush)
    _, _, kern = profiled(lambda: [ragged_attention(q, *pool)
                                   for _ in range(5)])
    log_ragged_kernels("ragged_attention_q8 table shape, per call", kern, 5)
    results["ragged_attention_q8"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: ragged_attention_plain(q, *pool), flush,
                         reps=5),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    log("q8 library_ms: scaled_dot_product_attention on the dequantized "
        "gathered pages; the gather and dequantization are not timed")
    return results


def dense_decode_phases(dev, flush, gen):
    """The v1 engine's dense-cache decode (a split-K walk, split_plan) at
    B 8: M 2048 (row lengths 1536 and 2048), M 1000 (993 and 1000), and
    edge lengths at M 2048, 1000 and 576 (0, 1, one chunk - 1, one chunk,
    one chunk + 1, two chunks + 1, M - 1, M), also at nh 12, kvh 4, hd 96
    (the kernel's generic route), q and cache in bf16 / fp32 / fp16; a
    repeated call bit-identical; the kernel and its yardstick timed in
    turns at M 2048 and at the v1 serve shape (M 576, lengths 544)."""
    from deepspeed_tpu_torch.ops.decode_attention import (
        dense_decode_attention, dense_decode_attention_plain, split_plan)

    B = 8

    def edges(M):
        chunk = split_plan(B, KVH, M)[0]
        return [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, M - 1, M]

    def inputs(M, lens, nh=NH, kvh=KVH, hd=HD):
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, nh, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        kc = torch.randn((B, kvh, M, hd), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        vc = torch.randn((B, kvh, M, hd), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        return q, kc, vc, lengths

    errs = []
    # (M, lengths, (nh, kvh, hd)); the last case takes the kernel's generic
    # route (a group of 3, rows of 12 / 24 16-byte vectors)
    cases = [(1000, [993, 1000] * (B // 2), ()),
             (2048, [1536, 2048] * (B // 2), ()), (2048, edges(2048), ()),
             (1000, edges(1000), ()), (576, edges(576), ()),
             (1000, edges(1000), (12, 4, 96))]
    for M, lens, shape in cases:
        q, kc, vc, lengths = inputs(M, lens, *shape)
        kvh = kc.shape[1]
        chunk, n_split = split_plan(B, kvh, M)
        name = f"dense_decode_attention {tuple(q.shape)} M={M}"
        log(f"{name}: grid ({B * kvh}, {n_split}) = {B * kvh * n_split} "
            f"blocks of {chunk}-slot chunks")
        for dt, tol in ((torch.bfloat16, TOL), (torch.float32, 2e-5),
                        (torch.float16, TOL)):
            args = (q.to(dt), kc.to(dt), vc.to(dt), lengths)
            o = dense_decode_attention(*args)
            e = check_close(f"{name} lengths {lens} {dt}", o,
                            dense_decode_attention_plain(*args), tol)
            if not bool((o[lengths == 0] == 0).all()):
                raise AssertionError("dense_decode_attention: a row of "
                                     "length 0 is not zeros")
            if dt == torch.bfloat16:
                errs.append(e)
    # a repeated call is bit-identical (the combine runs in split order)
    q, kc, vc, lengths = inputs(2048, [1536, 2048] * (B // 2))
    repeat_identical("dense_decode_attention",
                     lambda: dense_decode_attention(q, kc, vc, lengths))

    def timed(q, kc, vc, lengths):
        """kernel and yardstick in turns, the bound: the used K/V rows
        once per (row, kv head), q read and out written once, lengths."""
        total = int(lengths.sum())
        b_ms, b_by = bound(2 * total * KVH * HD * 2 + 2 * q.numel() * 2
                           + B * 4, 4 * total * NH * HD)
        lmax = int(lengths.max())
        ql = lengths[:, None]
        ms, lib_ms = time_turns(
            lambda: dense_decode_attention(q, kc, vc, lengths),
            lambda: sdpa_rows(q[:, :, None], kc[:, :, :lmax],
                              vc[:, :, :lmax], ql), flush)
        return ms, lib_ms, b_ms, b_by

    ms, lib_ms, b_ms, b_by = timed(q, kc, vc, lengths)
    res = dict(max_abs_err=max(errs), ms=ms,
               plain_ms=time_ms(lambda: dense_decode_attention_plain(
                   q, kc, vc, lengths), flush, reps=5),
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"dense_decode_attention B 8 M 2048: kernel_ms={ms:.4f} "
        f"library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
        f"plain_ms={res['plain_ms']:.4f}")
    ms, lib_ms, b_ms, b_by = timed(*inputs(576, [544] * B))
    log(f"dense_decode_attention v1 serve shape B 8 M 576 lengths 544: "
        f"kernel_ms={ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} "
        f"({b_by})")
    log("dense_decode_attention library_ms: scaled_dot_product_attention "
        "over cache[:, :, :max length] with a per-row length mask; kernel "
        "and library timed in turns (kernel, library, kernel), medians")
    return {"dense_decode_attention": res}


# ---------------------------------------------------------------------------
# small fp32 reference check
# ---------------------------------------------------------------------------
def small_fp32_check(dev):
    import dataclasses

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerLM, tiny_test

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = TransformerLM(dataclasses.replace(tiny_test(), num_kv_heads=2))

    def engine(use_kernel, params=None):
        return InferenceEngineV2(model, RaggedInferenceEngineConfig.from_dict(
            {"dtype": "float32", "prefill_bucket": 16, "decode_window": 8,
             "use_paged_kernel": use_kernel,
             "state_manager": {"max_tracked_sequences": 8, "max_seq_len": 128,
                               "num_blocks": 65, "block_size": 16}}),
            params=params, device=dev)

    kern = engine(True)
    plain = engine(False, params=kern.params)
    prompts = [list(range(3, 17)), [2, 4, 6], list(range(40, 62))]
    a = kern.put([1, 2, 3], prompts)
    b = plain.put([1, 2, 3], prompts)
    for e in (kern, plain):
        for u in (1, 2, 3):
            e.flush(u)
    gap = float(np.abs(a - b).max())
    ga = kern.generate(prompts, max_new_tokens=20)
    gb = plain.generate(prompts, max_new_tokens=20)
    same = all(np.array_equal(x, y) for x, y in zip(ga, gb))
    log(f"small fp32 check: put logits max|kernel - plain|={gap:.3e} "
        f"generate streams equal={same}")
    if not (gap <= 1e-4 and same):
        raise AssertionError("fp32 kernel engine disagrees with the plain "
                             "engine on the tiny model")

    # the int8 kv_quant pool: kernel engine against plain engine
    def q8_engine(use_kernel, params=None):
        return InferenceEngineV2(model, RaggedInferenceEngineConfig.from_dict(
            {"dtype": "float32", "prefill_bucket": 16, "decode_window": 8,
             "use_paged_kernel": use_kernel, "kv_quant": True,
             "state_manager": {"max_tracked_sequences": 8, "max_seq_len": 128,
                               "num_blocks": 65, "block_size": 16}}),
            params=params, device=dev)

    kern = q8_engine(True, params=kern.params)
    plain = q8_engine(False, params=kern.params)
    a = kern.put([1, 2, 3], prompts)
    b = plain.put([1, 2, 3], prompts)
    gap = float(np.abs(a - b).max())
    a2 = kern.put([1, 2, 3], [[7], [8], [9]])       # decode rows over int8
    b2 = plain.put([1, 2, 3], [[7], [8], [9]])
    gap = max(gap, float(np.abs(a2 - b2).max()))
    for e in (kern, plain):
        for u in (1, 2, 3):
            e.flush(u)
    ga = kern.generate(prompts, max_new_tokens=20)
    gb = plain.generate(prompts, max_new_tokens=20)
    same = all(np.array_equal(x, y) for x, y in zip(ga, gb))
    log(f"small fp32 check, kv_quant: put logits max|kernel - plain|="
        f"{gap:.3e} generate streams equal={same}")
    if not (gap <= 1e-4 and same):
        raise AssertionError("fp32 kv_quant kernel engine disagrees with the "
                             "kv_quant plain engine on the tiny model")

    # the v1 engine: dense decode kernel against the decode_kernel=False
    # einsum route
    import deepspeed_tpu_torch

    params = kern.params
    v1 = {dk: deepspeed_tpu_torch.init_inference(
        TransformerLM(dataclasses.replace(model.cfg, decode_kernel=dk)),
        config={"dtype": "fp32"}, params=params, device=dev)
        for dk in (True, False)}
    ids = torch.as_tensor(np.array([p[:3] for p in prompts]), device=dev)
    step_logits = {}
    for dk, e in v1.items():
        cache = e.model.init_kv_cache(3, 8, torch.float32, dev)
        with torch.no_grad():
            e.model.forward_cached(e.params, ids, cache, 0)
            step_logits[dk] = e.model.forward_cached(
                e.params, ids[:, -1:], cache, 3)
    gap = (step_logits[True] - step_logits[False]).abs().max().item()
    v1_prompts = np.array([p[:3] for p in prompts])
    ga = v1[True].generate(v1_prompts, max_new_tokens=20)
    gb = v1[False].generate(v1_prompts, max_new_tokens=20)
    same = np.array_equal(ga, gb)
    log(f"small fp32 check, v1: decode logits max|kernel - einsum|="
        f"{gap:.3e} generate streams equal={same}")
    if not (gap <= 1e-4 and same):
        raise AssertionError("fp32 v1 engine with the dense decode kernel "
                             "disagrees with the einsum route")


def small_woq_check(dev):
    """Weight-only quantization on the tiny fp32 model: a WOQ engine
    (bits 8 and 4) against a dense engine built from its own dequantized
    weights, for the v2 and the v1 engine: logits within 1e-4, generate()
    streams equal (the kernels dequantize exactly what the dense engine
    holds)."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.quantization import dequantize_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerLM, tiny_test

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = TransformerLM(dataclasses.replace(tiny_test(), num_kv_heads=2))

    def engine(bits, params):
        return InferenceEngineV2(model, RaggedInferenceEngineConfig.from_dict(
            {"dtype": "float32", "prefill_bucket": 16, "decode_window": 8,
             "quant_bits": bits,
             "state_manager": {"max_tracked_sequences": 8, "max_seq_len": 128,
                               "num_blocks": 65, "block_size": 16}}),
            params=params, device=dev)

    params = engine(0, None).params
    prompts = [list(range(3, 17)), [2, 4, 6], list(range(40, 62))]
    ids = np.array([p[:3] for p in prompts])
    for bits in (8, 4):
        woq = engine(bits, params)
        dense = engine(0, dequantize_params(woq.params))
        gap = float(np.abs(woq.put([1, 2, 3], prompts)
                           - dense.put([1, 2, 3], prompts)).max())
        for e in (woq, dense):
            for u in (1, 2, 3):
                e.flush(u)
        same = all(np.array_equal(x, y) for x, y in zip(
            woq.generate(prompts, max_new_tokens=20),
            dense.generate(prompts, max_new_tokens=20)))
        v1 = deepspeed_tpu_torch.init_inference(
            model, config={"dtype": "fp32", "quant_bits": bits},
            params=params, device=dev)
        v1d = deepspeed_tpu_torch.init_inference(
            model, config={"dtype": "fp32"},
            params=dequantize_params(v1.params), device=dev)
        v1_gap = (v1.forward(ids) - v1d.forward(ids)).abs().max().item()
        v1_same = np.array_equal(v1.generate(ids, max_new_tokens=20),
                                 v1d.generate(ids, max_new_tokens=20))
        log(f"small fp32 check, quant_bits {bits}: v2 put logits max|woq - "
            f"dense| {gap:.3e}, streams equal {same}; v1 forward logits "
            f"{v1_gap:.3e}, streams equal {v1_same}")
        if not (gap <= 1e-4 and same and v1_gap <= 1e-4 and v1_same):
            raise AssertionError(f"fp32 WOQ engines (bits {bits}) disagree "
                                 f"with the dense engines of their weights")


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------
def serve_phase(dev):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import \
        ragged_attention
    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b

    cfg = mistral_7b()
    L = cfg.num_layers
    t0 = time.perf_counter()
    pipe = deepspeed_tpu_torch.pipeline(
        cfg, device=dev,
        config={"dtype": "bfloat16",
                "ragged": {"seed": 0, "decode_window": 8,
                           "state_manager": {"max_ragged_batch_size": 8192}}})
    eng = pipe.engine
    torch.cuda.synchronize()
    log(f"serve: mistral_7b L={L} hidden={cfg.hidden_size} "
        f"heads={cfg.num_heads}/{cfg.kv_heads} bf16 seeded weights on "
        f"{dev} in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (128, 256, 384, 512, 640, 768, 896, 1024)]
    new = 64

    # warm-up: builds the kernels (if the kernel phases did not) and the
    # cuBLAS handles outside the timed main path
    pipe([prompts[0][:64]], max_new_tokens=4)

    before = dict(ragged=eng.ragged_steps, decode=eng.decode_steps,
                  syncs=eng.host_syncs, windows=eng.decode_windows)
    paged_attention.launches = 0
    ragged_attention.launches = 0
    # -- the main path: pipeline() then generate() ------------------------
    t0 = time.perf_counter()
    outs = pipe(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(paged_attention=paged_attention.launches,
                    ragged_attention=ragged_attention.launches)
    steps = dict(ragged=eng.ragged_steps - before["ragged"],
                 decode=eng.decode_steps - before["decode"],
                 syncs=eng.host_syncs - before["syncs"],
                 windows=eng.decode_windows - before["windows"])
    ttft = eng.last_ttft_s
    log(f"serve: pipeline 8 requests in {pipe_s:.2f}s; generate in "
        f"{gen_s:.2f}s (TTFT {ttft * 1e3:.1f} ms for the 8-prompt put, "
        f"decode {8 * (new - 1) / (gen_s - ttft):.1f} tokens/s)")
    log(f"serve: steps {steps} launches {launches}")

    for o, g, p in zip(outs, gen, prompts):
        if len(o) != new or len(g) != len(p) + new:
            raise AssertionError("a request did not get all its tokens")
        if not ((o >= 0) & (o < cfg.vocab_size)).all() or \
                not ((g >= 0) & (g < cfg.vocab_size)).all():
            raise AssertionError("token id out of [0, vocab)")
    # a ragged call launches the query tiles and the single-token walk
    # and counts once
    if launches["ragged_attention"] != L * steps["ragged"] or \
            steps["ragged"] == 0:
        raise AssertionError(f"ragged launches {launches} != {L} x ragged "
                             f"steps {steps['ragged']}")
    if launches["paged_attention"] != L * steps["decode"] or \
            steps["decode"] == 0:
        raise AssertionError(f"paged launches {launches} != {L} x decode "
                             f"steps {steps['decode']}")
    if steps["syncs"] != steps["windows"]:
        raise AssertionError(f"{steps['syncs']} host syncs for "
                             f"{steps['windows']} decode windows")
    gen2 = eng.generate(prompts, max_new_tokens=new)
    if not all(np.array_equal(a, b) for a, b in zip(gen, gen2)):
        raise AssertionError("a repeated generate() gave other streams")
    stream_match = sum(np.array_equal(o, g[len(p):])
                       for o, g, p in zip(outs, gen, prompts))
    log(f"serve: repeat generate() identical; pipeline vs generate streams "
        f"equal for {stream_match}/8 requests (bf16: batching may part "
        f"near-ties; informational)")

    uids = list(range(1000, 1008))
    logits = eng.put(uids, prompts)
    for u in uids:
        eng.flush(u)
    if logits.shape != (8, cfg.vocab_size) or not np.isfinite(logits).all():
        raise AssertionError("put() logits not finite / wrong shape")
    # the same put() through the plain versions in bf16, and through an
    # fp32 engine (plain versions, the weights cast up) as the reference
    ref = {}
    for dtype in ("bfloat16", "float32"):
        other = InferenceEngineV2(
            TransformerLM(cfg), RaggedInferenceEngineConfig.from_dict(
                {"dtype": dtype, "use_paged_kernel": False,
                 "state_manager": {"max_ragged_batch_size": 8192}}),
            params=eng.params, device=dev)
        ref[dtype] = other.put(uids, prompts)
        del other
    f32 = ref["float32"]
    for name, x, y in (("kernel - plain", logits, ref["bfloat16"]),
                       ("kernel - fp32", logits, f32),
                       ("plain - fp32", ref["bfloat16"], f32)):
        log(f"serve: put() logits max|{name}| = "
            f"{float(np.abs(x - y).max()):.4f}, argmax agreement "
            f"{float((x.argmax(-1) == y.argmax(-1)).mean()):.3f}")
    top2 = np.sort(f32, axis=-1)[:, -2:]
    log(f"serve: fp32 |logits| max {np.abs(f32).max():.3f}, smallest top-2 "
        f"margin {float((top2[:, 1] - top2[:, 0]).min()):.4f} "
        f"(bf16 gaps informational)")
    profile_phase(eng, prompts, eng.decode_window)
    launches.update(q8_serve_phase(dev, cfg, eng, prompts, new, logits,
                                   f32))
    v1_launches, v1_ids, v1_out = v1_serve_phase(dev, cfg, eng.params)
    launches.update(v1_launches)
    launches.update(woq_serve_phases(dev, cfg, eng, prompts, gen, logits,
                                     v1_ids, v1_out))
    return launches


def q8_serve_phase(dev, cfg, bf16_eng, prompts, new, bf16_logits,
                   f32_logits):
    """The int8 kv_quant pool at Mistral-7B: init_inference(use_ragged=True,
    kv_quant) on the bf16 engine's weights (the same tensors) and pool
    geometry, then put() + generate() as the bf16 serve phase drives
    them."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import \
        ragged_attention
    from deepspeed_tpu_torch.models import TransformerLM

    L = cfg.num_layers

    def build():
        e = deepspeed_tpu_torch.init_inference(
            TransformerLM(cfg), params=bf16_eng.params, device=dev,
            config={"dtype": "bfloat16", "use_ragged": True,
                    "ragged": {"kv_quant": True, "decode_window": 8,
                               "state_manager": {
                                   "max_ragged_batch_size": 8192}}})
        e.generate([prompts[0][:64]], max_new_tokens=4)        # warm-up
        return e

    eng = build()
    if eng.params["embed"].data_ptr() != bf16_eng.params["embed"].data_ptr():
        raise AssertionError("the int8 engine copied the weights")
    pool = {k: (tuple(v.shape), v.dtype) for k, v in eng.kv_cache.items()}
    q8_bytes = sum(v.numel() * v.element_size()
                   for v in eng.kv_cache.values())
    bf_bytes = sum(v.numel() * v.element_size()
                   for v in bf16_eng.kv_cache.values())
    log(f"serve q8: pool {pool}: {q8_bytes / 2**30:.3f} GiB against the "
        f"bf16 pool's {bf_bytes / 2**30:.3f} GiB (ratio "
        f"{q8_bytes / bf_bytes:.4f}) for the same "
        f"{eng.state_manager.config.num_blocks} blocks")

    before = dict(ragged=eng.ragged_steps, decode=eng.decode_steps,
                  syncs=eng.host_syncs, windows=eng.decode_windows)
    paged_attention.q8_launches = 0
    ragged_attention.q8_launches = 0
    # -- the main path: generate() over the int8 pool ----------------------
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(paged_attention_q8=paged_attention.q8_launches,
                    ragged_attention_q8=ragged_attention.q8_launches)
    steps = dict(ragged=eng.ragged_steps - before["ragged"],
                 decode=eng.decode_steps - before["decode"],
                 syncs=eng.host_syncs - before["syncs"],
                 windows=eng.decode_windows - before["windows"])
    ttft = eng.last_ttft_s
    log(f"serve q8: generate 8 requests in {gen_s:.2f}s (TTFT "
        f"{ttft * 1e3:.1f} ms for the 8-prompt put, decode "
        f"{8 * (new - 1) / (gen_s - ttft):.1f} tokens/s)")
    log(f"serve q8: steps {steps} launches {launches}")
    for g, p in zip(gen, prompts):
        if len(g) != len(p) + new or not ((g >= 0)
                                          & (g < cfg.vocab_size)).all():
            raise AssertionError("q8: a request did not get all its tokens "
                                 "in [0, vocab)")
    # one count a ragged call (its two launches), as in the bf16 phase
    if launches["ragged_attention_q8"] != L * steps["ragged"] or \
            steps["ragged"] == 0:
        raise AssertionError(f"q8 ragged launches {launches} != {L} x "
                             f"ragged steps {steps['ragged']}")
    if launches["paged_attention_q8"] != L * steps["decode"] or \
            steps["decode"] == 0:
        raise AssertionError(f"q8 paged launches {launches} != {L} x decode "
                             f"steps {steps['decode']}")
    if steps["syncs"] != steps["windows"]:
        raise AssertionError(f"q8: {steps['syncs']} host syncs for "
                             f"{steps['windows']} decode windows")
    # a freed block keeps its grow-only scale for its next tenant (as in
    # the JAX package), so a repeat is identical on a pool with the same
    # history: a second engine built and warmed up the same way
    twin = build()
    gen2 = twin.generate(prompts, max_new_tokens=new)
    del twin
    if not all(np.array_equal(a, b) for a, b in zip(gen, gen2)):
        raise AssertionError("q8: a repeated generate() gave other streams")
    gen3 = eng.generate(prompts, max_new_tokens=new)
    same = sum(np.array_equal(a, b) for a, b in zip(gen, gen3))
    log(f"serve q8: repeat generate() on an engine with the same history "
        f"identical; on the same engine (its blocks' scales now carry the "
        f"first run's absmax) {same}/8 streams equal (informational)")
    uids = list(range(1000, 1008))
    logits = eng.put(uids, prompts)
    for u in uids:
        eng.flush(u)
    if logits.shape != (8, cfg.vocab_size) or not np.isfinite(logits).all():
        raise AssertionError("q8 put() logits not finite / wrong shape")
    bf_gen = bf16_eng.generate(prompts, max_new_tokens=new)
    agree = np.mean([np.mean(a[len(p):] == b[len(p):])
                     for a, b, p in zip(gen, bf_gen, prompts)])
    for name, ref in (("bf16 pool", bf16_logits), ("fp32", f32_logits)):
        log(f"serve q8: put() logits max|q8 - {name}| = "
            f"{float(np.abs(logits - ref).max()):.4f}, argmax agreement "
            f"{float((logits.argmax(-1) == ref.argmax(-1)).mean()):.3f}")
    log(f"serve q8: generated-token agreement with the bf16 pool "
        f"{agree:.3f} (informational: random weights leave near-tied "
        f"logits, and one parted token parts the rest of a stream)")
    profile_phase(eng, prompts, eng.decode_window, "q8 ")
    del eng
    return launches


def v1_serve_phase(dev, cfg, params):
    """The v1 engine at Mistral-7B: init_inference() without use_ragged on
    the serve phase's weights; 8 prompts of 512 tokens, 64 new tokens,
    greedy."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.ops.decode_attention import \
        dense_decode_attention

    L, B, S, new = cfg.num_layers, 8, 512, 64
    eng = deepspeed_tpu_torch.init_inference(TransformerLM(cfg),
                                             params=params, dtype="bf16",
                                             device=dev)
    if eng.params["embed"].data_ptr() != params["embed"].data_ptr():
        raise AssertionError("the v1 engine copied the weights")
    ids = np.random.default_rng(5).integers(1, cfg.vocab_size, (B, S))
    eng.generate(ids[:, :64], max_new_tokens=4)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(ids, max_new_tokens=1)      # prefill + one sample, no decode
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    dense_decode_attention.launches = 0
    # -- the main path: generate() -----------------------------------------
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"dense_decode_attention": dense_decode_attention.launches}
    decode_s = gen_s - prefill_s
    log(f"serve v1: mistral_7b bf16 B={B} prompt {S} new {new}: generate "
        f"{gen_s:.2f}s, prefill {prefill_s * 1e3:.1f} ms, decode "
        f"{B * (new - 1) / decode_s:.1f} tokens/s "
        f"({decode_s / (new - 1) * 1e3:.2f} ms/step); launches {launches}")
    if out.shape != (B, S + new) or not np.array_equal(out[:, :S], ids) or \
            not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"v1 generate() returned {out.shape} / ids "
                             f"out of [0, vocab)")
    if launches["dense_decode_attention"] != L * (new - 1):
        raise AssertionError(f"v1 dense decode launches {launches} != "
                             f"{L} x {new - 1}")
    again = eng.generate(ids, max_new_tokens=new)
    if not np.array_equal(out, again):
        raise AssertionError("v1: a repeated generate() gave other tokens")
    log("serve v1: repeat generate() identical")
    # where the time goes: generate() with 1 new token (the prefill) and
    # with 9 (the prefill, then 8 decode steps); the steps are the
    # difference
    _, pre_wall, pre_k = profiled(lambda: eng.generate(ids, max_new_tokens=1))
    _, both_wall, both_k = profiled(
        lambda: eng.generate(ids, max_new_tokens=9))
    log_profile(f"v1 prefill ({B} x {S} tokens)", pre_wall, pre_k)
    log_profile(f"v1 decode (per step, {B} rows)", both_wall - pre_wall,
                minus(both_k, pre_k), 8)
    del eng
    return launches, ids, out


# ---------------------------------------------------------------------------
# weight-only quantized serve phases
# ---------------------------------------------------------------------------
WOQ_LEAVES = {("layers", k) for k in ("wq", "wk", "wv", "wo", "w_gate",
                                      "w_up", "w_down")} | {("embed",),
                                                           ("lm_head",)}


def woq_weights(eng, dense_params, bits, L):
    """The quantized leaves, the quantize launches of the engine's init
    and its resident weight bytes against the dense tree's."""
    from deepspeed_tpu_torch.inference.quantization import (
        QuantizedTensor, _flatten, quantized_nbytes)

    paths = {p for p, leaf in _flatten(eng.params)
             if isinstance(leaf, QuantizedTensor)}
    if paths != WOQ_LEAVES:
        raise AssertionError(f"quantized leaves {sorted(paths)}, want "
                             f"{sorted(WOQ_LEAVES)}")
    ratio = quantized_nbytes(eng.params) / quantized_nbytes(dense_params)
    limit = 0.51 if bits == 8 else 0.26
    log(f"woq{bits}: {len(paths)} quantized leaves; resident weights "
        f"{quantized_nbytes(eng.params) / 2**30:.3f} GiB = {ratio:.4f} x "
        f"the bf16 tree's {quantized_nbytes(dense_params) / 2**30:.3f} GiB "
        f"(limit {limit})")
    if not ratio <= limit:
        raise AssertionError(f"woq{bits}: resident weight bytes {ratio:.4f}"
                             f" x bf16 > {limit}")


def woq_memory_limit(dense_params):
    """What generate() may add at peak: two layers' dense weights (the
    layer being dequantized and the one before it), the dense embedding
    and head, and 1.5 GiB of activations."""
    layers = dense_params["layers"]
    layer = sum(layers[k][0].numel() * layers[k][0].element_size()
                for _, k in sorted(p for p in WOQ_LEAVES if len(p) == 2))
    nonlayer = sum(dense_params[k].numel() * dense_params[k].element_size()
                   for k in ("embed", "lm_head"))
    return layer, nonlayer, 2 * layer + nonlayer + 1.5 * 2**30


def woq_serve_phase(dev, cfg, bf16_eng, prompts, bits, new, bf16_gen,
                    bf16_logits):
    """init_inference(use_ragged=True, quant_bits=bits) on the bf16 serve
    phase's weight tensors: quantize at init, then generate() over the
    phase's 8 prompts with decode_window 8."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.ops import quantizer_kernels as qk

    L, N = cfg.num_layers, len(prompts)

    def build():
        qk.quantize_blocks.launches = 0
        e = deepspeed_tpu_torch.init_inference(
            TransformerLM(cfg), params=bf16_eng.params, device=dev,
            config={"dtype": "bfloat16", "use_ragged": True,
                    "quant_bits": bits,
                    "ragged": {"decode_window": 8, "state_manager": {
                        "max_ragged_batch_size": 8192}}})
        torch.cuda.synchronize()
        return e, qk.quantize_blocks.launches

    # -- the main path (1): quantize at init -------------------------------
    t0 = time.perf_counter()
    eng, q_launches = build()
    init_s = time.perf_counter() - t0
    log(f"woq{bits}: init_inference(use_ragged=True, quant_bits={bits}) in "
        f"{init_s:.2f}s, quantize_blocks launches {q_launches}")
    if q_launches != 7 * L + 2:
        raise AssertionError(f"woq{bits}: {q_launches} quantize launches at "
                             f"init, want 7 x {L} + 2")
    woq_weights(eng, bf16_eng.params, bits, L)
    eng.generate([prompts[0][:64]], max_new_tokens=4)           # warm-up

    layer, nonlayer, limit = woq_memory_limit(bf16_eng.params)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(ragged=eng.ragged_steps, decode=eng.decode_steps,
                  syncs=eng.host_syncs, windows=eng.decode_windows)
    qk.dequantize_blocks.launches = 0
    # -- the main path (2): generate() ---------------------------------------
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    d_launches = qk.dequantize_blocks.launches
    extra = torch.cuda.max_memory_allocated() - base
    steps = dict(ragged=eng.ragged_steps - before["ragged"],
                 decode=eng.decode_steps - before["decode"],
                 syncs=eng.host_syncs - before["syncs"],
                 windows=eng.decode_windows - before["windows"])
    want = 7 * L * (steps["ragged"] + steps["decode"]) \
        + 2 * (steps["ragged"] + steps["windows"])
    ttft = eng.last_ttft_s
    log(f"woq{bits}: generate {N} requests, {new} new tokens, in "
        f"{gen_s:.2f}s (TTFT {ttft * 1e3:.1f} ms for the {N}-prompt put, "
        f"decode {N * (new - 1) / (gen_s - ttft):.1f} tokens/s); steps "
        f"{steps}; "
        f"dequantize_blocks launches {d_launches} (want {want})")
    log(f"woq{bits}: extra peak memory in generate() "
        f"{extra / 2**30:.3f} GiB (limit {limit / 2**30:.3f}: two layers "
        f"{2 * layer / 2**30:.3f} + embed and head {nonlayer / 2**30:.3f} "
        f"+ 1.5 activations)")
    for g, p in zip(gen, prompts):
        if len(g) != len(p) + new or not ((g >= 0)
                                          & (g < cfg.vocab_size)).all():
            raise AssertionError(f"woq{bits}: a request did not get all its "
                                 f"tokens in [0, vocab)")
    if d_launches != want or steps["ragged"] == 0 or steps["decode"] == 0:
        raise AssertionError(f"woq{bits}: dequantize launches {d_launches} "
                             f"!= {want} for steps {steps}")
    if steps["syncs"] != steps["windows"]:
        raise AssertionError(f"woq{bits}: {steps['syncs']} host syncs for "
                             f"{steps['windows']} decode windows")
    if not extra <= limit:
        raise AssertionError(f"woq{bits}: generate() added {extra} bytes at "
                             f"peak > {limit}: a dense copy of the stack?")
    twin, _ = build()
    gen2 = twin.generate(prompts, max_new_tokens=new)
    del twin
    if not all(np.array_equal(a, b) for a, b in zip(gen, gen2)):
        raise AssertionError(f"woq{bits}: a fresh engine's generate() gave "
                             f"other streams")
    uids = list(range(1000, 1000 + N))
    logits = eng.put(uids, prompts)
    for u in uids:
        eng.flush(u)
    if logits.shape != (N, cfg.vocab_size) or not np.isfinite(logits).all():
        raise AssertionError(f"woq{bits}: put() logits not finite / wrong "
                             f"shape")
    # the bf16 engine on the same prompts and budget, in this call: bf16,
    # woq, bf16 (host-bound decode rates drift between calls)
    rates = []
    for e in (bf16_eng, eng, bf16_eng):
        t0 = time.perf_counter()
        e.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        rates.append(N * (new - 1) / (time.perf_counter() - t0
                                      - e.last_ttft_s))
    log(f"woq{bits}: decode tokens/s at {new} new tokens, bf16 / woq{bits} "
        f"/ bf16: {rates[0]:.1f} / {rates[1]:.1f} / {rates[2]:.1f} "
        f"(woq{bits} at {2 * rates[1] / (rates[0] + rates[2]):.3f}x bf16)")
    agree = np.mean([np.mean(a[len(p):] == b[len(p):len(p) + new])
                     for a, b, p in zip(gen, bf16_gen, prompts)])
    log(f"woq{bits}: a fresh engine's streams identical; put() logits "
        f"max|woq - bf16| {float(np.abs(logits - bf16_logits).max()):.4f}, "
        f"argmax agreement "
        f"{float((logits.argmax(-1) == bf16_logits.argmax(-1)).mean()):.3f}"
        f"; generated-token agreement with bf16 {agree:.3f} "
        f"(informational)")
    profile_phase(eng, prompts, eng.decode_window, f"woq{bits} ")
    del eng
    return {"quantize_blocks": q_launches, "dequantize_blocks": d_launches}


def woq_v1_phase(dev, cfg, params, ids, bf16_out, new=16):
    """The v1 engine under quant_bits=8 on the serve phase's weights: the
    v1 phase's 8 prompts of 512 tokens, 16 new tokens, greedy."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.ops import quantizer_kernels as qk

    L, (B, S) = cfg.num_layers, ids.shape
    qk.quantize_blocks.launches = 0
    # -- the main path (1): quantize at init -------------------------------
    eng = deepspeed_tpu_torch.init_inference(
        TransformerLM(cfg), params=params, dtype="bf16", quant_bits=8,
        device=dev)
    torch.cuda.synchronize()
    q_launches = qk.quantize_blocks.launches
    log(f"woq8 v1: init_inference(quant_bits=8): quantize_blocks launches "
        f"{q_launches}")
    if q_launches != 7 * L + 2:
        raise AssertionError(f"woq8 v1: {q_launches} quantize launches, "
                             f"want 7 x {L} + 2")
    woq_weights(eng, params, 8, L)
    eng.generate(ids[:, :64], max_new_tokens=4)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(ids, max_new_tokens=1)      # prefill + one sample, no decode
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    layer, nonlayer, limit = woq_memory_limit(params)
    # the v1 engine allocates its dense KV cache inside each call
    cache = 2 * L * B * cfg.kv_heads * (S + new) * cfg.head_dim * 2
    limit += cache
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    qk.dequantize_blocks.launches = 0
    # -- the main path (2): generate() ---------------------------------------
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    d_launches = qk.dequantize_blocks.launches
    extra = torch.cuda.max_memory_allocated() - base
    # the embedding and head once per call; every layer once for the
    # prefill and once for each of the new - 1 decode forwards
    want = 2 + 7 * L * new
    decode_s = gen_s - prefill_s
    log(f"woq8 v1: B={B} prompt {S} new {new}: generate {gen_s:.2f}s, "
        f"prefill {prefill_s * 1e3:.1f} ms, decode "
        f"{B * (new - 1) / decode_s:.1f} tokens/s "
        f"({decode_s / (new - 1) * 1e3:.2f} ms/step); dequantize_blocks "
        f"launches {d_launches} (want {want}); extra peak memory "
        f"{extra / 2**30:.3f} GiB (limit {limit / 2**30:.3f}, the KV cache "
        f"{cache / 2**30:.3f} of it)")
    if out.shape != (B, S + new) or not np.array_equal(out[:, :S], ids) or \
            not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"woq8 v1: generate() returned {out.shape} / "
                             f"ids out of [0, vocab)")
    if d_launches != want:
        raise AssertionError(f"woq8 v1: dequantize launches {d_launches} != "
                             f"{want}")
    if not extra <= limit:
        raise AssertionError(f"woq8 v1: generate() added {extra} bytes at "
                             f"peak > {limit}: a dense copy of the stack?")
    twin = deepspeed_tpu_torch.init_inference(
        TransformerLM(cfg), params=params, dtype="bf16", quant_bits=8,
        device=dev)
    again = twin.generate(ids, max_new_tokens=new)
    del twin
    if not np.array_equal(out, again):
        raise AssertionError("woq8 v1: a fresh engine's generate() gave "
                             "other tokens")
    logits = eng.forward(ids[:, :64])
    if not torch.isfinite(logits).all():
        raise AssertionError("woq8 v1: forward() logits not finite")
    # the bf16 v1 engine on the same weights, prompts and budget, in this
    # call: bf16, woq8, bf16 (prefill + new tokens, and the prefill alone)
    bf16 = deepspeed_tpu_torch.init_inference(TransformerLM(cfg),
                                              params=params, dtype="bf16",
                                              device=dev)
    rates = []
    for e in (bf16, eng, bf16):
        walls = []
        for n_new in (1, new):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.generate(ids, max_new_tokens=n_new)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rates.append(B * (new - 1) / (walls[1] - walls[0]))
    del bf16
    log(f"woq8 v1: decode tokens/s at {new} new tokens, bf16 / woq8 / "
        f"bf16: {rates[0]:.1f} / {rates[1]:.1f} / {rates[2]:.1f} (woq8 at "
        f"{2 * rates[1] / (rates[0] + rates[2]):.3f}x bf16)")
    agree = float(np.mean(out[:, S:] == bf16_out[:, S:S + new]))
    log(f"woq8 v1: a fresh engine's tokens identical; generated-token "
        f"agreement with bf16 v1 {agree:.3f} (informational)")
    _, pre_wall, pre_k = profiled(lambda: eng.generate(ids, max_new_tokens=1))
    _, both_wall, both_k = profiled(
        lambda: eng.generate(ids, max_new_tokens=9))
    log_profile(f"woq8 v1 prefill ({B} x {S} tokens)", pre_wall, pre_k)
    log_profile(f"woq8 v1 decode (per step, {B} rows)", both_wall - pre_wall,
                minus(both_k, pre_k), 8)
    del eng
    return {"quantize_blocks": q_launches, "dequantize_blocks": d_launches}


def woq_serve_phases(dev, cfg, bf16_eng, prompts, bf16_gen, bf16_logits,
                     v1_ids, v1_out):
    """int8 and int4 WOQ on the v2 engine, int8 on the v1 engine; the
    launch counts of the three main paths summed."""
    runs = [woq_serve_phase(dev, cfg, bf16_eng, prompts, 8, 64, bf16_gen,
                            bf16_logits),
            woq_serve_phase(dev, cfg, bf16_eng, prompts, 4, 16, bf16_gen,
                            bf16_logits),
            woq_v1_phase(dev, cfg, bf16_eng.params, v1_ids, v1_out)]
    return {k: sum(r[k] for r in runs)
            for k in ("quantize_blocks", "dequantize_blocks")}


def profiled(fn):
    """Runs fn() under torch.profiler; returns (fn's result, host ms of the
    call ending in a synchronize, {device event: (ms, count)} for the
    device-side events only: kernels, memcpy, memset)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        if e.device_type == DeviceType.CUDA and t > 0:
            kern[e.key] = (t / 1e3, e.count)
    return out, wall, kern


def log_profile(name, wall, kern, steps=1, top=6):
    dev_ms = sum(t for t, _ in kern.values())
    log(f"profile {name}: wall {wall / steps:.2f} ms/step, device "
        f"{dev_ms / steps:.2f} ms/step, busy {dev_ms / wall:.3f}, "
        f"launches/step {sum(c for _, c in kern.values()) / steps:.0f}")
    for k, (t, c) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"   {t / steps:.3f} ms/step {c / steps:.0f}x  {k[:90]}")


def log_ragged_kernels(name, kern, calls=1):
    """The ragged call's device time by kernel in a profile: the query
    tiles (ragged_tile_kernel), the single-token walk
    (ragged_singleton_kernel, the paged decode kernel's split walk) and
    the page walk route (ragged_paged_attention_kernel)."""
    parts = []
    for tag in ("ragged_tile_kernel", "ragged_singleton_kernel",
                "ragged_paged_attention_kernel"):
        hits = [(t, c) for k, (t, c) in kern.items() if tag in k]
        if hits:
            parts.append(f"{tag} {sum(t for t, _ in hits) / calls:.4f} ms "
                         f"({sum(c for _, c in hits) / calls:.0f}x)")
    log(f"profile {name}: " + (", ".join(parts) or "the profiler recorded "
                               "no device event"))


def minus(a, b):
    """Per-event difference of two profiles: the extra steps of a."""
    return {k: (t - b.get(k, (0.0, 0))[0], c - b.get(k, (0.0, 0))[1])
            for k, (t, c) in a.items()}


def profile_phase(eng, prompts, window, label=""):
    """Where the serving time goes. torch.profiler over
    generate() with max_new_tokens=1 (one put(): the ragged step) and with
    1 + window (the same put(), then one fused decode window). The window's
    device time and launches are the difference of the two runs; its wall
    time is the second run's after its put() (``last_ttft_s``)."""
    def run(new):
        _, wall, kern = profiled(
            lambda: eng.generate(prompts, max_new_tokens=new))
        return eng.last_ttft_s * 1e3, wall - eng.last_ttft_s * 1e3, kern

    put_wall, _, put_k = run(1)
    _, win_wall, both_k = run(1 + window)
    n_tok = sum(map(len, prompts))
    log_profile(f"{label}ragged step ({n_tok} tokens)", put_wall, put_k)
    log_ragged_kernels(f"{label}ragged step", put_k)
    win_k = minus(both_k, put_k)
    log_profile(f"{label}decode window (per step, {len(prompts)} rows)",
                win_wall, win_k, window)
    paged = [(t, c) for k, (t, c) in win_k.items()
             if "paged_decode_split_kernel" in k]
    log(f"profile {label}decode window: paged attention "
        f"{sum(t for t, _ in paged) / window:.3f} ms/step, "
        f"{sum(c for _, c in paged) / window:.0f} launches/step")


# ---------------------------------------------------------------------------
# flash kernel phases (training attention)
# ---------------------------------------------------------------------------
def flash_work(bh, bhk, sq, skv, causal, elem):
    """(bytes, flops) of each flash function at these shapes: every input
    read once and every output written once; two products in the forward
    (scores, P.V), three in dq (scores, dP, dS.K), four in dk/dv (scores,
    dP, P^T.dO, dS^T.Q), each 2 flops per visible (q, k) pair and head
    dim."""
    if causal:
        off = skv - sq
        pairs = sum(max(0, min(skv, off + r + 1)) for r in range(sq))
    else:
        pairs = sq * skv
    q_b, kv_b = bh * sq * HD * elem, bhk * skv * HD * elem
    row_b = bh * sq * 4                     # one f32 per q row (lse, delta)
    per_product = 2 * bh * pairs * HD
    return {"flash_fwd": (2 * q_b + 2 * kv_b + row_b, 2 * per_product),
            "flash_bwd_dq": (3 * q_b + 2 * kv_b + 2 * row_b, 3 * per_product),
            "flash_bwd_dkv": (2 * q_b + 4 * kv_b + 2 * row_b,
                              4 * per_product)}


def flash_run(fa, q, k, v, do, causal):
    """Kernel and plain outputs of the three functions on one input set;
    both backward versions take the kernel forward's lse and delta."""
    scale = 1.0 / HD ** 0.5
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale,
                                        causal)
    torch.cuda.synchronize()
    return ((o, o_p), (lse, lse_p), (dq, dq_p), (dk, dk_p), (dv, dv_p),
            (lse, delta))


def compare_outputs(name, o_pair, lse_pair, grads, tol_o, tol_g):
    """o absolute, lse absolute (1e-3), grads relative to max |plain|;
    raises past the tolerances or on a non-finite output."""
    (o, o_p), (lse, lse_p) = o_pair, lse_pair
    err_o = (o.float() - o_p.float()).abs().max().item()
    err_lse = (lse - lse_p).abs().max().item() if lse is not None else 0.0
    err_g = {}
    for gname, (a, b) in zip(("dq", "dk", "dv"), grads):
        ref = b.float().abs().max().item()
        err_g[gname] = (a.float() - b.float()).abs().max().item() / max(
            ref, 1e-30)
    log(f"{name}: o max_abs_err={err_o:.3e} lse {err_lse:.3e} "
        + " ".join(f"{g} rel_err={e:.3e}" for g, e in err_g.items())
        + f" (tolerance o {tol_o}, lse 1e-3, grads {tol_g})")
    finite = all(torch.isfinite(t).all().item()
                 for t in (o, grads[0][0], grads[1][0], grads[2][0]))
    if not (err_o <= tol_o and err_lse <= 1e-3 and finite
            and all(e <= tol_g for e in err_g.values())):
        raise AssertionError(f"{name}: a kernel disagrees with its plain "
                             f"version: o {err_o}, lse {err_lse}, grads "
                             f"{err_g}")
    return err_o, err_g


def flash_check(fa, name, q, k, v, do, causal, tol_o, tol_g):
    """Holds the three kernels against their plain versions; returns the
    errors (o absolute, grads relative to max |plain|)."""
    (o, o_p), (lse, lse_p), *grads, _ = flash_run(fa, q, k, v, do, causal)
    return compare_outputs(name, (o, o_p), (lse, lse_p), grads, tol_o, tol_g)


def hopper_resources():
    """Logs, for the tensor-core flash_fwd, flash_bwd_dq and flash_bwd_dkv
    kernels, the registers and spills from the ptxas report of the build,
    and the dynamic shared memory and resident blocks per SM from the CUDA
    occupancy API."""
    import ctypes

    from deepspeed_tpu_torch.ops.op_builder import cuda as cuda_build

    kinds = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")  # info's order
    text = cuda_build.build_logs.get("flash_attention", "")
    for entry in text.split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        if "hopper" not in name:
            continue
        kind = next(k for k in kinds if f"{k}_hopper" in name)
        dtype = "fp16" if "6__half" in name else "bf16"
        hd = re.search(r"Li(\d+)E", name).group(1)
        regs = re.search(r"Used (\d+) registers", entry).group(1)
        spill = re.findall(r"(\d+) bytes spill (?:stores|loads)", entry)
        log(f"  ptxas {kind} tensor-core {dtype} hd {hd}: {regs} registers "
            f"at launch (setmaxnreg: producer 40, consumers 232), spill "
            f"stores/loads {'/'.join(spill)} bytes")
    lib = cuda_build.load("flash_attention")
    for hd in HEAD_DIMS:
        out = (ctypes.c_int * 9)()
        cuda_build.check(lib.ds_flash_hopper_info(hd, 2, ctypes.addressof(
            out)), "ds_flash_hopper_info")
        for i, kind in enumerate(kinds):
            regs, smem, blocks = out[3 * i:3 * i + 3]
            log(f"  {kind} tensor-core bf16 hd {hd}: {regs} registers, "
                f"{smem} bytes of dynamic shared memory, 384 threads: "
                f"{blocks} block(s) per SM")
            if blocks < 1:
                raise AssertionError(f"{kind} hd {hd} cannot launch")


def flash_masked_rows(fa, q, k, v, do, causal=True):
    """Sq > Skv: the rows that see no key give o == 0, lse == -1e30 and
    dq == 0 exactly."""
    scale = 1.0 / q.shape[-1] ** 0.5
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    dead = (k.shape[1] - q.shape[1]) + torch.arange(q.shape[1],
                                                    device=q.device) < 0
    ok = bool((o[:, dead] == 0).all()) and bool((lse[:, dead] == -1e30).all())
    ok_dq = bool((dq[:, dead] == 0).all())
    log(f"flash Sq {q.shape[1]} > Skv {k.shape[1]}: {int(dead.sum())} rows "
        f"see no key; o == 0 and lse == -1e30 there: {ok}; dq == 0 there: "
        f"{ok_dq}")
    if not ok:
        raise AssertionError("flash_fwd: a row that sees no key is not "
                             "o = 0, lse = -1e30")
    if not ok_dq:
        raise AssertionError("flash_bwd_dq: a row that sees no key has a "
                             "non-zero dq")


def flash_phases(dev, flush):
    from deepspeed_tpu_torch.ops import flash_attention as fa

    hopper_resources()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    bh, bhk, S = TRAIN_B * NH, TRAIN_B * KVH, TRAIN_S

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, k, v, do = rnd(bh, S, HD), rnd(bhk, S, HD), rnd(bhk, S, HD), \
        rnd(bh, S, HD)
    err_o, err_g = flash_check(fa, f"flash bf16 causal B{TRAIN_B} nh{NH} "
                               f"kvh{KVH} S{S}", q, k, v, do, True, TOL,
                               2e-2)
    flash_check(fa, f"flash bf16 causal Sq {S // 2} < Skv {S}",
                q[:, S // 2:].contiguous(), k, v,
                do[:, S // 2:].contiguous(), True, TOL, 2e-2)
    flash_check(fa, "flash bf16 non-causal", q, k, v, do, False, TOL, 2e-2)
    for dt, tol_o, tol_g in ((torch.float32, 1e-4, 1e-4),
                             (torch.float16, TOL, 2e-2)):
        flash_check(fa, f"flash {dt} causal", q.to(dt), k.to(dt), v.to(dt),
                    do.to(dt), True, tol_o, tol_g)
    # the tensor-core kernels' other routes: head_dim 64, one kv head per
    # q head, a single 128-row tile, and Sq > Skv (whole q tiles see no key)
    h64 = [t[..., :64].contiguous() for t in (q, k, v, do)]
    flash_check(fa, "flash bf16 causal hd 64", *h64, True, TOL, 2e-2)
    mha = (q[:bhk], k, v, do[:bhk])
    flash_check(fa, "flash bf16 causal MHA (group 1)", *mha, True, TOL, 2e-2)
    one = [t[:, :128].contiguous() for t in (q, k, v, do)]
    flash_check(fa, "flash bf16 causal S 128 (one tile)", *one, True, TOL,
                2e-2)
    tall = (q[:, :256].contiguous(), k[:, :128].contiguous(),
            v[:, :128].contiguous(), do[:, :256].contiguous())
    flash_check(fa, "flash bf16 causal Sq 256 > Skv 128", *tall, True, TOL,
                2e-2)
    flash_masked_rows(fa, *tall)

    # a repeated backward is bit-identical (no atomics)
    *_, (lse, delta) = flash_run(fa, q, k, v, do, True)
    scale = 1.0 / HD ** 0.5
    runs = [(fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, True),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True))
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("a repeated flash backward is not bit-identical")
    log("flash backward repeated (the tensor-core flash_bwd_dq and "
        "flash_bwd_dkv): bit-identical")

    # times at the training shape, each kernel in turns with its yardstick
    # (never called by the port)
    q4 = q.view(TRAIN_B, NH, S, HD)
    k4, v4 = k.view(TRAIN_B, KVH, S, HD), v.view(TRAIN_B, KVH, S, HD)
    do4 = do.view(TRAIN_B, NH, S, HD)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    lib_out = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)

    def lib_bwd():
        torch.autograd.grad(lib_out, (qg, kg, vg), do4, retain_graph=True)

    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, True),
                      lambda: fa.flash_fwd_plain(q, k, v, scale, True),
                      lambda: sdpa(q4, k4, v4, is_causal=True,
                                   enable_gqa=True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                 scale, True),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse,
                                                       delta, scale, True),
                         lib_bwd),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                   scale, True),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                         delta, scale, True),
                          lib_bwd),
    }
    work = flash_work(bh, bhk, S, S, True, 2)
    errs = {"flash_fwd": err_o, "flash_bwd_dq": err_g["dq"],
            "flash_bwd_dkv": max(err_g["dk"], err_g["dv"])}
    results = {}
    for name, (kern, plain, lib) in calls.items():
        b_ms, b_by = bound(*work[name])
        ms, lib_ms = time_turns(kern, lib, flush)
        results[name] = dict(
            max_abs_err=errs[name], ms=ms,
            plain_ms=time_ms(plain, flush, reps=3, warmup=1),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        r = results[name]
        log(f"{name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) err={r['max_abs_err']:.3e}")
    log("flash library_ms: forward = scaled_dot_product_attention; the dq "
        "and dkv rows = its autograd backward, which computes the pair; "
        "kernel and library timed in turns (kernel, library, kernel), "
        "medians")
    return results


# ---------------------------------------------------------------------------
# block-sparse attention phases
# ---------------------------------------------------------------------------
def sparse_configs():
    """The three layouts at Mistral-7B attention width: (i) Fixed, block
    64, causal (the timed case and the op path's); (ii) BigBird, block 64,
    non-causal; (iii) the pattern of (i) at the JAX default block 16."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    return {
        "(i) fixed b64 causal": (sa.FixedSparsityConfig(
            num_heads=NH, block=64, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional"), True),
        "(ii) bigbird b64": (sa.BigBirdSparsityConfig(
            num_heads=NH, block=64, num_sliding_window_blocks=3,
            num_global_blocks=1, num_random_blocks=1), False),
        "(iii) fixed b16 causal": (sa.FixedSparsityConfig(
            num_heads=NH, block=16, num_local_blocks=16, num_global_blocks=4,
            attention="unidirectional"), True),
    }


def visible_layout(layout, causal):
    lay = np.asarray(layout, bool)
    if causal:
        lay = lay & np.tril(np.ones(lay.shape[1:], bool))[None]
    return lay


def sparse_work(layout, causal, block, bh, tables, elem, tiles=None):
    """(bytes, flops) of each sparse function: every input (q, k, v, do,
    lse, delta, the tables the function's kernel reads: the per-block ones,
    or on the tensor-core route the tile tables, dq's for the forward and
    dq, dk/dv's for dk/dv) read once and
    every output written once; 2 flops per visible (q, k) pair and head dim
    per product, two products in the forward, three in dq, four in dk/dv.
    Visible pairs: block^2 per active off-diagonal block, block (block + 1)
    / 2 per causal diagonal block."""
    lay = visible_layout(layout, causal)
    H, n, _ = lay.shape
    diag = int(np.trace(lay, axis1=1, axis2=2).sum()) if causal else 0
    pairs = (int(lay.sum()) - diag) * block ** 2 + diag * block * (
        block + 1) // 2
    per_product = 2 * (bh // H) * pairs * HD
    x = bh * n * block * HD * elem              # one [bh, S, D] tensor
    row = bh * n * block * 4                    # lse or delta
    tb_kv = sum(t.numel() * 4 for t in tables[:2])
    tb_q = sum(t.numel() * 4 for t in tables[2:])
    tb_dq, tb_dkv = tb_kv, tb_q
    if tiles is not None:
        tb_dq = (tiles.dq_items.numel() + tiles.dq_steps.numel()) * 4
        tb_dkv = (tiles.dkv_items.numel() + tiles.dkv_steps.numel()) * 4
    return {"sparse_fwd": (4 * x + row + tb_dq, 2 * per_product),
            "sparse_bwd_dq": (5 * x + 2 * row + tb_dq, 3 * per_product),
            "sparse_bwd_dkv": (6 * x + 2 * row + tb_dkv, 4 * per_product)}


def layout_stats(layout, causal, tables, tiles=None):
    """The layout's block counts and table widths; with the host tile
    tables (build_tile_tables) also the tensor-core walk: tile products
    per head, steps per head, the share of consumer slots that multiply,
    and the longest step list."""
    lay = visible_layout(layout, causal)
    H, n, _ = lay.shape
    rows, cols = lay.sum(-1), lay.sum(-2)
    room = n * (n + 1) // 2 if causal else n * n
    text = (f"{int(lay.sum()) // H} active blocks per head of {room} "
            f"{'causal ' if causal else ''}blocks (density "
            f"{lay.sum() / (H * room):.3f}), Jmax {tables[0].shape[-1]} / "
            f"median {float(np.median(rows)):.0f}, Imax "
            f"{tables[2].shape[-1]} / median {float(np.median(cols)):.0f}")
    if tiles is not None:
        masks = tiles.dq_steps[:, 1].view(np.uint32)
        pairs = int(((masks & 0xFFFF) != 0).sum()
                    + ((masks >> 16) != 0).sum())
        text += (f"; 64-row tiles: {pairs / H:.0f} tile products per head, "
                 f"dq {tiles.dq_steps.shape[0] / H:.0f} steps per head "
                 f"({pairs / (2 * tiles.dq_steps.shape[0]):.3f} of slots "
                 f"busy, longest {tiles.dq_max}), dk/dv "
                 f"{tiles.dkv_steps.shape[0] / H:.0f} ("
                 f"{pairs / (2 * tiles.dkv_steps.shape[0]):.3f}, longest "
                 f"{tiles.dkv_max})")
    return text


def sparse_tables(sk, layout, causal, block, dev):
    """The per-block tables and, where S is a multiple of 64, the tile
    tables of the tensor-core kernels, on the card."""
    tables = sk.device_tables(layout, causal, dev)
    s = np.shape(layout)[1] * block
    tiles = (sk.device_tile_tables(layout, causal, block, dev)
             if s % sk.TILE == 0 else None)
    return tables, tiles


def sparse_calls(sk, q, k, v, do, tables, causal, block, tiles=None):
    """Each sparse function as (kernel call, plain call) without arguments
    on one input set; the backward ones take the kernel forward's lse and
    delta; every kernel call takes the tile tables, which the tensor-core
    route walks."""
    args = (1.0 / q.shape[-1] ** 0.5, causal, block, NH)
    tq, tkv = tables[:2], tables[2:]
    o, lse = sk.sparse_fwd(q, k, v, *tq, *args, tiles=tiles)
    bwd = (q, k, v, do, lse, (do.float() * o.float()).sum(-1, keepdim=True))
    return {
        "sparse_fwd": (
            lambda: sk.sparse_fwd(q, k, v, *tq, *args, tiles=tiles),
            lambda: sk.sparse_fwd_plain(q, k, v, *tq, *args)),
        "sparse_bwd_dq": (
            lambda: sk.sparse_bwd_dq(*bwd, *tq, *args, tiles=tiles),
            lambda: sk.sparse_bwd_dq_plain(*bwd, *tq, *args)),
        "sparse_bwd_dkv": (
            lambda: sk.sparse_bwd_dkv(*bwd, *tkv, *args, tiles=tiles),
            lambda: sk.sparse_bwd_dkv_plain(*bwd, *tkv, *args)),
    }


def sparse_run(sk, q, k, v, do, tables, causal, block, tiles=None):
    """Kernel and plain outputs of the three functions on one input set:
    (o, lse, dq, dk, dv), each as (kernel, plain)."""
    calls = sparse_calls(sk, q, k, v, do, tables, causal, block, tiles)
    (o, lse), (o_p, lse_p) = (f() for f in calls["sparse_fwd"])
    dq, dq_p = (f() for f in calls["sparse_bwd_dq"])
    (dk, dv), (dk_p, dv_p) = (f() for f in calls["sparse_bwd_dkv"])
    torch.cuda.synchronize()
    return (o, o_p), (lse, lse_p), (dq, dq_p), (dk, dk_p), (dv, dv_p)


def sparse_check(sk, name, q, k, v, do, tables, causal, block, tol_o,
                 tol_g, tiles=None):
    """Holds the three sparse kernels against their plain versions, as
    flash_check holds the flash kernels; logs their route."""
    route = ("tensor cores" if sk.tensor_core_route(q) else "tile kernels")
    (o, o_p), (lse, lse_p), *grads = sparse_run(sk, q, k, v, do, tables,
                                                causal, block, tiles)
    return compare_outputs(f"{name} [forward, dq, dk/dv on the {route}]",
                           (o, o_p), (lse, lse_p), grads, tol_o, tol_g)


def sparse_library(layout, causal, block, q, k, v, do):
    """The yardstick (never called by the port): scaled_dot_product_attention
    with the layout expanded to a boolean [1, 1, S, S] token mask (head 0's
    layout for every head; tril under causal), as (forward call, autograd
    backward call), the backward computing the dq + dkv pair."""
    S = q.shape[1]
    lay0 = torch.as_tensor(visible_layout(layout, causal)[0],
                           device=q.device)
    mask = lay0.repeat_interleave(block, 0).repeat_interleave(block, 1)
    if causal:
        mask &= torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    mask = mask[None, None]
    q4, k4, v4, do4 = (t.view(1, NH, S, -1) for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    lib_out = sdpa(qg, kg, vg, attn_mask=mask)
    return (lambda: sdpa(q4, k4, v4, attn_mask=mask),
            lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do4,
                                        retain_graph=True))


def time_bwd_turns(calls, lib_bwd, flush):
    """dq, dk/dv and the library pair in turns (dq, dkv, library, dq,
    dkv): medians of the kernels' 40 samples and of the library's 20."""
    kern = ("sparse_bwd_dq", "sparse_bwd_dkv")
    first = {n: time_samples(calls[n][0], flush) for n in kern}
    lib_t = time_samples(lib_bwd, flush)
    last = {n: time_samples(calls[n][0], flush) for n in kern}
    return ({n: statistics.median(first[n] + last[n]) for n in kern},
            statistics.median(lib_t))


def sparse_resources(sk, max_steps):
    """Logs, for the tensor-core sparse_bwd_dq, sparse_bwd_dkv and
    sparse_fwd, the registers and spills from the ptxas report of the
    build and the
    dynamic shared memory (at step lists of up to max_steps) and resident
    blocks per SM from the CUDA occupancy API; raises on a spill, a
    missing kernel in the report of a build made by this process, or a
    kernel that cannot launch."""
    import ctypes

    from deepspeed_tpu_torch.ops.op_builder import cuda as cuda_build

    kinds = ("sparse_bwd_dq", "sparse_bwd_dkv", "sparse_fwd")  # info's
    text = cuda_build.build_logs.get("sparse_attention", "")
    seen = 0
    for entry in text.split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        if "hopper" not in name:
            continue
        kind = next(k for k in kinds if f"{k}_hopper" in name)
        dtype = "fp16" if "6__half" in name else "bf16"
        hd = re.search(r"Li(\d+)E", name).group(1)
        regs = re.search(r"Used (\d+) registers", entry).group(1)
        spill = [int(x) for x in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", entry)]
        log(f"  ptxas {kind} tensor-core {dtype} hd {hd}: {regs} registers "
            f"at launch (setmaxnreg: producer 24, consumers 240), spill "
            f"stores/loads {'/'.join(map(str, spill))} bytes")
        if any(spill):
            raise AssertionError(f"{kind} {dtype} hd {hd} spills registers")
        seen += 1
    if not text:
        log("  ptxas: no report in this process (the libraries of an "
            "unchanged tree were reused)")
    elif seen != 12:
        raise AssertionError(f"ptxas listed {seen} tensor-core sparse "
                             f"kernels, want 12 (3 kernels x 2 dtypes x 2 "
                             f"head dims)")
    lib = cuda_build.load("sparse_attention")
    for hd in HEAD_DIMS:
        out = (ctypes.c_int * 9)()
        cuda_build.check(lib.ds_sparse_hopper_info(
            hd, 2, max_steps, ctypes.addressof(out)),
            "ds_sparse_hopper_info")
        for i, kind in enumerate(kinds):
            regs, smem, blocks = out[3 * i:3 * i + 3]
            log(f"  {kind} tensor-core bf16 hd {hd}: {regs} registers, "
                f"{smem} bytes of dynamic shared memory (lists of up to "
                f"{max_steps} steps), 384 threads: {blocks} block(s) per SM")
            if blocks < 1:
                raise AssertionError(f"{kind} hd {hd} cannot launch")


def sparse_zero_rows(sk, q, k, v, do, dev):
    """Block 16, non-causal: q blocks 1-2 (inside the first 64-row tile)
    and 40-47 (whole tiles) see no block, kv blocks 5-6 and 48-55 feed
    none. The tensor-core kernels give o = 0, lse = -1e30 and dq = 0, and
    dk = dv = 0 there exactly, and the other rows are not all zero."""
    s, block = 1024, 16
    n = s // block
    lay = np.ones((NH, n, n), bool)
    lay[:, 1:3] = lay[:, 40:48] = False
    lay[:, :, 5:7] = lay[:, :, 48:56] = False
    x = [t[:, :s].contiguous() for t in (q, k, v, do)]
    tables, tiles = sparse_tables(sk, lay, False, block, dev)
    sparse_check(sk, "sparse bf16 empty rows b16 S 1024", *x, tables, False,
                 block, TOL, 2e-2, tiles)
    (o, _), (lse, _), (dq, _), (dk, _), (dv, _) = sparse_run(
        sk, *x, tables, False, block, tiles)
    q_dead = np.repeat(~lay[0].any(1), block)
    k_dead = np.repeat(~lay[0].any(0), block)
    qd, kd = (torch.as_tensor(m, device=dev) for m in (q_dead, k_dead))
    ok = (bool((o[:, qd] == 0).all()) and bool((dq[:, qd] == 0).all())
          and bool((lse[:, qd] == sk.NEG_INF).all())
          and bool((lse[:, ~qd] > sk.NEG_INF / 2).all())
          and bool((dk[:, kd] == 0).all()) and bool((dv[:, kd] == 0).all())
          and all(bool((t[:, ~m] != 0).any())
                  for t, m in ((o, qd), (dq, qd), (dk, kd), (dv, kd))))
    log(f"sparse b16: {int(q_dead.sum())} q rows of empty q blocks give "
        f"o = 0, lse = -1e30 and dq = 0, {int(k_dead.sum())} kv rows of "
        f"empty kv blocks dk = dv = 0, exactly: {ok}")
    if not ok:
        raise AssertionError("sparse: empty q / kv blocks must give exact "
                             "zeros (o, dq / dk, dv) and lse = -1e30")


def sparse_phases(dev, flush):
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops import sparse_kernels as sk

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    S = SPARSE_S
    q, k, v, do = (torch.randn((NH, S, HD), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    results, first = {}, None
    sparse_resources(sk, S // sk.TILE)
    for label, (cfg, causal) in sparse_configs().items():
        layout = cfg.make_layout(S)
        tables, tiles = sparse_tables(sk, layout, causal, cfg.block, dev)
        log(f"sparse {label}: B 1, nh {NH}, hd {HD}, S {S}, "
            + layout_stats(layout, causal, tables,
                           sk.build_tile_tables(layout, causal, cfg.block)))
        err_o, err_g = sparse_check(sk, f"sparse bf16 {label}", q, k, v, do,
                                    tables, causal, cfg.block, TOL, 2e-2,
                                    tiles)
        calls = sparse_calls(sk, q, k, v, do, tables, causal, cfg.block,
                             tiles)
        work = sparse_work(layout, causal, cfg.block, NH, tables, 2, tiles)
        lib_fwd, lib_bwd = sparse_library(layout, causal, cfg.block, q, k,
                                          v, do)
        fwd_ms, lib_fwd_ms = time_turns(calls["sparse_fwd"][0], lib_fwd,
                                        flush)
        times = {"sparse_fwd": fwd_ms}
        bwd_times, lib_pair = time_bwd_turns(calls, lib_bwd, flush)
        times.update(bwd_times)
        log(f"sparse {label} kernel ms: " + ", ".join(
            f"{name} {t:.4f} (bound {bound(*work[name])[0]:.5f})"
            for name, t in times.items())
            + f"; forward against the library's {lib_fwd_ms:.4f} (in "
            f"turns: kernel, library, kernel); dq + dk/dv "
            f"{sum(bwd_times.values()):.4f} against the library pair "
            f"{lib_pair:.4f} (in turns: dq, dkv, library, dq, dkv)")
        if first is not None:
            continue
        # (i): the kernels line, with the plain versions and the library
        first = (cfg, tables, tiles, calls)
        errs = {"sparse_fwd": err_o, "sparse_bwd_dq": err_g["dq"],
                "sparse_bwd_dkv": max(err_g["dk"], err_g["dv"])}
        lib = {"sparse_fwd": lib_fwd_ms, "sparse_bwd_dq": lib_pair,
               "sparse_bwd_dkv": lib_pair}
        for name, (_, plain) in calls.items():
            b_ms, b_by = bound(*work[name])
            results[name] = dict(
                max_abs_err=errs[name], ms=times[name],
                plain_ms=time_ms(plain, flush, reps=3, warmup=1),
                library_ms=lib[name], bound_ms=b_ms, bound_by=b_by)
            r = results[name]
            log(f"{name}: kernel_ms={r['ms']:.4f} plain_ms="
                f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
                f"err={r['max_abs_err']:.3e}")
        log("sparse library_ms: forward = scaled_dot_product_attention "
            "with the layout as a [1, 1, S, S] boolean mask; the dq and dkv "
            "rows = its autograd backward, which computes the pair")
    cfg, tables, tiles, calls = first
    for dt, tol_o, tol_g in ((torch.float32, 1e-4, 1e-4),
                             (torch.float16, TOL, 2e-2)):
        sparse_check(sk, f"sparse {dt} (i)", q.to(dt), k.to(dt), v.to(dt),
                     do.to(dt), tables, True, cfg.block, tol_o, tol_g, tiles)
    sparse_check(sk, "sparse bf16 (i) hd 64",
                 *(t[..., :64].contiguous() for t in (q, k, v, do)), tables,
                 True, cfg.block, TOL, 2e-2, tiles)
    # the other blocks: 32 (2 x 2 sub-blocks a tile) and 128 (a block of
    # 2 x 2 tiles) at S 2048, and block 16 at an S with a ragged last
    # 64-row tile (the tile kernels' route)
    for block, s2 in ((32, 2048), (128, 2048), (16, 2064)):
        lay = sa.FixedSparsityConfig(
            num_heads=NH, block=block, num_local_blocks=4,
            attention="unidirectional").make_layout(s2)
        tb, tl = sparse_tables(sk, lay, True, block, dev)
        sparse_check(sk, f"sparse bf16 fixed b{block} causal S {s2}",
                     *(t[:, :s2].contiguous() for t in (q, k, v, do)), tb,
                     True, block, TOL, 2e-2, tl)
    # q blocks with no active block: o = 0 and dq = 0 there
    lay = np.zeros((NH, 16, 16), bool)
    lay[:, 4:, :4] = True
    lay[:, 4:, 4:] = np.tril(np.ones((12, 12), bool))
    tb, tl = sparse_tables(sk, lay, False, 64, dev)
    (o, _), (lse, _), (dq, _), _, _ = sparse_run(
        sk, *(t[:, :1024].contiguous() for t in (q, k, v, do)), tb, False,
        64, tl)
    if not ((o[:, :256] == 0).all() and (dq[:, :256] == 0).all()
            and (lse[:, :256] == sk.NEG_INF).all()
            and (o[:, 256:] != 0).any()):
        raise AssertionError("sparse: q blocks with no active block must "
                             "give o = 0, lse = -1e30 and dq = 0")
    log("sparse: q blocks with no active block (whole 64-row tiles) give "
        "o = 0, lse = -1e30 and dq = 0")
    sparse_zero_rows(sk, q, k, v, do, dev)
    # a repeated forward and backward are bit-identical (no atomics)
    runs = [(*calls["sparse_fwd"][0](), calls["sparse_bwd_dq"][0](),
             *calls["sparse_bwd_dkv"][0]()) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("a repeated sparse forward or backward is not "
                             "bit-identical")
    log("sparse forward and backward repeated (the tensor-core sparse_fwd, "
        "sparse_bwd_dq and sparse_bwd_dkv at (i)): bit-identical")
    # the tables stay cached per layout (~0.1 GiB for the block-16 one):
    # free them before the later phases measure their peak memory
    sk._DEVICE_TABLES.clear()
    sk._DEVICE_TILES.clear()
    return results


def sparse_op_phase(dev):
    """The op's own entry point: SparseSelfAttention(cfg (i)) on bf16
    [1, 32, 8192, 128] inputs, forward and backward five times; then a
    small fp32 check of impl="kernel" against impl="dense" on the card."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops import sparse_kernels as sk

    cfg, causal = sparse_configs()["(i) fixed b64 causal"]
    S = SPARSE_S
    base = torch.cuda.memory_allocated()    # what earlier phases left
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    q, k, v, do = (torch.randn((1, NH, S, HD), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    attn = sa.SparseSelfAttention(cfg)

    def step():
        for t in (q, k, v):
            t.grad = None
        o = attn(q, k, v, causal=True)
        o.backward(do)
        return o

    step()                      # warm-up: layout, tables, library load
    kernels = (sk.sparse_fwd, sk.sparse_bwd_dq, sk.sparse_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kfn in kernels:
        kfn.launches = 0
    # -- the main path: SparseSelfAttention forward + backward x 5 ----------
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        o = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {kfn.__name__: kfn.launches for kfn in kernels}
    med = statistics.median(times)
    log(f"sparse op: SparseSelfAttention fixed b64 causal, B 1, nh {NH}, "
        f"hd {HD}, S {S}, bf16: forward+backward ms "
        f"{[f'{x * 1e3:.2f}' for x in times]}, median {med * 1e3:.2f} ms = "
        f"{S / med:.0f} tokens/s; peak memory "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB; "
        f"launches {launches}")
    if launches != {kfn.__name__: 5 for kfn in kernels}:
        raise AssertionError(f"sparse op launches {launches}, want 5 each")
    grads = [t.grad for t in (q, k, v)]
    if not all(torch.isfinite(t).all().item() for t in (o, *grads)):
        raise AssertionError("sparse op: non-finite output or gradient")
    # the last call against the plain versions on the same inputs
    tables = sk.device_tables(attn.get_layout(S), True, dev)
    args = (1.0 / HD ** 0.5, True, cfg.block, NH)
    qf, kf, vf, dof = (t.detach().reshape(NH, S, HD) for t in (q, k, v, do))
    o_p, lse_p = sk.sparse_fwd_plain(qf, kf, vf, *tables[:2], *args)
    delta = (dof.float() * o_p.float()).sum(-1, keepdim=True)
    dq_p = sk.sparse_bwd_dq_plain(qf, kf, vf, dof, lse_p, delta,
                                  *tables[:2], *args)
    dk_p, dv_p = sk.sparse_bwd_dkv_plain(qf, kf, vf, dof, lse_p, delta,
                                         *tables[2:], *args)
    compare_outputs("sparse op vs plain versions (bf16)",
                    (o.detach().reshape(NH, S, HD), o_p), (None, None),
                    [(g.reshape(NH, S, HD), p)
                     for g, p in zip(grads, (dq_p, dk_p, dv_p))], TOL, 2e-2)
    # where one call's time goes, on the card's clock: CUDA events, since a
    # torch.profiler session after the earlier phases' ones recorded no
    # device events here. Two more events bracket the sparse_fwd wrapper
    # inside the forward (after the counted run), so that the forward's
    # time outside the kernel shows on both clocks.
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    fwd_wrapper, inner = sk.sparse_fwd, {}

    def bracketed_fwd(*a, **kw):
        ev[1].record()
        t = time.perf_counter()
        out = fwd_wrapper(*a, **kw)
        inner["host"] = time.perf_counter() - t
        ev[2].record()
        return out

    # the wrapper counts its launch on the module's name, the bracket here
    bracketed_fwd.launches = 0
    for t in (q, k, v):
        t.grad = None
    torch.cuda.synchronize()
    sk.sparse_fwd = bracketed_fwd
    try:
        t0 = time.perf_counter()
        ev[0].record()
        out = attn(q, k, v, causal=True)
        ev[3].record()
        host_fwd = (time.perf_counter() - t0) * 1e3
        out.backward(do)
        ev[4].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        sk.sparse_fwd = fwd_wrapper
    fwd, bwd = ev[0].elapsed_time(ev[3]), ev[3].elapsed_time(ev[4])
    kern = ev[1].elapsed_time(ev[2])
    log(f"sparse op on the card's clock: forward {fwd:.3f} ms (the "
        f"sparse_fwd wrapper {kern:.3f} ms, the forward outside it "
        f"{fwd - kern:.3f} ms), backward (delta, dq, dk/dv) {bwd:.3f} ms, "
        f"of a {wall:.3f} ms call (device share {(fwd + bwd) / wall:.3f}); "
        f"on the host's clock the forward call took {host_fwd:.3f} ms, "
        f"{host_fwd - inner['host'] * 1e3:.3f} ms of it outside the "
        f"sparse_fwd wrapper")
    # the table look-up's key: by identity for the op's cached read-only
    # layout, a serialization for a writeable copy of it
    lay = attn.get_layout(S)
    lay_w = np.array(lay)
    key_us = {}
    for name, x in (("cached read-only", lay), ("writeable copy", lay_w)):
        t = time.perf_counter()
        for _ in range(50):
            sk._layout_key(x, True)
        key_us[name] = (time.perf_counter() - t) / 50 * 1e6
    log(f"sparse op layout key ({list(lay.shape)} {lay.dtype}), host us a "
        f"look-up: " + ", ".join(f"{n} {u:.2f}" for n, u in key_us.items()))

    # small fp32: impl="kernel" against impl="dense" on the same CUDA tensors
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = sa.FixedSparsityConfig(num_heads=NH, block=64,
                                   num_local_blocks=4, num_global_blocks=1,
                                   attention="unidirectional")
    lay = small.make_layout(1024)
    x = [torch.randn((1, NH, 1024, 64), generator=gen, device=dev)
         for _ in range(4)]
    outs = {}
    for impl in ("kernel", "dense"):
        ins = [t.clone().requires_grad_(True) for t in x[:3]]
        out = sa.sparse_attention(*ins, lay, 64, causal=True, impl=impl)
        out.backward(x[3])
        outs[impl] = (out.detach(), *(t.grad for t in ins))
    gaps = [(a - b).abs().max().item()
            for a, b in zip(outs["kernel"], outs["dense"])]
    log(f"sparse op fp32 S 1024 hd 64: max|kernel - dense| o {gaps[0]:.3e} "
        f"dq {gaps[1]:.3e} dk {gaps[2]:.3e} dv {gaps[3]:.3e} (tolerance "
        f"1e-4)")
    if not max(gaps) <= 1e-4:
        raise AssertionError(f"sparse op fp32: kernel disagrees with dense "
                             f"{gaps}")
    # a shape the kernels do not take raises under auto, never runs dense
    lay8 = sa.FixedSparsityConfig(num_heads=NH, block=8).make_layout(1024)
    try:
        sa.sparse_attention(*x[:3], lay8, 8)
    except ValueError as e:
        log(f"sparse op: block 8 under impl='auto' on the card raises: {e}")
    else:
        raise AssertionError("sparse op: block 8 on the card did not raise")
    return launches


# ---------------------------------------------------------------------------
# weight-only quantization and RMSNorm kernel phases
# ---------------------------------------------------------------------------
def halfway_block(block, qrange, k, dev):
    """A block whose scale is exactly 2**k (absmax = qrange * 2**k) and
    whose other elements are (m + 0.5) * 2**k: x / scale lands exactly on
    .5, where rintf (half to even) and roundf (half away) differ."""
    m = torch.arange(block, dtype=torch.float32, device=dev) \
        % (2 * int(qrange)) - qrange
    x = (m + 0.5) * 2.0 ** k
    x[0] = qrange * 2.0 ** k
    return x


def quant_edge_input(gen, dev, bits):
    """n = 2048 * 5 + 777: a random block, an all-zero block, a half-way
    block, a block of tiny values, a random block, then a ragged tail."""
    qrange = 127.0 if bits == 8 else 7.0
    return torch.cat([
        torch.randn(WOQ_BLOCK, generator=gen, device=dev) * 3.0,
        torch.zeros(WOQ_BLOCK, device=dev),
        halfway_block(WOQ_BLOCK, qrange, -2, dev),
        torch.randn(WOQ_BLOCK, generator=gen, device=dev) * 1e-3,
        torch.randn(WOQ_BLOCK + 777, generator=gen, device=dev)])


def check_quant(name, x, block, bits):
    """quantize_blocks then dequantize_blocks (f32, bf16, fp16 out; int4
    through pack / unpack) against the plain versions: bit-equal. Returns
    the largest difference seen (0.0)."""
    from deepspeed_tpu_torch.ops import quantizer_kernels as qk
    from deepspeed_tpu_torch.ops.quantizer import pack_int4, unpack_int4

    q, s = qk.quantize_blocks(x, block, bits)
    qp, sp = qk.quantize_blocks_plain(x, block, bits)
    torch.cuda.synchronize()
    err = max((q.int() - qp.int()).abs().max().item(),
              (s - sp).abs().max().item())
    if not (torch.equal(q, qp) and torch.equal(s, sp)):
        raise AssertionError(f"quantize_blocks {name}: q / scales differ "
                             f"from the plain version (max diff {err})")
    qv = unpack_int4(pack_int4(q)) if bits == 4 else q
    n = x.numel()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        out = qk.dequantize_blocks(qv, s, dt, n=n)
        ref = qk.dequantize_blocks_plain(qv, s, dt, n=n)
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"dequantize_blocks {name} -> {dt}: differs "
                                 f"from the plain version (max diff {d})")
        err = max(err, d)
    log(f"quantize / dequantize {name}: bits {bits}, block {block}, "
        f"n {n}: q, scales and f32 / bf16 / fp16 outputs bit-equal")
    return err


def woq_kernel_phases(dev, flush):
    """quantize_blocks / dequantize_blocks at one Mistral-7B layer's w_gate
    and w_down (bf16, block 2048, bits 8 and 4), edge inputs (a ragged
    tail, a zero block, half-way values) in f32 / bf16 / fp16 and the
    element-wise route (block 1000, a misaligned source); then RMSNorm."""
    from deepspeed_tpu_torch.ops import quantizer_kernels as qk

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    H, F = 4096, 14336
    weights = {"w_gate": torch.randn((H, F), generator=gen, device=dev,
                                     dtype=torch.bfloat16) * 0.02,
               "w_down": torch.randn((F, H), generator=gen, device=dev,
                                     dtype=torch.bfloat16) * 0.02}
    err = 0.0
    for bits in (8, 4):
        for name, w in weights.items():
            err = max(err, check_quant(f"{name} {tuple(w.shape)} bf16", w,
                                       WOQ_BLOCK, bits))
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = quant_edge_input(gen, dev, bits).to(dt)
            err = max(err, check_quant(f"edge input {dt}", x, WOQ_BLOCK,
                                       bits))
        x = quant_edge_input(gen, dev, bits).to(torch.bfloat16)[1:]
        err = max(err, check_quant("element-wise route (block 1000, source "
                                   "off 16-byte alignment)", x, 1000, bits))

    w = weights["w_gate"]
    n = w.numel()
    nb = n // WOQ_BLOCK
    q, s = qk.quantize_blocks(w, WOQ_BLOCK, 8)
    # quantize reads bf16 and writes int8 + one f32 per block; dequantize
    # the reverse; ~6 f32 operations per element (abs, max, divide, round,
    # clamp) and 1 (the multiply)
    io_bytes = n * 2 + n + nb * 4
    results = {}
    b_ms, b_by = bound(io_bytes, 6 * n, F32_FLOPS_PER_S)
    results["quantize_blocks"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: qk.quantize_blocks(w, WOQ_BLOCK, 8), flush),
        plain_ms=time_ms(lambda: qk.quantize_blocks_plain(w, WOQ_BLOCK, 8),
                         flush, reps=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound(io_bytes, n, F32_FLOPS_PER_S)
    results["dequantize_blocks"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: qk.dequantize_blocks(q, s, torch.bfloat16, n=n),
                   flush),
        plain_ms=time_ms(lambda: qk.dequantize_blocks_plain(
            q, s, torch.bfloat16, n=n), flush, reps=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    del weights, w, q, s
    results.update(rms_norm_phases(dev, flush))
    for name, r in results.items():
        lib = "—" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"{name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={lib} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) max_abs_err={r['max_abs_err']:.3e}")
    return results


def rms_norm_phases(dev, flush):
    """rms_norm(x, w, 1e-5, use_pallas=True), the op's entry, at a ragged
    step [4608, 4096], a decode step [8, 4096] and a train micro-batch
    [4096, 4096] in bf16, the ragged step in fp32, and h 4100 (no multiple
    of the vector width): one launch per call, none for use_pallas=False;
    against rms_norm_ref within 1e-5 (fp32) or one bf16 rounding
    (2**-7 |plain| + 1e-6)."""
    from deepspeed_tpu_torch.ops.norms import (rms_norm, rms_norm_kernel,
                                               rms_norm_ref)

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    cases = [("ragged step", (4608, 4096), torch.bfloat16),
             ("decode step", (8, 4096), torch.bfloat16),
             ("train micro-batch", (4096, 4096), torch.bfloat16),
             ("ragged step fp32", (4608, 4096), torch.float32),
             ("h 4100", (37, 4100), torch.bfloat16)]
    inputs = [(label, torch.randn(shape, generator=gen, device=dev,
                                  dtype=dt) * 2.0,
               (0.5 + torch.rand(shape[-1], generator=gen,
                                 device=dev)).to(dt))
              for label, shape, dt in cases]
    torch.cuda.synchronize()
    rms_norm_kernel.launches = 0
    # -- the main path: the op entry, one launch per call -------------------
    outs = [rms_norm(x, w, 1e-5, use_pallas=True) for _, x, w in inputs]
    rms_norm(inputs[0][1], inputs[0][2], 1e-5)      # use_pallas=False
    torch.cuda.synchronize()
    launches = rms_norm_kernel.launches
    if launches != len(inputs):
        raise AssertionError(f"rms_norm launches {launches} for "
                             f"{len(inputs)} use_pallas=True calls")
    # a bf16 x with an f32 weight (the kernel reads each in its own dtype)
    x, w = inputs[1][1], inputs[1][2].float()
    checks = [(label, x, w, out) for (label, x, w), out in zip(inputs, outs)]
    checks.append(("decode step, f32 weight", x, w,
                   rms_norm(x, w, 1e-5, use_pallas=True)))
    err = 0.0
    for label, x, w, out in checks:
        ref = rms_norm_ref(x, w, 1e-5)
        diff = (out.float() - ref.float()).abs()
        if x.dtype == torch.float32:
            ok = bool((diff <= 1e-5).all())
            tol = "1e-5"
        else:
            ok = bool((diff <= 2.0 ** -7 * ref.float().abs() + 1e-6).all())
            tol = "2**-7 |plain| + 1e-6"
        e = diff.max().item()
        log(f"rms_norm {label} {tuple(x.shape)} {x.dtype}: max_abs_err="
            f"{e:.3e} (tolerance {tol})")
        if not (ok and out.shape == x.shape and out.dtype == x.dtype
                and torch.isfinite(out).all()):
            raise AssertionError(f"rms_norm {label}: the kernel disagrees "
                                 f"with rms_norm_ref ({e})")
        err = max(err, e)
    _, x, w = inputs[0]
    rows, h = x.shape
    F = torch.nn.functional
    lib_ms = None
    if hasattr(F, "rms_norm"):
        lib = F.rms_norm(x, (h,), w, 1e-5)
        gap = (lib.float() - rms_norm_ref(x, w, 1e-5).float()).abs().max()
        # F.rms_norm casts x * rsqrt(var + eps) back to bf16 before the
        # weight multiply; the port (and JAX) multiply in f32, cast once
        log(f"rms_norm library yardstick F.rms_norm bf16: max|lib - plain| "
            f"{gap.item():.3e} (rounds before the weight multiply; "
            f"informational)")
        lib_ms = time_ms(lambda: F.rms_norm(x, (h,), w, 1e-5), flush)
    b_ms, b_by = bound(2 * rows * h * 2 + h * 2, 4 * rows * h,
                       F32_FLOPS_PER_S)
    return {"rms_norm": dict(
        max_abs_err=err, launches=launches,
        ms=time_ms(lambda: rms_norm(x, w, 1e-5, use_pallas=True), flush),
        plain_ms=time_ms(lambda: rms_norm_ref(x, w, 1e-5), flush, reps=5),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)}


# ---------------------------------------------------------------------------
# small fp32 training check
# ---------------------------------------------------------------------------
SMALL_TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
    "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
}


def small_train_check(dev):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
                flash_min_seq=128)
    kern, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**base)),
        config=SMALL_TRAIN_CONFIG, device=dev)
    plain, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**base, use_flash=False)),
        config=SMALL_TRAIN_CONFIG, params=kern.params, device=dev)
    rng = np.random.default_rng(3)
    before = fa.flash_fwd.launches
    gaps = []
    for _ in range(3):
        batch = {"input_ids": rng.integers(0, 256, (2, 2, 256))}
        gaps.append(abs(kern.train_batch(batch=batch)
                        - plain.train_batch(batch=batch)))
    ran = fa.flash_fwd.launches - before
    log(f"small fp32 training check: |loss kernel - plain| per step "
        f"{[f'{g:.2e}' for g in gaps]} (tolerance 1e-5), flash_fwd "
        f"launches {ran}")
    if not (max(gaps) <= 1e-5 and ran > 0):
        raise AssertionError("fp32 flash-kernel training disagrees with the "
                             "plain-attention engine on the tiny model")


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------
def train_phase(dev):
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(mistral_7b(), num_layers=4)
    L, gas, steps = cfg.num_layers, 2, 5
    config = {"train_micro_batch_size_per_gpu": TRAIN_B,
              "gradient_accumulation_steps": gas,
              "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
              "gradient_clipping": 1.0, "bf16": {"enabled": True},
              "steps_per_print": 10 ** 9}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(cfg),
                                                config=config)
    torch.cuda.synchronize()
    log(f"train: mistral_7b width, L={L} (of 32), hidden {cfg.hidden_size}, "
        f"heads {cfg.num_heads}/{cfg.kv_heads}, "
        f"{engine.param_count / 1e9:.3f} B params, bf16 + fp32 master on "
        f"{engine.device} in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (gas, TRAIN_B, TRAIN_S))}
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for kfn in kernels:
        kfn.launches = 0
    # -- the main path: train_batch() x 5, then eval_batch() --------------
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(engine.train_batch(batch=batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    eval_loss = engine.eval_batch(batch=batch)
    launches = {kfn.__name__: kfn.launches for kfn in kernels}
    tokens = gas * TRAIN_B * TRAIN_S
    med = statistics.median(step_s[1:])
    log(f"train: losses {[f'{x:.4f}' for x in losses]}, eval {eval_loss:.4f}")
    log(f"train: step s {[f'{x:.3f}' for x in step_s]}; median of steps "
        f"2-{steps} {med * 1e3:.1f} ms = {tokens / med:.0f} tokens/s "
        f"({tokens} tokens/step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"train: launches {launches}")
    if not (all(np.isfinite(losses)) and np.isfinite(eval_loss)
            and losses[-1] < losses[0]):
        raise AssertionError(f"train losses not finite and falling: {losses}")
    # random tokens hold nothing to learn beyond the batch itself: a low
    # loss on a fresh batch would mean the causal mask leaks the targets
    held = engine.eval_batch(batch={"input_ids": rng.integers(
        0, cfg.vocab_size, (gas, TRAIN_B, TRAIN_S))})
    log(f"train: loss on a fresh random batch {held:.4f} (the fixed "
        f"batch's fell to {losses[-1]:.4f}; ln V = "
        f"{np.log(cfg.vocab_size):.2f})")
    if not held > np.log(cfg.vocab_size) / 2:
        raise AssertionError(f"fresh-batch loss {held}: the causal mask "
                             f"leaks future tokens")
    want = {"flash_fwd": steps * 2 * L * gas + L * gas,
            "flash_bwd_dq": steps * L * gas, "flash_bwd_dkv": steps * L * gas}
    if launches != want:
        raise AssertionError(f"train launches {launches} != {want}")
    train_profile(engine, batch)
    return launches


def train_profile(engine, batch):
    """Device time, busy share, top kernels and every flash kernel of one
    train_batch()."""
    _, wall, kern = profiled(lambda: engine.train_batch(batch=batch))
    dev_ms = sum(t for t, _ in kern.values())
    log(f"profile train step: wall {wall:.2f} ms (profiled), device "
        f"{dev_ms:.2f} ms, busy {dev_ms / wall:.3f}, launches "
        f"{sum(c for _, c in kern.values())}")
    for k, (t, c) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"   {t:.3f} ms {c}x  {k[:90]}")
    flash = {k: v for k, v in kern.items() if "flash" in k}
    log(f"profile train step flash kernels: "
        f"{sum(t for t, _ in flash.values()):.3f} ms")
    for k, (t, c) in sorted(flash.items(), key=lambda kv: -kv[1][0]):
        log(f"   {t:.3f} ms {c}x  {k[:90]}")


# ---------------------------------------------------------------------------
# phase 8b: ZeRO-Offload and native checkpoints
# ---------------------------------------------------------------------------
HOST_SRC = "deepspeed_tpu_torch/csrc/host/"
OFFLOAD_GAS = 2
RESIDENT_BYTES_PER_PARAM = 18      # bf16 param, f32 master, m, v, f32 grad
HOST_STATE_BYTES_PER_PARAM = 12    # f32 master, m, v


def meminfo_gib(key):
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 2 ** 20
    raise KeyError(key)


def host_rss_gib():
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    raise KeyError("VmRSS")


def offload_config(offload=None, stage=2, **extra):
    cfg = {"train_micro_batch_size_per_gpu": TRAIN_B,
           "gradient_accumulation_steps": OFFLOAD_GAS,
           "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
           "gradient_clipping": 1.0, "bf16": {"enabled": True},
           "steps_per_print": 10 ** 9, "zero_optimization": {"stage": stage}}
    if offload is not None:
        cfg["zero_optimization"]["offload_optimizer"] = dict(offload)
    cfg.update(extra)
    return cfg


TIERED = {"device": "cpu", "pin_memory": True}
LEGACY = {"device": "cpu"}


def free_engine(eng):
    eng.close()
    gc.collect()
    torch.cuda.empty_cache()


def host_ops_phase():
    """The host C++ optimizers on one Mistral-7B layer's w_gate (4096 x
    14336 f32 elements) against the port's torch optimizer math on CPU
    tensors, three steps with one gradient as in the JAX package's test
    (rtol 1e-5, atol 1e-6); the bf16 copy-back equal to round-to-nearest-
    even of the f32 result; per-call time and GB/s beside a CPU copy_ of
    the same bytes."""
    from deepspeed_tpu_torch.ops import cpu_optimizers as co
    from deepspeed_tpu_torch.ops import optimizers as topt
    from deepspeed_tpu_torch.ops.op_builder import builder, cpu

    t0 = time.perf_counter()
    for b in cpu.ALL_OPS.values():
        b().build()
    log(f"host ops: g++ build {time.perf_counter() - t0:.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in builder.build_seconds.items()) or 'reused'}) "
        f"into {builder.BUILD_ROOT}")
    lscpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    model = next((l.split(":", 1)[1].strip() for l in lscpu.splitlines()
                  if l.startswith("Model name")), "unknown")
    cpus = os.cpu_count()
    log(f"host ops: CPU '{model}', {cpus} CPUs, torch threads "
        f"{torch.get_num_threads()}, OMP_NUM_THREADS "
        f"{os.environ.get('OMP_NUM_THREADS', 'unset')}")
    n = 4096 * 14336
    gen = torch.Generator().manual_seed(5)
    p0 = torch.randn(n, generator=gen)
    g32 = torch.randn(n, generator=gen).mul_(0.1)
    cases = [
        ("cpu_adam", "f32", lambda: co.DeepSpeedCPUAdam(
            lr=1e-2, weight_decay=0.01), topt.FusedAdam(
            lr=1e-2, weight_decay=0.01), 28),
        ("cpu_adam", "bf16", lambda: co.DeepSpeedCPUAdam(
            lr=1e-2, weight_decay=0.01), topt.FusedAdam(
            lr=1e-2, weight_decay=0.01), 28),
        ("cpu_adagrad", "f32", lambda: co.DeepSpeedCPUAdagrad(lr=1e-2),
         topt.FusedAdagrad(lr=1e-2, eps=1e-10), 20),
        ("cpu_lion", "f32", lambda: co.DeepSpeedCPULion(
            lr=1e-3, weight_decay=0.01), topt.FusedLion(
            lr=1e-3, weight_decay=0.01), 20),
    ]
    records = []
    for name, gdt, make, ref_opt, bytes_per in cases:
        opt = make()
        g = g32.bfloat16() if gdt == "bf16" else g32
        p = p0.clone()
        state = [torch.zeros(n) for _ in opt.state_keys()]
        out = torch.empty(n, dtype=torch.bfloat16)
        ms = []
        for step in (1, 2, 3):
            t0 = time.perf_counter()
            opt.step(step, p, g, *state,
                     params_out_bf16=out if gdt == "bf16" else None)
            ms.append((time.perf_counter() - t0) * 1e3)
        opt.destroy()
        ref = [p0.clone()]
        ref_state = ref_opt.init_state(ref)
        for step in (1, 2, 3):
            ref_opt.apply(ref, [g.float()], ref_state, step)
        err = float((p - ref[0]).abs().max())
        if not torch.allclose(p, ref[0], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"{name} ({gdt} grads) disagrees with the "
                                 f"torch optimizer: max |diff| {err:.3e}")
        if gdt == "bf16" and not torch.equal(out, p.bfloat16()):
            raise AssertionError(f"{name}: the bf16 copy-back is not the "
                                 f"round-to-nearest-even of the f32 result")
        nbytes = n * bytes_per
        src = torch.ones(nbytes // 8)
        dst = torch.empty_like(src)
        dst.copy_(src)
        copies = []
        for _ in range(3):
            t0 = time.perf_counter()
            dst.copy_(src)
            copies.append((time.perf_counter() - t0) * 1e3)
        del src, dst
        med, copy_ms = statistics.median(ms[1:]), statistics.median(copies)
        rec = {"name": name, "grads": gdt, "source": HOST_SRC + name + ".cpp",
               "build_s": builder.build_seconds.get(name), "elements": n,
               "ms": med, "gb_s": nbytes / med / 1e6,
               "copy_ms": copy_ms, "copy_gb_s": nbytes / copy_ms / 1e6,
               "max_abs_err": err}
        records.append(rec)
        log(f"host ops: {name} ({gdt} grads) {med:.1f} ms a call "
            f"(steps {[f'{x:.1f}' for x in ms]}), {rec['gb_s']:.1f} GB/s "
            f"over {bytes_per} B/element; copy_ of the same bytes "
            f"{copy_ms:.1f} ms = {rec['copy_gb_s']:.1f} GB/s; max |diff| vs "
            f"torch {err:.2e}" + ("; bf16 copy-back == RNE(f32)"
                                  if gdt == "bf16" else ""))
    return {"host_ops": records, "cpu": model, "cpus": cpus}


def offload_run(cfg, config, batch, steps, label, params=None, seed=0):
    """An engine of ``config`` trained ``steps`` times on ``batch``: (engine,
    losses, step seconds, peak device GiB above what was allocated before
    it, init seconds), logged."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(cfg), config=config, params=params, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(batch=batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    ho = eng.host_opt
    extra = ""
    if ho is not None:
        t = ho.timings
        extra = (f"; last step H2D {t.get('h2d_ms', 0):.1f} ms, D2H "
                 f"{t.get('d2h_ms', 0):.1f} ms, host optimizer "
                 f"{t.get('host_opt_ms', 0):.1f} ms")
        if eng.offload_tiered:
            extra += (f", stream {t.get('stream_ms', 0):.1f} ms, waits "
                      f"{t.get('wait_ms', 0):.1f} ms; prefetch hit "
                      f"{ho.prefetch_hit_fraction:.3f}, exposed "
                      f"{ho.prefetch_exposed_fraction:.3f}; "
                      f"{len(ho.buckets)} buckets, pinned "
                      f"{ho.pinned.bytes / 2 ** 30:.2f} GiB")
        else:
            extra += (f"; {len(ho.segments)} segments, ring pinned "
                      f"{ho.pinned.bytes / 2 ** 30:.2f} GiB")
    log(f"offload {label}: init {init_s:.1f}s, losses "
        f"{[f'{x:.4f}' for x in losses]}, step s "
        f"{[f'{x:.3f}' for x in step_s]}, peak device {peak:.2f} GiB, host "
        f"RSS {host_rss_gib():.1f} GiB" + extra)
    return eng, losses, step_s, peak, init_s


def compare_tiered_resident(res, tier):
    """torch.equal of compute params, master and moments, leaf by leaf."""
    master, moments = tier.host_opt.get_all_leaves()
    for name, a, b in zip(res._leaf_names, res._param_leaves,
                          tier._param_leaves):
        if not torch.equal(a, b):
            raise AssertionError(f"tiered params differ from resident: {name}")
    for name, a, b in zip(res._leaf_names, res._master_leaves, master):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"tiered master differs from resident: "
                                 f"{name}")
    for key, leaves in moments.items():
        for name, a, b in zip(res._leaf_names, res.opt_state[key], leaves):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"tiered {key} differs from resident: "
                                     f"{name}")


def offload_width_phase(dev, cfg, batch):
    """Resident, tiered (pin_memory, stage 2) and legacy (stage 2) on the
    same weights and fixed batch, 3 steps each: tiered equal to resident bit
    for bit, legacy within rtol 0.05, atol 1e-2 (one bf16 rounding of the
    shipped gradients)."""
    from deepspeed_tpu_torch.models import TransformerLM

    gen = torch.Generator(device=dev).manual_seed(0)
    weights = TransformerLM(cfg).init_params(gen, dtype=torch.bfloat16)
    res, r_loss, r_s, r_peak, _ = offload_run(
        cfg, offload_config(stage=2), batch, 3, "resident L=4",
        params=weights)
    tier, t_loss, t_s, t_peak, _ = offload_run(
        cfg, offload_config(TIERED), batch, 3, "tiered L=4", params=weights)
    if t_loss != r_loss:
        raise AssertionError(f"tiered losses {t_loss} != resident {r_loss}")
    compare_tiered_resident(res, tier)
    log("offload L=4: tiered == resident bit for bit (losses, params, "
        "master, exp_avg, exp_avg_sq)")
    free_engine(tier)
    del tier
    leg, l_loss, l_s, l_peak, _ = offload_run(
        cfg, offload_config(LEGACY), batch, 3, "legacy L=4", params=weights)
    if not np.allclose(l_loss, r_loss, rtol=0.05, atol=1e-2):
        raise AssertionError(f"legacy losses {l_loss} vs resident {r_loss}")
    log(f"offload L=4: legacy within rtol 0.05 / atol 1e-2 of resident "
        f"(max |diff| {max(abs(a - b) for a, b in zip(l_loss, r_loss)):.2e}); "
        f"median step ms resident {statistics.median(r_s[1:]) * 1e3:.1f}, "
        f"tiered {statistics.median(t_s[1:]) * 1e3:.1f}, legacy "
        f"{statistics.median(l_s[1:]) * 1e3:.1f}")
    free_engine(leg)
    free_engine(res)
    del leg, res, weights


def full_depth_layers(cfg):
    """32 unless the host cannot hold the f32 state (12 B a parameter)
    beside this process: then the deepest depth that fits, never below 20
    (from 20 layers up the resident state passes 80 GB)."""
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.kv_heads * cfg.head_dim
    per_layer = 2 * h * h + 2 * h * kv + 3 * h * f + 2 * h
    fixed = 2 * v * h + h
    room = meminfo_gib("MemTotal") - host_rss_gib() - 4.0
    for L in range(cfg.num_layers, 19, -1):
        need = (fixed + L * per_layer) * HOST_STATE_BYTES_PER_PARAM / 2 ** 30
        if need <= room:
            return L, need, room, fixed + L * per_layer
    raise AssertionError(f"the host cannot hold 20 layers of f32 state "
                         f"({room:.1f} GiB free)")


def offload_full_depth_phase(dev, batch):
    """Mistral-7B at full depth through both offload backends, 3 steps each
    on one fixed batch: losses finite and falling, flash launches 2·L·gas /
    L·gas / L·gas a step, peak device memory under 80 GiB; then one more
    step under torch.profiler for the split into device, transfer and host
    optimizer."""
    import dataclasses

    from deepspeed_tpu_torch.models import mistral_7b
    from deepspeed_tpu_torch.ops import flash_attention as fa

    base = mistral_7b()
    L, need, room, n_params = full_depth_layers(base)
    cfg = dataclasses.replace(base, num_layers=L)
    log(f"offload full depth: L={L} of {base.num_layers}, "
        f"{n_params / 1e9:.3f} B params; host state {need:.1f} GiB of "
        f"{room:.1f} GiB the host can give (MemTotal "
        f"{meminfo_gib('MemTotal'):.1f}, MemAvailable "
        f"{meminfo_gib('MemAvailable'):.1f}, RSS {host_rss_gib():.1f}); "
        f"resident state would be {RESIDENT_BYTES_PER_PARAM} B x "
        f"{n_params / 1e9:.2f} B = "
        f"{RESIDENT_BYTES_PER_PARAM * n_params / 1e9:.0f} GB")
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    want = {"flash_fwd": 3 * 2 * L * OFFLOAD_GAS,
            "flash_bwd_dq": 3 * L * OFFLOAD_GAS,
            "flash_bwd_dkv": 3 * L * OFFLOAD_GAS}
    total = dict.fromkeys(want, 0)
    tokens = OFFLOAD_GAS * TRAIN_B * TRAIN_S
    results = {}
    for label, off in (("legacy", LEGACY), ("tiered", TIERED)):
        for kfn in kernels:
            kfn.launches = 0
        eng, losses, step_s, peak, init_s = offload_run(
            cfg, offload_config(off), batch, 3, f"{label} L={L}")
        launches = {kfn.__name__: kfn.launches for kfn in kernels}
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{label} L={L} losses not finite and "
                                 f"falling: {losses}")
        if launches != want:
            raise AssertionError(f"{label} L={L} launches {launches} != "
                                 f"{want}")
        if peak >= 80.0:
            raise AssertionError(f"{label} L={L} peak device memory "
                                 f"{peak:.2f} GiB >= 80 GiB")
        for k in total:
            total[k] += launches[k]
        med = statistics.median(step_s[1:])
        log(f"offload {label} L={L}: median step {med * 1e3:.0f} ms = "
            f"{tokens / med:.0f} tokens/s ({tokens} tokens/step); launches "
            f"{launches}; peak device {peak:.2f} GiB")
        # the split of one more step: torch.profiler where it records the
        # card, and the engine's and the tier's CUDA events in any case
        _, wall, kern = profiled(lambda: eng.train_batch(batch=batch))
        st, t = eng.step_timings(), eng.host_opt.timings
        copy_ms = sum(v for k, (v, _) in kern.items() if "Memcpy" in k)
        dev_ms = sum(v for k, (v, _) in kern.items()
                     if "Memcpy" not in k and "Memset" not in k)
        log(f"profile {label} L={L} step: wall {wall:.0f} ms; by events: "
            f"forward+backward {st.get('grads_ms', 0.0):.0f} ms, update "
            f"{st.get('update_ms', 0.0):.0f} ms, of which host optimizer "
            f"{t.get('host_opt_ms', 0.0):.0f} ms; H2D "
            f"{t.get('h2d_ms', 0.0):.0f} ms, D2H {t.get('d2h_ms', 0.0):.0f} "
            f"ms on the copy streams; profiler: " + (
                f"device kernels {dev_ms:.0f} ms, copies {copy_ms:.0f} ms"
                if kern else "recorded no device event"))
        for k, (tt, c) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:5]:
            log(f"   {tt:.1f} ms {c}x  {k[:90]}")
        results[label] = {"step_ms": med * 1e3, "peak_gib": peak,
                          "init_s": init_s}
        free_engine(eng)
        del eng
        log(f"offload {label} L={L} freed: host RSS {host_rss_gib():.1f} "
            f"GiB, device allocated "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    return total


def nvme_phase(dev, cfg, batch):
    """The NVMe tier at 2 layers: 2 steps, losses equal to the RAM tier's
    (rtol 1e-5), swap bytes and seconds; the swap files removed."""
    swap_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "nvme_swap")
    nvme = {"device": "nvme", "nvme_path": swap_root}
    cpu, c_loss, *_ = offload_run(cfg, offload_config(LEGACY), batch, 2,
                                  "legacy (RAM) L=2")
    free_engine(cpu)
    del cpu
    eng, n_loss, n_s, *_ = offload_run(
        cfg, offload_config(nvme, aio={"thread_count": 8}), batch, 2,
        "legacy (NVMe) L=2")
    ho = eng.host_opt
    if not np.allclose(n_loss, c_loss, rtol=1e-5):
        raise AssertionError(f"NVMe losses {n_loss} != RAM tier {c_loss}")
    files = sum(len(fs) for _, _, fs in os.walk(ho.swap_dir))
    log(f"offload NVMe L=2: losses equal the RAM tier's within 1e-5 "
        f"({n_loss} vs {c_loss}); {files} swap files under {ho.swap_dir}, "
        f"{ho.swap_bytes / 1e9:.2f} GB moved in {ho.swap_seconds:.1f} s "
        f"({ho.swap_bytes / max(ho.swap_seconds, 1e-9) / 1e9:.2f} GB/s, "
        f"init included)")
    swap_dir = ho.swap_dir
    free_engine(eng)
    if os.path.exists(swap_dir):
        raise AssertionError(f"swap files left at {swap_dir}")
    shutil.rmtree(swap_root, ignore_errors=True)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def checkpoint_phase(dev, cfg, batch):
    """Save after 2 steps, load into a fresh engine of other weights: its
    next loss bit-identical to the saving engine's, resident and tiered;
    then the v1 engine from the checkpoint against params= on the same
    weights (prefill logits torch.equal)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "ckpt_smoke")
    nxt = {"input_ids": np.random.default_rng(9).integers(
        0, cfg.vocab_size, (OFFLOAD_GAS, TRAIN_B, TRAIN_S))}
    for label, off in (("resident", None), ("tiered", TIERED)):
        path = os.path.join(root, label)
        src, *_ = offload_run(cfg, offload_config(off), batch, 2,
                              f"{label} L=2 (to save)")
        t0 = time.perf_counter()
        src.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        nbytes = dir_bytes(path)
        ref = src.train_batch(batch=nxt)
        free_engine(src)
        del src
        dst, *_ = offload_run(cfg, offload_config(off), batch, 0,
                              f"{label} L=2 (to load)", seed=1)
        t0 = time.perf_counter()
        dst.load_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if label == "resident":
            model = TransformerLM(cfg)
            ids = np.random.default_rng(10).integers(0, cfg.vocab_size,
                                                     (1, 512))
            icfg = {"dtype": "bfloat16", "max_out_tokens": 1024}
            v1_ck = deepspeed_tpu_torch.init_inference(
                model, config=dict(icfg, checkpoint=path))
            a = v1_ck.forward(ids)
            del v1_ck
            v1_p = deepspeed_tpu_torch.init_inference(
                model, config=icfg, params=dst.params)
            b = v1_p.forward(ids)
            del v1_p
            if not torch.equal(a, b):
                raise AssertionError("v1 logits from the checkpoint differ "
                                     "from params=")
            log(f"checkpoint: v1 init_inference(checkpoint=) prefill logits "
                f"[1, 512, {cfg.vocab_size}] torch.equal to params=")
            del a, b
        got = dst.train_batch(batch=nxt)
        if got != ref:
            raise AssertionError(f"{label}: resumed loss {got} != "
                                 f"uninterrupted {ref}")
        log(f"checkpoint {label} L=2: save {save_s:.1f}s, load {load_s:.1f}s, "
            f"{nbytes / 1e9:.2f} GB ({nbytes / save_s / 1e9:.2f} GB/s "
            f"written); resumed loss {got:.6f} == uninterrupted {ref:.6f}")
        free_engine(dst)
        del dst
        shutil.rmtree(path)
    shutil.rmtree(root, ignore_errors=True)


def offload_phase(dev):
    """Phase 8b: host ops, the three engines at 4 layers, both offload
    backends at full depth, the NVMe tier and checkpoints at 2 layers.
    Returns (flash launches of the full-depth runs, the host_ops record)."""
    import dataclasses

    from deepspeed_tpu_torch.models import mistral_7b

    host = host_ops_phase()
    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(0, mistral_7b().vocab_size,
                                       (OFFLOAD_GAS, TRAIN_B, TRAIN_S))}
    t0 = time.perf_counter()
    offload_width_phase(dev, dataclasses.replace(mistral_7b(), num_layers=4),
                        batch)
    log(f"offload L=4 phase: {time.perf_counter() - t0:.0f}s")
    t0 = time.perf_counter()
    launches = offload_full_depth_phase(dev, batch)
    log(f"offload full-depth phase: {time.perf_counter() - t0:.0f}s")
    two = dataclasses.replace(mistral_7b(), num_layers=2)
    t0 = time.perf_counter()
    nvme_phase(dev, two, batch)
    log(f"offload NVMe phase: {time.perf_counter() - t0:.0f}s")
    t0 = time.perf_counter()
    checkpoint_phase(dev, two, batch)
    log(f"checkpoint phase: {time.perf_counter() - t0:.0f}s")
    return launches, host


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch.ops.op_builder import cuda as cuda_build

    dev = torch.device("cuda", 0)
    card = device_line()
    log(f"device: {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f}s "
        f"(nvcc {cuda_build.build_seconds:.1f}s) into "
        f"{cuda_build.BUILD_ROOT}")
    for name, text in sorted(cuda_build.build_logs.items()):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", text))
        if regs:
            log(f"  ptxas {name}: {len(regs)} kernels, {min(regs)}-"
                f"{max(regs)} registers, {spills} bytes spilled")

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    results = kernel_phases(dev, flush)
    results.update(flash_phases(dev, flush))
    results.update(sparse_phases(dev, flush))
    results.update(woq_kernel_phases(dev, flush))
    rms_launches = results["rms_norm"].pop("launches")
    del flush
    if "--kernels-only" in sys.argv:
        return 0    # a build-and-compare run; no result line
    small_fp32_check(dev)
    small_woq_check(dev)
    launches = serve_phase(dev)
    launches["rms_norm"] = rms_launches
    gc.collect()
    torch.cuda.empty_cache()    # the serving engine is gone
    small_train_check(dev)
    launches.update(train_phase(dev))
    gc.collect()
    torch.cuda.empty_cache()    # the training engine is gone
    t0 = time.perf_counter()
    offload_launches, host_ops = offload_phase(dev)
    log(f"phase 8b: {time.perf_counter() - t0:.0f}s; flash launches of the "
        f"full-depth runs {offload_launches}")
    for k, n in offload_launches.items():
        launches[k] += n
    launches.update(sparse_op_phase(dev))

    sources = {"paged_attention": ("deepspeed_tpu_torch/csrc/"
                                   "paged_attention.cu",
                                   "deepspeed_tpu/inference/v2/kernels/"
                                   "paged_attention.py:260"),
               "ragged_attention": ("deepspeed_tpu_torch/csrc/"
                                    "ragged_attention.cu",
                                    "deepspeed_tpu/inference/v2/kernels/"
                                    "ragged_attention.py:234"),
               "paged_attention_q8": ("deepspeed_tpu_torch/csrc/"
                                      "paged_attention.cu",
                                      "deepspeed_tpu/inference/v2/kernels/"
                                      "paged_attention.py:175"),
               "ragged_attention_q8": ("deepspeed_tpu_torch/csrc/"
                                       "ragged_attention.cu",
                                       "deepspeed_tpu/inference/v2/kernels/"
                                       "ragged_attention.py:150"),
               "dense_decode_attention": ("deepspeed_tpu_torch/csrc/"
                                          "dense_decode_attention.cu",
                                          "deepspeed_tpu/ops/"
                                          "decode_attention.py:35"),
               "flash_fwd": (FLASH_SRC,
                             "deepspeed_tpu/ops/flash_attention.py:63"),
               "flash_bwd_dq": (FLASH_SRC,
                                "deepspeed_tpu/ops/flash_attention.py:155"),
               "flash_bwd_dkv": (FLASH_SRC,
                                 "deepspeed_tpu/ops/flash_attention.py:196"),
               "sparse_fwd": (SPARSE_SRC,
                              "deepspeed_tpu/ops/sparse_kernels.py:105"),
               "sparse_bwd_dq": (SPARSE_SRC,
                                 "deepspeed_tpu/ops/sparse_kernels.py:190"),
               "sparse_bwd_dkv": (SPARSE_SRC,
                                  "deepspeed_tpu/ops/sparse_kernels.py:222"),
               "quantize_blocks": (QUANT_SRC, "deepspeed_tpu/ops/"
                                   "quantizer_kernels.py:28"),
               "dequantize_blocks": (QUANT_SRC, "deepspeed_tpu/ops/"
                                     "quantizer_kernels.py:37"),
               "rms_norm": ("deepspeed_tpu_torch/csrc/rms_norm.cu",
                            "deepspeed_tpu/ops/norms.py:23")}
    kernels = []
    for name, r in results.items():
        src, replaces = sources[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(card)
    print(json.dumps(host_ops))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

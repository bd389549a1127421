#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (deepspeed_tpu_torch) runs on an
NVIDIA GPU: builds the hand-written kernels from this checkout, holds each
against its plain PyTorch version at the shapes of the main paths, serves
full-width Mistral-7B (seeded random weights) through ``pipeline()`` and
``generate()``, trains full-width Mistral-7B at 4 layers through
``initialize()`` and ``train_batch()``, and checks that both paths ran
through the kernels.

    python3 chip_smoke.py            # needs one CUDA card; exit 0 = ok
    python3 chip_smoke.py --kernels-only   # phases 1-3 only, no result

Phases, in the order they run (each raises on failure, so the run cannot
exit 0):

1. device line: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, kernel build seconds and ptxas resource lines;
2. serving kernel phases at nh 32, kvh 8, hd 128, bs 64, bf16: paged
   decode and a mixed ragged batch against their plain versions (max
   |diff| <= 1e-2: one bf16 rounding of an output of magnitude ~1 is
   <= 2**-8 relative, plus f32 reordering), padding outputs exactly 0,
   and a pure-decode ragged batch bit-equal to the decode kernel; fp32
   (2e-5) and fp16 (1e-2) on the same inputs; times (CUDA events,
   medians, L2 flushed before each launch), bound and library yardstick;
3. flash kernel phases at Mistral-7B training geometry (B 2, nh 32, kvh
   8, hd 128, S 2048, bf16, causal): flash_fwd, flash_bwd_dq and
   flash_bwd_dkv against their plain versions (o within 1e-2 absolute,
   lse within 1e-3, the gradients within 2e-2 of max |plain|: bf16 casts
   of p and ds at other points of the summation), also at Sq 1024 < Skv
   2048, non-causal, and in fp32 (1e-4 absolute / relative: f32
   reordering over 2048 keys) and fp16 (as bf16) on the same inputs; a
   repeated backward bit-identical; times, the operations bound at 989
   TFLOP/s and the library yardstick (scaled_dot_product_attention
   forward, and its autograd backward for the dq + dkv pair);
4. a small fp32 serve check: tiny model, kernel engine vs plain engine,
   put() logits within 1e-4 and generate() streams equal;
5. serve: Mistral-7B, 32 layers, bf16, pipeline() answers 8 requests
   (prompts 128-1024 tokens, 64 new tokens, greedy) and generate() runs
   them with decode_window 8; launch counts must equal 32 x steps, one
   host sync per window, identical streams on a repeat, finite logits;
   the put() logits of the kernels against the plain versions in bf16
   and against an fp32 engine (informational); the device time, busy
   share and top kernels of one ragged step and of one fused decode
   window (torch.profiler over generate()); then the serving engine is
   freed;
6. a small fp32 training check: a tiny model (hd 64, flash from S 128)
   trained 3 steps by a kernel engine and by a use_flash=False engine on
   the same weights, losses within 1e-5;
7. train: Mistral-7B width at 4 layers (of 32: the fp32 master and Adam
   state of all 32 would not fit one card), bf16 over an fp32 master,
   AdamW lr 3e-4, clip 1.0, micro 2 x gas 2 x S 2048, through
   initialize() and train_batch(): five steps and one eval_batch on one
   fixed batch; losses finite and falling, and a fresh random batch's
   loss above ln(V) / 2 (no leak through the causal mask); launch counts
   2 x L x gas (forward, with the remat recompute) and L x gas (dq, dkv)
   per step, plus L x gas forwards for the eval; step time, tokens/s,
   peak memory, and the device time, busy share and top kernels of one
   more step (torch.profiler);
8. the kernels JSON line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Everything it builds goes under build/ of the checkout. It imports nothing
of JAX and nothing of the JAX package.
"""

import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
TOL = 1e-2

NH, KVH, HD, BS = 32, 8, 128, 64   # Mistral-7B attention geometry
TRAIN_B, TRAIN_S = 2, 2048         # micro-batch rows x sequence (train)
FLASH_SRC = "deepspeed_tpu_torch/csrc/flash_attention.cu"


def log(msg):
    print(msg, flush=True)


def time_ms(fn, flush, reps=20, warmup=3):
    """Median CUDA-event time of one call, with the 50 MB L2 flushed before
    every launch (each layer of the serving path reads its own pool slice
    cold)."""
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
    return statistics.median(times)


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def device_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------
def make_pool(gen, n_pages, dev):
    shape = (n_pages, BS, KVH, HD)
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
    R, mb = tables.shape
    ctx = mb * BS
    k = k_cache[tables.long()].reshape(R, ctx, KVH, HD).transpose(1, 2)
    v = v_cache[tables.long()].reshape(R, ctx, KVH, HD).transpose(1, 2)
    mask = (torch.arange(ctx, device=q_rows.device)[None, None, None, :]
            < q_lens[:, None, :, None])
    return torch.nn.functional.scaled_dot_product_attention(
        q_rows, k, v, attn_mask=mask, enable_gqa=True)


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
        paged_attention, paged_attention_plain)
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
    q_lens = lengths[:, None]
    results["paged_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: paged_attention(q, k_cache, v_cache, tables,
                                           lengths), flush),
        plain_ms=time_ms(lambda: paged_attention_plain(
            q, k_cache, v_cache, tables, lengths), flush, reps=5),
        library_ms=time_ms(lambda: library_attention(
            q[:, :, None], k_cache, v_cache, tables, q_lens),
            flush),
        bound_ms=b_ms, bound_by=b_by)

    # -- pure decode through the ragged kernel: bit-equal ------------------
    rag_dec = ragged_attention(q, k_cache, v_cache,
                               torch.arange(N, dtype=torch.int32, device=dev),
                               lengths, tables)
    torch.cuda.synchronize()
    if not torch.equal(rag_dec, out):
        diff = (rag_dec.float() - out.float()).abs().max().item()
        raise AssertionError(f"pure-decode ragged batch is not bit-equal "
                             f"to the decode kernel (max diff {diff})")
    log("ragged_attention pure-decode batch: bit-equal to paged_attention")

    # -- ragged mixed batch ------------------------------------------------
    # row 0: 512-token prefill chunk (positions 0..511); row 1: a
    # 96-token continuation (positions 704..799); rows 2..7: decode rows
    rows_pos = [list(range(512)), list(range(704, 800))] + [
        [n - 1] for n in (1, 100, 640, 1000, 1536, 2048)]
    ctx_lens = [p[-1] + 1 for p in rows_pos]
    n_pages = 1 + sum(-(-n // BS) for n in ctx_lens) + 64
    k_cache, v_cache = make_pool(gen, n_pages, dev)
    tables = torch.as_tensor(tables_for(rng, ctx_lens, n_pages, mb),
                             device=dev)
    row_ids = np.concatenate([[r] * len(p) for r, p in enumerate(rows_pos)])
    tok_lens = np.concatenate([np.asarray(p) + 1 for p in rows_pos])
    n_tok = len(row_ids)
    T = 1 << (n_tok - 1).bit_length()
    row_ids = np.pad(row_ids, (0, T - n_tok)).astype(np.int32)
    tok_lens = np.pad(tok_lens, (0, T - n_tok)).astype(np.int32)
    row_ids_t = torch.as_tensor(row_ids, device=dev)
    tok_lens_t = torch.as_tensor(tok_lens, device=dev)
    q = torch.randn((T, NH, HD), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    out = ragged_attention(q, k_cache, v_cache, row_ids_t, tok_lens_t,
                           tables)
    ref = ragged_attention_plain(q, k_cache, v_cache, row_ids_t, tok_lens_t,
                                 tables)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    pad_zero = bool((out[n_tok:] == 0).all().item())
    log(f"ragged_attention: T={T} ({n_tok} valid: 512 prefill + 96 "
        f"continuation + 6 decode) max_abs_err={err:.3e} "
        f"padding_exact_zero={pad_zero}")
    if not (err <= TOL and pad_zero and torch.isfinite(out).all()):
        raise AssertionError(f"ragged_attention disagrees with its plain "
                             f"version: err {err}, padding zero {pad_zero}")
    # a padding token's output is zeros whatever its q and row id hold:
    # q and row ids are read for the n_tok valid tokens, lengths read and
    # out written for all T; the used table entries once per row
    kv_bytes = 2 * sum(ctx_lens) * KVH * HD * 2
    used_pages = sum(-(-n // BS) for n in ctx_lens)
    io_bytes = ((n_tok + T) * NH * HD * 2 + used_pages * 4
                + (n_tok + T) * 4)
    b_ms, b_by = bound(kv_bytes + io_bytes,
                       4 * int(tok_lens.sum()) * NH * HD)
    other_dtypes("ragged_attention", ragged_attention,
                 ragged_attention_plain, q, k_cache, v_cache, row_ids_t,
                 tok_lens_t, tables)
    # library yardstick: queries grouped per row, [R, nh, Lq, hd]
    Lq = max(len(p) for p in rows_pos)
    qr = torch.zeros((len(rows_pos), NH, Lq, HD), device=dev,
                     dtype=torch.bfloat16)
    ql = torch.zeros((len(rows_pos), Lq), device=dev, dtype=torch.int32)
    start = 0
    for r, p in enumerate(rows_pos):
        qr[r, :, :len(p)] = q[start:start + len(p)].transpose(0, 1)
        ql[r, :len(p)] = torch.as_tensor(np.asarray(p) + 1, device=dev)
        start += len(p)
    results["ragged_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ragged_attention(q, k_cache, v_cache, row_ids_t,
                                            tok_lens_t, tables), flush),
        plain_ms=time_ms(lambda: ragged_attention_plain(
            q, k_cache, v_cache, row_ids_t, tok_lens_t, tables), flush,
            reps=5),
        library_ms=time_ms(lambda: library_attention(
            qr, k_cache, v_cache, tables, ql), flush),
        bound_ms=b_ms, bound_by=b_by)
    for name, r in results.items():
        log(f"{name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) max_abs_err={r['max_abs_err']:.3e}")
    return results


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
    return launches


def profile_phase(eng, prompts, window):
    """Where the serving time goes. torch.profiler over
    generate() with max_new_tokens=1 (one put(): the ragged step) and with
    1 + window (the same put(), then one fused decode window). The window's
    device time and launches are the difference of the two runs; its wall
    time is the second run's after its put() (``last_ttft_s``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(new):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate(prompts, max_new_tokens=new)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 - eng.last_ttft_s * 1e3
        kern = {}   # device-side events only: kernels, memcpy, memset
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0.0) or 0.0
            if e.device_type == DeviceType.CUDA and t > 0:
                kern[e.key] = (t / 1e3, e.count)
        return eng.last_ttft_s * 1e3, wall, kern

    put_wall, _, put_k = run(1)
    _, win_wall, both_k = run(1 + window)
    win_k = {k: (t - put_k.get(k, (0.0, 0))[0], c - put_k.get(k, (0.0, 0))[1])
             for k, (t, c) in both_k.items()}
    n_tok = sum(map(len, prompts))
    for name, wall, kern, steps in (
            (f"ragged step ({n_tok} tokens)", put_wall, put_k, 1),
            (f"decode window (per step, {len(prompts)} rows)",
             win_wall, win_k, window)):
        dev_ms = sum(t for t, _ in kern.values())
        log(f"profile {name}: wall {wall / steps:.2f} ms/step, device "
            f"{dev_ms / steps:.2f} ms/step, busy {dev_ms / wall:.3f}, "
            f"launches/step {sum(c for _, c in kern.values()) / steps:.0f}")
        for k, (t, c) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]:
            log(f"   {t / steps:.3f} ms/step {c / steps:.0f}x  {k[:90]}")


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


def flash_check(fa, name, q, k, v, do, causal, tol_o, tol_g):
    """Holds the three kernels against their plain versions; returns the
    errors (o absolute, grads relative to max |plain|)."""
    (o, o_p), (lse, lse_p), *grads, _ = flash_run(fa, q, k, v, do, causal)
    err_o = (o.float() - o_p.float()).abs().max().item()
    err_lse = (lse - lse_p).abs().max().item()
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
        raise AssertionError(f"{name}: a flash kernel disagrees with its "
                             f"plain version: o {err_o}, lse {err_lse}, "
                             f"grads {err_g}")
    return err_o, err_g


def flash_phases(dev, flush):
    from deepspeed_tpu_torch.ops import flash_attention as fa

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

    # a repeated backward is bit-identical (no atomics)
    *_, (lse, delta) = flash_run(fa, q, k, v, do, True)
    scale = 1.0 / HD ** 0.5
    runs = [(fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, True),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True))
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("a repeated flash backward is not bit-identical")
    log("flash backward repeated: bit-identical")

    # times at the training shape; the yardstick is never called by the port
    q4 = q.view(TRAIN_B, NH, S, HD)
    k4, v4 = k.view(TRAIN_B, KVH, S, HD), v.view(TRAIN_B, KVH, S, HD)
    do4 = do.view(TRAIN_B, NH, S, HD)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    lib_out = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)

    def lib_bwd():
        torch.autograd.grad(lib_out, (qg, kg, vg), do4, retain_graph=True)

    lib_bwd_ms = time_ms(lib_bwd, flush)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, True),
                      lambda: fa.flash_fwd_plain(q, k, v, scale, True),
                      lambda: sdpa(q4, k4, v4, is_causal=True,
                                   enable_gqa=True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                 scale, True),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse,
                                                       delta, scale, True),
                         None),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                   scale, True),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                         delta, scale, True),
                          None),
    }
    work = flash_work(bh, bhk, S, S, True, 2)
    errs = {"flash_fwd": err_o, "flash_bwd_dq": err_g["dq"],
            "flash_bwd_dkv": max(err_g["dk"], err_g["dv"])}
    results = {}
    for name, (kern, plain, lib) in calls.items():
        b_ms, b_by = bound(*work[name])
        results[name] = dict(
            max_abs_err=errs[name], ms=time_ms(kern, flush),
            plain_ms=time_ms(plain, flush, reps=3, warmup=1),
            library_ms=time_ms(lib, flush) if lib else lib_bwd_ms,
            bound_ms=b_ms, bound_by=b_by)
        r = results[name]
        log(f"{name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) err={r['max_abs_err']:.3e}")
    log("flash library_ms: forward = scaled_dot_product_attention; the dq "
        "and dkv rows = its autograd backward, which computes the pair")
    return results


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
    """Device time, busy share and top kernels of one train_batch()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        if e.device_type == DeviceType.CUDA and t > 0:
            kern[e.key] = (t / 1e3, e.count)
    dev_ms = sum(t for t, _ in kern.values())
    log(f"profile train step: wall {wall:.2f} ms (profiled), device "
        f"{dev_ms:.2f} ms, busy {dev_ms / wall:.3f}, launches "
        f"{sum(c for _, c in kern.values())}")
    for k, (t, c) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"   {t:.3f} ms {c}x  {k[:90]}")


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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    results = kernel_phases(dev, flush)
    results.update(flash_phases(dev, flush))
    del flush
    if "--kernels-only" in sys.argv:
        return 0    # a build-and-compare run; no result line
    small_fp32_check(dev)
    launches = serve_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()    # the serving engine is gone
    small_train_check(dev)
    launches.update(train_phase(dev))

    sources = {"paged_attention": ("deepspeed_tpu_torch/csrc/"
                                   "paged_attention.cu",
                                   "deepspeed_tpu/inference/v2/kernels/"
                                   "paged_attention.py:260"),
               "ragged_attention": ("deepspeed_tpu_torch/csrc/"
                                    "ragged_attention.cu",
                                    "deepspeed_tpu/inference/v2/kernels/"
                                    "ragged_attention.py:234"),
               "flash_fwd": (FLASH_SRC,
                             "deepspeed_tpu/ops/flash_attention.py:63"),
               "flash_bwd_dq": (FLASH_SRC,
                                "deepspeed_tpu/ops/flash_attention.py:155"),
               "flash_bwd_dkv": (FLASH_SRC,
                                 "deepspeed_tpu/ops/flash_attention.py:196")}
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

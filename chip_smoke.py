#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (deepspeed_tpu_torch) runs on an
NVIDIA GPU: builds the hand-written kernels from this checkout, holds each
against its plain PyTorch version at the shapes of the main paths, serves
full-width Mistral-7B (seeded random weights) through ``pipeline()`` and
``generate()`` over a bf16 and an int8 KV pool, through the serving
runtime (``ServingEngine`` + ``ServingAPI`` over HTTP) and through the v1
``init_inference()`` engine, then with weight-only quantized weights
(int8 and int4 on the v2 engine, int8 on the v1 engine), trains
full-width Mistral-7B at 4 layers
through ``initialize()`` and ``train_batch()`` (and, with telemetry,
diagnostics and the monitor on, under each selective remat policy,
through the forward / backward / step shims and through universal
checkpoints), drives the RLHF hybrid engine (train, publish, generate,
rollout, a PPO learner step, int8 delta publication) at 2 layers and the
multi-LoRA adapter bank over the serving weights, then at 4 layers
through both ZeRO-Offload backends (the host C++ optimizer and the tiered
pinned-memory state, and their deep runs at 2), with the NVMe tier and
checkpoints at 2 layers and LAMB over the tiered state at 4,
trains it at 4 layers under ZeRO stages 1-3 over an NCCL process group
and with the tensor / sequence / MiCS keys at one rank (after checking
the attention kernels at tensor-parallel head counts and ring attention
against them), through the 1F1B pipeline schedule at one stage and as
one middle stage of a 4-stage split of its 32 layers, with the ZeRO++
and quantized-reduce keys and the 1-bit optimizers at one rank (and the
quantized transports at its full width),
with its layer stack and activations offloaded to the host and through
ZeRO-Infinity's per-layer files, serves returning conversations through
the KV spill tier and through the stitched ``ragged_attention="off"``
dispatch, serves Mixtral-8x7B width (8 of 32 layers in bf16, all 32
under WOQ int8) and trains it at 2 layers, runs block-sparse attention
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
   weights, logits within 1e-4 and streams equal; and a tiny top-2 MoE
   model (4 experts): the v2 kernel engine against the plain engine, a
   WOQ int8 engine against the dense engine of its dequantized weights
   (put() logits within 1e-4, streams equal; 79 prompt tokens and the
   decode rows through the grouped expert route), the v1 dense decode
   kernel against the einsum route;
6. serve: Mistral-7B, 32 layers, bf16, pipeline() answers 8 requests
   (prompts 128-1024 tokens, 64 new tokens, greedy) and generate() runs
   them with decode_window 8; launch counts must equal 32 x steps, one
   host sync per window, identical streams on a repeat, finite logits;
   the put() logits of the kernels against the plain versions in bf16
   and against an fp32 engine (informational); the device time, busy
   share and top kernels of one ragged step and of one fused decode
   window, and the paged kernel's ms per decode step (torch.profiler over
   generate()); then phase 2c, the serving runtime on the same engine:
   the 8 prompts (rows 0-3 greedy, 4-7 sampled at temperature 0.8, top_p
   0.95, top_k 50, seeds 1-4), 64 new tokens each, concurrently over HTTP
   (ServingAPI on 127.0.0.1:0 over ServingEngine(eng, ServingConfig())),
   through in-process ServingEngine.submit() and twice through the
   direct DynamicSplitFuseScheduler: every stream 64 tokens in [0, V),
   the two direct runs equal, /healthz 200, /metrics parsed with its
   request and generated-token counters equal to what was streamed, a
   request cancelled after its 8th token freeing its KV blocks (free
   blocks after the drain as before the phase), a burst beyond
   AdmissionConfig(max_pending=2) answered 429 with Retry-After, paged
   and ragged launches = 32 x the engine's decode and ragged steps, the
   sampler's row keys equal on the card and the CPU, sampled generate()
   repeat identical with one host sync per window, top_k=1 equal to
   greedy, each row's window-8 and window-1 sampled streams equal where
   its greedy ones are, the engine's spans in a torch.profiler trace;
   logged: stream agreement with the direct path, window 8 against
   window 1, TTFT and inter-token p50 / p99 over HTTP and in-process, output
   tokens/s of every run beside generate()'s, and the sampled decode
   window's profile and launches against greedy; then, on the same weight
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
   same call, and profiles; then phase 2d, the KV spill tier on the same
   weight tensors: 8 two-turn conversations (turn 1: a 512-token prompt,
   32 new tokens; turn 2: that, its 32 tokens and 64 new ones, 32 new
   tokens), all turn 1s 4 at a time, then the turn 2s, through pools of
   64 blocks under prefix caching with the spill tier's host tier alone
   (1 GiB), with 8 blocks of host tier over a 1 GiB disk tier, without
   spill, and (bf16) through a 128-block pool; then int8 with the host
   tier and without spill: spilled and restored counts above 0, every
   restored block torch.equal to the bytes spilled, bf16 spill
   token-identical to the large pool (int8: turn 1 to the same pool
   without spill; a freed int8 block keeps its scales, as in JAX, so a
   pool of fresh blocks is no reference), the disk tier
   used, /healthz's kv_spill summary claiming every held digest, the
   drain emptying the tier, removing the disk namespace and leaving every
   block free or reclaimable, paged and ragged launches 32 x steps;
   logged: restore ms and bytes a block, turn 2's TTFT with restores,
   with recompute (and in the large pool), the int8 / bf16 bytes a block;
   then phase 2h, the serving fleet on one card: (a) two in-process
   replicas over the same weight tensors behind ReplicaRouter (prefix
   caching on): the 8 prompts greedy, 32 new, routed while a gate holds
   both loops so each replica's first step takes all its requests, every
   stream token-identical to a direct scheduler given that replica's
   requests in one go; 8 requests sharing a 512-token prefix all on one
   replica with prefix hits there; a drain under 4 live streams finishing
   them while the next 4 go to the other replica; every block free or
   held only by the prefix index after; ragged and paged launches 32 x
   steps; (b) disaggregated prefill -> decode through the router over
   the chunked handoff (4 blocks a chunk) on bf16 and int8 pools, 2
   prompts of 384 and 640 tokens, 32 new, each alone on fresh engines (an
   int8 block keeps its scales when freed) with its prefill one put() on
   both sides: token-identical to colocated, the chunks applied as the
   pages predict, launches 32 x steps; logged: bytes a block, ms a chunk
   applied, TTFT disaggregated against colocated; then one 8-chunk
   handoff into a replica decoding another request (a scheduler step
   between every two chunks); (c) a worker process (spawn_worker, python
   -m ...serve.worker, the spec at Mistral-7B width and 2 layers, on the
   same card): its streams (2 prompts of 256 tokens, 32 new)
   token-identical to an in-process engine of the same spec, and
   through POST /handoff from an in-process prefill
   replica, federated /metrics carrying it, the seconds from spawn to
   the ready line; (d) at that width, ReplicaRouter.push_weights over the
   worker and an in-process replica during traffic, a full payload of
   seed-1 weights then an int8 delta to seed-2 weights (one quantize
   launch a leaf, as the bucket plan predicts): no stream dropped,
   weight_version 1 then 2 on both, post-swap streams equal to a fresh
   engine built from the payload, every leaf at its address, the
   reconstruction torch.equal to the publisher's, a corrupt chunk refused
   with the version and leaves untouched; logged: payload bytes,
   serialize and push seconds, weight_update_overlap_steps_total; then
   the worker drains, stops and exits 0. Then phase 8m (d), the
   multi-LoRA bank on the same 32 layers: an engine over the serve
   engine's weight tensors (shared, not copied) with max_lora_adapters 2
   and lora_rank 16, two seeded adapters loaded (B at scale 0.5): base
   rows torch.equal to the bank-less engine in the 8-prompt put() and in
   a decode step, 16-token streams equal; a put() mixing base, A and B
   rows gives each row within the serve put()'s logit gap to the fp32
   engine of that row alone (and the adapter rows move off base); a
   mixed generate(adapter=...); a publish_adapter payload installed
   through apply_payload torch.equal to a direct load_adapter; logged:
   the device ms of the put() and of a decode-window step, bank-less,
   bank on with base rows, and mixed. Then the serving engines are
   freed. Phase 2e runs inside this phase,
   before 2c, on the same engine: the 8 prompts through
   ragged_attention="off" (each its own prefill, on the flash forward
   kernel: 32 launches a prompt), last-token logits within twice the
   ragged step's own gap to the fp32 engine, TTFT of the 8-prompt put in
   turns (on, off, off, on), greedy streams against the ragged ones
   (informational), generate()'s flash and paged launches, and a pair of
   fresh int8-pool engines compared the same way;
2f. Mixtral-8x7B serving (after the Mistral engines are freed): (a) 8 of
   32 layers in bf16 through pipeline() and generate(), the serve phase's
   8 prompts, 64 new tokens, decode_window 8: ragged and paged launches
   8 x steps, one host sync per window, identical streams on a repeat,
   put() logits of the kernel engine within 0.05 x max|plain| of the
   plain bf16 engine's with both engines routed as the plain engine
   routes (top-2 routing is discrete: the free-running gap and the rows
   whose own top-2 differs are logged), TTFT, decode tokens/s, the put's
   and a decode window's device ms and launches, one layer's MoE MLP
   profiled at both shapes (ms, launches, share of the step; no host
   sync in it, under CUDA's sync debug mode); 2g, expert-parallel
   serving's one-rank path on the same engine: the MoE MLP through
   moe_layer_dropless_ep over a one-rank expert group (paged_model's ep
   route; capacity C = k T, nothing dropped), the first 4 prompts, 64 new
   tokens: put() logits within 0.05 x max|grouped| of the grouped-GEMM
   route's on the same engine, the greedy streams' first divergence,
   TTFT and decode tokens/s of both routes, ragged and paged launches,
   one layer's MoE MLP on both routes at the put and decode shapes (CUDA
   events), the dispatch buffer's bytes (E k T H 2) and the peak GiB, and
   the expert products alone at one rank's share of ep 2 / 4 / 8 (E / ep
   experts on ep copies of the capacity); then the v1 engine on the
   same weights (8 x 512, 16 new: 8 x 15 dense decode launches); (b) all
   32 layers under WOQ int8, built a layer at a time (8 x 32 + 2
   quantize launches; the quantizer kernels bit-equal to their plain
   versions on one layer's [8, 4096, 14336] e_gate leaf), resident GiB,
   generate() over the 8 prompts: dequantize launches 8 x 32 per step +
   2 per call or window, one sync per window, TTFT, decode tokens/s,
   dequantize ms a step;
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
   kernels of one more step (torch.profiler), and the host syncs of one
   step (torch's sync debug mode), with telemetry off;
8f. the training surface, on phase 8's model, settings, seed and batch:
   (a) an engine with telemetry, diagnostics (post-mortems on anomaly),
   csv_monitor and memory_breakdown on: its five losses torch.equal to
   phase 8's, the registry's training_loss and training_grad_norm equal
   to each step's, one Train/loss CSV row a step; step ms and host syncs
   against phase 8's; (c) from one saved state, each of
   nothing_saveable, save_attn, save_dots_and_attn,
   dots_with_no_batch_dims_saveable and dots_saveable: loss and
   gradients torch.equal to nothing_saveable's, flash_fwd L x gas a step
   where attn_out is kept (2 x L x gas otherwise), step ms, the step's
   and a forward+backward's peak above the state; (d) forward / backward
   / step over gas 2: master, params and moments torch.equal to
   train_batch's; (b) a NaN in one embedding row: one nan_loss verdict
   naming ``embed`` first, one post-mortem bundle; (e) at 2 layers (the
   fp32 master and moments of 4 layers are 13.5 GB a copy on disk), a
   stage-0 save through ds_to_universal into a stage-3 engine and a
   tiered-offload engine of other weights: the next loss torch.equal to
   the saving engine's; AsyncCheckpointEngine once over the card's layer
   tensors;
8m. the RLHF hybrid engine at Mistral-7B width and 2 layers (the time
   limit), bf16, ZeRO 2, AdamW, through initialize() with
   hybrid_engine.enabled: (a) one train step on [1, 2, 2048], publish(),
   generate() of 4 x 1280-token prompts, 32 new, greedy, token-identical
   to a fresh InferenceEngineV2 built from the payload; another step and
   generate() republishes (weight_version rises); (b) rollout() of 4
   sampled prompts (1100-1500 tokens, temperature 1, seed 7, 32 new):
   every logprob finite and <= 0; a CriticValueHead fit on them and one
   PPOLearner.step (the packed S 2048: the flash route) with a finite
   loss and flash_fwd / dq / dkv launches > 0; (c) publish_delta() as
   the anchor, a train step, publish_delta() again: the int8 delta with
   one quantize launch a leaf, and the colocated engine's put() logits
   torch.equal to a fresh engine of the anchor payload with the delta
   applied; logged: losses, publish s, payload bytes, rollout tokens/s,
   learner step ms, delta bytes and wire ratio (phase 8m (d) runs in the
   serve phase, above);
8g. Mixtral-8x7B width at 2 layers (3.165 B parameters) through
   initialize() / train_batch() at one NCCL rank: ZeRO 1, bf16, AdamW,
   clip 1.0, micro 2 x gas 2 x S 2048, remat, top-2 at capacity 1.0, 3
   steps on one fixed batch: losses finite, the last below the first, aux
   finite, the share of (token, choice) pairs dropped, flash launches 2 x
   L x gas and L x gas a step, step ms, tokens/s, peak GiB; then one
   dropless top-1 step, its loss finite;
8j. 8g's model, weights and batch at ZeRO 1 and ZeRO 3 with
   moe.expert_parallel_size 1, 3 steps each, through the engine's
   per-leaf ZeRO groups (an expert leaf's: the ranks holding its experts,
   here the one rank): losses and every compute and master leaf
   torch.equal to 8g's engine (by bit fingerprint), flash launches 2 x L x
   gas and L x gas a step, step ms, peak GiB (the multi-rank parts of
   ROADMAP A8 run under gloo on the CPU only);
8c. ZeRO over torch.distributed at world 1: comm.init_distributed() with
   no environment (backend nccl and world 1 asserted); on phase 8's model,
   settings, seed and fixed batch, a stage-0 engine, then stages 1, 2 and
   3 (stage3_param_persistence_threshold 0) each with overlap_grad_reduce
   "bucketed" and "off", 3 train_batch() steps each: losses and params
   torch.equal to stage 0's, flash launches 2 x L x gas and L x gas a
   step; the bucket plans, step ms (median of steps 2-3), init s and peak
   memory per engine beside the card's name and power limit; one more
   stage-3 step under torch.profiler, whose NCCL all-gather and
   reduce-scatter calls (at one rank NCCL runs them as device copies) are
   counted with their device ms; the process group destroyed at the end;
8h. tensor / sequence parallelism and the rest of ZeRO on one card:
   (a) the paged (bf16 and int8 pools), ragged (both pools), dense-decode
   and flash fwd / dq / dk-dv kernels at the per-rank head counts tensor
   parallelism gives Mistral-7B / Mixtral width (nh / kvh 16 / 4, 8 / 2,
   4 / 1 at tp 2, 4, 8; hd 128, bf16), and (d) at the counts a padded
   layout of uneven TP would give (12 / 3 at tp 3, 2 / 1 at tp 16, where
   kvh < tp; the layout itself is not built, ROADMAP A8), each
   against its plain version at phase 2's / 3's tolerances, each split
   plan logged; (b) ring attention
   over a one-rank seq group at B 1, nh 32, kvh 8, S 8192, q_chunk =
   kv_chunk = 1024, causal, its output within 1e-2 of the flash kernels'
   (one bf16 step where |o| >= 2) and its gradients within 2e-2 of max
   |flash|, fwd+bwd ms (CUDA events, median) and peak memory of both;
   (c) the engine through initialize() at one NCCL rank on 8c's model,
   settings and batch with tensor_parallel_size / sequence_parallel_size
   / mics_shard_size 1 and reduce_scatter false at stage 3: its 2-step
   losses and params torch.equal to 8c's stage-3 engine, flash launches
   2 x L x gas and L x gas a step, check_engine_sanity clean;
8i. pipeline parallelism on one card: (a) phase 8's model, weights and
   batch (4 layers, bf16, remat, micro 2 x M 2 x S 2048): the engine's
   stage-0 step (run twice, its update skipped) up to its reduced
   gradients, then TransformerLM.loss_and_grads through the 1F1B
   schedule at a pp-1 topology on the same weights and micro-batches:
   the loss within 1e-3 relative, each leaf's gradient within 2e-2 of its
   max |engine| (whether torch.equal is logged), flash launches 2 x L x M
   and L x M (the engine's), ms and peak above the resident state of
   both; (b) stage 1 of a pp-4 split of Mistral-7B's 32 layers (8 layers,
   the replicated embedding, norm and head, 2.007 B parameters, bf16,
   with the f32 master, AdamW moments and gradient accumulator resident):
   the schedule's stage function and backward slot (accumulating into
   buffers like the engine's) on a random incoming activation and
   cotangent, a 7-deep stash of inputs held, forward and backward slot ms
   and the AdamW update ms (CUDA events), peak GiB, the state's bytes,
   outputs finite, and the step time 14 ticks predict at M 8 (labelled a
   prediction for a 4-card run);
8k. quantized communication at one NCCL rank on phase 8's model, settings
   and batch (ROADMAP A10): (a) ZeRO-3 with zero_quantized_weights and
   zero_quantized_gradients, ZeRO-2 with quantized_reduce int8 and fp8
   (overlap_grad_reduce off), 2 steps each: losses and params torch.equal
   to phase 8c's stage-3 / stage-2 "off" engines (the JAX engine
   quantizes nothing at a data-parallel world of 1), no quantizer launch,
   flash launches 2 x L x gas and L x gas a step, step ms beside 8c's;
   hpZ 2 refused with the JAX topology's ValueError; (b) the ZeRO-3
   gather (make_zero3_gather, qwZ and qgZ) forward and backward on every
   stacked leaf of the cell over the one-rank group: outputs and
   gradients equal to the same calls through the plain quantizer (max
   |diff| 0), a repeat bit-identical, the quantizer launches of one
   forward + backward, its ms against the unquantized gather (CUDA
   events, L2 flushed), and the wire bytes 4 ranks would send (computed);
   (c) the int8 and fp8 wire (_quantize_wire / _dequantize_wire) on the
   largest stage-2 gradient bucket: equal to the plain versions (the fp8
   route, plain torch, to the CPU's on 1 M elements), clamped 100- and
   1-element messages, quantize and dequantize ms; (d)
   compressed_allreduce_padded over the cell's flat f32 momentum buffer
   at one rank (ms, peak; a 1 M-element buffer equal to the CPU's
   result), then OneBitAdam, OneBitLamb and ZeroOneAdam (freeze at step
   1, 3 steps, ZeRO 0, no clipping): losses finite and falling, step ms,
   peak GiB, flash launches as above;
8b. offload and checkpoints (the engines of each step freed before the
   next): the host C++ ops built by g++ from csrc/host (seconds logged);
   DeepSpeedCPUAdam with f32 and bf16 gradients, Adagrad and Lion on one
   layer's w_gate (58.7 M f32 elements), 3 steps, against the port's torch
   optimizers on CPU tensors (rtol 1e-5, atol 1e-6), the bf16 copy-back
   equal to round-to-nearest-even of the f32 result, ms a call and GB/s
   beside a CPU copy_ of the same bytes, the CPU model and thread count;
   at 2 layers (``TIER_WIDTH_LAYERS``; 4 before, cut for the run's time
   limit), on the same bf16 weights and fixed batch, 3 steps each of
   the resident (ZeRO 2), tiered (offload_optimizer {device: cpu,
   pin_memory: true}) and legacy ({device: cpu}) engines: tiered equal to
   resident bit for bit (losses, params, master, moments: torch.equal),
   legacy within rtol 0.05, atol 1e-2; then Mistral-7B at 2 layers
   (``DEEP_LAYERS``: earlier versions ran 32, then 12, then 8, then 6,
   then 4 here; cut for the run's time limit), bf16, AdamW, micro 2 x gas 2 x S 2048, remat, through the
   legacy and the tiered engine, 2 steps each (``DEEP_STEPS``; 3 before)
   on one fixed batch: losses finite, the last below
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
8l. LAMB over the tiered tier (inside 8b, after its first engines): the
   train cell at 8b's depth, ZeRO 2, bf16, LAMB lr 3e-4, 3 steps each through
   the resident and the tiered engine on 8b's weights and batch: losses,
   params, master and moments torch.equal (the tiered buckets hold whole
   leaves, each trust ratio the whole leaf's), losses finite and falling,
   flash launches 2 x L x gas and L x gas a step; median step ms and peak
   GiB of both beside 8b's resident and tiered AdamW;
8d. parameter and activation offload on phase 8's model, settings and
   batch at stage 3: at 2 layers (``TIER_WIDTH_LAYERS``; 4 before, cut
   for the run's time limit), offload_param {device: cpu} against the
   resident engine, cpu_checkpointing against it, and offload_param cpu
   with the host C++ optimizer against that optimizer alone (the tiered
   optimizer offload at stage 3 refused, as in JAX), 3 steps each: losses
   and params torch.equal, flash launches 2 x L x gas and L x gas a
   step, the stack in pinned host memory; then offload_param cpu with
   the host C++ optimizer at 2 layers, 2 steps (26 layers, the host's
   cap, and 3 steps, then 12, 8, 6 and 4 layers before; cut for the
   run's time limit): losses
   finite and falling, step ms, tokens/s, peak device GiB beside phase
   8b's 32-layer runs, host RSS, layer copies a step and their exposed
   share;
8e. ZeRO-Infinity (offload_param {device: nvme}) under build/nvme_infinity
   (removed at the end), through the sharded executor over a one-rank data
   group (each layer's pieces gathered before it runs, its gradients
   reduce-scattered: one-rank copies; the files the whole layer): at 2
   layers (``TIER_WIDTH_LAYERS``; 4 before), 2 steps, the optimizer
   state in
   host RAM and on NVMe torch.equal to each other and within rtol 0.05 /
   atol 1e-2 of phase 8d's host-optimizer engine, flash launches as above,
   no layer on the device after init (no stacked leaf among the
   persistent ones, the init's device bytes at most the persistent
   leaves' plus less than one layer), the files removed by close(); then
   at 2 layers (20, where the host capped it, then 12, 8, 6 and 4
   before; cut for the run's time limit), the same init check, 2 steps: losses finite and falling,
   step ms,
   tokens/s, peak device GiB, bytes read from the layer files and their
   rate, each sweep's share waiting on reads, init s and bytes written;
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
   (the flash launches of phases 2e, 8, 8f, 8m, 8g, 8j, 8c, 8h, 8i, 8k,
   8b, 8l, 8d and 8e together, the paged and ragged ones of phases 6, 2e,
   2c, 2d, 2h, 8m, 2f and 2g,
   the dense decode ones of phases 6 and 2f, the quantizer ones of the
   WOQ phases, 2h, 8m, 2f and 8k (b)-(c)), then the last line
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


class PhaseClock:
    """Wall seconds of each phase of the run, logged as each one ends and
    printed together as one ``{"phase_seconds": ...}`` line at the end."""

    def __init__(self):
        self.start = time.perf_counter()
        self.seconds = {}

    def run(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.done(name, t0)
        return out

    def done(self, name, t0):
        """Record phase ``name`` as having run from ``t0`` until now."""
        s = time.perf_counter() - t0
        self.seconds[name] = round(s, 1)
        log(f"[phase {name}: {s:.1f}s; {time.perf_counter() - self.start:.0f}"
            f"s into the run]")


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
def serve_phase(dev, clock):
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
    t0 = t_phase = time.perf_counter()
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
    clock.done("2a", t_phase)
    stitched = clock.run("2e", stitched_serve_phase, dev, cfg, eng, prompts,
                         new, logits, f32, gen)
    greedy_window_launches = clock.run("2a profile", profile_phase, eng,
                                       prompts, eng.decode_window)
    for k, n in clock.run("2c", serving_runtime_phase, cfg, eng, prompts,
                          new, gen, greedy_window_launches).items():
        launches[k] += n
    launches.update(clock.run("2b", q8_serve_phase, dev, cfg, eng, prompts,
                              new, logits, f32))
    v1_launches, v1_ids, v1_out = clock.run("v1", v1_serve_phase, dev, cfg,
                                            eng.params)
    launches.update(v1_launches)
    launches.update(clock.run("woq", woq_serve_phases, dev, cfg, eng,
                              prompts, gen, logits, v1_ids, v1_out))
    for k, n in clock.run("2d", kv_spill_phase, dev, cfg, eng).items():
        launches[k] += n
    for k, n in clock.run("2h", fleet_phase, dev, cfg, eng, prompts,
                          new).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in clock.run("8m (d)", lora_bank_phase, dev, cfg, eng, prompts,
                          float(np.abs(logits - f32).max())).items():
        launches[k] += n
    for k, n in clock.run("2i", spec_phase, dev, cfg, eng, prompts, gen,
                          float(np.abs(logits - f32).max())).items():
        launches[k] = launches.get(k, 0) + n
    launches["paged_attention"] += stitched["paged_attention"]
    launches["flash_fwd"] = stitched["flash_fwd"]
    return launches


# ---------------------------------------------------------------------------
# phase 2i: speculative decoding and the online adapter
# ---------------------------------------------------------------------------
SPEC_K = 4                  # drafted tokens a round
SPEC_LOOKUP_NEW = 32        # (c)'s new tokens
SPEC_Q8_NEW = 32            # (d)'s new tokens
ADAPT_LAYERS = 2            # (e)'s depth (of 32; the time limit)
ADAPT_REQUESTS = 16
ADAPT_NEW = 32


def llama_160m():
    """(b)'s draft: the shapes of the public JackFram/llama-160m config
    (hidden 768, 12 layers, 12 heads without GQA, FFN 3072, vocab 32000,
    RMSNorm eps 1e-6, rotary positions), its max_seq_len raised from 2048
    to the target's 8192, as ``load_draft_model`` requires."""
    from deepspeed_tpu_torch.models import TransformerConfig

    return TransformerConfig(vocab_size=32000, hidden_size=768,
                             intermediate_size=3072, num_layers=12,
                             num_heads=12, num_kv_heads=12, max_seq_len=8192,
                             norm_eps=1e-6)


def attention_counts(reset=False):
    """{kernel row: launches} of the serving attention kernels (rows 1,
    1q, 3, 3q)."""
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import \
        ragged_attention

    if reset:
        for f in (paged_attention, ragged_attention):
            f.launches = 0
            f.q8_launches = 0
    return {"paged_attention": paged_attention.launches,
            "paged_attention_q8": paged_attention.q8_launches,
            "ragged_attention": ragged_attention.launches,
            "ragged_attention_q8": ragged_attention.q8_launches}


def add_counts(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def spec_stats(eng):
    """The engine's speculation counters: (drafted, accepted, miss rounds,
    row rounds), the spec windows and their device loop rounds."""
    from deepspeed_tpu_torch.telemetry import get_registry

    reg = get_registry()
    return np.array([reg.family_total(f"inference_spec_{n}")
                     for n in ("drafted_tokens_total",
                               "accepted_tokens_total",
                               "miss_rounds_total", "window_rounds_total")]
                    + [eng.spec_windows, eng.spec_rounds, eng.decode_steps,
                       eng.ragged_steps], dtype=np.int64)


def all_position_logits(eng, prompts, streams):
    """The target's f32 logits at every position of prompt + stream (the
    stream's last token left out), from ONE fresh ragged step over fresh
    sequences: ``paged_ragged_step`` with every token as a row's output.
    Returns one [len(stream), V] array a row: the logits that pick each
    generated token."""
    from deepspeed_tpu_torch.inference.v2.paged_model import \
        paged_ragged_step
    from deepspeed_tpu_torch.inference.v2.ragged import batch as rbatch

    uids = list(range(5000, 5000 + len(prompts)))
    seqs = [np.asarray(list(p) + list(s[:-1]), np.int64)
            for p, s in zip(prompts, streams)]
    rb = rbatch.pack(list(zip(uids, seqs)), eng.state_manager)
    starts = np.cumsum([0] + [len(s) for s in seqs])
    i32 = eng._i32
    with torch.no_grad():
        logits = paged_ragged_step(
            eng.serve_cfg, eng.params, i32(rb.ids), i32(rb.row_ids),
            i32(rb.positions), i32(rb.lengths), i32(rb.write_blocks),
            i32(rb.write_offsets), i32(rb.block_tables),
            i32(np.arange(starts[-1])), eng.kv_cache, eng.block_size,
            touched_blocks=i32(rb.touched_blocks)).cpu().numpy()
    for u in uids:
        eng.flush(u)
    return [logits[starts[i] + len(p) - 1:starts[i + 1]]
            for i, p in enumerate(prompts)]


def hold_invariant(name, eng, prompts, outs, tol):
    """Every emitted token is the target's argmax at its position, or
    within ``tol`` of the top logit there (a bf16 near-tie): one fresh
    put() over prompt + stream. Returns (argmax share, worst gap)."""
    streams = [o[len(p):] for p, o in zip(prompts, outs)]
    ref = all_position_logits(eng, prompts, streams)
    hits = total = 0
    worst = 0.0
    for r, s in zip(ref, streams):
        if r.shape[0] != len(s) or not np.isfinite(r).all():
            raise AssertionError(f"2i {name}: reference logits of shape "
                                 f"{r.shape} for {len(s)} tokens")
        got = r[np.arange(len(s)), np.asarray(s)]
        gap = r.max(axis=-1) - got
        hits += int((gap == 0).sum())
        total += len(s)
        worst = max(worst, float(gap.max()))
    log(f"2i {name}: every emitted token the target's argmax or within "
        f"{tol:.4f} of it: argmax at {hits}/{total}, worst gap "
        f"{worst:.4f}")
    if worst > tol:
        raise AssertionError(f"2i {name}: an emitted token {worst:.4f} "
                             f"below the target's top logit (tolerance "
                             f"{tol:.4f})")
    return hits / total, worst


def first_call_profiled(eng, attr):
    """Wraps ``eng.<attr>`` so that its first call runs under a card-only
    torch.profiler session; the returned dict gets that call's host ms and
    device events."""
    orig = getattr(eng, attr)
    box = {}

    def wrapped(*a, **kw):
        if box:
            return orig(*a, **kw)
        out, wall, kern = profiled(lambda: orig(*a, **kw))
        box.update(wall=wall, kern=kern, out=out)
        return out

    setattr(eng, attr, wrapped)
    return box


def spec_small_check(dev):
    """2i (a): the tiny fp32 model of ``small_fp32_check`` (2 KV heads)
    on the kernel engine with a 1-layer draft of its vocabulary:
    speculative streams under "ngram", "draft" and "auto" equal the plain
    greedy streams, over repetitive and random prompts, and the spec
    windows launch the paged kernel draft_layers x (spec_k + 1) times and
    the ragged kernel (its f32 page-walk route) target_layers times a
    round."""
    import dataclasses

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerLM, tiny_test

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(tiny_test(), num_kv_heads=2)
    dcfg = dataclasses.replace(cfg, num_layers=1)
    rng = np.random.default_rng(4)
    prompt_sets = {"repetitive": [[5, 9, 17, 23] * 6, [3] + [7, 8, 9] * 7,
                                  list(range(30, 40)) * 3],
                   "random": [list(map(int, rng.integers(1, 255, n)))
                              for n in (21, 34, 9)]}
    counts = {}
    for kind, prompts in prompt_sets.items():
        eng = InferenceEngineV2(
            TransformerLM(cfg), RaggedInferenceEngineConfig.from_dict(
                {"dtype": "float32", "prefill_bucket": 16,
                 "decode_window": 8,
                 "state_manager": {"max_tracked_sequences": 8,
                                   "max_seq_len": 128, "num_blocks": 65,
                                   "block_size": 16}}), device=dev)
        plain = eng.generate(prompts, max_new_tokens=20)
        eng.load_draft_model(TransformerLM(dcfg))
        for mode in ("ngram", "draft", "auto"):
            s0 = spec_stats(eng)
            attention_counts(reset=True)
            out = eng.generate(prompts, max_new_tokens=20, speculative=True,
                               spec_k=SPEC_K, spec_mode=mode)
            got = attention_counts()
            d = spec_stats(eng) - s0
            add_counts(counts, got)
            same = all(np.array_equal(a, b) for a, b in zip(out, plain))
            want_paged = (dcfg.num_layers * (SPEC_K + 1) * int(d[5])
                          + cfg.num_layers * int(d[6]))
            want_ragged = cfg.num_layers * (int(d[5]) + int(d[7]))
            log(f"2i (a) fp32 {kind} {mode}: streams equal to plain greedy "
                f"{same}; drafted/accepted/miss/rounds {d[:4].tolist()}, "
                f"{d[4]} spec windows of {d[5]} loop rounds, {d[6]} plain "
                f"decode steps; launches {got} (paged want {want_paged}, "
                f"ragged want {want_ragged})")
            if not same:
                raise AssertionError(f"2i (a) {kind} {mode}: speculative "
                                     f"streams differ from plain greedy")
            if got["paged_attention"] != want_paged or \
                    got["ragged_attention"] != want_ragged:
                raise AssertionError(f"2i (a) {kind} {mode}: launches "
                                     f"{got} != paged {want_paged}, ragged "
                                     f"{want_ragged}")
            if mode == "draft" and d[5] == 0:
                raise AssertionError("2i (a): no spec window ran")
    return counts


def spec_full_width(dev, cfg, eng, prompts, gen, tol):
    """2i (b)-(d) over the serve cell's 32-layer weight tensors (shared):
    (b) the llama-160m-shaped draft and a self-draft on the serve cell's
    8 prompts; (c) prompt lookup on repeated spans under "auto"; (d) an
    int8 target pool with a self-draft. Returns the launches of the
    speculative generate() calls."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.serve import weights as sw
    from deepspeed_tpu_torch.models import TransformerLM

    new = len(gen[0]) - len(prompts[0])
    counts = {}

    def engine(**extra):
        e = InferenceEngineV2(
            TransformerLM(cfg), RaggedInferenceEngineConfig.from_dict(
                dict({"dtype": "bfloat16",
                      "decode_window": eng.decode_window,
                      "state_manager": {"max_ragged_batch_size": 8192}},
                     **extra)), params=eng.params, device=dev)
        if not all(a.data_ptr() == b.data_ptr() for (_, a), (_, b) in zip(
                sw.flatten_params(e.params), sw.flatten_params(eng.params))):
            raise AssertionError("2i: the engine copied the weights")
        return e

    def spec_run(e, name, ps, n, mode="draft", **kw):
        s0 = spec_stats(e)
        attention_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = e.generate(ps, max_new_tokens=n, speculative=True,
                         spec_k=SPEC_K, spec_mode=mode, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = attention_counts()
        add_counts(counts, got)
        d = spec_stats(e) - s0
        log(f"2i {name}: {secs:.2f}s, {len(ps) * n / secs:.1f} tokens/s; "
            f"drafted/accepted/miss rounds/row rounds {d[:4].tolist()} "
            f"(accept rate {d[1] / max(d[0], 1):.3f}), {d[4]} spec "
            f"windows of {d[5]} loop rounds, {d[6]} plain decode steps; "
            f"launches {got}")
        for o, p in zip(out, ps):
            if len(o) != len(p) + n or not ((o >= 0) & (o < cfg.vocab_size)
                                            ).all():
                raise AssertionError(f"2i {name}: a row did not get its "
                                     f"{n} tokens in [0, vocab)")
        return out, secs, d

    def divergence(name, outs, ref, ps):
        firsts = [first_divergence(o[len(p):], g[len(p):])
                  for o, g, p in zip(outs, ref, ps)]
        log(f"2i {name}: first divergence from plain greedy per row "
            f"{firsts} (None = equal; bf16 near-ties, informational)")

    # -- (b) the llama-160m-shaped draft ---------------------------------
    target = engine()
    target.load_draft_model(TransformerLM(llama_160m()))
    K = target.decode_window
    # one spec window's device time: the first window of a short run
    # (card-only profile of the window alone; the draft's catch-up of the
    # prompts runs before it)
    box = first_call_profiled(target, "_spec_window_fn")
    target.generate(prompts, max_new_tokens=1 + K, speculative=True,
                    spec_k=SPEC_K, spec_mode="draft")
    spec_k = box["kern"]
    log_profile("2i (b) one spec window (llama-160m draft)", box["wall"],
                spec_k)
    # speculative against plain in turns: plain, spec, spec, plain; the
    # first spec run is the one counted and held
    times = {"plain": [], "spec": []}
    out = None
    for which in ("plain", "spec", "spec", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "plain":
            target.generate(prompts, max_new_tokens=new)
        else:
            o, _, _ = spec_run(target, "(b) llama-160m draft", prompts, new)
            out = o if out is None else out
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t0)
    tps = {k: len(prompts) * new / statistics.median(v)
           for k, v in times.items()}
    divergence("(b) llama-160m draft", out, gen, prompts)
    hold_invariant("(b) llama-160m draft", target, prompts, out, tol)
    # one plain window's device time: generate() of 1 + K tokens less
    # generate() of 1 (card-only profiles)
    _, _, put_k = profiled(
        lambda: target.generate(prompts, max_new_tokens=1))
    _, _, both_k = profiled(
        lambda: target.generate(prompts, max_new_tokens=1 + K))
    win_k = minus(both_k, put_k)
    log(f"2i (b): tokens/s speculative {tps['spec']:.1f} against plain "
        f"{tps['plain']:.1f} (in turns, medians of 2); one spec window "
        f"{sum(t for t, _ in spec_k.values()):.2f} device ms, "
        f"{sum(c for _, c in spec_k.values())} launches, "
        f"{box['out'][2]} rounds, "
        f"{int((box['out'][0] >= 0).sum().item())} tokens over its "
        f"{len(prompts)} rows; one plain window "
        f"{sum(t for t, _ in win_k.values()):.2f} device ms, "
        f"{sum(c for _, c in win_k.values())} launches, {K * len(prompts)} "
        f"tokens")
    # -- (b) the self-draft: the target's own tensors on its own pool ----
    target.load_draft_model(TransformerLM(cfg), eng.params)
    out, _, d = spec_run(target, "(b) self-draft", prompts, new)
    divergence("(b) self-draft", out, gen, prompts)
    hold_invariant("(b) self-draft", target, prompts, out, tol)
    # -- (c) prompt lookup on repeated spans, routed by "auto" -----------
    rng = np.random.default_rng(9)
    spans = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
             for n in (16, 24, 32, 48)]
    lookup = [(s * (512 // len(s) + 1))[:512] for s in spans]
    target.load_draft_model(TransformerLM(llama_160m()))
    reg_mode = target._m_spec_mode_requests
    before = {m: reg_mode.labels(mode=m).value for m in ("ngram", "draft")}
    out, _, d = spec_run(target, "(c) prompt lookup, auto", lookup,
                         SPEC_LOOKUP_NEW, mode=None)
    routes = {m: reg_mode.labels(mode=m).value - before[m]
              for m in before}
    log(f"2i (c): the chooser routed {routes} (cold start: a prompt whose "
        f"trailing n-gram recurs goes to prompt lookup)")
    # seeded weights need not continue a repeated span, so a round may
    # find no recurring tail to draft from: drafting is logged, not held
    if routes["ngram"] == 0:
        raise AssertionError(f"2i (c): prompt lookup took no request "
                             f"({routes})")
    hold_invariant("(c) prompt lookup", target, lookup, out, tol)
    del target
    gc.collect()
    torch.cuda.empty_cache()
    # -- (d) an int8 target pool, self-draft -----------------------------
    q8 = engine(kv_quant=True)
    q8.load_draft_model(TransformerLM(cfg), eng.params)
    ps = prompts[:2]
    out, _, d = spec_run(q8, "(d) int8 pool, self-draft", ps, SPEC_Q8_NEW)
    if counts.get("ragged_attention_q8", 0) == 0:
        raise AssertionError("2i (d): the verify did not run the int8 "
                             "ragged kernel")
    # the int8 pool's own rounding against the bf16 pool widens the bound
    uids = [6000, 6001]
    gap_q8 = float(np.abs(q8.put(uids, ps) - eng.put(uids, ps)).max())
    for e in (q8, eng):
        for u in uids:
            e.flush(u)
    hold_invariant("(d) int8 pool", q8, ps, out, tol + gap_q8)
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def adapter_run(eng, requests, new, autotune):
    """Streams of ``requests`` through one serving runtime over ``eng``
    (all submitted, then drained). With ``autotune`` the adapter runs on
    an injected clock (one second a tick) and a scripted SLO that burns
    for 6 ticks once every request is admitted (a burn sheds new
    requests at the door); returns (streams, adapter moves, ticks)."""
    import asyncio

    from deepspeed_tpu_torch.autotuning import OnlineAdapterConfig
    from deepspeed_tpu_torch.inference.v2 import serve
    from deepspeed_tpu_torch.runtime import tunables

    script = {"ticks": 0, "admitted": False, "burnt": 0}

    class ScriptedSLO:
        def burning(self):
            script["ticks"] += 1
            if script["admitted"] and script["burnt"] < 6:
                script["burnt"] += 1
                return True
            return False

    async def run():
        serving = serve.ServingEngine(eng, serve.ServingConfig(
            autotune=OnlineAdapterConfig(
                interval_s=1.0, hold_ticks=1, restore_ticks=2,
                min_decode_window=2) if autotune else None))
        moves = []
        if autotune:
            adapter = serving.adapter
            clock = {"t": 0.0}

            def tick_clock():
                clock["t"] += 1.0
                return clock["t"]

            adapter.clock = tick_clock
            adapter.slo = ScriptedSLO()
            orig = eng.set_decode_window

            def recorded(window, **kw):
                moves.append((eng.decode_window, int(window)))
                return orig(window, **kw)

            eng.set_decode_window = recorded
        await serving.start()
        streams = [await serving.submit(p, new) for p in requests]
        script["admitted"] = True
        outs = [await s.drain() for s in streams]
        await serving.stop()
        if autotune:
            del eng.set_decode_window
            eng.set_decode_window(8, source="config")
        return outs, moves

    outs, moves = asyncio.run(run())
    window = tunables.REGISTRY.get("serving.decode_window")
    for old, w in moves:
        if w != tunables.clamp("serving.decode_window", w) or \
                w not in tunables.REGISTRY.ladder("serving.decode_window"):
            raise AssertionError(f"2i (e): the adapter moved K {old} -> {w}, "
                                 f"off the clamp {window.range_str()} or "
                                 f"its ladder")
    return outs, moves, script["ticks"]


def spec_adapter_phase(dev, cfg, eng):
    """2i (e): the serving runtime with ``ServingConfig.autotune`` over a
    Mistral-width engine cut to ADAPT_LAYERS layers (views of the serve
    cell's stacked weights), ADAPT_REQUESTS requests."""
    import dataclasses

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerLM

    c2 = dataclasses.replace(cfg, num_layers=ADAPT_LAYERS)
    params = {k: v for k, v in eng.params.items() if k != "layers"}
    params["layers"] = {k: v[:ADAPT_LAYERS]
                        for k, v in eng.params["layers"].items()}
    small = InferenceEngineV2(
        TransformerLM(c2), RaggedInferenceEngineConfig.from_dict(
            {"dtype": "bfloat16", "decode_window": 8,
             "state_manager": {"max_ragged_batch_size": 8192}}),
        params=params, device=dev)
    rng = np.random.default_rng(12)
    requests = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
                for n in rng.integers(64, 384, ADAPT_REQUESTS)]
    attention_counts(reset=True)
    outs, moves, ticks = adapter_run(small, requests, ADAPT_NEW, True)
    counts = attention_counts()
    ref, _, _ = adapter_run(small, requests, ADAPT_NEW, False)
    for o in outs:
        if len(o) != ADAPT_NEW:
            raise AssertionError("2i (e): a request did not complete with "
                                 "its full token count")
    firsts = [first_divergence(a, b) for a, b in zip(outs, ref)]
    log(f"2i (e): the adapter ticked {ticks} times and moved K {moves}; "
        f"all {ADAPT_REQUESTS} requests complete; first divergence from "
        f"autotune off per stream {firsts} (informational); launches "
        f"{counts}")
    if ticks < 1:
        raise AssertionError("2i (e): the adapter never ticked")
    return counts


def spec_phase(dev, cfg, eng, prompts, gen, tol):
    """Phase 2i: speculative decoding (a)-(d) and the online adapter
    (e). Returns the attention launches of its speculative and served
    runs."""
    counts = spec_small_check(dev)
    add_counts(counts, spec_full_width(dev, cfg, eng, prompts, gen, tol))
    add_counts(counts, spec_adapter_phase(dev, cfg, eng))
    return counts


# ---------------------------------------------------------------------------
# phase 2e: the stitched dispatch (ragged_attention="off")
# ---------------------------------------------------------------------------
def timed_put(eng, uids, prompts):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.put(uids, prompts)
    ms = (time.perf_counter() - t0) * 1e3
    for u in uids:
        eng.flush(u)
    return out, ms


def first_divergence(a, b):
    n = min(len(a), len(b))
    diff = np.nonzero(np.asarray(a[:n]) != np.asarray(b[:n]))[0]
    return int(diff[0]) if len(diff) else None


def stitched_serve_phase(dev, cfg, eng, prompts, new, ragged_logits, f32,
                         ragged_gen):
    """Phase 2e on the serve phase's engine: the 8 prompts (128-1024
    tokens: buckets of multiples of 128, so every prefill takes the flash
    kernel) through ragged_attention="off" against the ragged step. The
    last-token logits must agree within twice the ragged path's own gap
    to the fp32 engine on the same prompts: both are bf16 evaluations of
    one function in different rounding orders, each within its bf16
    error of the fp32 value; the tolerance uses the measured error of the
    ragged path, not the stitched one's. Greedy streams and TTFT (put()
    ms, the two modes in turns) are logged, an int8-pool pair of fresh
    engines compared the same way. Returns the flash and paged
    launches."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.ops import flash_attention as fa

    L = cfg.num_layers
    t_phase = time.perf_counter()
    uids = list(range(2000, 2008))
    f0, p0 = fa.flash_fwd.launches, paged_attention.launches
    eng.set_ragged_mode("off")
    off, _ = timed_put(eng, uids, prompts)
    flash_put = fa.flash_fwd.launches - f0
    if flash_put != L * len(prompts):
        raise AssertionError(f"2e: flash_fwd launched {flash_put} times for "
                             f"{len(prompts)} prompts, not {L} x "
                             f"{len(prompts)}")
    ttft = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        eng.set_ragged_mode(mode)
        ttft[mode].append(timed_put(eng, uids, prompts)[1])
    gap = float(np.abs(off - ragged_logits).max())
    err_on = float(np.abs(ragged_logits - f32).max())
    err_off = float(np.abs(off - f32).max())
    agree = float((off.argmax(-1) == ragged_logits.argmax(-1)).mean())
    log(f"2e: put() logits max|off - on| {gap:.4f} (tolerance 2 x "
        f"max|on - fp32| = {2 * err_on:.4f}; max|off - fp32| {err_off:.4f}); "
        f"argmax agreement {agree:.3f}; flash_fwd {flash_put} launches "
        f"for the put (= {L} x {len(prompts)})")
    if not (np.isfinite(off).all() and gap <= 2 * err_on):
        raise AssertionError("2e: stitched put() logits outside the bf16 "
                             "tolerance of the ragged step's")
    log(f"2e: TTFT (the 8-prompt put, ms, in turns on/off/off/on): ragged "
        f"{[f'{x:.1f}' for x in ttft['on']]}, stitched "
        f"{[f'{x:.1f}' for x in ttft['off']]}")
    eng.set_ragged_mode("off")
    f1, p1 = fa.flash_fwd.launches, paged_attention.launches
    d0 = eng.decode_steps
    gen = eng.generate(prompts, max_new_tokens=new)
    eng.set_ragged_mode("auto")
    decode = eng.decode_steps - d0
    flash_gen = fa.flash_fwd.launches - f1
    paged_gen = paged_attention.launches - p1
    if flash_gen != L * len(prompts) or paged_gen != L * decode:
        raise AssertionError(f"2e: generate() launches flash {flash_gen}, "
                             f"paged {paged_gen} for {decode} decode steps")
    same = [np.array_equal(a, b) for a, b in zip(gen, ragged_gen)]
    div = [first_divergence(a[len(p):], b[len(p):])
           for a, b, p in zip(gen, ragged_gen, prompts)]
    log(f"2e: greedy generate() off vs on: {sum(same)}/8 streams equal; "
        f"first divergent token per row {div} (bf16 near-ties part the "
        f"paths; informational); launches flash {flash_gen}, paged "
        f"{paged_gen} = {L} x {decode} decode steps")
    # the int8 pool: two fresh engines on the same weight tensors (a freed
    # int8 block keeps its scales, so each mode gets the same history)
    q8 = {}
    for mode in ("on", "off"):
        e = InferenceEngineV2(TransformerLM(cfg), RaggedInferenceEngineConfig.
                              from_dict({"dtype": "bfloat16",
                                         "kv_quant": True,
                                         "ragged_attention": mode,
                                         "state_manager": {
                                             "max_ragged_batch_size": 8192}}),
                              params=eng.params, device=dev)
        q8[mode] = timed_put(e, uids, prompts)
        del e
    q_gap = float(np.abs(q8["off"][0] - q8["on"][0]).max())
    q_err = float(np.abs(q8["on"][0] - f32).max())
    log(f"2e int8 pool: put() logits max|off - on| {q_gap:.4f} (tolerance "
        f"2 x max|on - fp32| = {2 * q_err:.4f}), argmax agreement "
        f"{float((q8['off'][0].argmax(-1) == q8['on'][0].argmax(-1)).mean()):.3f}; "
        f"TTFT ms ragged {q8['on'][1]:.1f}, stitched {q8['off'][1]:.1f}")
    if not (np.isfinite(q8["off"][0]).all() and q_gap <= 2 * q_err):
        raise AssertionError("2e: int8 stitched put() outside the bf16 "
                             "tolerance")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 2e: {time.perf_counter() - t_phase:.0f}s")
    return {"flash_fwd": fa.flash_fwd.launches - f0,
            "paged_attention": paged_attention.launches - p0}


# ---------------------------------------------------------------------------
# phase 2c: the serving runtime (ServingEngine, admission, loop, HTTP API)
# ---------------------------------------------------------------------------
SERVE_SAMPLED = dict(temperature=0.8, top_p=0.95, top_k=50)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else float("nan")


def prom_samples(text):
    """Prometheus text -> {family-or-sample name: summed value}; raises on
    a line that is not a comment or a ``name{labels} value`` sample."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.fullmatch(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)", line)
        if m is None:
            raise AssertionError(f"/metrics line does not parse: {line!r}")
        out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(3))
    return out


async def http_call(host, port, method, target, payload=None):
    """One HTTP/1.1 request; returns (status, headers, body lines, the
    seconds from send to each body line)."""
    import asyncio
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(payload).encode() if payload is not None else b""
    writer.write((f"{method} {target} HTTP/1.1\r\nHost: smoke\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    lines, times = [], []
    while True:
        line = await reader.readline()
        if not line:
            break
        lines.append(line)
        times.append(time.perf_counter() - t0)
    writer.close()
    return status, headers, lines, times


def latencies(times_per_request):
    """TTFT and inter-token gaps (s) over a run's requests."""
    ttft = [t[0] for t in times_per_request if t]
    itl = [b - a for t in times_per_request for a, b in zip(t, t[1:])]
    return ttft, itl


def log_latencies(name, times_per_request, seconds, n_tokens):
    ttft, itl = latencies(times_per_request)
    log(f"phase 2c {name}: {n_tokens} tokens in {seconds:.2f}s = "
        f"{n_tokens / seconds:.1f} output tokens/s; TTFT p50 "
        f"{pct(ttft, 50) * 1e3:.1f} / p99 {pct(ttft, 99) * 1e3:.1f} ms; "
        f"inter-token p50 {pct(itl, 50) * 1e3:.2f} / p99 "
        f"{pct(itl, 99) * 1e3:.2f} ms")
    return {"tokens_per_s": n_tokens / seconds,
            "ttft_p50_ms": pct(ttft, 50) * 1e3,
            "ttft_p99_ms": pct(ttft, 99) * 1e3,
            "itl_p50_ms": pct(itl, 50) * 1e3,
            "itl_p99_ms": pct(itl, 99) * 1e3}


def check_streams(name, streams, new, vocab):
    for i, toks in enumerate(streams):
        if len(toks) != new or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"phase 2c {name}: request {i} got "
                                 f"{len(toks)} tokens (want {new}) or an "
                                 f"id outside [0, {vocab})")


def serving_runtime_phase(cfg, eng, prompts, new, greedy_gen,
                          greedy_window_launches):
    """Phase 2c: the serving runtime on the bf16 Mistral-7B engine. The 8
    prompts (rows 0-3 greedy, rows 4-7 sampled: temperature 0.8, top_p
    0.95, top_k 50, seeds 1-4), 64 new tokens each, go concurrently over
    HTTP (ServingAPI on 127.0.0.1:0 over ServingEngine(eng,
    ServingConfig())), then through in-process ServingEngine.submit(),
    then twice through the direct DynamicSplitFuseScheduler path. Checks
    (each raises): every stream 64 tokens in [0, V); the two direct runs
    equal; /healthz 200; /metrics parses and its request and generated-
    token counters equal what was streamed; a request cancelled after its
    8th token frees its KV blocks (free blocks after the drain equal those
    before the phase); a burst beyond AdmissionConfig(max_pending=2) gets
    429 with Retry-After; paged and ragged launches over the phase equal
    L x the engine's decode and ragged step counts; generate() sampled
    twice identical, with one host sync per window; top_k=1 equal to the
    greedy generate(); window 8 against window 1: each row's sampled
    streams equal where its greedy ones are; the spans reach
    torch.profiler. Logged: stream agreement with the direct path, the
    window 8 / window 1 counts, TTFT and inter-token p50 / p99, output
    tokens/s beside generate()'s, launches per sampled window against
    greedy. Returns the phase's paged and ragged launches."""
    import asyncio

    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import \
        ragged_attention
    from deepspeed_tpu_torch.inference.v2.sampling import (fold_in_rows,
                                                           prng_key)
    from deepspeed_tpu_torch.inference.v2.serve import (AdmissionConfig,
                                                        ServingAPI,
                                                        ServingConfig,
                                                        ServingEngine)
    from deepspeed_tpu_torch.telemetry import trace

    t_phase = time.perf_counter()
    L, V, n = cfg.num_layers, cfg.vocab_size, len(prompts)
    kws = [{} if i < 4 else dict(SERVE_SAMPLED, seed=i - 3)
           for i in range(n)]
    sm = eng.state_manager
    # the sampler's row keys: the same bits on the card as on the CPU
    rows, gidx = torch.arange(256), torch.arange(256) * 7 + 3
    keys = fold_in_rows(prng_key(7, eng.device), rows.to(eng.device),
                        gidx.to(eng.device)).cpu()
    if not torch.equal(keys, fold_in_rows(prng_key(7), rows, gidx)):
        raise AssertionError("phase 2c: row keys differ between the card "
                             "and the CPU")
    free0 = sm.free_blocks()
    steps0 = dict(ragged=eng.ragged_steps, decode=eng.decode_steps)
    paged_attention.launches = 0
    ragged_attention.launches = 0

    async def serve_runs():
        serving = ServingEngine(eng, ServingConfig())
        await serving.start()
        api = ServingAPI(serving)
        host, port = await api.start()
        _, _, m0, _ = await http_call(host, port, "GET", "/metrics")
        t0 = time.perf_counter()
        http = await asyncio.gather(*[http_call(
            host, port, "POST", "/generate",
            dict(prompt=prompts[i], max_new_tokens=new, **kws[i]))
            for i in range(n)])
        http_s = time.perf_counter() - t0
        health = await http_call(host, port, "GET", "/healthz")
        _, _, m1, _ = await http_call(host, port, "GET", "/metrics")

        async def one(i):
            t0 = time.perf_counter()
            stream = await serving.submit(prompts[i], new, **kws[i])
            times = []
            async for _ in stream:
                times.append(time.perf_counter() - t0)
            return stream.tokens, times
        t0 = time.perf_counter()
        inproc = await asyncio.gather(*[one(i) for i in range(n)])
        inproc_s = time.perf_counter() - t0

        stream = await serving.submit(prompts[-1], new)
        async for _ in stream:
            if len(stream.tokens) == 8:
                await stream.cancel()
        cancelled = (stream.status, len(stream.tokens))
        await api.stop()
        await serving.stop(drain=True)
        return (http, http_s, health, b"".join(m0).decode(),
                b"".join(m1).decode(), inproc, inproc_s, cancelled)

    async def burst():
        serving = ServingEngine(eng, ServingConfig(
            admission=AdmissionConfig(max_pending=2, retry_after_s=1.5)))
        api = ServingAPI(serving)
        host, port = await api.start()
        calls = [asyncio.ensure_future(http_call(
            host, port, "POST", "/generate",
            {"prompt": prompts[0][:16], "max_new_tokens": 4}))
            for _ in range(4)]
        done = []
        while len(done) < 2:            # the two shed at the door
            fin, _ = await asyncio.wait([c for c in calls if c not in done],
                                        return_when=asyncio.FIRST_COMPLETED)
            done.extend(fin)
        shed = [c.result() for c in done]
        await serving.stop(drain=False)  # cancels the two parked
        parked = [await c for c in calls if c not in done]
        await api.stop()
        return shed, parked

    (http, http_s, health, m0, m1, inproc, inproc_s,
     cancelled) = asyncio.run(serve_runs())
    http_streams, http_times = [], []
    for status, headers, lines, times in http:
        if status != 200:
            raise AssertionError(f"phase 2c: /generate answered {status}")
        docs = [json.loads(x) for x in lines]
        toks = [d["token"] for d in docs[:-1]]
        if docs[-1].get("tokens") != toks or \
                docs[-1].get("status") != "completed":
            raise AssertionError(f"phase 2c: NDJSON tail {docs[-1]}")
        http_streams.append(toks)
        http_times.append(times[:-1])
    check_streams("HTTP", http_streams, new, V)
    inproc_streams = [t for t, _ in inproc]
    check_streams("in-process", inproc_streams, new, V)
    if health[0] != 200 or json.loads(health[2][0])["status"] != "ok":
        raise AssertionError(f"phase 2c: /healthz {health[0]}")
    p0, p1 = prom_samples(m0), prom_samples(m1)
    streamed = sum(len(s) for s in http_streams)
    for name, want in (("serving_requests_submitted_total", n),
                       ("serving_requests_finished_total", n),
                       ("serving_generated_tokens_total", streamed)):
        got = p1.get(name, 0.0) - p0.get(name, 0.0)
        if got != want:
            raise AssertionError(f"phase 2c: /metrics {name} moved by "
                                 f"{got}, {want} were streamed")
    if cancelled[0] != "cancelled" or not 8 <= cancelled[1] < new:
        raise AssertionError(f"phase 2c: cancel after 8 tokens: {cancelled}")
    if sm.free_blocks() != free0:
        raise AssertionError(f"phase 2c: {sm.free_blocks()} free KV blocks "
                             f"after the drain, {free0} before")
    log(f"phase 2c: /healthz 200, /metrics parsed ({len(p1)} samples), "
        f"counters = streamed ({n} requests, {streamed} tokens); cancel "
        f"after 8 tokens freed its blocks ({free0} free)")

    shed, parked = asyncio.run(burst())
    for status, headers, lines, _ in shed:
        if status != 429 or headers.get("retry-after") != "2":
            raise AssertionError(f"phase 2c: burst answered {status} "
                                 f"{headers}")
    for status, _, lines, _ in parked:
        if status != 200 or json.loads(lines[-1])["status"] != "cancelled":
            raise AssertionError("phase 2c: a parked request did not end "
                                 "cancelled")
    log("phase 2c: a burst of 4 beyond max_pending=2 got 2 x 429 "
        "(Retry-After: 2), the 2 parked ended cancelled at stop")

    def direct():
        sched = DynamicSplitFuseScheduler(eng)
        for i, p in enumerate(prompts):
            sched.submit(5000 + i, p, new, **kws[i])
        t0 = time.perf_counter()
        sched.run()
        seconds = time.perf_counter() - t0
        res = sched.results()
        out = [res[5000 + i][len(prompts[i]):].tolist() for i in range(n)]
        for i in range(n):
            sched.release(5000 + i)
        return out, seconds
    d1, d1_s = direct()
    d2, d2_s = direct()
    check_streams("direct", d1, new, V)
    if d1 != d2:
        raise AssertionError("phase 2c: two direct scheduler runs differ")
    for name, streams in (("HTTP", http_streams),
                          ("in-process", inproc_streams)):
        log(f"phase 2c: {name} streams equal to the direct path: greedy "
            f"{sum(a == b for a, b in zip(streams[:4], d1[:4]))}/4, "
            f"sampled {sum(a == b for a, b in zip(streams[4:], d1[4:]))}/4 "
            f"(informational: arrival order changes the batching, and "
            f"bf16 near-ties can part)")

    # generate(): greedy, then sampled twice, then top_k = 1
    t0 = time.perf_counter()
    g8 = eng.generate(prompts, new)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    s0, w0 = eng.host_syncs, eng.decode_windows
    t0 = time.perf_counter()
    s8 = eng.generate(prompts, new, seed=7, **SERVE_SAMPLED)
    torch.cuda.synchronize()
    sampled_s = time.perf_counter() - t0
    if eng.host_syncs - s0 != eng.decode_windows - w0 or \
            eng.decode_windows == w0:
        raise AssertionError(f"phase 2c: {eng.host_syncs - s0} host syncs "
                             f"for {eng.decode_windows - w0} sampled windows")
    s8b = eng.generate(prompts, new, seed=7, **SERVE_SAMPLED)
    if not all(np.array_equal(a, b) for a, b in zip(s8, s8b)):
        raise AssertionError("phase 2c: a repeated sampled generate() gave "
                             "other streams")
    k1 = eng.generate(prompts, new, seed=7, **dict(SERVE_SAMPLED, top_k=1))
    if not all(np.array_equal(a, b) for a, b in zip(k1, greedy_gen)):
        raise AssertionError("phase 2c: top_k=1 generate() differs from "
                             "the greedy one")
    check_streams("sampled generate()", [list(o[len(p):]) for o, p in
                                         zip(s8, prompts)], new, V)
    log(f"phase 2c: sampled generate() repeat identical, one host sync a "
        f"window, top_k=1 = greedy; greedy repeat = serve phase's: "
        f"{all(np.array_equal(a, b) for a, b in zip(g8, greedy_gen))}")

    # window 8 against the per-token path (window 1), greedy and sampled
    eng.set_decode_window(1, source="config")
    g1 = eng.generate(prompts, new)
    s1 = eng.generate(prompts, new, seed=7, **SERVE_SAMPLED)
    eng.set_decode_window(8, source="config")
    g_eq = [np.array_equal(a, b) for a, b in zip(g8, g1)]
    s_eq = [np.array_equal(a, b) for a, b in zip(s8, s1)]
    log(f"phase 2c: window 8 vs window 1 (per-token): greedy streams "
        f"equal {sum(g_eq)}/{n}, sampled {sum(s_eq)}/{n}")
    # a row whose greedy streams agree ran on the same bits in both
    # paths, so its sampled streams must agree too: a difference there is
    # a key or generated-token index that the two paths derive apart
    parted = [i for i in range(n) if g_eq[i] and not s_eq[i]]
    if parted:
        raise AssertionError(
            f"phase 2c: rows {parted} agree greedy but not sampled between "
            f"window 8 and window 1")

    # the spans in a torch.profiler trace
    trace.enable_profiler_annotations(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            eng.generate(prompts[:2], 9, seed=3, **SERVE_SAMPLED)
    finally:
        trace.enable_profiler_annotations(False)
    names = {e.key for e in prof.key_averages()}
    if not {"ragged_step", "decode_window"} <= names:
        raise AssertionError("phase 2c: the engine's spans are missing from "
                             "the torch.profiler trace")
    sampled_window_launches = profile_phase(eng, prompts, eng.decode_window,
                                            label="sampled ", seed=7,
                                            **SERVE_SAMPLED)
    log(f"phase 2c: launches per decode step in a window, sampled "
        f"{sampled_window_launches:.0f} against greedy "
        f"{greedy_window_launches:.0f} (+"
        f"{sampled_window_launches - greedy_window_launches:.0f} for the "
        f"sampler)")

    launches = dict(paged_attention=paged_attention.launches,
                    ragged_attention=ragged_attention.launches)
    steps = dict(ragged=eng.ragged_steps - steps0["ragged"],
                 decode=eng.decode_steps - steps0["decode"])
    if launches["paged_attention"] != L * steps["decode"] or \
            launches["ragged_attention"] != L * steps["ragged"] or \
            not steps["decode"] or not steps["ragged"]:
        raise AssertionError(f"phase 2c: launches {launches} != {L} x "
                             f"steps {steps}")
    if sm.free_blocks() != free0:
        raise AssertionError("phase 2c: KV blocks leaked")
    mem = eng.memory_report()
    if not 0 < mem["device"]["allocated"] <= mem["device"]["total"]:
        raise AssertionError(f"phase 2c: memory_report() {mem['device']}")
    log(f"phase 2c: memory_report(): allocated "
        f"{mem['device']['allocated'] / 2**30:.2f} GiB, peak "
        f"{mem['device']['peak'] / 2**30:.2f} GiB of "
        f"{mem['device']['total'] / 2**30:.2f}; buffers (GiB) "
        + ", ".join(f"{k} {v / 2**30:.2f}"
                    for k, v in sorted(mem["buffers"].items())))
    n_tok = n * new
    rows = {"http": log_latencies("HTTP", http_times, http_s, n_tok),
            "in_process": log_latencies("in-process",
                                        [t for _, t in inproc], inproc_s,
                                        n_tok)}
    log(f"phase 2c: output tokens/s in the same call: HTTP "
        f"{rows['http']['tokens_per_s']:.1f}, in-process "
        f"{rows['in_process']['tokens_per_s']:.1f}, direct scheduler "
        f"{n_tok / d1_s:.1f} / {n_tok / d2_s:.1f}, generate() greedy "
        f"{n_tok / greedy_s:.1f}, sampled {n_tok / sampled_s:.1f}")
    log(f"phase 2c: launches {launches} = {L} x steps {steps}; "
        f"{time.perf_counter() - t_phase:.1f}s")
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


# ---------------------------------------------------------------------------
# phase 2d: the KV spill tier
# ---------------------------------------------------------------------------
SPILL_CONVS, SPILL_BATCH = 8, 4   # 12 before: cut for the time limit
SPILL_T1, SPILL_NEW1, SPILL_NEW2 = 512, 32, 64     # turn-1 prompt, tokens


def spill_run(dev, cfg, params, blocks, kv_quant, spill=None):
    """SPILL_CONVS two-turn conversations through one engine (pool of
    ``blocks``, prefix caching on, ``spill``: the spill tier's settings or
    None): all
    turn 1s, 4 at a time, then the turn 2s in the same order. Returns the
    engine, the streams, turn 2's TTFTs and what the spy saw: the bytes a
    block took in the tier, and the number of restores, each checked bit
    for bit against a device copy of the block taken when it was spilled.
    The spy only enqueues device work (a copy at a spill, a comparison
    after a restore, both on the engine's stream) and reads the
    comparisons after the last turn, so the timed turns hold no sync of
    its own."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM

    sm = {"num_blocks": blocks, "enable_prefix_caching": True,
          "max_ragged_batch_size": 8192}
    if spill is not None:
        sm.update(spill, enable_kv_spill=True)
    eng = deepspeed_tpu_torch.init_inference(
        TransformerLM(cfg), params=params, device=dev,
        config={"dtype": "bfloat16", "use_ragged": True,
                "ragged": {"kv_quant": kv_quant, "decode_window": 8,
                           "state_manager": sm}})
    seen = {"restored": 0, "bytes": []}
    spilled, equal = {}, []
    tier = eng.spill
    if tier is not None:
        spill_block, restore_block = tier.spill_block, tier.restore_block
        as_int = {1: torch.int8, 2: torch.int16, 4: torch.int32}

        def bits(t):
            return t.view(as_int[t.element_size()])

        def spy_spill(digest, block):
            if not tier.has(digest):
                spilled[digest] = {k: v[:, block].clone()
                                   for k, v in eng.kv_cache.items()}
            n0 = tier.spilled_bytes
            ok = spill_block(digest, block)
            if tier.spilled_bytes > n0:
                seen["bytes"].append(tier.spilled_bytes - n0)
            return ok

        def spy_restore(digest, block):
            ok = restore_block(digest, block)
            if ok:
                want = spilled[digest]
                equal.append(torch.stack([
                    (bits(v[:, block]) == bits(want[k])).all()
                    for k, v in eng.kv_cache.items()]).all())
            return ok

        tier.spill_block, tier.restore_block = spy_spill, spy_restore
    rng = np.random.default_rng(21)
    turn1 = [list(map(int, rng.integers(1, cfg.vocab_size, SPILL_T1)))
             for _ in range(SPILL_CONVS)]
    extra = [list(map(int, rng.integers(1, cfg.vocab_size, SPILL_NEW2)))
             for _ in range(SPILL_CONVS)]
    out1, out2, ttft2 = [], [], []
    for a in range(0, SPILL_CONVS, SPILL_BATCH):
        out1 += eng.generate(turn1[a:a + SPILL_BATCH],
                             max_new_tokens=SPILL_NEW1,
                             uids=list(range(a, a + SPILL_BATCH)))
    for a in range(0, SPILL_CONVS, SPILL_BATCH):
        prompts = [list(map(int, out1[i])) + extra[i]
                   for i in range(a, a + SPILL_BATCH)]
        out2 += eng.generate(prompts, max_new_tokens=SPILL_NEW1,
                             uids=list(range(100 + a, 100 + a + SPILL_BATCH)))
        ttft2.append(eng.last_ttft_s)
    torch.cuda.synchronize()
    if equal:
        same = torch.stack(equal).cpu()
        if not bool(same.all()):
            raise AssertionError(f"{int((~same).sum())} of {len(equal)} "
                                 f"restored blocks differ from the bytes "
                                 f"spilled")
    seen["restored"] = len(equal)
    spilled.clear()
    return eng, out1, out2, ttft2, seen


def kv_spill_phase(dev, cfg, bf16_eng):
    """Phase 2d on phase 6's Mistral-7B weights: a pool of 64 blocks (8
    MiB each in bf16) cannot retain the 8 conversations' 64 prefix
    blocks. Spill on (host tier alone; then 8 blocks of host tier over a
    1 GiB disk tier) is token-identical to a pool that spills nothing, its
    restored blocks torch.equal to the spilled bytes; spill off recomputes
    (agreement logged only). Then the int8 pool, spill on and off (its
    turn 1 equal between them). Launches, /healthz's kv_spill summary,
    the drain's cleanup."""
    import asyncio

    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import \
        ragged_attention
    from deepspeed_tpu_torch.inference.v2.ragged.spill import SpillSummary
    from deepspeed_tpu_torch.inference.v2.serve import (ServingConfig,
                                                        ServingEngine)

    L = cfg.num_layers
    disk_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "kv_spill")
    big = SPILL_CONVS * 10 + 8
    launches = dict.fromkeys(("paged_attention", "ragged_attention",
                              "paged_attention_q8", "ragged_attention_q8"), 0)
    spilled_per_block = {}
    for kv_quant in (False, True):
        tag = "int8" if kv_quant else "bf16"
        # the int8 pool's launches have counters of their own
        attr = "q8_launches" if kv_quant else "launches"
        suffix = "_q8" if kv_quant else ""
        configs = [("spill host", 64, {"kv_spill_host_bytes": 1 << 30})]
        if not kv_quant:
            configs.append(("spill host+disk", 64, {
                "kv_spill_host_bytes": 8 * 8 << 20,
                "kv_spill_disk_bytes": 1 << 30, "kv_spill_dir": disk_root}))
        configs.append(("no spill", 64, None))
        if not kv_quant:
            # an int8 block keeps its grow-only scales when it is freed (as
            # in JAX), so an int8 stream depends on the pool's history and
            # a pool that never recycles a block is no reference for it
            # (on the card: turn 1 agreed on 4/12, turn 2 on 0/12)
            configs.append(("large pool", big, None))
        runs = {}
        for label, blocks, spill in configs:
            t0 = time.perf_counter()
            setattr(ragged_attention, attr, 0)
            setattr(paged_attention, attr, 0)
            eng, out1, out2, ttft2, seen = spill_run(
                dev, cfg, bf16_eng.params, blocks, kv_quant, spill)
            steps = (eng.ragged_steps, eng.decode_steps)
            got = (getattr(ragged_attention, attr),
                   getattr(paged_attention, attr))
            if got != (L * steps[0], L * steps[1]) or 0 in steps:
                raise AssertionError(
                    f"2d {tag} {label}: launches ragged / paged {got} != "
                    f"{L} x steps {steps}")
            launches["ragged_attention" + suffix] += got[0]
            launches["paged_attention" + suffix] += got[1]
            runs[label] = (out1, out2, ttft2)
            sm = eng.state_manager
            msg = (f"2d {tag} {label}: pool {blocks} blocks, turn-2 TTFT ms "
                   f"{[round(t * 1e3, 1) for t in ttft2]}, prefix reused "
                   f"{int(sm._m_reused_tokens.value)} tokens in this "
                   f"process, {time.perf_counter() - t0:.1f}s")
            tier = eng.spill
            if tier is not None:
                if tier.spilled_blocks == 0 or seen["restored"] == 0 or \
                        seen["restored"] != tier.restored_blocks:
                    raise AssertionError(f"2d {tag} {label}: spilled "
                                         f"{tier.spilled_blocks}, restored "
                                         f"{tier.restored_blocks}, checked "
                                         f"{seen['restored']}")
                if spill.get("kv_spill_dir") and \
                        not tier.stats()["disk_entries"]:
                    raise AssertionError(f"2d {tag} {label}: nothing went "
                                         f"to the disk tier")
                per_block = statistics.median(seen["bytes"])
                spilled_per_block[tag] = per_block
                sec = tier.seconds
                n_s, n_r = tier.spilled_blocks, tier.restored_blocks
                restore_ms = sum(v for k, v in sec.items()
                                 if k.startswith("restore_")) / n_r * 1e3
                msg += (f"; spilled {n_s} blocks "
                        f"({per_block / 2**20:.3f} MiB a block), restored "
                        f"{n_r} (each bit-equal to its spilled bytes); "
                        f"host ms a spill: " + ", ".join(
                            f"{k[6:]} {sec[k] / n_s * 1e3:.2f}"
                            for k in sec if k.startswith("spill_"))
                        + "; a restore: " + ", ".join(
                            f"{k[8:]} {sec[k] / n_r * 1e3:.2f}"
                            for k in sec if k.startswith("restore_"))
                        + f" (total {restore_ms:.2f}); stats "
                        f"{tier.stats()}")
                free0 = sm.config.num_blocks - 1
                ns = tier.disk_dir

                async def health_and_drain():
                    serving = await ServingEngine(eng,
                                                  ServingConfig()).start()
                    doc = serving.health()["kv_spill"]
                    await serving.stop()
                    return doc

                held = list(tier._host) + list(tier._disk)
                doc = asyncio.run(health_and_drain())
                summary = SpillSummary.from_doc(json.loads(json.dumps(doc)))
                if summary is None or summary.entries != len(held) or not \
                        all(summary.claims(d) for d in held):
                    raise AssertionError(f"2d {tag} {label}: /healthz "
                                         f"kv_spill {doc}")
                if len(tier) or (ns is not None and os.path.exists(ns)):
                    raise AssertionError(f"2d {tag} {label}: the drain left "
                                         f"spill entries or {ns}")
                if sm.reclaimable_blocks() != free0:
                    raise AssertionError(
                        f"2d {tag} {label}: {sm.reclaimable_blocks()} free "
                        f"or reclaimable blocks after the drain, {free0} "
                        f"before")
                msg += (f"; /healthz kv_spill claims all {len(held)} held "
                        f"digests; drained: tier empty"
                        + (", disk namespace removed" if ns else ""))
            log(msg)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        ref = runs.get("large pool")

        def agree(a, b, turn):
            return sum(np.array_equal(x, y) for x, y in zip(a[turn], b[turn]))

        for label in runs:
            if not label.startswith("spill"):
                continue
            if not kv_quant:
                if agree(runs[label], ref, 0) + agree(runs[label], ref, 1) \
                        != 2 * SPILL_CONVS:
                    raise AssertionError(f"2d {tag} {label}: streams differ "
                                         f"from the large pool's")
                continue
            # int8: turn 1, before any restore, equals the run of the same
            # pool (the same block history) without spill
            if agree(runs[label], runs["no spill"], 0) != SPILL_CONVS:
                raise AssertionError(f"2d {tag} {label}: turn 1 differs "
                                     f"from the same pool without spill")
            log(f"2d {tag} {label}: turn 1 token-identical to the same "
                f"pool without spill; turn 2 (restore against recompute) "
                f"agrees on {agree(runs[label], runs['no spill'], 1)}/"
                f"{SPILL_CONVS} (informational)")
        log(f"2d {tag}: "
            + (f"spill on token-identical to the large pool in both turns; "
               f"recompute (no spill) agrees with it on "
               f"{agree(runs['no spill'], ref, 1)}/{SPILL_CONVS} turn-2 "
               f"streams (a prefill of another batch: informational); "
               if ref else "")
            + f"turn-2 TTFT ms median, restore "
            f"{statistics.median(runs['spill host'][2]) * 1e3:.1f} against "
            f"recompute {statistics.median(runs['no spill'][2]) * 1e3:.1f}"
            + (f" and the large pool {statistics.median(ref[2]) * 1e3:.1f}"
               if ref else ""))
    log(f"2d: spilled bytes a block int8 / bf16 = "
        f"{spilled_per_block['int8'] / spilled_per_block['bf16']:.4f} "
        f"(predicted about 0.5)")
    shutil.rmtree(disk_root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 2h: the serving fleet on one card
# ---------------------------------------------------------------------------
FLEET_CHUNK_BLOCKS = 4        # KV blocks a chunk of the handoff stream
FLEET_SPEC_LAYERS = 2         # the worker's depth (of 32; the time limit)
FLEET_ROUTED_NEW = 32         # 2h (a)'s new tokens (64 before; the limit)
FLEET_BLOCKS = 64             # pools of 2h (b)'s fresh engines (a request
                              # there holds at most 11 blocks, 27 with the
                              # overlap run's other request)


def fleet_engine(dev, cfg, params, registry=None, **sm):
    """A serving engine over the weight tensors ``params`` (shared, not
    copied), built inside ``registry``'s scope when one is given so its
    metrics land there."""
    import contextlib

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.telemetry.registry import scoped_registry

    with (scoped_registry(registry) if registry is not None
          else contextlib.nullcontext()):
        return InferenceEngineV2(
            TransformerLM(cfg), RaggedInferenceEngineConfig.from_dict(
                {"dtype": "bfloat16", "seed": 0, "decode_window": 8,
                 "kv_quant": bool(sm.pop("kv_quant", False)),
                 "state_manager": dict({"max_ragged_batch_size": 8192},
                                       **sm)}),
            params=params, device=dev)


def gated(replicas):
    """Hold each replica's loop thread inside a command until the returned
    event is set: requests routed meanwhile wait in admission, and the
    loop's first step then takes all of them, as a direct scheduler that
    got them in one go does."""
    import threading
    gate = threading.Event()
    for r in replicas:
        r.serving.loop_runner.post(lambda: gate.wait(60.0))
    return gate


def direct_streams(eng, prompts, new):
    """Greedy streams of ``prompts`` submitted together to a direct
    DynamicSplitFuseScheduler on ``eng`` (the serving runtime's scheduler
    with ServingConfig()'s defaults)."""
    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    sched = DynamicSplitFuseScheduler(eng)
    for i, p in enumerate(prompts):
        sched.submit(7000 + i, p, new)
    sched.run()
    res = sched.results()
    out = [res[7000 + i][len(p):].tolist() for i, p in enumerate(prompts)]
    for i in range(len(prompts)):
        sched.release(7000 + i)
    return out


def blocks_clean(eng):
    """No KV block is held by a sequence: every block is free or retained
    by the prefix index alone."""
    sm = eng.state_manager
    return (sm.tracked_sequences() == 0 and sm.free_blocks()
            + len(sm._prefix) == sm.config.num_blocks - 1)


def fleet_router_run(dev, cfg, eng, prompts, new):
    """2h (a): two in-process replicas over ``eng``'s weight tensors
    behind ReplicaRouter. Returns the engines' step counts."""
    import asyncio

    from deepspeed_tpu_torch.inference.v2.serve import (Replica,
                                                        ReplicaRouter,
                                                        RouterConfig,
                                                        ServingConfig)
    from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry

    regs = [MetricsRegistry(), MetricsRegistry()]
    engines = [fleet_engine(dev, cfg, eng.params, regs[i],
                            enable_prefix_caching=True) for i in range(2)]
    # each replica's engine and serving stack report to its own registry
    replicas = [Replica(f"fleet{i}", e, ServingConfig(), registry=regs[i])
                for i, e in enumerate(engines)]
    rng = np.random.default_rng(8)
    prefix = list(map(int, rng.integers(1, cfg.vocab_size, 512)))
    shared = [prefix + list(map(int, rng.integers(1, cfg.vocab_size, 64)))
              for _ in range(8)]

    async def run():
        router = ReplicaRouter(replicas, RouterConfig(monitor_interval_s=0))
        await router.start()
        gate = gated(replicas)
        t0 = time.perf_counter()
        streams = [await router.submit(p, new) for p in prompts]
        gate.set()
        routed = [await s.drain() for s in streams]
        routed_s = time.perf_counter() - t0
        placed = [s.replica for s in streams]
        # the shared-prefix requests: the first alone (its flush indexes
        # the prefix), then the other seven at once
        first = await router.submit(shared[0], 16)
        await first.drain()
        rest = [await router.submit(p, 16) for p in shared[1:]]
        for s in rest:
            await s.drain()
        shared_placed = [first.replica] + [s.replica for s in rest]
        shared_ok = all(s.status == "completed" and len(s.tokens) == 16
                        for s in [first] + rest)
        # drain one replica mid-traffic
        live = [await router.submit(p, new) for p in prompts[:4]]
        for s in live:
            await s.__anext__()
        victim = live[0].replica
        drain = asyncio.ensure_future(router.drain_replica(victim))
        await asyncio.sleep(0)
        later = [await router.submit(p, 16) for p in prompts[4:]]
        for s in live + later:
            await s.drain()
        await drain
        drained = dict(victim=victim, state=router._by_name[victim].state,
                       live=[(s.replica, s.status, len(s.tokens))
                             for s in live],
                       later=[(s.replica, s.status, len(s.tokens))
                              for s in later])
        await router.stop()
        return routed, routed_s, placed, shared_placed, shared_ok, drained

    routed, routed_s, placed, shared_placed, shared_ok, drained = \
        asyncio.run(run())
    # the reference: a direct scheduler on an engine configured as the
    # replicas' (prefix caching aside), over the same weight tensors
    ref_eng = fleet_engine(dev, cfg, eng.params)
    subsets = {name: [i for i, n in enumerate(placed) if n == name]
               for name in ("fleet0", "fleet1")}
    log(f"2h (a): routed placement {placed} ({routed_s:.2f}s for "
        f"{len(prompts)} x {new} tokens)")
    if not all(subsets.values()):
        raise AssertionError(f"2h (a): the ring put every request on one "
                             f"replica: {placed}")
    for name, idx in subsets.items():
        ref = direct_streams(ref_eng, [prompts[i] for i in idx], new)
        got = [routed[i] for i in idx]
        if got != ref:
            bad = [i for i, a, b in zip(idx, got, ref) if a != b]
            raise AssertionError(f"2h (a): routed streams {bad} on {name} "
                                 f"differ from the direct scheduler's")
    if len(set(shared_placed)) != 1 or not shared_ok:
        raise AssertionError(f"2h (a): shared-prefix placement "
                             f"{shared_placed}, completed {shared_ok}")
    home = replicas[0 if shared_placed[0] == "fleet0" else 1]
    hits = home.registry.family_total("inference_prefix_hits_total")
    if hits <= 0:
        raise AssertionError(f"2h (a): no prefix-cache hit on {home.name}")
    survivor = "fleet1" if drained["victim"] == "fleet0" else "fleet0"
    if drained["state"] != "drained" or any(
            st != "completed" or n != new for _, st, n in drained["live"]):
        raise AssertionError(f"2h (a): drain {drained}")
    if any(r != survivor or st != "completed" or n != 16
           for r, st, n in drained["later"]):
        raise AssertionError(f"2h (a): traffic after the drain {drained}")
    for e, r in zip(engines, replicas):
        if not blocks_clean(e):
            raise AssertionError(f"2h (a): {r.name} holds KV blocks after "
                                 f"the drain")
    log(f"2h (a): routed streams token-identical to the direct scheduler "
        f"on each replica's requests ({[len(v) for v in subsets.values()]}"
        f"); 8 shared-prefix requests all on {home.name}, prefix hits "
        f"{hits:.0f} there; drained {drained['victim']} mid-traffic: its "
        f"{len(drained['live'])} streams finished, the next "
        f"{len(drained['later'])} went to {survivor}; every block free or "
        f"retained by the prefix index")
    steps = [(e.ragged_steps, e.decode_steps) for e in engines + [ref_eng]]
    del engines, replicas, ref_eng
    return steps


def fleet_handoff_run(dev, cfg, eng, prompts, new, kv_quant):
    """2h (b) for one pool: each request alone, colocated on a fresh
    engine and disaggregated (a fresh prefill engine -> chunked handoff ->
    a fresh decode engine) through the router; fresh engines, because an
    int8 block keeps its scales when freed. Returns (steps, stats)."""
    import asyncio

    from deepspeed_tpu_torch.inference.v2.serve import (PrefillReplica,
                                                        Replica,
                                                        ReplicaRouter,
                                                        RouterConfig,
                                                        ServingConfig)
    from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry

    # a chunk as large as the prompt: the colocated prefill is one put(),
    # as the prefill replica's is
    scfg = dict(chunk=8192)
    stats = dict(colo_ttft=[], disagg_ttft=[], bytes_per_block=[],
                 chunk_ms=[], overlap=0.0)
    steps = [0, 0]

    async def one(prompt):
        reg = MetricsRegistry()
        colo_eng = fleet_engine(dev, cfg, eng.params, kv_quant=kv_quant,
                                num_blocks=FLEET_BLOCKS)
        pre_eng = fleet_engine(dev, cfg, eng.params, kv_quant=kv_quant,
                               num_blocks=FLEET_BLOCKS)
        dec_eng = fleet_engine(dev, cfg, eng.params, reg, kv_quant=kv_quant,
                               num_blocks=FLEET_BLOCKS)
        colo = Replica("colo", colo_eng, ServingConfig(**scfg))
        await colo.start()
        t0 = time.perf_counter()
        s = await colo.submit(prompt, new)
        await s.__anext__()
        stats["colo_ttft"].append(time.perf_counter() - t0)
        colocated = await s.drain()
        await colo.stop()
        dec = Replica("decode0", dec_eng, ServingConfig(**scfg),
                      registry=reg)
        router = ReplicaRouter(
            [dec], RouterConfig(disaggregated=True, monitor_interval_s=0,
                                handoff_chunk_blocks=FLEET_CHUNK_BLOCKS),
            prefill_replicas=[PrefillReplica("prefill0", pre_eng)])
        await router.start()
        t0 = time.perf_counter()
        s = await router.submit(prompt, new)
        await s.__anext__()
        stats["disagg_ttft"].append(time.perf_counter() - t0)
        disagg = await s.drain()
        await router.stop()
        nbytes = reg.family_total("handoff_chunk_bytes_total")
        n_blocks = -(-len(prompt) // dec_eng.block_size)
        stats["bytes_per_block"].append(nbytes / n_blocks)
        apply_h = reg.get("handoff_chunk_apply_seconds")
        chunks = reg.family_total("handoff_chunks_total")
        stats["chunk_ms"].append(
            1e3 * sum(sr.sum for _, sr in apply_h.series()) / max(chunks, 1))
        stats["overlap"] += reg.family_total(
            "handoff_chunk_overlap_steps_total")
        for e in (colo_eng, pre_eng, dec_eng):
            steps[0] += e.ragged_steps
            steps[1] += e.decode_steps
        return colocated, disagg, chunks, n_blocks

    tag = "int8" if kv_quant else "bf16"
    for i, p in enumerate(prompts):
        colocated, disagg, chunks, n_blocks = asyncio.run(one(p))
        if len(colocated) != new or disagg != colocated:
            raise AssertionError(
                f"2h (b) {tag}: request {i} disaggregated "
                f"{first_divergence(disagg, colocated)} != colocated")
        if chunks != -(-n_blocks // FLEET_CHUNK_BLOCKS):
            raise AssertionError(f"2h (b) {tag}: {chunks} chunks applied "
                                 f"for {n_blocks} blocks")
    return steps, stats


def fleet_overlap_run(dev, cfg, eng, prompt):
    """2h (b): one chunked handoff applied while the decode replica's loop
    decodes another request; the scheduler steps between chunk applies."""
    import asyncio

    from deepspeed_tpu_torch.inference.v2.serve import (PrefillReplica,
                                                        Replica,
                                                        ServingConfig)

    async def run():
        pre_eng = fleet_engine(dev, cfg, eng.params, num_blocks=FLEET_BLOCKS)
        pre = PrefillReplica("prefill0", pre_eng)
        dec_eng = fleet_engine(dev, cfg, eng.params, num_blocks=FLEET_BLOCKS)
        dec = Replica("decode0", dec_eng, ServingConfig())
        await dec.start()
        # a victim long enough to outlast the transfer (cancelled after)
        victim = await dec.submit(prompt[:128], 1024)
        await victim.__anext__()
        tok, payloads, rng_state, _ = await pre.prefill(
            prompt, 16, chunk_blocks=1)
        loop = dec.serving.loop_runner
        handle = await dec.serving.begin_handoff(payloads[0])
        s0 = loop.steps_done
        for chunk in payloads[1:]:
            before = loop.steps_done
            deadline = time.monotonic() + 60.0
            while loop.steps_done == before:
                if time.monotonic() > deadline or victim.status != "active":
                    raise AssertionError("2h (b): the decode loop took no "
                                         "step while the handoff streamed")
                await asyncio.sleep(0.001)
            await handle.feed(chunk)
        overlapped = loop.steps_done - s0
        stream = await handle.commit(prompt=prompt, generated=[tok],
                                     max_new_tokens=16, rng_state=rng_state)
        rest = await stream.drain()
        await victim.cancel()
        await dec.stop()
        return overlapped, len(payloads) - 1, len(rest), (pre_eng, dec_eng)

    overlapped, n_chunks, n_rest, engines = asyncio.run(run())
    if n_rest != 15 or overlapped < n_chunks:
        raise AssertionError(f"2h (b): overlap run {overlapped} steps over "
                             f"{n_chunks} chunks, {n_rest} tokens")
    return overlapped, n_chunks, (sum(e.ragged_steps for e in engines),
                                  sum(e.decode_steps for e in engines))


def fleet_spec(cfg, seed=0):
    """The worker's spec: Mistral-7B width at FLEET_SPEC_LAYERS layers."""
    import dataclasses
    return {"model": dict(dataclasses.asdict(cfg),
                          num_layers=FLEET_SPEC_LAYERS),
            "state_manager": {"max_tracked_sequences": 16,
                              "max_seq_len": 2048, "num_blocks": 128,
                              "block_size": 64,
                              "max_ragged_batch_size": 4096},
            "engine": {"dtype": "bfloat16", "decode_window": 8},
            "serving": {"token_budget": 4096, "chunk": 4096},
            "seed": seed}


def leaf_state(eng):
    from deepspeed_tpu_torch.inference.v2.serve import weights as sw
    return [(n, t.data_ptr(), t.clone()) for n, t in
            sw.flatten_params(eng.params)]


def fleet_remote_run(dev, cfg, prompts, new):
    """2h (c) and (d): a worker subprocess on the same card (spawn_worker,
    the spec at Mistral-7B width and FLEET_SPEC_LAYERS layers) beside an
    in-process engine from the same spec; then live weight pushes to both
    through ReplicaRouter.push_weights. Returns launch counts."""
    import asyncio
    import tempfile

    from deepspeed_tpu_torch.inference.v2.serve import spawn_worker

    spec = fleet_spec(cfg)
    root = os.path.dirname(os.path.abspath(__file__))
    spec_dir = tempfile.mkdtemp(prefix="fleet_spec_",
                                dir=os.path.join(root, "build"))
    spec_path = os.path.join(spec_dir, "spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    # faulthandler: a SIGABRT on a stuck worker dumps its threads' stacks
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""), PYTHONFAULTHANDLER="1")
    t0 = time.perf_counter()
    proc, info = spawn_worker(["--spec", spec_path, "--name", "worker0",
                               "--device", dev.type], timeout_s=240.0,
                              env=env)
    spawn_s = time.perf_counter() - t0
    log(f"2h (c): spawn_worker -> ready line in {spawn_s:.1f}s: {info}")
    def tails():
        return (f"worker stdout:\n{''.join(proc.stdout_tail)[-3000:]}\n"
                f"worker stderr:\n{''.join(proc.stderr_tail)[-6000:]}")

    out = {}
    try:
        try:
            out = asyncio.run(asyncio.wait_for(fleet_remote_checks(
                dev, cfg, spec, info, prompts, new), 300.0))
        except asyncio.TimeoutError:
            import faulthandler
            import signal
            faulthandler.dump_traceback(all_threads=True)
            proc.send_signal(signal.SIGABRT)
            time.sleep(3.0)
            raise AssertionError(f"2h (c)-(d) did not finish in 300 s; "
                                 f"{tails()}")
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(spec_dir, ignore_errors=True)
    if rc != 0:
        raise AssertionError(f"2h (c): the worker exited with {rc}: "
                             f"{tails()}")
    log(f"2h (c): the worker drained, stopped and exited with 0")
    out["spawn_s"] = spawn_s
    return out


async def fleet_remote_checks(dev, cfg, spec, info, prompts, new):
    import asyncio

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.config_v2 import \
        DSStateManagerConfig
    from deepspeed_tpu_torch.inference.v2.serve import (PrefillReplica,
                                                        RemoteReplica,
                                                        Replica,
                                                        ReplicaRouter,
                                                        RouterConfig)
    from deepspeed_tpu_torch.inference.v2.serve import weights as sw
    from deepspeed_tpu_torch.inference.v2.serve import worker as ws
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.ops import quantizer_kernels as qk
    from deepspeed_tpu_torch.telemetry import get_registry

    remote = RemoteReplica("worker0", info["host"], int(info["port"]))
    local_eng = ws.build_engine(spec, dev)
    local = Replica("local0", local_eng, ws._serving_config(spec))
    await local.start()
    await remote.start()

    async def serve_seq(replica, ps, n):
        outs = []
        for p in ps:
            s = await replica.submit(p, n)
            outs.append(await s.drain())
        return outs

    async def fresh_streams(params, ps, n):
        model = TransformerLM(TransformerConfig(**spec["model"]))
        e = InferenceEngineV2(model, RaggedInferenceEngineConfig(
            state_manager=DSStateManagerConfig(**spec["state_manager"]),
            **spec["engine"]), params=params, device=dev)
        r = Replica("fresh", e, ws._serving_config(spec))
        await r.start()
        try:
            return await serve_seq(r, ps, n)
        finally:
            await r.stop()

    ps = [p[:256] for p in prompts[:2]]
    # (c) the worker's streams against an in-process engine of one spec
    log("2h (c): the worker serves")
    rem = await serve_seq(remote, ps, new)
    log("2h (c): the in-process engine of the spec serves")
    loc = await serve_seq(local, ps, new)
    if rem != loc or any(len(x) != new for x in rem):
        raise AssertionError("2h (c): remote streams differ from the "
                             "in-process engine built from the same spec")
    # a handoff over POST /handoff from an in-process prefill replica
    log("2h (c): handoffs over POST /handoff")
    pre = PrefillReplica("prefill0", ws.build_engine(spec, dev))
    handed = []
    for p in ps:
        tok, payloads, rng_state, _ = await pre.prefill(
            p, new, chunk_blocks=FLEET_CHUNK_BLOCKS)
        s = await remote.resume_handoff(
            payloads, chunked=True, prompt=p, generated=[tok],
            max_new_tokens=new, rng_state=rng_state)
        handed.append([tok] + await s.drain())
    if handed != rem:
        raise AssertionError("2h (c): streams handed off over POST /handoff "
                             "differ from the worker's own")
    router = ReplicaRouter([remote, local],
                           RouterConfig(monitor_interval_s=0))
    await router.start()
    text = await router.federated_metrics_async()
    if 'replica="worker0"' not in text:
        raise AssertionError("2h (c): federated /metrics lack the worker")
    log(f"2h (c): worker streams token-identical to the in-process engine "
        f"of the same spec ({len(ps)} x {new} tokens), and through POST "
        f"/handoff from an in-process prefill replica; federated /metrics "
        f"{len(text.splitlines())} lines with replica=\"worker0\"")

    # (d) live weight pushes during traffic
    log("2h (d): payloads")
    gen = torch.Generator(device=dev)
    model = TransformerLM(TransformerConfig(**spec["model"]))
    trees = {}
    for seed in (1, 2):
        gen.manual_seed(seed)
        trees[seed] = model.init_params(gen, dtype=torch.bfloat16)
    before = [(n, t.data_ptr()) for n, t in
              sw.flatten_params(local_eng.params)]
    t0 = time.perf_counter()
    items = sw.flatten_params(trees[1])
    buckets = sw.plan_buckets(items)
    flat1 = {n: sw.fetch_leaf(t) for n, t in items}
    full = sw.chunk_weight_leaves(({n: flat1[n] for n in b}
                                   for b in buckets), 1)
    full_s = time.perf_counter() - t0
    flat2 = {n: sw.fetch_leaf(t) for n, t in sw.flatten_params(trees[2])}
    qk.quantize_blocks.launches = 0
    t0 = time.perf_counter()
    delta, recon = sw.chunk_weight_deltas(flat2, flat1, 2, 1, device=dev)
    torch.cuda.synchronize()
    delta_s = time.perf_counter() - t0
    q_launches = qk.quantize_blocks.launches
    if q_launches != sum(len(b) for b in sw.plan_buckets(list(
            flat2.items()))):
        raise AssertionError(f"2h (d): {q_launches} quantize launches for "
                             f"{len(flat2)} leaves")
    reg = get_registry()
    ov0 = reg.family_total("weight_update_overlap_steps_total")
    results = {}
    for version, payload in ((1, full), (2, delta)):
        log(f"2h (d): push {version}")
        traffic = [await router.submit(p, 32) for p in ps]
        t0 = time.perf_counter()
        got = await router.push_weights(payload)
        push_s = time.perf_counter() - t0
        done = [await s.drain() for s in traffic]
        if got != version or any(len(x) != 32 for x in done) or any(
                s.status != "completed" for s in traffic):
            raise AssertionError(f"2h (d): push {version}: {got}, streams "
                                 f"{[s.status for s in traffic]}")
        await remote.refresh(force=True)
        if (local.weight_version, remote.weight_version) != (version,
                                                             version):
            raise AssertionError(
                f"2h (d): weight_version local {local.weight_version} "
                f"remote {remote.weight_version}, want {version}")
        flat = flat1 if version == 1 else recon
        ref = await fresh_streams(
            sw.flat_to_tree(local_eng.params, flat), ps, new)
        if await serve_seq(local, ps, new) != ref or \
                await serve_seq(remote, ps, new) != ref:
            raise AssertionError(f"2h (d): post-swap streams at version "
                                 f"{version} differ from a fresh engine "
                                 f"built from the payload")
        results[version] = (sw.payload_bytes(payload), push_s)
    after = [(n, t.data_ptr()) for n, t in
             sw.flatten_params(local_eng.params)]
    if before != after:
        raise AssertionError("2h (d): a swap moved a leaf")
    base = sw.delta_base_of(local_eng)
    if not all(torch.equal(torch.from_numpy(base[n]),
                           torch.from_numpy(recon[n])) for n in recon):
        raise AssertionError("2h (d): the delta's reconstruction differs "
                             "from the publisher's recon")
    # a corrupt chunk: typed failure, version and params untouched
    snap = leaf_state(local_eng)
    bad = list(full)
    bad[1] = bytearray(bad[1])
    bad[1][len(bad[1]) // 2] ^= 0xFF
    bad[1] = bytes(bad[1])
    try:
        await local.apply_weights(bad)
        raise AssertionError("2h (d): a corrupt chunk applied")
    except ValueError as e:
        if "crc" not in str(e).lower() and "corrupt" not in str(e).lower():
            raise
    if local.weight_version != 2 or not all(
            p == t.data_ptr() and torch.equal(c, t) for (_, p, c), (_, t)
            in zip(snap, sw.flatten_params(local_eng.params))):
        raise AssertionError("2h (d): a corrupt payload changed the engine")
    overlap = reg.family_total("weight_update_overlap_steps_total") - ov0
    log(f"2h (d): full payload {results[1][0] / 2**20:.1f} MiB "
        f"({len(full) - 1} chunks, serialized in {full_s:.2f}s, pushed to "
        f"both replicas in {results[1][1]:.2f}s); delta "
        f"{results[2][0] / 2**20:.1f} MiB ({results[2][0] / results[1][0]:.3f}"
        f" of full; built in {delta_s:.2f}s with {q_launches} quantize "
        f"launches, pushed in {results[2][1]:.2f}s); no stream dropped, "
        f"weight_version 1 then 2 on both, post-swap streams = fresh "
        f"engines from the payloads, every leaf at its address, the "
        f"delta's reconstruction torch.equal to recon, a corrupt chunk "
        f"refused (version and leaves untouched); "
        f"weight_update_overlap_steps_total +{overlap:.0f}")
    # drain (the router drains both replicas), then stop: the worker
    # process exits
    await router.stop(drain=True)
    await remote.stop()
    return {"quantize_blocks": q_launches}


def fleet_phase(dev, cfg, eng, prompts, new):
    """Phase 2h: the serving fleet on one card (see the module docstring).
    Returns the phase's paged, ragged and quantize launches."""
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import \
        ragged_attention

    L = cfg.num_layers
    t_phase = time.perf_counter()
    for kern in (paged_attention, ragged_attention):
        kern.launches = 0
        kern.q8_launches = 0
    t0 = time.perf_counter()
    steps = fleet_router_run(dev, cfg, eng, prompts, FLEET_ROUTED_NEW)
    ragged = sum(s[0] for s in steps)
    decode = sum(s[1] for s in steps)
    if (ragged_attention.launches, paged_attention.launches) != (
            L * ragged, L * decode) or not ragged or not decode:
        raise AssertionError(
            f"2h (a): launches ragged {ragged_attention.launches} paged "
            f"{paged_attention.launches} != {L} x steps ({ragged}, "
            f"{decode})")
    log(f"2h (a): ragged {ragged_attention.launches} / paged "
        f"{paged_attention.launches} launches = {L} x steps ({ragged}, "
        f"{decode}); {time.perf_counter() - t0:.1f}s")
    launches = {"ragged_attention": ragged_attention.launches,
                "paged_attention": paged_attention.launches}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ps = [prompts[2], prompts[4]]       # 384 and 640 tokens: 2 and 3 chunks
    for kv_quant in (False, True):
        tag = "int8" if kv_quant else "bf16"
        attr = "q8_launches" if kv_quant else "launches"
        for kern in (paged_attention, ragged_attention):
            setattr(kern, attr, 0)
        (ragged, decode), st = fleet_handoff_run(dev, cfg, eng, ps, 32,
                                                 kv_quant)
        got = (getattr(ragged_attention, attr),
               getattr(paged_attention, attr))
        if got != (L * ragged, L * decode) or not ragged or not decode:
            raise AssertionError(f"2h (b) {tag}: launches {got} != {L} x "
                                 f"({ragged}, {decode})")
        suffix = "_q8" if kv_quant else ""
        launches[f"ragged_attention{suffix}"] = \
            launches.get(f"ragged_attention{suffix}", 0) + got[0]
        launches[f"paged_attention{suffix}"] = \
            launches.get(f"paged_attention{suffix}", 0) + got[1]
        log(f"2h (b) {tag}: {len(ps)} requests (prompts "
            f"{[len(p) for p in ps]}, 32 new) disaggregated over the "
            f"chunked handoff ({FLEET_CHUNK_BLOCKS} blocks a chunk) "
            f"token-identical to colocated; bytes a block "
            f"{statistics.median(st['bytes_per_block']):.0f}, ms a chunk "
            f"applied {statistics.median(st['chunk_ms']):.3f}, TTFT "
            f"disaggregated {statistics.median(st['disagg_ttft']) * 1e3:.1f}"
            f" ms against colocated "
            f"{statistics.median(st['colo_ttft']) * 1e3:.1f} ms (medians), "
            f"handoff_chunk_overlap_steps_total +{st['overlap']:.0f} "
            f"(each request alone: nothing else to step); launches {got}")
        gc.collect()
        torch.cuda.empty_cache()
    paged_attention.launches = ragged_attention.launches = 0
    overlapped, n_chunks, (r, d) = fleet_overlap_run(dev, cfg, eng,
                                                     prompts[3])
    if (ragged_attention.launches, paged_attention.launches) != (
            L * r, L * d):
        raise AssertionError("2h (b): overlap run launches")
    launches["ragged_attention"] += ragged_attention.launches
    launches["paged_attention"] += paged_attention.launches
    log(f"2h (b): a {n_chunks}-chunk handoff into a replica decoding "
        f"another request: {overlapped} scheduler steps while it streamed "
        f"in; {time.perf_counter() - t0:.1f}s for (b)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paged_attention.launches = ragged_attention.launches = 0
    remote = fleet_remote_run(dev, cfg, prompts, 32)
    launches["quantize_blocks"] = remote["quantize_blocks"]
    # this process's 2-layer engines (the worker counts its own)
    launches["ragged_attention"] += ragged_attention.launches
    launches["paged_attention"] += paged_attention.launches
    log(f"2h (c)-(d): {time.perf_counter() - t0:.1f}s; phase 2h "
        f"{time.perf_counter() - t_phase:.1f}s")
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


def device_events(prof):
    """{device event: (ms, count)} of a profile's device-side events only:
    kernels, memcpy, memset."""
    from torch.autograd import DeviceType

    kern = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        if e.device_type == DeviceType.CUDA and t > 0:
            kern[e.key] = (t / 1e3, e.count)
    return kern


def profiled(fn, cpu=False):
    """Runs fn() under torch.profiler; returns (fn's result, host ms of the
    call ending in a synchronize, ``device_events`` of the profile). By
    default the session records the card's activity alone: the device
    times without the cost of recording every host op (~8 s a profiled
    32-layer generate() pair with them), and a host ms close to the
    call's own. ``cpu=True`` records the host ops too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return out, wall, device_events(prof)


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


def profile_phase(eng, prompts, window, label="", **gen_kw):
    """Where the serving time goes. torch.profiler over
    generate() with max_new_tokens=1 (one put(): the ragged step) and with
    1 + window (the same put(), then one fused decode window). The window's
    device time and launches are the difference of the two runs; its wall
    time is the second run's after its put() (``last_ttft_s``). ``gen_kw``
    goes to generate() (the sampling arguments). Returns the window's
    device launches per step."""
    def run(new):
        _, wall, kern = profiled(
            lambda: eng.generate(prompts, max_new_tokens=new, **gen_kw))
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
    return sum(c for _, c in win_k.values()) / window


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
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": TRAIN_B,
                "gradient_accumulation_steps": 2,
                "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
                "gradient_clipping": 1.0, "bf16": {"enabled": True},
                "steps_per_print": 10 ** 9}


def train_phase(dev):
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(mistral_7b(), num_layers=4)
    L, gas, steps = cfg.num_layers, 2, 5
    # telemetry and diagnostics off: phase 8f holds its observed engine
    # against this one
    config = dict(TRAIN_CONFIG, gradient_accumulation_steps=gas,
                  telemetry={"enabled": False})
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
    syncs = count_syncs(lambda: engine.train_batch(batch=batch))
    log(f"train: host syncs in one step, telemetry off: {syncs}")
    return launches, {"losses": losses, "median_ms": med * 1e3,
                      "syncs": syncs, "batch": batch}


def count_syncs(fn):
    """Synchronizing CUDA calls (device-to-host reads, waits) made by
    fn(), as torch's sync debug mode reports them: "N at file:line, ..."
    (the Python lines that made them), or "none reported"."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in seen
             if "synchroniz" in str(w.message)]
    return (f"{len(sites)} at {', '.join(sites)}" if sites
            else "none reported")


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
# phase 8f: the training surface (telemetry, diagnostics, monitor; remat
# policies; forward / backward / step; universal checkpoints)
# ---------------------------------------------------------------------------
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
POLICIES_8F = ("nothing_saveable", "save_attn", "save_dots_and_attn",
               "dots_with_no_batch_dims_saveable", "dots_saveable")


def flash_launches():
    from deepspeed_tpu_torch.ops import flash_attention as fa
    return {n: getattr(fa, n).launches for n in FLASH_NAMES}


def engine_state(eng):
    """Clones of an engine's master, compute params and moments, and its
    step (to restart a step from the same state)."""
    return ([m.clone() for m in eng._master_leaves],
            [p.detach().clone() for p in eng._param_leaves],
            {k: [t.clone() for t in v] for k, v in eng.opt_state.items()},
            eng._step)


@torch.no_grad()
def restore_state(eng, state):
    master, params, moments, step = state
    for a, b in zip(eng._master_leaves, master):
        a.copy_(b)
    for a, b in zip(eng._param_leaves, params):
        a.copy_(b)
    for k, v in moments.items():
        for a, b in zip(eng.opt_state[k], v):
            a.copy_(b)
    eng._step = step


def same_state(eng, state):
    master, params, moments, _ = state
    return (all(torch.equal(a, b) for a, b in zip(eng._master_leaves,
                                                   master))
            and all(torch.equal(a.detach(), b)
                    for a, b in zip(eng._param_leaves, params))
            and all(torch.equal(a, b) for k, v in moments.items()
                    for a, b in zip(eng.opt_state[k], v)))


def training_surface_phase(dev, card, base):
    """Phase 8f on train_phase's model, settings, seed and fixed batch
    (``base``: its losses, median step ms and host syncs, telemetry off):
    (a) an engine with telemetry, diagnostics, csv_monitor and
    memory_breakdown on, (c) the remat policies, (d) the shims and (b) a
    NaN leaf on it; (e) universal checkpoints at 2 layers. Returns the
    flash launches."""
    import dataclasses
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing as ds_ckpt
    from deepspeed_tpu_torch.telemetry import anomaly, get_registry

    cfg = dataclasses.replace(mistral_7b(), num_layers=4)
    L, gas, batch = cfg.num_layers, 2, base["batch"]
    tmp = tempfile.mkdtemp(prefix="phase8f_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    launches0 = flash_launches()
    t_phase = time.perf_counter()
    # -- (a) observability changes no numbers -----------------------------
    config = dict(TRAIN_CONFIG, memory_breakdown=True,
                  telemetry={"enabled": True},
                  diagnostics={"postmortem_dir": os.path.join(tmp, "pm"),
                               "postmortem_on_anomaly": True},
                  csv_monitor={"enabled": True, "output_path": tmp,
                               "job_name": "8f"})
    torch.cuda.reset_peak_memory_stats()
    eng, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(cfg),
                                             config=config)
    losses, step_s = [], []
    reg = get_registry()
    for _ in range(len(base["losses"])):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(batch=batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if reg.get("training_loss").value != losses[-1] or \
                reg.get("training_grad_norm").value != \
                eng.get_global_grad_norm():
            raise AssertionError("8f: the registry's training_loss / "
                                 "training_grad_norm differ from the step's")
    if losses != base["losses"]:
        raise AssertionError(f"8f: observed losses {losses} != telemetry-"
                             f"off losses {base['losses']}")
    with open(os.path.join(tmp, "8f", "Train_loss.csv")) as fh:
        rows = [r.strip().split(",") for r in fh if r.strip()]
    if [int(r[0]) for r in rows[1:]] != list(range(1, len(losses) + 1)) or \
            [float(r[1]) for r in rows[1:]] != losses:
        raise AssertionError(f"8f: Train/loss CSV rows {rows}")
    med = statistics.median(step_s[1:]) * 1e3
    syncs = count_syncs(lambda: eng.train_batch(batch=batch))
    log(f"8f (a): telemetry + diagnostics + csv_monitor + memory_breakdown "
        f"on: 5 losses torch.equal to the telemetry-off engine's; registry "
        f"training_loss / training_grad_norm = the returned values each "
        f"step; Train/loss CSV {len(rows) - 1} rows; step ms median "
        f"{med:.1f} against {base['median_ms']:.1f} off "
        f"({med / base['median_ms'] - 1:+.2%}); host syncs a step "
        f"{syncs} against {base['syncs']} off; memory_breakdown "
        f"{eng.memory_breakdown}; csv files "
        f"{len(os.listdir(os.path.join(tmp, '8f')))} [{card}]")
    # -- (c) the remat policies against nothing_saveable ------------------
    state = engine_state(eng)
    ref = None
    micro = {k: torch.as_tensor(v[0]).to(dev) for k, v in batch.items()}
    for pol in POLICIES_8F:
        ds_ckpt.configure(policy=pol)
        # a forward + backward alone: the activations the policy keeps,
        # apart from the update's temporaries
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(
            eng.model.apply(eng._model_params(), micro).float(),
            eng._grad_inputs())
        del grads
        torch.cuda.synchronize()
        act = (torch.cuda.max_memory_allocated() - base_bytes) / 2 ** 30
        times, peaks = [], []
        f0 = flash_launches()["flash_fwd"]
        for _ in range(3):
            restore_state(eng, state)
            torch.cuda.synchronize()
            base_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = eng.train_batch(batch=batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            peaks.append((torch.cuda.max_memory_allocated() - base_bytes)
                         / 2 ** 30)
        fwd = (flash_launches()["flash_fwd"] - f0) / 3
        if ref is None:
            ref = (loss, [g.clone() for g in eng._grad_acc])
            same = True
        else:
            same = loss == ref[0] and all(
                torch.equal(a, b) for a, b in zip(eng._grad_acc, ref[1]))
        log(f"8f (c) {pol}: loss and grads torch.equal to "
            f"nothing_saveable: {same}; step ms median "
            f"{statistics.median(times):.1f} ({[f'{t:.1f}' for t in times]}); "
            f"peak above the state {max(peaks):.2f} GiB, of one micro-batch's "
            f"forward + backward {act:.2f} GiB; flash_fwd "
            f"{fwd:.0f} a step (2 x L x gas = {2 * L * gas}) [{card}]")
        if not same:
            raise AssertionError(f"8f: {pol} differs from nothing_saveable")
        want = L * gas if "attn" in pol else 2 * L * gas
        if fwd != want:
            raise AssertionError(f"8f: {pol} launched flash_fwd {fwd} times "
                                 f"a step, not {want}")
    ds_ckpt.configure(policy="nothing_saveable")
    del ref
    # -- (d) forward / backward / step over gas 2 = train_batch -----------
    restore_state(eng, state)
    eng.train_batch(batch=batch)
    after = engine_state(eng)
    restore_state(eng, state)
    for g in range(gas):
        eng.backward(eng(
            {k: v[g] for k, v in batch.items()}))
    eng.step()
    if not same_state(eng, after):
        raise AssertionError("8f: forward/backward/step differ from "
                             "train_batch")
    log("8f (d): forward / backward / step over gas 2: master, params and "
        "moments torch.equal to train_batch's")
    del after, state
    # -- (b) a NaN written into one named leaf ----------------------------
    n0 = len(anomaly.recent())
    tok = int(batch["input_ids"][0, 0, 0])
    with torch.no_grad():
        eng.params["embed"][tok, 0] = float("nan")
    nan_loss = eng.train_batch(batch=batch)
    verdicts = anomaly.recent()[n0:]
    pm_root = os.path.join(tmp, "pm")
    bundles = os.listdir(pm_root) if os.path.isdir(pm_root) else []
    top = [t["bucket"] for t in verdicts[0]["top_buckets"]] if verdicts \
        else []
    log(f"8f (b): NaN at embed[{tok}, 0]: loss {nan_loss}, verdicts "
        f"{[v['kind'] for v in verdicts]}, top buckets {top}, bundles "
        f"{bundles}")
    if not (np.isnan(nan_loss) and len(verdicts) == 1
            and verdicts[0]["kind"] == "nan_loss" and top[:1] == ["embed"]
            and len(bundles) == 1):
        raise AssertionError("8f: the NaN leaf did not give one nan_loss "
                             "verdict naming embed and one bundle")
    free_engine(eng)
    del eng
    # -- (e) universal checkpoints at 2 layers ----------------------------
    universal_phase(dev, tmp, batch)
    shutil.rmtree(tmp, ignore_errors=True)
    out = {k: v - launches0[k] for k, v in flash_launches().items()}
    log(f"phase 8f: {time.perf_counter() - t_phase:.0f}s; flash launches "
        f"{out}")
    return out


def universal_phase(dev, tmp, batch):
    """8f (e) at 2 layers (the fp32 master and moments of 4 Mistral-width
    layers are 13.5 GB a copy on disk, and a conversion writes a second
    copy): a stage-0 engine trains 2 steps and saves; ds_to_universal
    converts; a stage-3 engine and a tiered-offload engine of other
    weights load the directory and take the next step: each loss
    torch.equal to the saving engine's own next step. Then
    AsyncCheckpointEngine writes the card's layer tensors once."""
    import dataclasses

    from deepspeed_tpu_torch.checkpoint.universal import ds_to_universal
    from deepspeed_tpu_torch.models import mistral_7b
    from deepspeed_tpu_torch.runtime.checkpoint_engine import \
        AsyncCheckpointEngine

    two = dataclasses.replace(mistral_7b(), num_layers=2)
    nxt = {"input_ids": np.random.default_rng(11).integers(
        0, two.vocab_size, (OFFLOAD_GAS, TRAIN_B, TRAIN_S))}
    src, *_ = offload_run(two, offload_config(None, stage=0), batch, 2,
                          "8f (e) stage 0 L=2 (to save)")
    ck, uni = os.path.join(tmp, "ck"), os.path.join(tmp, "universal")
    t0 = time.perf_counter()
    src.save_checkpoint(ck)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds_to_universal(ck, uni)
    conv_s = time.perf_counter() - t0
    nbytes = dir_bytes(uni)
    shutil.rmtree(ck)
    # AsyncCheckpointEngine over the card's tensors: the snapshot is taken
    # at save(); the tensors change right after it
    layers = src.params["layers"]
    want = {k: v.float().cpu() for k, v in layers.items()}
    ace = AsyncCheckpointEngine()
    t0 = time.perf_counter()
    ace.save({"layers": layers}, os.path.join(tmp, "layers.npz"))
    snap_s = time.perf_counter() - t0
    ref = src.train_batch(batch=nxt)
    ace.commit("8f")
    got = ace.load(os.path.join(tmp, "layers.npz"))["layers"]
    if not all(torch.equal(torch.from_numpy(got[k]), want[k]) for k in want):
        raise AssertionError("8f: AsyncCheckpointEngine wrote other values "
                             "than the tensors held at save()")
    free_engine(src)
    del src, layers, want, got
    log(f"8f (e): stage-0 save {save_s:.1f}s, ds_to_universal "
        f"{conv_s:.1f}s ({nbytes / 1e9:.2f} GB of fragments); "
        f"AsyncCheckpointEngine save() of the card's layer tensors "
        f"returned in {snap_s:.2f}s, the file equal to them")
    for label, config in (("stage 3", offload_config(None, stage=3)),
                          ("tiered", offload_config(TIERED))):
        dst, *_ = offload_run(two, config, batch, 0,
                              f"8f (e) {label} L=2 (to load)", seed=1)
        t0 = time.perf_counter()
        dst.load_universal_checkpoint(uni)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        loss = dst.train_batch(batch=nxt)
        log(f"8f (e) {label}: load_universal_checkpoint {load_s:.1f}s, "
            f"next loss {loss!r} torch.equal to the saving engine's "
            f"{ref!r}: {loss == ref}")
        if loss != ref:
            raise AssertionError(f"8f: {label} after the universal load "
                                 f"{loss} != {ref}")
        free_engine(dst)
        del dst
    shutil.rmtree(uni)


# ---------------------------------------------------------------------------
# phase 8c: ZeRO 1/2/3 over torch.distributed (NCCL, world 1)
# ---------------------------------------------------------------------------
def nccl_calls(prof):
    """{op: (calls, device ms)} of the c10d NCCL calls in a profile (the
    ``nccl:*`` ranges; at one rank NCCL runs a gather or scatter as a
    device copy inside them)."""
    out = {}
    for e in prof.key_averages():
        if e.key.startswith("nccl:"):
            n, t = out.get(e.key, (0, 0.0))
            dt = (getattr(e, "device_time_total", 0.0) or 0.0) / 1e3
            out[e.key] = (max(n, e.count), t + dt)
    return out


def zero_dp_phase(dev, card):
    """Phase 8c: the data-parallel engine at stages 1-3, bucketed and off,
    against stage 0 at world 1 over NCCL. Returns the flash launches and
    the stage-3 and stage-2 "off" engines' losses and params after 2 steps
    (what phases 8h and 8k's engines must equal), with their median step
    ms."""
    import dataclasses

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b
    from deepspeed_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    comm.init_distributed()
    backend, world = dist.get_backend(), dist.get_world_size()
    log(f"phase 8c: process group backend {backend}, world {world}")
    if backend != "nccl" or world != 1:
        raise AssertionError(f"phase 8c needs one NCCL rank, got "
                             f"{backend} x {world}")
    cfg = dataclasses.replace(mistral_7b(), num_layers=4)
    L, gas, steps = cfg.num_layers, 2, 3
    rng = np.random.default_rng(4)          # phase 8's fixed batch
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (gas, TRAIN_B, TRAIN_S))}
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    want = {"flash_fwd": steps * 2 * L * gas,
            "flash_bwd_dq": steps * L * gas, "flash_bwd_dkv": steps * L * gas}
    total = {k: 0 for k in want}
    ref, bad, rows, two_steps = None, [], [], {}
    for stage, mode in [(0, "off")] + [(s, m) for s in (1, 2, 3)
                                       for m in ("bucketed", "off")]:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        config = {"train_micro_batch_size_per_gpu": TRAIN_B,
                  "gradient_accumulation_steps": gas,
                  "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
                  "gradient_clipping": 1.0, "bf16": {"enabled": True},
                  "steps_per_print": 10 ** 9,
                  "zero_optimization": {
                      "stage": stage, "overlap_grad_reduce": mode,
                      "stage3_param_persistence_threshold": 0}}
        t0 = time.perf_counter()
        eng, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(cfg),
                                                 config=config)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        for kfn in kernels:
            kfn.launches = 0
        losses, step_s = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(eng.train_batch(batch=batch))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if mode == "off" and stage in (2, 3) and len(losses) == 2:
                two_steps[stage] = (list(losses), [
                    p.detach().clone() for p in eng._param_leaves])
        launches = {kfn.__name__: kfn.launches for kfn in kernels}
        for k, n in launches.items():
            total[k] += n
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(step_s[1:]) * 1e3
        params = [p.detach() for p in eng._param_leaves]
        if ref is None:
            ref = (losses, [p.clone() for p in params])
            equal = True
        else:
            equal = losses == ref[0] and all(
                torch.equal(a, b) for a, b in zip(params, ref[1]))
        tag = f"stage {stage} {mode}"
        rows.append((tag, med, peak))
        if mode == "off":
            two_steps[f"ms{stage}"] = med
        log(f"phase 8c {tag}: grad reduction {eng.grad_overlap_mode}, "
            f"losses {losses}, equal to stage 0: {equal}; step ms "
            f"{[f'{x * 1e3:.1f}' for x in step_s]}, median of steps 2-3 "
            f"{med:.1f}; init {init_s:.2f}s; peak {peak:.2f} GiB; launches "
            f"{launches} [{card}]")
        if eng.grad_bucket_plan is not None:
            log(eng.grad_bucket_plan.summary())
        if not equal:
            bad.append(f"{tag}: differs from stage 0")
        if launches != want:
            bad.append(f"{tag}: launches {launches} != {want}")
        if stage == 3 and mode == "off":
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.train_batch(batch=batch)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            calls = nccl_calls(prof)
            kern = device_events(prof)
            dev_ms = sum(t for t, _ in kern.values())
            log(f"phase 8c profile of one stage-3 step: wall {wall:.1f} ms, "
                f"device {dev_ms:.2f} ms, busy {dev_ms / wall:.3f}; NCCL "
                f"calls {sum(n for n, _ in calls.values())}, device "
                f"{sum(t for _, t in calls.values()):.3f} ms [{card}]")
            for k, (n, t) in sorted(calls.items()):
                log(f"   {t:.3f} ms {n}x  {k}")
            for k, (t, c) in sorted(kern.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
                log(f"   {t:.3f} ms {c}x  {k[:90]}")
            for op in ("gather", "scatter"):
                if not any(op in k and n > 0 and t > 0
                           for k, (n, t) in calls.items()):
                    bad.append(f"the stage-3 profile shows no NCCL {op} "
                               f"on the card")
        eng.close()
        del eng, params
    del ref
    comm.destroy_process_group()
    base = rows[0]
    for tag, med, peak in rows[1:]:
        log(f"phase 8c {tag}: step {med:.1f} ms ({med / base[1]:.3f}x "
            f"stage 0's {base[1]:.1f}), peak {peak:.2f} GiB (stage 0 "
            f"{base[2]:.2f}) [{card}]")
    log(f"phase 8c: {time.perf_counter() - t_phase:.0f}s; flash launches "
        f"{total}")
    if bad:
        raise AssertionError("phase 8c: " + "; ".join(bad))
    gc.collect()
    torch.cuda.empty_cache()
    return total, two_steps


# ---------------------------------------------------------------------------
# phase 8h: tensor / sequence parallelism and the rest of ZeRO on one card
# ---------------------------------------------------------------------------
RING_S, RING_CHUNK = 8192, 1024


# 8h (d): the per-rank (q, kv) heads that a padded layout of uneven tensor
# parallelism would give Mistral-7B: at tp 3 the 8 kv heads padded to 9, 3
# a rank, each with its 4 query heads (12); at tp 16 (kvh 8 < tp) a rank's
# 2 query heads and the one kv head they read. The layout is not built
# (check_tp refuses uneven splits, ROADMAP A8, and the JAX engine refuses
# them too); this checks only that the kernels take such shapes.
UNEVEN_TP_HEADS = (("tp 3, padded", 12, 3), ("tp 16, kvh < tp", 2, 1))


def tp_head_checks(dev):
    """8h (a): the attention kernels at the per-rank head counts tensor
    parallelism gives Mistral-7B / Mixtral width (nh 32, kvh 8, hd 128):
    16 / 4, 8 / 2 and 4 / 1 heads at tp 2, 4 and 8; 8h (d): those a padded
    uneven layout would give at tp 3 and tp 16 (``UNEVEN_TP_HEADS``). Paged
    decode (bf16 and int8 pools), a mixed ragged batch (both pools), dense
    decode and the three flash kernels, each against its plain version at
    phase 2's and phase 3's tolerances; each split plan logged."""
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import (
        page_split_plan, paged_attention, paged_attention_plain)
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import (
        ragged_attention, ragged_attention_plain, singleton_plans)
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.decode_attention import (
        dense_decode_attention, dense_decode_attention_plain, split_plan)

    rng = np.random.default_rng(8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    mb = 2048 // BS
    dec_lens = [1, 63, 64, 65, 500, 1024, 1537, 2048]
    N = len(dec_lens)
    n_pages = 1 + sum(-(-n // BS) for n in dec_lens) + 64
    lengths = torch.as_tensor(dec_lens, dtype=torch.int32, device=dev)
    rows_pos = [list(range(512)), list(range(704, 800))] + [
        [n - 1] for n in (1, 100, 640, 1000, 1536, 2048)]
    worst = 0.0
    layouts = [(f"tp {tp}", NH // tp, KVH // tp) for tp in (2, 4, 8)]
    for label, nh, kvh in layouts + list(UNEVEN_TP_HEADS):
        tag = f"{label} (nh {nh}, kvh {kvh})"
        tables = torch.as_tensor(tables_for(rng, dec_lens, n_pages, mb),
                                 device=dev)
        q = torch.randn((N, nh, HD), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        chunk, n_split = page_split_plan(N, kvh, mb, BS)
        log(f"8h {tag}: paged plan grid ({N * kvh}, {n_split}) = "
            f"{N * kvh * n_split} blocks of {chunk}-page chunks")
        k_cache, v_cache = make_pool(gen, n_pages, dev, kvh=kvh)
        args = (q, k_cache, v_cache, tables, lengths)
        worst = max(worst, check_close(f"8h {tag} paged_attention",
                                       paged_attention(*args),
                                       paged_attention_plain(*args), TOL))
        kq, vq, ks, vs = make_q8_pool(gen, n_pages, dev, kvh=kvh)
        pool = (kq, vq, tables, lengths, ks, vs)
        worst = max(worst, check_close(f"8h {tag} paged_attention_q8",
                                       paged_attention(q, *pool),
                                       paged_attention_plain(q, *pool), TOL))
        for q8 in (False, True):
            case = ragged_case(gen, rng, dev, list(enumerate(rows_pos)),
                               T=1024, nh=nh, kvh=kvh, q8=q8)
            rargs = case["args"]
            R, MB = rargs[5].shape
            plans = singleton_plans(rargs[0].shape[0], R, kvh, MB, BS)
            name = "ragged_attention" + ("_q8" if q8 else "")
            log(f"8h {tag} {name}: tile grid ({nh // 2}, "
                f"{rargs[0].shape[0] // 64 + 1}), singleton plans {plans}")
            worst = max(worst, check_close(f"8h {tag} {name}",
                                           ragged_attention(*rargs),
                                           ragged_attention_plain(*rargs),
                                           TOL))
        M, B = 2048, 8
        dl = torch.as_tensor([1536, 2048] * (B // 2), dtype=torch.int32,
                             device=dev)
        dq = torch.randn((B, nh, HD), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        kc, vc = (torch.randn((B, kvh, M, HD), generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        chunk, n_split = split_plan(B, kvh, M)
        log(f"8h {tag}: dense decode plan grid ({B * kvh}, {n_split}) = "
            f"{B * kvh * n_split} blocks of {chunk}-slot chunks")
        worst = max(worst, check_close(
            f"8h {tag} dense_decode_attention",
            dense_decode_attention(dq, kc, vc, dl),
            dense_decode_attention_plain(dq, kc, vc, dl), TOL))
        bh, bhk, S = TRAIN_B * nh, TRAIN_B * kvh, TRAIN_S

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16)

        log(f"8h {tag}: flash grids over {bh} q heads x {S // 64} 64-row "
            f"tiles, {bhk} kv heads (group {bh // bhk})")
        err_o, err_g = flash_check(fa, f"8h {tag} flash bf16 causal S {S}",
                                   rnd(bh, S, HD), rnd(bhk, S, HD),
                                   rnd(bhk, S, HD), rnd(bh, S, HD), True,
                                   TOL, 2e-2)
        worst = max(worst, err_o)
        del k_cache, v_cache, kq, vq, pool, kc, vc
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def cuda_median_ms(fn, reps=3, warmup=1):
    """Median ms of ``fn`` on the card's clock (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ring_check(dev, card):
    """8h (b): ring attention over a one-rank seq group at B 1, nh 32, kvh
    8, hd 128, S 8192, q_chunk = kv_chunk = 1024, causal, bf16: its output
    within 1e-2 absolute of the flash kernels' on the same inputs (one
    bf16 rounding step where |o| >= 2, where that step is 0.0156) and its
    gradients within 2e-2 of max |flash|; forward+backward ms (median of
    CUDA events) and peak memory of both."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention
    from deepspeed_tpu_torch.sequence.ring_attention import ring_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, k, v = (rnd(1, NH, RING_S, HD), rnd(1, KVH, RING_S, HD),
               rnd(1, KVH, RING_S, HD))
    do = rnd(1, NH, RING_S, HD)

    def run(fn):
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = fn(qs, ks, vs)
        o.backward(do)
        return o.detach(), (qs.grad, ks.grad, vs.grad)

    def ring(a, b, c):
        return ring_attention(a, b, c, causal=True, q_chunk=RING_CHUNK,
                              kv_chunk=RING_CHUNK)

    def flash(a, b, c):
        return flash_attention(a, b, c, causal=True)

    rows = {}
    outs = {}
    for name, fn in (("ring", ring), ("flash", flash)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        outs[name] = run(fn)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        ms = cuda_median_ms(lambda: run(fn))
        rows[name] = (ms, peak)
    (o_r, g_r), (o_f, g_f) = outs["ring"], outs["flash"]
    diff = (o_r.float() - o_f.float()).abs()
    err_o = diff.max().item()
    # both outputs are f32 results rounded to bf16: where |o| >= 2 one
    # rounding step (2^-6 = 0.0156) exceeds 1e-2, so there the bound is
    # one bf16 step of the flash output's magnitude
    step = torch.exp2(torch.floor(torch.log2(
        o_f.float().abs().clamp_min(2.0 ** -126))) - 7)
    limit = torch.maximum(torch.full_like(step, 1e-2), step)
    past = diff > 1e-2
    over = int(past.sum())
    steps = (diff[past] / step[past]).max().item() if over else 0.0
    err_g = {n: (a.float() - b.float()).abs().max().item()
             / max(b.float().abs().max().item(), 1e-30)
             for n, a, b in zip(("dq", "dk", "dv"), g_r, g_f)}
    log(f"8h ring S {RING_S} chunks {RING_CHUNK}: o max_abs_err vs flash "
        f"{err_o:.3e} (1e-2, or one bf16 step where |o| >= 2: {over} of "
        f"{diff.numel()} elements past 1e-2, at most {steps:.2f} steps), "
        f"grads rel {err_g} (2e-2); fwd+bwd ms ring "
        f"{rows['ring'][0]:.2f} / flash {rows['flash'][0]:.2f}, extra peak "
        f"GiB ring {rows['ring'][1]:.2f} / flash {rows['flash'][1]:.2f} "
        f"[{card}]")
    finite = bool(torch.isfinite(o_r).all()) and all(
        bool(torch.isfinite(g).all()) for g in g_r)
    if not (finite and bool((diff <= limit).all())
            and all(e <= 2e-2 for e in err_g.values())):
        raise AssertionError(f"8h: ring attention disagrees with flash: o "
                             f"{err_o}, grads {err_g}")
    del q, k, v, do, outs, o_r, g_r, o_f, g_f
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def parallel_phase(dev, card, ref):
    """Phase 8h: (a) the kernels at tensor-parallel head counts, (b) ring
    attention against flash at S 8192, (c) the training engine at one NCCL
    rank with tensor_parallel_size / sequence_parallel_size /
    mics_shard_size 1 and reduce_scatter false: its 2-step losses and
    params torch.equal to phase 8c's stage-3 engine (``ref``), the flash
    kernels launched on its path, check_engine_sanity clean. Returns the
    flash launches of (c)."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.utils.sanity import check_engine_sanity

    t_phase = time.perf_counter()
    worst = tp_head_checks(dev)
    log(f"8h (a), (d): every kernel within its tolerance at the tp 2 / 4 / "
        f"8 head counts and those of a padded uneven layout (tp 3: 12 / 3, "
        f"tp 16: 2 / 1) (worst {worst:.3e}); "
        f"{time.perf_counter() - t_phase:.0f}s")
    t0 = time.perf_counter()
    ring_check(dev, card)
    log(f"8h (b): {time.perf_counter() - t0:.0f}s")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(mistral_7b(), num_layers=4)
    L, gas, steps = cfg.num_layers, 2, 2
    rng = np.random.default_rng(4)          # phase 8's fixed batch
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (gas, TRAIN_B, TRAIN_S))}
    config = {"train_micro_batch_size_per_gpu": TRAIN_B,
              "gradient_accumulation_steps": gas,
              "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
              "gradient_clipping": 1.0, "bf16": {"enabled": True},
              "steps_per_print": 10 ** 9,
              "tensor_parallel_size": 1, "sequence_parallel_size": 1,
              "zero_optimization": {
                  "stage": 3, "overlap_grad_reduce": "off",
                  "stage3_param_persistence_threshold": 0,
                  "mics_shard_size": 1, "reduce_scatter": False}}
    eng, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(cfg),
                                             config=config)
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for kfn in kernels:
        kfn.launches = 0
    losses = [eng.train_batch(batch=batch) for _ in range(steps)]
    torch.cuda.synchronize()
    launches = {kfn.__name__: kfn.launches for kfn in kernels}
    want = {"flash_fwd": steps * 2 * L * gas,
            "flash_bwd_dq": steps * L * gas, "flash_bwd_dkv": steps * L * gas}
    equal = losses == ref[0] and all(
        torch.equal(a.detach(), b) for a, b in zip(eng._param_leaves, ref[1]))
    report = check_engine_sanity(eng, raise_on_error=False)
    log(f"8h (c): world-1 engine with the tp / sp / MiCS keys at 1 and "
        f"reduce_scatter false: losses {losses}, torch.equal to phase 8c's "
        f"stage 3: {equal}; launches {launches}; check_engine_sanity "
        f"{report}; {time.perf_counter() - t0:.0f}s [{card}]")
    eng.close()
    del eng
    comm.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    bad = []
    if not equal:
        bad.append("the engine differs from phase 8c's stage 3")
    if launches != want:
        bad.append(f"launches {launches} != {want}")
    if not report["ok"]:
        bad.append(f"check_engine_sanity reported {report['problems']}")
    if bad:
        raise AssertionError("phase 8h: " + "; ".join(bad))
    log(f"phase 8h: {time.perf_counter() - t_phase:.0f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 8k: quantized communication (ZeRO++, the quantized rings, 1-bit)
# ---------------------------------------------------------------------------
# the 1-bit runs' lr: past a freeze at step 1 an Adam update is m / (sqrt(v)
# + eps) with one step's variance (large where v is small); LAMB's is
# scaled by its trust ratio
ONEBIT_LR = {"OneBitAdam": 3e-5, "OneBitLamb": 1e-3, "ZeroOneAdam": 3e-5}


def quant_counts(reset=False):
    from deepspeed_tpu_torch.ops import quantizer_kernels as qk
    out = {"quantize_blocks": qk.quantize_blocks.launches,
           "dequantize_blocks": qk.dequantize_blocks.launches}
    if reset:
        qk.quantize_blocks.launches = qk.dequantize_blocks.launches = 0
    return out


class plain_quantizer:
    """Routes ``comm/quantized.py``'s quantize / dequantize calls through
    the plain versions for a comparison run."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops import quantizer_kernels as qk
        self.saved = (qk.quantize_blocks, qk.dequantize_blocks)
        qk.quantize_blocks = qk.quantize_blocks_plain
        qk.dequantize_blocks = qk.dequantize_blocks_plain
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops import quantizer_kernels as qk
        qk.quantize_blocks, qk.dequantize_blocks = self.saved


def zeropp_engines(dev, card, refs, cfg, batch):
    """8k (a): ZeRO++ and quantized_reduce at one NCCL rank, where the JAX
    engine quantizes nothing: each engine's 2-step losses and params
    torch.equal to phase 8c's unquantized engine of its stage; hpZ 2
    refused as the JAX topology refuses it. Returns the flash launches."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    L, gas, steps = cfg.num_layers, 2, 2
    want = {"flash_fwd": steps * 2 * L * gas,
            "flash_bwd_dq": steps * L * gas, "flash_bwd_dkv": steps * L * gas}
    total = {k: 0 for k in want}
    bad = []
    runs = [("qwZ + qgZ", 3, {"zero_quantized_weights": True,
                              "zero_quantized_gradients": True}),
            ("quantized_reduce int8", 2, {"quantized_reduce": "int8"}),
            ("quantized_reduce fp8", 2, {"quantized_reduce": "fp8"})]
    for tag, stage, extra in runs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        config = {"train_micro_batch_size_per_gpu": TRAIN_B,
                  "gradient_accumulation_steps": gas,
                  "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
                  "gradient_clipping": 1.0, "bf16": {"enabled": True},
                  "steps_per_print": 10 ** 9,
                  "zero_optimization": {
                      "stage": stage, "overlap_grad_reduce": "off",
                      "stage3_param_persistence_threshold": 0, **extra}}
        eng, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(cfg),
                                                 config=config)
        for kfn in kernels:
            kfn.launches = 0
        before = quant_counts()
        losses, step_s = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(eng.train_batch(batch=batch))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = {kfn.__name__: kfn.launches for kfn in kernels}
        for k, n in launches.items():
            total[k] += n
        ref = refs[stage]
        equal = losses == ref[0] and all(
            torch.equal(a.detach(), b)
            for a, b in zip(eng._param_leaves, ref[1]))
        quantized = quant_counts() != before
        log(f"8k (a) ZeRO {stage} {tag} at one rank: losses {losses}, "
            f"torch.equal to 8c's stage {stage}: {equal}; quantizer "
            f"launches {quant_counts()} (unchanged: {not quantized}); "
            f"residual state {eng.quant_reduce_state}; step ms "
            f"{[f'{x * 1e3:.1f}' for x in step_s]} (8c stage {stage}: "
            f"{refs[f'ms{stage}']:.1f}); peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
            f"launches {launches} [{card}]")
        if not equal:
            bad.append(f"{tag} differs from 8c's stage {stage}")
        if quantized:
            bad.append(f"{tag} quantized at one rank")
        if launches != want:
            bad.append(f"{tag}: launches {launches} != {want}")
        eng.close()
        del eng
    try:
        deepspeed_tpu_torch.initialize(model=TransformerLM(cfg), config={
            "train_micro_batch_size_per_gpu": TRAIN_B,
            "gradient_accumulation_steps": gas,
            "zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}})
        bad.append("hpZ 2 at one rank was not refused")
    except ValueError as exc:
        log(f"8k (a) hpZ 2 at one rank: ValueError, as the JAX topology "
            f"raises: {exc}")
    if bad:
        raise AssertionError("8k (a): " + "; ".join(bad))
    return total


def zeropp_transport(dev, card, cfg, flush):
    """8k (b), (c): the ZeRO-3 gather with qwZ and qgZ on every stacked
    leaf of the train cell over the one-rank NCCL group, forward and
    backward, and the int8 / fp8 wire on its largest gradient bucket:
    kernels against the plain quantizer (max |diff| 0), a repeat
    bit-identical, times against the unquantized gather. Returns the
    quantizer launches of the main drive (the first kernel run)."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm import quantized as tq
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.runtime.engine import _flatten
    from deepspeed_tpu_torch.runtime.grad_overlap import plan_grad_buckets
    from deepspeed_tpu_torch.runtime.zero.partition import (build_zero_plan,
                                                            zero_dim)

    comm.init_distributed()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = TransformerLM(cfg).init_params(gen, dtype=torch.bfloat16)
    leaves = params["layers"]
    names = sorted(leaves)
    dims = {k: zero_dim(tuple(leaves[k].shape), 1) for k in names}
    cots = {k: torch.randn(leaves[k].shape, generator=gen, device=dev,
                           dtype=torch.bfloat16) for k in names}

    def run(quantized):
        out = {}
        for k in names:
            p = leaves[k].detach().requires_grad_(True)
            g = tq.make_zero3_gather(dims[k], None, fwd_quantized=quantized,
                                     bwd_quantized=quantized)(p)
            g.backward(cots[k])
            out[k] = (g.detach(), p.grad)
        return out

    quant_counts(reset=True)
    got = run(True)
    torch.cuda.synchronize()
    main = quant_counts(reset=True)
    if dev.type == "cuda" and not all(main.values()):
        bad_launch = f"the quantized gathers launched {main}"
    else:
        bad_launch = None
    with plain_quantizer():
        want = run(True)
    again = run(True)
    bad, worst = ([bad_launch] if bad_launch else []), 0.0
    for k in names:
        for a, b, c in zip(got[k], want[k], again[k]):
            worst = max(worst, float((a.float() - b.float()).abs().max()))
            if not torch.equal(a, b) or not torch.equal(a, c):
                bad.append(k)
    n_params = sum(leaves[k].numel() for k in names)
    del want, again
    fwd_bwd = {}
    for q in (True, False):
        fwd_bwd[q] = time_ms(lambda q=q: run(q), flush, reps=5, warmup=1)
    bf16_bytes = 2 * n_params
    wire4 = sum(tq.quant_wire_bytes(leaves[k].numel() // 4) for k in names)
    log(f"8k (b) ZeRO-3 gather, qwZ + qgZ, {len(names)} stacked leaves "
        f"({n_params / 1e9:.3f} B params, bf16, dims {dims}) over a "
        f"one-rank NCCL group: forward and gradients equal to the plain "
        f"quantizer's (max |diff| {worst}), a repeat bit-identical: "
        f"{not bad}; quantizer launches of one forward + backward {main}; "
        f"forward + backward {fwd_bwd[True]:.2f} ms against "
        f"{fwd_bwd[False]:.2f} ms unquantized (CUDA events, median of 5, "
        f"L2 flushed) [{card}]; computed, not measured: at 4 ranks a rank "
        f"would send {wire4 / 1e6:.1f} MB of int8 blocks + scales a gather "
        f"against {bf16_bytes / 4 / 1e6:.1f} MB of bf16 "
        f"({bf16_bytes / 4 / wire4:.2f}x)")
    del got, cots
    # (c) the wire on the largest gradient bucket of the stage-2 plan
    shapes = {k: tuple(v.shape) for k, v in _flatten(params)}
    total_n = sum(torch.Size(v).numel() for v in shapes.values())
    plan = plan_grad_buckets(
        sorted(shapes), [shapes[k] for k in sorted(shapes)],
        build_zero_plan(1, 2, shapes), 500_000_000, 500_000_000)
    big = max(b.numel for b in plan.buckets)
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    x = torch.randn(big, generator=gen, device=dev) * 1e-3
    for mode in ("int8", "fp8"):
        quant_counts(reset=True)
        q, s = tq._quantize_wire(x, 2048, mode)
        d = tq._dequantize_wire(q, s, big)
        torch.cuda.synchronize()
        for k, n in quant_counts(reset=True).items():
            main[k] += n
        with plain_quantizer():
            q2, s2 = tq._quantize_wire(x, 2048, mode)
            d2 = tq._dequantize_wire(q2, s2, big)
        # the fp8 wire is plain torch: its card result against the CPU's
        cpu = tq._quantize_wire(x[:1 << 20].cpu(), 2048, mode)
        same = (torch.equal(q.view(torch.uint8), q2.view(torch.uint8))
                and torch.equal(s, s2) and torch.equal(d, d2)
                and torch.equal(q[:(1 << 20) // 2048].cpu().view(torch.uint8),
                                cpu[0].view(torch.uint8))
                and torch.equal(s[:(1 << 20) // 2048].cpu(), cpu[1]))
        del q2, s2, d2
        for n_small in (100, 1):
            qs = tq._quantize_wire(x[:n_small], 2048, mode)
            with plain_quantizer():
                qp = tq._quantize_wire(x[:n_small], 2048, mode)
            same = same and qs[0].shape[1] == n_small and torch.equal(
                qs[0].view(torch.uint8), qp[0].view(torch.uint8))
        t_q = time_ms(lambda: tq._quantize_wire(x, 2048, mode), flush, 5, 1)
        t_d = time_ms(lambda: tq._dequantize_wire(q, s, big), flush, 5, 1)
        err = float((d - x).abs().max() / x.abs().max())
        log(f"8k (c) {mode} wire on the largest stage-2 bucket ({big} f32 "
            f"elements, block 2048): equal to the plain versions (and the "
            f"CPU's on 1 M elements; clamped 100- and 1-element messages): "
            f"{same}; quantize {t_q:.3f} ms, dequantize {t_d:.3f} ms; "
            f"max error {err:.2e} of max |x|; {quant_wire_bytes_line(big)} "
            f"[{card}]")
        if not same:
            bad.append(f"the {mode} wire differs from its plain version")
        del q, s, d
    del x
    if bad:
        raise AssertionError("8k (b), (c): differ from the plain quantizer "
                             "or not repeatable: " + ", ".join(bad))
    return main, total_n


def quant_wire_bytes_line(n):
    from deepspeed_tpu_torch.comm.quantized import quant_wire_bytes
    return (f"one hop {quant_wire_bytes(n) / 1e6:.1f} MB against "
            f"{4 * n / 1e6:.1f} MB f32 (computed)")


def onebit_phase(dev, card, cfg, batch, total_n):
    """8k (d): compressed_allreduce_padded over the train cell's flat
    momentum buffer at one rank (ms, peak; a 1 M-element buffer equal to
    the CPU's result), then the train cell with OneBitAdam, OneBitLamb and
    ZeroOneAdam, freeze at step 1, 3 steps, ZeRO 0, no clipping: losses
    finite and falling. Returns the flash launches."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import compressed as tc
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.ops import flash_attention as fa

    bad = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    padded = tc.padded_numel(total_n, 1)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    buf = torch.randn(total_n, generator=gen, device=dev) * 1e-3
    we = torch.zeros(padded, device=dev)
    se = torch.zeros(padded, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, we, se = tc.compressed_allreduce_padded(buf, we, se)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    ms = cuda_median_ms(lambda: tc.compressed_allreduce_padded(buf, we, se))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    two = bool(torch.isfinite(out).all()) and out.unique().numel() <= 2
    small = buf[:1 << 20].contiguous()
    pad_s = tc.padded_numel(small.numel(), 1)
    got = tc.compressed_allreduce_padded(
        small, torch.zeros(pad_s, device=dev), torch.zeros(pad_s, device=dev))
    ref = tc.compressed_allreduce_padded(
        small.cpu(), torch.zeros(pad_s), torch.zeros(pad_s))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
    log(f"8k (d) compressed_allreduce_padded over {total_n} f32 elements "
        f"(padded {padded}) at one rank: {ms:.2f} ms (first call "
        f"{first:.1f} ms), peak {peak:.2f} GiB above its inputs; output "
        f"+-scale only: {two}; a 1 M-element buffer equal to the CPU's: "
        f"{same} [{card}]")
    if not (two and same):
        bad.append("the compressed allreduce")
    del buf, we, se, out, got, ref
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    total = {k.__name__: 0 for k in kernels}
    L, gas, steps = cfg.num_layers, 2, 3
    for opt, params in (("OneBitAdam", {"freeze_step": 1}),
                        ("OneBitLamb", {"freeze_step": 1}),
                        ("ZeroOneAdam", {"var_freeze_step": 1})):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        config = {"train_micro_batch_size_per_gpu": TRAIN_B,
                  "gradient_accumulation_steps": gas,
                  "optimizer": {"type": opt,
                                "params": dict(lr=ONEBIT_LR[opt], **params)},
                  "gradient_clipping": 0.0, "bf16": {"enabled": True},
                  "steps_per_print": 10 ** 9,
                  "zero_optimization": {"stage": 0}}
        eng, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(cfg),
                                                 config=config)
        for kfn in kernels:
            kfn.launches = 0
        losses, step_s = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(eng.train_batch(batch=batch))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = {kfn.__name__: kfn.launches for kfn in kernels}
        for k, n in launches.items():
            total[k] += n
        ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
        log(f"8k (d) {opt} (lr {ONEBIT_LR[opt]}, {params}) at one rank: losses "
            f"{losses}, finite and falling: {ok}; step ms "
            f"{[f'{x * 1e3:.1f}' for x in step_s]}; peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
            f"launches {launches} [{card}]")
        want = {"flash_fwd": steps * 2 * L * gas,
                "flash_bwd_dq": steps * L * gas,
                "flash_bwd_dkv": steps * L * gas}
        if not ok:
            bad.append(f"{opt} losses {losses}")
        if launches != want:
            bad.append(f"{opt} launches {launches} != {want}")
        eng.close()
        del eng
    if bad:
        raise AssertionError("8k (d): " + "; ".join(bad))
    return total


def zeropp_phase(dev, card, refs):
    """Phase 8k: quantized communication at one NCCL rank on the train
    cell (Mistral-7B width, 4 layers, bf16, micro 2 x gas 2 x S 2048).
    Returns the flash and quantizer launches of its main drives."""
    import dataclasses

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import mistral_7b

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(mistral_7b(), num_layers=4)
    rng = np.random.default_rng(4)          # phase 8's fixed batch
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (2, TRAIN_B, TRAIN_S))}
    t0 = time.perf_counter()
    launches = zeropp_engines(dev, card, refs, cfg, batch)
    log(f"8k (a): {time.perf_counter() - t0:.0f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    quant, total_n = zeropp_transport(dev, card, cfg, flush)
    del flush
    launches.update(quant)
    log(f"8k (b), (c): {time.perf_counter() - t0:.0f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for k, n in onebit_phase(dev, card, cfg, batch, total_n).items():
        launches[k] += n
    log(f"8k (d): {time.perf_counter() - t0:.0f}s")
    comm.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 8k: {time.perf_counter() - t_phase:.0f}s; launches "
        f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 8i: pipeline parallelism on one card
# ---------------------------------------------------------------------------
PIPE_STAGES, PIPE_M = 4, 8     # the pp-4 split of 32 layers; M predicted


def pipeline_phase(dev, card):
    """Phase 8i: (a) ``TransformerLM.loss_and_grads`` through the 1F1B
    schedule at a pp-1 topology against the engine's stage-0 step on
    phase 8's model, weights and batch; (b) one middle stage of a pp-4
    split of Mistral-7B's 32 layers (8 layers, the replicated embedding,
    norm and head, AdamW state resident): its forward and backward slots
    through the schedule's stage function with a 7-deep stash, the state
    bytes, and the step time 14 ticks predict at M 8 (a prediction for a
    4-card run). Returns the flash launches of both."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer
    from deepspeed_tpu_torch.parallel.topology import (MeshTopology,
                                                       TopologyConfig)
    from deepspeed_tpu_torch.runtime.engine import _flatten
    from deepspeed_tpu_torch.runtime.pipe.pipeline import backward_slot

    t_phase = time.perf_counter()
    gib = 2 ** 30
    cfg = dataclasses.replace(mistral_7b(), num_layers=4)
    L, gas = cfg.num_layers, 2
    rng = np.random.default_rng(4)          # phase 8's fixed batch
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (gas, TRAIN_B, TRAIN_S))}
    config = dict(TRAIN_CONFIG, gradient_accumulation_steps=gas,
                  telemetry={"enabled": False})
    # phase 8's engine, seed and weights
    eng, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(cfg),
                                             config=config)
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for kfn in kernels:
        kfn.launches = 0
    # -- (a) the engine's stage-0 step up to its reduced gradients ---------
    got = {}

    def capture(acc, shards, scale, lr, events=None, inv=None):
        got["acc"] = acc       # the engine's own buffers; no update runs
        return True, torch.zeros((), device=dev), None

    eng._apply_grads = capture
    eng.train_batch(batch=batch)           # warm-up: the same step again
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref_loss = eng.train_batch(batch=batch)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    ref_peak = (torch.cuda.max_memory_allocated() - base) / gib
    ref = [a.div_(gas) for a in got.pop("acc")]   # the unscale by 1 / gas
    eng_launches = {k.__name__: k.launches // 2 for k in kernels}
    # -- (a) the same micro-batches through the 1F1B schedule ------------
    model = eng.model
    model.set_topology(eng.topology)       # pp 1
    dev_batch = eng._shard_batch(batch)
    params = eng._model_params()
    for kfn in kernels:
        kfn.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = model.loss_and_grads(params, dev_batch)
    torch.cuda.synchronize()
    pp_ms = (time.perf_counter() - t0) * 1e3
    pp_peak = (torch.cuda.max_memory_allocated() - base) / gib
    launches = {k.__name__: k.launches for k in kernels}
    names = [n for n, _ in _flatten(grads)]
    errs, equal = {}, True
    for n, g, r in zip(names, (g for _, g in _flatten(grads)), ref):
        errs[n] = ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)
                   ).item()
        equal = equal and torch.equal(g, r)
    worst = max(errs, key=errs.get)
    loss_gap = abs(float(loss) - ref_loss)
    want = {"flash_fwd": 2 * L * gas, "flash_bwd_dq": L * gas,
            "flash_bwd_dkv": L * gas}
    log(f"8i (a): 1F1B at pp 1 (mistral_7b width, L={L}, bf16, remat, "
        f"micro {TRAIN_B} x M {gas} x S {TRAIN_S}): loss {float(loss)!r} "
        f"against the engine's stage-0 step {ref_loss!r} (gap "
        f"{loss_gap:.3e}); gradients: worst |1F1B - engine| / max "
        f"|engine| {errs[worst]:.3e} ({worst}; tolerance 2e-2), every leaf "
        f"torch.equal: {equal}; flash launches {launches} (predicted "
        f"{want}; the engine's step {eng_launches}); ms 1F1B {pp_ms:.1f}, "
        f"engine step to its gradients {ref_ms:.1f} (its second; phase 8's "
        f"step includes the update); peak above the resident state 1F1B "
        f"{pp_peak:.2f} GiB, engine {ref_peak:.2f} GiB [{card}]")
    model.set_topology(None)
    del grads, ref, params, dev_batch, got
    eng.close()
    del eng, model
    comm.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    bad = []
    if errs[worst] > 2e-2 or not np.isfinite(float(loss)):
        bad.append(f"gradient {worst} differs by {errs[worst]:.3e}")
    if loss_gap > 1e-3 * abs(ref_loss):
        bad.append(f"loss {float(loss)} against {ref_loss}")
    if launches != want:
        bad.append(f"launches {launches} != {want}")
    # -- (b) a middle stage of the pp-4 split of 32 layers ----------------
    full = mistral_7b()
    pp, k = PIPE_STAGES, full.num_layers // PIPE_STAGES
    stage = 1
    model = TransformerLM(full)
    model.set_topology(MeshTopology(TopologyConfig(pipe=pp), world_size=pp,
                                    rank=stage))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = TransformerLM(dataclasses.replace(full, num_layers=k)
                           ).init_params(gen, dtype=torch.bfloat16)
    leaves = [v.requires_grad_(True) for _, v in _flatten(params)]
    n_params = sum(v.numel() for v in leaves)
    # the resident AdamW state: f32 master, m and v, and the engine's f32
    # gradient buffers, which the schedule accumulates into (18 bytes a
    # parameter with the bf16 copy)
    master = [v.detach().float() for v in leaves]
    opt = build_optimizer("adamw", {"lr": 3e-4})
    state = opt.init_state(master)
    acc = [torch.zeros_like(m) for m in master]
    state_bytes = sum(t.numel() * t.element_size() for t in
                      leaves + master + acc
                      + [x for v in state.values() for x in v])
    stage_fn = model.stage_function(stage, TRAIN_S, torch.bfloat16, dev)
    ids = torch.as_tensor(batch["input_ids"][0], device=dev)
    hshape = (TRAIN_B, TRAIN_S, full.hidden_size)
    stash = [torch.randn(hshape, generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2 * pp - 1)]
    cot = torch.randn(hshape, generator=gen, device=dev,
                      dtype=torch.bfloat16) * 1e-3
    for kfn in kernels:
        kfn.launches = 0

    def fwd_slot():
        with torch.no_grad():
            return stage_fn(params, ids, stash[0])

    def run(x_raw, h):
        return stage_fn(params, x_raw, h), None

    diff = list(range(len(leaves)))

    def bwd_slot():
        # the schedule's own slot: a middle stage reads neither the
        # embedding nor the head (their gradients stay None)
        _, gh = backward_slot(run, params, leaves, diff, acc, ids, stash[-1],
                              cot=cot)
        return gh.to(torch.bfloat16)

    fwd_ms = cuda_median_ms(fwd_slot)
    out = fwd_slot()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bwd_ms = cuda_median_ms(bwd_slot)
    gh = bwd_slot()
    peak = torch.cuda.max_memory_allocated() / gib
    upd_ms = cuda_median_ms(lambda: opt.apply(master, acc, state, 1,
                                              lr=3e-4))
    b_launches = {kf.__name__: kf.launches for kf in kernels}
    ticks = PIPE_M + 2 * (pp - 1)
    predicted = ticks * (fwd_ms + bwd_ms) + upd_ms
    finite = bool(torch.isfinite(out).all() and torch.isfinite(gh).all())
    log(f"8i (b): stage {stage} of a pp-{pp} split of mistral_7b's "
        f"{full.num_layers} layers: {k} layers + embedding, norm and head, "
        f"{n_params / 1e9:.3f} B params, state {state_bytes / 1e9:.2f} GB "
        f"resident (bf16 params, f32 master, m, v, gradient accumulator; "
        f"reckoned ~36 GB at 18 B a parameter); a {2 * pp - 1}-deep stash "
        f"of [{TRAIN_B}, {TRAIN_S}, {full.hidden_size}] bf16; forward slot "
        f"{fwd_ms:.2f} ms, backward slot {bwd_ms:.2f} ms, AdamW update "
        f"{upd_ms:.2f} ms (CUDA events, median of 3); peak "
        f"{peak:.2f} GiB; outputs finite {finite}; flash launches "
        f"{b_launches}; PREDICTION for a {pp}-card run (not a "
        f"measurement): {ticks} ticks x (forward + backward) + update = "
        f"{predicted:.1f} ms a step at M {PIPE_M} "
        f"({PIPE_M * TRAIN_B * TRAIN_S} tokens) [{card}]")
    if not finite:
        bad.append("stage outputs not finite")
    if peak > 79:
        bad.append(f"peak {peak:.2f} GiB")
    del params, leaves, master, state, acc, stash, out, gh
    gc.collect()
    torch.cuda.empty_cache()
    total = {n: launches[n] + 2 * eng_launches[n] + b_launches[n]
             for n in launches}
    log(f"phase 8i: {time.perf_counter() - t_phase:.0f}s; flash launches "
        f"{total}")
    if bad:
        raise AssertionError("phase 8i: " + "; ".join(bad))
    return total


# ---------------------------------------------------------------------------
# phase 8b: ZeRO-Offload and native checkpoints
# ---------------------------------------------------------------------------
HOST_SRC = "deepspeed_tpu_torch/csrc/host/"
OFFLOAD_GAS = 2
RESIDENT_BYTES_PER_PARAM = 18      # bf16 param, f32 master, m, v, f32 grad
HOST_STATE_BYTES_PER_PARAM = 12    # f32 master, m, v
# what a run with its layer stack or layer files on the host holds beside
# its state: the process, the CUDA context, the pinned transfer ring,
# staging buffers (a 29-layer offload_param run held 5.6 GiB more than its
# state and the RSS before it)
HOST_MARGIN_GIB = 8.0
HOST_CAP_GIB = 96.0


def meminfo_gib(key):
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 2 ** 20
    raise KeyError(key)


def host_limit_gib():
    """The host memory a run may hold: MemTotal, capped at what one
    card's machine gives a run (HOST_CAP_GIB, below its MemTotal of 101
    GiB; the run is ended when it passes it)."""
    return min(meminfo_gib("MemTotal"), HOST_CAP_GIB)


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


def offload_run(cfg, config, batch, steps, label, params=None, seed=0,
                on_init=None):
    """An engine of ``config`` trained ``steps`` times on ``batch``: (engine,
    losses, step seconds, peak device GiB above what was allocated before
    it, init seconds), logged. ``on_init(engine, bytes)`` sees the device
    bytes the engine's init allocated, before the first step."""
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
    if on_init is not None:
        on_init(eng, torch.cuda.memory_allocated() - base)
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


def offload_width_phase(dev, cfg, batch, deep=False):
    """Resident, tiered (pin_memory, stage 2) and legacy (stage 2) on the
    same weights and fixed batch, 3 steps each: tiered equal to resident bit
    for bit, legacy within rtol 0.05, atol 1e-2 (one bf16 rounding of the
    shipped gradients). With ``deep`` (the full depth is this depth) the
    tiered and legacy runs are also the full-depth runs, held by
    ``offload_deep_checks``. Returns the resident and tiered engines'
    median step ms and peak GiB (phase 8l's yardstick) and the flash
    launches of the full-depth runs."""
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    deep_launches = {kfn.__name__: 0 for kfn in kernels}

    def run(label, config):
        for kfn in kernels:
            kfn.launches = 0
        out = offload_run(cfg, config, batch, 3, f"{label} L={L}",
                          params=weights)
        return out, {kfn.__name__: kfn.launches for kfn in kernels}

    def deep_checks(label, out, launches):
        """After the run's comparisons: the profiled step moves it on."""
        if deep:
            offload_deep_checks(label, L, out[0], batch, *out[1:4],
                                launches)
            for k in deep_launches:
                deep_launches[k] += launches[k]

    gen = torch.Generator(device=dev).manual_seed(0)
    weights = TransformerLM(cfg).init_params(gen, dtype=torch.bfloat16)
    L = cfg.num_layers
    (res, r_loss, r_s, r_peak, _), _ = run("resident",
                                           offload_config(stage=2))
    t_out, t_launches = run("tiered", offload_config(TIERED))
    tier, t_loss, t_s, t_peak, _ = t_out
    if t_loss != r_loss:
        raise AssertionError(f"tiered losses {t_loss} != resident {r_loss}")
    compare_tiered_resident(res, tier)
    log(f"offload L={L}: tiered == resident bit for bit (losses, params, "
        f"master, exp_avg, exp_avg_sq)")
    deep_checks("tiered", t_out, t_launches)
    free_engine(tier)
    del tier, t_out
    l_out, l_launches = run("legacy", offload_config(LEGACY))
    leg, l_loss, l_s, l_peak, _ = l_out
    if not np.allclose(l_loss, r_loss, rtol=0.05, atol=1e-2):
        raise AssertionError(f"legacy losses {l_loss} vs resident {r_loss}")
    log(f"offload L={L}: legacy within rtol 0.05 / atol 1e-2 of resident "
        f"(max |diff| {max(abs(a - b) for a, b in zip(l_loss, r_loss)):.2e}); "
        f"median step ms resident {statistics.median(r_s[1:]) * 1e3:.1f}, "
        f"tiered {statistics.median(t_s[1:]) * 1e3:.1f}, legacy "
        f"{statistics.median(l_s[1:]) * 1e3:.1f}")
    deep_checks("legacy", l_out, l_launches)
    free_engine(leg)
    free_engine(res)
    del leg, res, weights, l_out
    return {"resident": (statistics.median(r_s[1:]) * 1e3, r_peak),
            "tiered": (statistics.median(t_s[1:]) * 1e3, t_peak)}, \
        deep_launches


LAMB = {"type": "lamb", "params": {"lr": 3e-4, "weight_decay": 0.01}}


def lamb_tiered_phase(dev, cfg, batch, adamw):
    """Phase 8l: LAMB (a trust ratio per leaf, whole leaves in the tiered
    buckets) over the tiered tier at the train cell, ZeRO 2, against
    resident LAMB on the same weights and fixed batch, 3 steps each:
    losses, params, master and moments torch.equal; flash launches 2 x L
    x gas and L x gas a step; median step ms and peak GiB of both beside
    8b's AdamW engines (``adamw``). Returns the flash launches."""
    from deepspeed_tpu_torch.models import TransformerLM

    gen = torch.Generator(device=dev).manual_seed(0)
    weights = TransformerLM(cfg).init_params(gen, dtype=torch.bfloat16)
    (res, r_loss, r_s, r_peak, _), n1 = tier_run(
        cfg, offload_config(stage=2, optimizer=LAMB), batch, 3,
        f"8l resident LAMB L={cfg.num_layers}", weights)
    (tier, t_loss, t_s, t_peak, _), n2 = tier_run(
        cfg, offload_config(TIERED, optimizer=LAMB), batch, 3,
        f"8l tiered LAMB L={cfg.num_layers}", weights)
    if t_loss != r_loss:
        raise AssertionError(f"8l: tiered LAMB losses {t_loss} != resident "
                             f"{r_loss}")
    compare_tiered_resident(res, tier)
    if not (all(np.isfinite(r_loss)) and r_loss[-1] < r_loss[0]):
        raise AssertionError(f"8l: LAMB losses not finite and falling: "
                             f"{r_loss}")
    ho = tier.host_opt
    r_ms, t_ms = (statistics.median(x[1:]) * 1e3 for x in (r_s, t_s))
    log(f"8l L={cfg.num_layers}: tiered LAMB == resident LAMB bit for bit "
        f"(losses "
        f"{[f'{x:.4f}' for x in t_loss]}, params, master, exp_avg, "
        f"exp_avg_sq); median step ms resident {r_ms:.1f}, tiered "
        f"{t_ms:.1f} ({t_ms / r_ms:.2f}x); peak GiB {r_peak:.2f} / "
        f"{t_peak:.2f}; {len(ho.buckets)} buckets of whole leaves; 8b's "
        f"AdamW resident {adamw['resident'][0]:.1f} ms / "
        f"{adamw['resident'][1]:.2f} GiB, tiered {adamw['tiered'][0]:.1f} "
        f"ms / {adamw['tiered'][1]:.2f} GiB; flash launches a step "
        f"{ {k: v // 3 for k, v in n2.items()} }")
    free_engine(tier)
    free_engine(res)
    del tier, res, weights
    return {k: n1[k] + n2[k] for k in n1}


# the depth and steps of the deep offload runs of phases 8b, 8d and 8e:
# 2 layers and 2 steps, cut from 32 (8b), 26 (8d) and 20 (8e) layers
# (their host caps) and 3 steps to make room for phases 2e and 8f, then
# from 12 layers for phases 2f and 8g, from 8 for phases 2g and 8j, from
# 6 for phase 8l and from 4 for phase 2h, within the run's time limit. At these depths the
# resident state (18 B a parameter) would still fit the card: these runs show the
# offloaded engines at depth, not a depth only offload reaches (earlier
# versions of this script did, at 20-32 layers)
DEEP_LAYERS = 2
DEEP_STEPS = 2
# the depth of phases 8d's and 8e's reference comparisons: 4 layers
# before, cut (with DEEP_LAYERS, 6 before) to keep the run well inside its
# time limit; 2 layers still give the stacked leaves an order to get wrong
TIER_WIDTH_LAYERS = 2


def full_depth_layers(cfg, bytes_per_param=HOST_STATE_BYTES_PER_PARAM,
                      margin_gib=4.0, max_layers=DEEP_LAYERS):
    """``max_layers`` unless the host cannot hold the f32 state (12 B a
    parameter) beside this process: then the deepest depth that fits,
    never below min(20, max_layers)."""
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.kv_heads * cfg.head_dim
    per_layer = 2 * h * h + 2 * h * kv + 3 * h * f + 2 * h
    fixed = 2 * v * h + h
    room = host_limit_gib() - host_rss_gib() - margin_gib
    top = min(cfg.num_layers, max_layers)
    for L in range(top, min(max_layers, 20) - 1, -1):
        need = (fixed + L * per_layer) * bytes_per_param / 2 ** 30
        if need <= room:
            return L, need, room, fixed + L * per_layer
    raise AssertionError(f"the host cannot hold {L} layers of f32 state "
                         f"({room:.1f} GiB free)")


def offload_deep_line(base):
    """The depth of phase 8b's full-depth runs (``full_depth_layers``),
    logged with the host memory it needs; returns (L, that config)."""
    import dataclasses

    L, need, room, n_params = full_depth_layers(base)
    log(f"offload full depth: L={L} of {base.num_layers} (cut to "
        f"{DEEP_LAYERS} for the run's time limit), "
        f"{n_params / 1e9:.3f} B params; host state {need:.1f} GiB of "
        f"{room:.1f} GiB the host can give (limit "
        f"{host_limit_gib():.1f}, MemTotal "
        f"{meminfo_gib('MemTotal'):.1f}, MemAvailable "
        f"{meminfo_gib('MemAvailable'):.1f}, RSS {host_rss_gib():.1f}); "
        f"resident state would be {RESIDENT_BYTES_PER_PARAM} B x "
        f"{n_params / 1e9:.2f} B = "
        f"{RESIDENT_BYTES_PER_PARAM * n_params / 1e9:.0f} GB")
    return L, dataclasses.replace(base, num_layers=L)


def offload_deep_checks(label, L, eng, batch, losses, step_s, peak,
                        launches):
    """The checks of a full-depth offload run of ``len(losses)`` steps:
    losses finite and falling, flash launches 2·L·gas / L·gas / L·gas a
    step, peak device memory under 80 GiB; then one more step under
    torch.profiler for the split into device, transfer and host
    optimizer. Returns the run's step ms, peak GiB."""
    steps = len(losses)
    want = {"flash_fwd": steps * 2 * L * OFFLOAD_GAS,
            "flash_bwd_dq": steps * L * OFFLOAD_GAS,
            "flash_bwd_dkv": steps * L * OFFLOAD_GAS}
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{label} L={L} losses not finite and "
                             f"falling: {losses}")
    if launches != want:
        raise AssertionError(f"{label} L={L} launches {launches} != {want}")
    if peak >= 80.0:
        raise AssertionError(f"{label} L={L} peak device memory "
                             f"{peak:.2f} GiB >= 80 GiB")
    tokens = OFFLOAD_GAS * TRAIN_B * TRAIN_S
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
    return {"step_ms": med * 1e3, "peak_gib": peak}


def offload_full_depth_phase(dev, batch, L, cfg):
    """Mistral-7B at full depth (``offload_deep_line``) through both offload
    backends, DEEP_STEPS steps each on one fixed batch, held by
    ``offload_deep_checks``. Returns their flash launches."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    total = {kfn.__name__: 0 for kfn in kernels}
    for label, off in (("legacy", LEGACY), ("tiered", TIERED)):
        for kfn in kernels:
            kfn.launches = 0
        eng, losses, step_s, peak, _ = offload_run(
            cfg, offload_config(off), batch, DEEP_STEPS, f"{label} L={L}")
        launches = {kfn.__name__: kfn.launches for kfn in kernels}
        offload_deep_checks(label, L, eng, batch, losses, step_s, peak,
                            launches)
        for k in total:
            total[k] += launches[k]
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
                                  f"legacy (RAM) L={cfg.num_layers}")
    free_engine(cpu)
    del cpu
    eng, n_loss, n_s, *_ = offload_run(
        cfg, offload_config(nvme, aio={"thread_count": 8}), batch, 2,
        f"legacy (NVMe) L={cfg.num_layers}")
    ho = eng.host_opt
    if not np.allclose(n_loss, c_loss, rtol=1e-5):
        raise AssertionError(f"NVMe losses {n_loss} != RAM tier {c_loss}")
    files = sum(len(fs) for _, _, fs in os.walk(ho.swap_dir))
    log(f"offload NVMe L={cfg.num_layers}: losses equal the RAM tier's "
        f"within 1e-5 "
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
                              f"{label} L={cfg.num_layers} (to save)")
        t0 = time.perf_counter()
        src.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        nbytes = dir_bytes(path)
        ref = src.train_batch(batch=nxt)
        free_engine(src)
        del src
        dst, *_ = offload_run(cfg, offload_config(off), batch, 0,
                              f"{label} L={cfg.num_layers} (to load)", seed=1)
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
        log(f"checkpoint {label} L={cfg.num_layers}: save {save_s:.1f}s, "
            f"load {load_s:.1f}s, "
            f"{nbytes / 1e9:.2f} GB ({nbytes / save_s / 1e9:.2f} GB/s "
            f"written); resumed loss {got:.6f} == uninterrupted {ref:.6f}")
        free_engine(dst)
        del dst
        shutil.rmtree(path)
    shutil.rmtree(root, ignore_errors=True)


def offload_phase(dev):
    """Phase 8b: host ops, the three engines and phase 8l at
    TIER_WIDTH_LAYERS layers, both offload backends at full depth, the NVMe
    tier and checkpoints at 2 layers. Returns (flash launches of the
    full-depth runs and 8l, the host_ops record)."""
    import dataclasses

    from deepspeed_tpu_torch.models import mistral_7b

    host = host_ops_phase()
    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(0, mistral_7b().vocab_size,
                                       (OFFLOAD_GAS, TRAIN_B, TRAIN_S))}
    width = dataclasses.replace(mistral_7b(), num_layers=TIER_WIDTH_LAYERS)
    deep_L, deep_cfg = offload_deep_line(mistral_7b())
    # at the width runs' depth the full-depth runs would repeat them: the
    # width runs carry the full-depth checks instead
    fold = deep_L == TIER_WIDTH_LAYERS
    t0 = time.perf_counter()
    adamw, launches = offload_width_phase(dev, width, batch, deep=fold)
    log(f"offload L={TIER_WIDTH_LAYERS} phase: "
        f"{time.perf_counter() - t0:.0f}s" + (
            " (with the full-depth checks: the same depth)" if fold else ""))
    t0 = time.perf_counter()
    lamb = lamb_tiered_phase(dev, width, batch, adamw)
    log(f"phase 8l: {time.perf_counter() - t0:.0f}s")
    if not fold:
        t0 = time.perf_counter()
        launches = offload_full_depth_phase(dev, batch, deep_L, deep_cfg)
        log(f"offload full-depth phase: {time.perf_counter() - t0:.0f}s")
    for k, n in lamb.items():
        launches[k] += n
    two = dataclasses.replace(mistral_7b(), num_layers=2)
    t0 = time.perf_counter()
    nvme_phase(dev, two, batch)
    log(f"offload NVMe phase: {time.perf_counter() - t0:.0f}s")
    t0 = time.perf_counter()
    checkpoint_phase(dev, two, batch)
    log(f"checkpoint phase: {time.perf_counter() - t0:.0f}s")
    return launches, host


# ---------------------------------------------------------------------------
# phases 8d and 8e: parameter offload, activation offload, ZeRO-Infinity
# ---------------------------------------------------------------------------
# peak device GiB of phase 8b's offload runs at 32 layers (PERF.md §2)
OFFLOAD_32L_PEAK_GIB = {"tiered": 60.27, "legacy": 57.49}
# f32 master, m, v and f32 host gradients, and the bf16 layer files in
# the page cache
INFINITY_HOST_BYTES_PER_PARAM = 18
PARAM_STACK_BYTES_PER_PARAM = 2      # the bf16 layer stack in pinned memory


def tier_config(zero=None, **extra):
    """Phase 8's settings at stage 3 (persistence threshold 0)."""
    cfg = offload_config(stage=3, **extra)
    cfg["zero_optimization"]["stage3_param_persistence_threshold"] = 0
    cfg["zero_optimization"].update(zero or {})
    return cfg


def flash_counts(reset=False):
    from deepspeed_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    if reset:
        for kfn in kernels:
            kfn.launches = 0
    return {kfn.__name__: kfn.launches for kfn in kernels}


def flash_want(L, steps, gas=OFFLOAD_GAS):
    return {"flash_fwd": steps * 2 * L * gas,
            "flash_bwd_dq": steps * L * gas,
            "flash_bwd_dkv": steps * L * gas}


def tier_run(cfg, config, batch, steps, label, params, on_init=None):
    """offload_run with the flash launches of its steps checked (2 x L x
    gas forwards with the recompute, L x gas of each backward kernel);
    returns offload_run's tuple and the launches."""
    flash_counts(reset=True)
    out = offload_run(cfg, config, batch, steps, label, params=params,
                      on_init=on_init)
    launches = flash_counts()
    want = flash_want(cfg.num_layers, steps)
    if launches != want:
        raise AssertionError(f"{label}: flash launches {launches} != {want}")
    return out, launches


def equal_engines(label, a, b, a_loss, b_loss):
    """Losses and compute params torch.equal (host tiers' masters too)."""
    if a_loss != b_loss:
        raise AssertionError(f"{label}: losses {b_loss} != {a_loss}")
    for name, x, y in zip(a._leaf_names, a._param_leaves, b._param_leaves):
        if not torch.equal(x.detach().cpu(), y.detach().cpu()):
            raise AssertionError(f"{label}: params differ at {name}")
    if a.host_opt is not None:
        for name, x, y in zip(a._leaf_names, a.host_opt.get_all_leaves()[0],
                              b.host_opt.get_all_leaves()[0]):
            if not torch.equal(x, y):
                raise AssertionError(f"{label}: masters differ at {name}")
    log(f"{label}: losses and params torch.equal over 3 steps")


def param_offload_width_phase(dev, cfg, batch, weights, deep=False):
    """Phase 8d at ``cfg``'s depth (``TIER_WIDTH_LAYERS``), stage 3:
    offload_param {device: cpu} against the resident engine, with the
    host C++ optimizer against that
    optimizer alone (JAX refuses the tiered optimizer offload at stage 3,
    and so does the port), and cpu_checkpointing against the resident
    engine: torch.equal each, the stack in pinned host memory. With
    ``deep`` (the full depth is this depth) the offload_param + host
    optimizer run is also the full-depth run, held by
    ``param_offload_deep_checks``. Returns the launches, the legacy
    losses and the full-depth record (None without ``deep``)."""
    L = cfg.num_layers
    from deepspeed_tpu_torch.runtime.config import (ConfigError,
                                                    DeepSpeedConfig)

    launches = dict.fromkeys(flash_want(0, 0), 0)

    def add(n):
        for k in launches:
            launches[k] += n[k]

    po = {"offload_param": {"device": "cpu"}}
    (res, r_loss, r_s, r_peak, _), n = tier_run(
        cfg, tier_config(), batch, 3, f"resident stage 3 L={L}", weights)
    add(n)
    (off, o_loss, o_s, o_peak, _), n = tier_run(
        cfg, tier_config(po), batch, 3, f"offload_param cpu L={L}", weights)
    add(n)
    layers = off.params["layers"]
    if not all(v.device.type == "cpu" and v.is_pinned()
               for v in layers.values()):
        raise AssertionError("offload_param: the layer stack is not in "
                             "pinned host memory")
    if any(v.device.type != "cuda" for k, v in off.params.items()
           if k != "layers"):
        raise AssertionError("offload_param: a persistent leaf left the card")
    equal_engines("8d offload_param cpu vs resident stage 3", res, off,
                  r_loss, o_loss)
    st = off.host_stream.timings()
    stack = sum(v.numel() * v.element_size() for v in layers.values())
    log(f"8d L={L}: stack {stack / 2**30:.2f} GiB pinned on the host; median "
        f"step ms resident {statistics.median(r_s[1:]) * 1e3:.1f}, "
        f"offload_param {statistics.median(o_s[1:]) * 1e3:.1f}; peak device "
        f"{r_peak:.2f} / {o_peak:.2f} GiB; layer copies "
        f"{st['h2d_ms']:.1f} ms on the side stream over 3 steps, compute "
        f"stream waited {st['wait_ms']:.1f} ms")
    free_engine(off)
    del off
    ck = {"activation_checkpointing": {"cpu_checkpointing": True}}
    (cpu_ck, c_loss, c_s, c_peak, _), n = tier_run(
        cfg, tier_config(**ck), batch, 3, f"cpu_checkpointing L={L}", weights)
    add(n)
    equal_engines("8d cpu_checkpointing vs resident stage 3", res, cpu_ck,
                  r_loss, c_loss)
    log(f"8d L={L}: cpu_checkpointing median step ms "
        f"{statistics.median(c_s[1:]) * 1e3:.1f}, peak device {c_peak:.2f} "
        f"GiB (resident {r_peak:.2f})")
    free_engine(cpu_ck)
    free_engine(res)
    del cpu_ck, res
    try:
        DeepSpeedConfig(tier_config(dict(po, offload_optimizer=TIERED)))
    except ConfigError as e:
        log(f"8d: the tiered optimizer offload at stage 3 is refused, as in "
            f"JAX ({str(e)[:70]}...)")
    else:
        raise AssertionError("the tiered optimizer offload at stage 3 was "
                             "accepted")
    (leg, l_loss, _, l_peak, _), n = tier_run(
        cfg, tier_config({"offload_optimizer": LEGACY}), batch, 3,
        f"legacy stage 3 L={L}", weights)
    add(n)
    (lpo, p_loss, p_s, p_peak, p_init), n = tier_run(
        cfg, tier_config(dict(po, offload_optimizer=LEGACY)), batch, 3,
        f"offload_param cpu + legacy L={L}", weights)
    add(n)
    equal_engines("8d offload_param cpu + legacy vs legacy", leg, lpo,
                  l_loss, p_loss)
    log(f"8d L={L}: peak device legacy {l_peak:.2f} GiB, with offload_param "
        f"{p_peak:.2f} GiB")
    record = (param_offload_deep_checks(L, lpo, p_loss, p_s, p_peak, p_init)
              if deep else None)
    free_engine(lpo)
    free_engine(leg)
    del lpo, leg
    return launches, l_loss, record


def param_offload_depth(base):
    """The depth of phase 8d's full-depth run, logged; returns (L, that
    config)."""
    import dataclasses

    L, need, room, n_params = full_depth_layers(
        base, HOST_STATE_BYTES_PER_PARAM + PARAM_STACK_BYTES_PER_PARAM,
        HOST_MARGIN_GIB)
    log(f"8d full depth: L={L} of {base.num_layers}"
        + (" (cut: host memory)" if L < min(DEEP_LAYERS, 20) else
           f" (cut to {DEEP_LAYERS}: the run's time limit)"
           if L < base.num_layers else "")
        + f", {n_params / 1e9:.3f} B params; host state and stack "
        f"{need:.1f} GiB of {room:.1f} GiB")
    return L, dataclasses.replace(base, num_layers=L)


def param_offload_deep_checks(L, eng, losses, step_s, peak, init_s):
    """The checks of phase 8d's full-depth run (offload_param cpu with the
    host C++ optimizer, ``len(losses)`` steps, its flash launches checked
    by ``tier_run``): losses finite and falling; step ms, tokens/s, peak
    device GiB beside phase 8b's at 32 layers, host RSS, the layer copies
    a step and the share of them the compute stream waited for."""
    steps = len(losses)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"8d L={L}: losses not finite and falling: "
                             f"{losses}")
    # the layer copies a step: the mean of the steps
    hs = eng.host_stream
    st, tm = hs.timings(), eng.step_timings()
    st = {k: v / steps for k, v in st.items()}
    h2d = hs.h2d_bytes / steps
    tokens = OFFLOAD_GAS * TRAIN_B * TRAIN_S
    med = statistics.median(step_s[1:])
    log(f"8d L={L}: median step {med * 1e3:.0f} ms = {tokens / med:.0f} "
        f"tokens/s; peak device {peak:.2f} GiB (phase 8b at 32 layers: "
        f"legacy {OFFLOAD_32L_PEAK_GIB['legacy']}, tiered "
        f"{OFFLOAD_32L_PEAK_GIB['tiered']}); "
        f"host RSS {host_rss_gib():.1f} GiB; init {init_s:.1f}s")
    log(f"8d L={L} a step (mean of {steps}): layer copies "
        f"{h2d / 1e9:.2f} GB ({st['h2d_ms']:.0f} ms on the side stream, "
        f"{h2d / max(st['h2d_ms'], 1e-9) / 1e6:.2f} GB/s), compute stream "
        f"waited {st['wait_ms']:.0f} ms (exposed share "
        f"{st['wait_ms'] / max(st['h2d_ms'], 1e-9):.3f}); last step: "
        f"forward+backward {tm.get('grads_ms', 0):.0f} ms, update "
        f"{tm.get('update_ms', 0):.0f} ms")
    return {"L": L, "step_ms": med * 1e3, "peak_gib": peak}


def param_offload_depth_phase(dev, batch, L, cfg):
    """Phase 8d at full depth (``param_offload_depth``): offload_param cpu
    with the host C++ optimizer, DEEP_STEPS steps, held by
    ``param_offload_deep_checks``."""
    config = tier_config({"offload_param": {"device": "cpu"},
                          "offload_optimizer": LEGACY})
    (eng, losses, step_s, peak, init_s), launches = tier_run(
        cfg, config, batch, DEEP_STEPS,
        f"8d offload_param cpu + legacy L={L}", None)
    record = param_offload_deep_checks(L, eng, losses, step_s, peak, init_s)
    free_engine(eng)
    del eng
    return launches, record


def infinity_config(path, optim_nvme=False):
    zero = {"offload_param": {"device": "nvme", "nvme_path": path}}
    if optim_nvme:
        zero["offload_optimizer"] = {"device": "nvme", "nvme_path": path}
    return tier_config(zero, aio={"thread_count": 8})


# less than one Mistral-7B layer in bf16 (0.41 GiB): a layer left on the
# card by ZeRO-Infinity's init fails check_infinity_resident
INFINITY_INIT_SLACK_GIB = 0.25


def check_infinity_resident(label, eng, init_bytes):
    """ZeRO-Infinity's init keeps no layer on the device: no ``layers/``
    leaf among the persistent ones, no compute params, and at most the
    persistent leaves' bytes (plus less than a layer) allocated by the
    init. Returns the persistent bytes."""
    inf = eng._infinity
    stacked = [k for k in list(inf.persist_names) + list(inf.pp_dev)
               if k.startswith("layers/")]
    persist = inf.device_param_bytes()
    slack = INFINITY_INIT_SLACK_GIB * 2 ** 30
    if eng.params is not None or stacked or init_bytes > persist + slack:
        raise AssertionError(
            f"{label}: layer params resident on the device (params "
            f"{'kept' if eng.params is not None else 'None'}, stacked "
            f"leaves among the persistent ones {stacked}, init allocated "
            f"{init_bytes / 2**30:.3f} GiB against the persistent leaves' "
            f"{persist / 2**30:.3f} + {INFINITY_INIT_SLACK_GIB})")
    log(f"{label}: init allocated {init_bytes / 2**30:.3f} GiB on the "
        f"device, the persistent leaves {persist / 2**30:.3f} GiB; no layer "
        f"resident")
    return persist


def infinity_width_phase(dev, cfg, batch, weights, root, l_loss,
                         deep=False):
    """Phase 8e at ``cfg``'s depth (``TIER_WIDTH_LAYERS``): ZeRO-Infinity
    with the optimizer state in host RAM and on NVMe, torch.equal to each other, within phase 8b's
    legacy tolerance of the losses ``l_loss`` of phase 8d's stage-3
    engine with the host C++ optimizer on the same weights; the device
    holds only the persistent leaves. With ``deep`` (the full depth is
    this depth) the host-RAM run is also the full-depth run, held by
    ``infinity_deep_checks``. Returns the launches and the full-depth
    record (None without ``deep``)."""
    L = cfg.num_layers
    runs = {}
    record = None
    for label, on in (("host", False), ("nvme", True)):
        init = {}

        def on_init(e, nbytes, label=label):
            init["persist"] = check_infinity_resident(
                f"8e L={L} optimizer {label}", e, nbytes)
            init["base"] = torch.cuda.memory_allocated()

        # two steps: the optimizer sweep over the files takes ~8 s a step
        (eng, losses, step_s, peak, init_s), n = tier_run(
            cfg, infinity_config(root, on), batch, 2,
            f"infinity (optimizer {label}) L={L}", weights, on_init=on_init)
        inf = eng._infinity
        persist = init["persist"]
        master = [m.clone() for m in inf.get_all_leaves()[0]]
        runs[label] = (losses, master, n)
        log(f"8e L={L} optimizer {label}: median step "
            f"{statistics.median(step_s[1:]) * 1e3:.0f} ms, peak device "
            f"{peak:.2f} GiB, device params {persist / 2**30:.3f} GiB "
            f"(persistent leaves only), init {init_s:.1f}s; timings "
            f"{ {k: round(v, 3) for k, v in inf.timings.items()} }")
        if deep and label == "host":
            record = infinity_deep_checks(L, eng, losses, step_s, peak,
                                          init["base"], init_s,
                                          dict(inf.timings))
        pdir = inf.param_dir
        free_engine(eng)
        del eng
        if os.path.exists(pdir):
            raise AssertionError(f"infinity files left at {pdir}")
    (h_loss, h_master, n1), (v_loss, v_master, n2) = runs["host"], \
        runs["nvme"]
    if h_loss != v_loss or not all(torch.equal(a, b) for a, b in
                                   zip(h_master, v_master)):
        raise AssertionError(f"infinity optimizer on NVMe {v_loss} != on "
                             f"the host {h_loss}")
    if not np.allclose(h_loss, l_loss[:2], rtol=0.05, atol=1e-2):
        raise AssertionError(f"infinity losses {h_loss} vs legacy {l_loss}")
    log(f"8e L={L}: optimizer on NVMe torch.equal to on the host (losses, "
        f"master); within rtol 0.05 / atol 1e-2 of legacy stage 3 (max "
        f"|diff| {max(abs(a - b) for a, b in zip(h_loss, l_loss)):.2e}; "
        f"2 steps)")
    return {k: n1[k] + n2[k] for k in n1}, record


def infinity_depth_layers(cfg, root, max_layers=DEEP_LAYERS):
    """The deepest depth up to ``max_layers`` (never below min(20,
    max_layers)) whose param files fit the free space under ``root`` and
    whose host state fits the host's memory."""
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.kv_heads * cfg.head_dim
    per_layer = 2 * h * h + 2 * h * kv + 3 * h * f + 2 * h
    fixed = 2 * v * h + h
    st = os.statvfs(root)
    disk = st.f_bavail * st.f_frsize / 2 ** 30 - 4.0
    room = host_limit_gib() - host_rss_gib() - HOST_MARGIN_GIB
    for L in range(min(cfg.num_layers, max_layers),
                   min(max_layers, 20) - 1, -1):
        host = (fixed + L * per_layer) * INFINITY_HOST_BYTES_PER_PARAM
        files = L * per_layer * 2
        if host / 2 ** 30 <= room and files / 2 ** 30 <= disk:
            return L, host / 2 ** 30, room, files / 2 ** 30, disk, \
                fixed + L * per_layer
    raise AssertionError(f"ZeRO-Infinity: neither {L} layers' host state "
                         f"({room:.1f} GiB free) nor their files "
                         f"({disk:.1f} GiB free) fit")


def infinity_depth(base, root):
    """The depth of phase 8e's full-depth run (cut by the host's memory or
    the disk), logged; returns (L, that config)."""
    import dataclasses

    L, host, room, files, disk, n_params = infinity_depth_layers(base, root)
    log(f"8e full depth: L={L} of {base.num_layers}"
        + (" (cut: host memory or disk)" if L < min(DEEP_LAYERS, 20) else
           f" (cut to {DEEP_LAYERS}: the run's time limit)"
           if L < base.num_layers else "")
        + f", {n_params / 1e9:.3f} B params; host state {host:.1f} of "
        f"{room:.1f} GiB, param files {files:.1f} of {disk:.1f} GiB free")
    return L, dataclasses.replace(base, num_layers=L)


def infinity_deep_checks(L, eng, losses, step_s, peak, base_b, init_s,
                         timings):
    """The checks of phase 8e's full-depth run (the optimizer in host RAM;
    its flash launches and resident bytes checked by the caller): losses
    finite and falling; step ms, tokens/s, peak device GiB, bytes read a
    step and their rate, the share of each sweep that waits on a read,
    init s and bytes written."""
    inf = eng._infinity
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"8e L={L}: losses not finite and falling: "
                             f"{losses}")
    tokens = OFFLOAD_GAS * TRAIN_B * TRAIN_S
    med = statistics.median(step_s[1:])
    t = timings
    sweeps = t["forward_s"] + t["backward_s"]
    log(f"8e L={L}: losses {[f'{x:.4f}' for x in losses]}, step s "
        f"{[f'{x:.2f}' for x in step_s]}; median {med * 1e3:.0f} ms = "
        f"{tokens / med:.0f} tokens/s; peak device {peak:.2f} GiB (persistent "
        f"params and activations; {base_b / 2**30:.2f} GiB allocated before "
        f"the steps; phase 8b's tiered at 32 layers: "
        f"{OFFLOAD_32L_PEAK_GIB['tiered']}); host RSS "
        f"{host_rss_gib():.1f} GiB")
    log(f"8e L={L} last step: read {t['read_bytes'] / 1e9:.2f} GB from the "
        f"layer files ({t['read_bytes'] / max(sweeps, 1e-9) / 1e9:.2f} GB/s "
        f"over the two sweeps); forward sweep {t['forward_s']:.2f}s, waits "
        f"on reads {t['forward_read_wait_s'] / max(t['forward_s'], 1e-9):.3f}"
        f"; backward sweep {t['backward_s']:.2f}s, waits "
        f"{t['backward_read_wait_s'] / max(t['backward_s'], 1e-9):.3f}; "
        f"optimizer sweep {t['optimizer_s']:.2f}s; init {init_s:.1f}s "
        f"({inf.init_s:.1f}s writing {inf.bytes_written / 1e9:.2f} GB of "
        f"layer files)")
    return {"L": L, "step_ms": med * 1e3, "peak_gib": peak}


def infinity_depth_phase(dev, batch, root, L, cfg):
    """Phase 8e at full depth (``infinity_depth``): DEEP_STEPS steps with
    the optimizer in host RAM, flash launches checked, held by
    ``infinity_deep_checks``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM

    flash_counts(reset=True)
    gc.collect()
    torch.cuda.empty_cache()
    b0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(cfg), config=infinity_config(root))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    inf = eng._infinity
    torch.cuda.reset_peak_memory_stats()
    base_b = torch.cuda.memory_allocated()
    check_infinity_resident(f"8e L={L}", eng, base_b - b0)
    losses, step_s = [], []
    for _ in range(DEEP_STEPS):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(batch=batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = flash_counts()
    want = flash_want(L, DEEP_STEPS)
    if launches != want:
        raise AssertionError(f"8e L={L}: flash launches {launches} != {want}")
    record = infinity_deep_checks(L, eng, losses, step_s, peak, base_b,
                                  init_s, dict(inf.timings))
    free_engine(eng)
    del eng
    return launches, record


def memory_tiers_phase(dev):
    """Phases 8d and 8e on phase 8's settings and fixed batch."""
    import dataclasses

    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b

    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(0, mistral_7b().vocab_size,
                                       (OFFLOAD_GAS, TRAIN_B, TRAIN_S))}
    four = dataclasses.replace(mistral_7b(), num_layers=TIER_WIDTH_LAYERS)
    weights = TransformerLM(four).init_params(
        torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    launches = dict.fromkeys(flash_want(0, 0), 0)

    def add(n):
        for k in launches:
            launches[k] += n[k]

    # at the width runs' depth a full-depth run would repeat one of them:
    # that width run carries the full-depth checks instead
    t0 = time.perf_counter()
    L8, cfg8 = param_offload_depth(mistral_7b())
    n, l_loss, d8 = param_offload_width_phase(
        dev, four, batch, weights, deep=L8 == TIER_WIDTH_LAYERS)
    add(n)
    if d8 is None:
        n, d8 = param_offload_depth_phase(dev, batch, L8, cfg8)
        add(n)
    log(f"phase 8d: {time.perf_counter() - t0:.0f}s")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "nvme_infinity")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    try:
        L9, cfg9 = infinity_depth(mistral_7b(), root)
        n, d9 = infinity_width_phase(
            dev, four, batch, weights, root, l_loss,
            # its host run takes DEEP_STEPS (2) steps
            deep=L9 == TIER_WIDTH_LAYERS and DEEP_STEPS == 2)
        add(n)
        del weights
        if d9 is None:
            n, d9 = infinity_depth_phase(dev, batch, root, L9, cfg9)
            add(n)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 8e: {time.perf_counter() - t0:.0f}s")
    return launches, {"8d": d8, "8e": d9}


# ---------------------------------------------------------------------------
# phase 5 (MoE): small fp32 checks on a tiny Mixtral-style model
# ---------------------------------------------------------------------------
def small_moe_check(dev):
    """A tiny top-2 MoE model in fp32: the v2 kernel engine against the
    plain engine (put() logits 1e-4, streams equal), the v1 engine with the
    dense decode kernel against its einsum route, and a WOQ int8 engine
    against the dense engine of its own dequantized weights."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.quantization import dequantize_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = TransformerLM(TransformerConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, max_seq_len=128, moe_num_experts=4,
        moe_top_k=2))

    def engine(params=None, **kw):
        return InferenceEngineV2(model, RaggedInferenceEngineConfig.from_dict(
            {"dtype": "float32", "prefill_bucket": 16, "decode_window": 8,
             "state_manager": {"max_tracked_sequences": 8, "max_seq_len": 128,
                               "num_blocks": 65, "block_size": 16}, **kw}),
            params=params, device=dev)

    # 79 prompt tokens and decode rows through the grouped experts
    prompts = [list(range(3, 17)), [2, 4, 6], list(range(40, 62)),
               list(range(100, 140))]
    uids = [1, 2, 3, 4]

    def compare(name, a_eng, b_eng, tol=1e-4):
        a = a_eng.put(uids, prompts)
        b = b_eng.put(uids, prompts)
        gap = float(np.abs(a - b).max())
        for e in (a_eng, b_eng):
            for u in uids:
                e.flush(u)
        same = all(np.array_equal(x, y) for x, y in zip(
            a_eng.generate(prompts, max_new_tokens=20),
            b_eng.generate(prompts, max_new_tokens=20)))
        log(f"small fp32 MoE check, {name}: put logits max|diff| "
            f"{gap:.3e} (tolerance {tol}), generate streams equal {same}")
        if not (gap <= tol and same):
            raise AssertionError(f"fp32 MoE {name} disagree on the tiny "
                                 f"model")

    kern = engine(use_paged_kernel=True)
    compare("v2 kernel vs plain engine", kern,
            engine(params=kern.params, use_paged_kernel=False))
    woq = engine(params=kern.params, quant_bits=8)
    compare("WOQ int8 vs the dense engine of its weights", woq,
            engine(params=dequantize_params(woq.params)))
    v1 = {dk: deepspeed_tpu_torch.init_inference(
        TransformerLM(dataclasses.replace(model.cfg, decode_kernel=dk)),
        config={"dtype": "fp32"}, params=kern.params, device=dev)
        for dk in (True, False)}
    ids = np.array([p[:3] for p in prompts])
    step_logits = {}
    for dk, e in v1.items():
        cache = e.model.init_kv_cache(len(ids), 8, torch.float32, dev)
        t = torch.as_tensor(ids, device=dev)
        with torch.no_grad():
            e.model.forward_cached(e.params, t, cache, 0)
            step_logits[dk] = e.model.forward_cached(e.params, t[:, -1:],
                                                     cache, 3)
    gap = (step_logits[True] - step_logits[False]).abs().max().item()
    same = np.array_equal(v1[True].generate(ids, max_new_tokens=20),
                          v1[False].generate(ids, max_new_tokens=20))
    log(f"small fp32 MoE check, v1: decode logits max|kernel - einsum| "
        f"{gap:.3e}, generate streams equal {same}")
    if not (gap <= 1e-4 and same):
        raise AssertionError("fp32 MoE v1 engine with the dense decode "
                             "kernel disagrees with the einsum route")


# ---------------------------------------------------------------------------
# phase 2f: Mixtral-8x7B serving (bf16 at 8 layers, WOQ int8 at 32)
# ---------------------------------------------------------------------------
MOE_SERVE_LAYERS = 8        # bf16: all 32 layers are 93 GB


def routed_put(eng, uids, prompts, tape=None):
    """``eng.put(uids, prompts)`` (then flushed) with the serving MoE's
    routing (``sharded_moe.route_topk``) recorded, or, given the ``tape``
    of another engine's same put(), replaced by it: each row takes the
    taped experts, weighted by its own gate probabilities. Returns
    (logits, tape, the (row, layer) routings whose own top-k differs from
    the taped one)."""
    from deepspeed_tpu_torch.moe import sharded_moe

    orig = sharded_moe.route_topk
    rec, taped, moved = [], iter(tape or ()), []

    def route(probs, k, renormalize_top1):
        topv, topi = orig(probs, k, renormalize_top1)
        if tape is None:
            rec.append(topi)
            return topv, topi
        want = next(taped)
        if want.shape != topi.shape:
            raise AssertionError(f"routing tape {tuple(want.shape)} for "
                                 f"{tuple(topi.shape)}")
        moved.append((topi.sort(-1).values != want.sort(-1).values)
                     .any(-1).sum())
        v = torch.gather(probs, 1, want)
        if k > 1 or renormalize_top1:
            v = v / torch.sum(v, dim=-1, keepdim=True)
        return v, want

    sharded_moe.route_topk = route
    try:
        logits = eng.put(uids, prompts)
    finally:
        sharded_moe.route_topk = orig
    for u in uids:
        eng.flush(u)
    if tape is not None and next(taped, None) is not None:
        raise AssertionError("routing tape longer than the put()'s calls")
    return logits, rec, int(sum(int(m) for m in moved))


def window_device_ms(eng, prompts, window):
    """(device ms of one put() of ``prompts``, device ms and launches a step
    of one fused decode window after it), from two profiled generate()
    runs as ``profile_phase`` takes them."""
    _, _, put_k = profiled(lambda: eng.generate(prompts, max_new_tokens=1))
    _, _, both_k = profiled(
        lambda: eng.generate(prompts, max_new_tokens=1 + window))
    win_k = minus(both_k, put_k)
    return (sum(t for t, _ in put_k.values()),
            sum(t for t, _ in win_k.values()) / window,
            sum(c for _, c in win_k.values()) / window, win_k)


def moe_mlp_share(cfg, eng, put_ms, win_ms, n_tok, n_rows, reps=10):
    """The MoE MLP of one layer (``paged_model._moe_mlp``) alone at the put()
    shape and at the decode shape: a call under CUDA's sync debug mode
    (it fails on a host sync), its time on CUDA events (median of ``reps``
    calls, launch gaps included), its device ms and launches a call from
    one profile of ``reps`` calls, and L times the device ms as a share of
    the step's device ms."""
    from deepspeed_tpu_torch.inference.quantization import dequantize_params
    from deepspeed_tpu_torch.inference.v2 import paged_model

    lp = dequantize_params({k: v[0] for k, v in
                            eng.params["layers"].items()})
    gen = torch.Generator(device=eng.device).manual_seed(5)
    no_flush = torch.empty(1, device=eng.device)   # the weights exceed L2
    for label, rows, step_ms in (("put", n_tok, put_ms),
                                 ("decode step", n_rows, win_ms)):
        x = torch.randn((rows, cfg.hidden_size), generator=gen,
                        device=eng.device, dtype=eng.dtype)

        def call():
            return paged_model._moe_mlp(cfg, lp, x)

        call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")    # raises on a host sync
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ms = statistics.median(time_samples(call, no_flush, reps=reps,
                                            warmup=2))
        _, _, kern = profiled(lambda: [call() for _ in range(reps)])
        dev = sum(t for t, _ in kern.values()) / reps
        n = sum(c for _, c in kern.values()) / reps
        share = (f"{cfg.num_layers * dev / step_ms:.3f}"
                 if dev > 0 and step_ms > 0 else
                 "not measured (the profiler recorded no device event)")
        log(f"2f MoE MLP at the {label} shape ({rows} rows), one layer: "
            f"{ms:.3f} ms (CUDA events), {dev:.3f} device ms and {n:.0f} "
            f"launches (profiler), no host sync; x {cfg.num_layers} layers "
            f"= {share} of the step's {step_ms:.2f} device ms")


def ep_serve_phase(cfg, eng, prompts, new):
    """2g: expert-parallel serving, one rank's path at full width: 2f's
    engine and weights (Mixtral-8x7B, 8 of 32 layers, bf16) with its MoE
    MLP routed through ``moe_layer_dropless_ep`` over a one-rank expert
    group (``paged_model._moe_mlp``'s ep route, given a ``MoEGroups``: the
    worst-case capacity C = k T, dispatch and combine on indices into
    ``[E, C, H]``), the first 4 of 2f's prompts. Against 2f's grouped-GEMM
    route on the same engine: the put() logits at 2f's tolerance (0.05 x
    max|grouped|; both routes gate in f32 and pick the same experts unless
    bf16 rounding moves a token), the greedy streams (first divergence
    logged); TTFT and decode tokens/s of each; the MoE MLP of one layer at
    the put and decode shapes on both routes (CUDA events); the dispatch
    buffer's bytes (E k T H 2) and the peak; then the expert products alone
    at one rank's share for ep 2 / 4 / 8 (E / ep local experts on the ep
    copies of every row the all-to-all brings them). Returns the paged and
    ragged launches of the ep route's generate()."""
    from functools import partial

    from deepspeed_tpu_torch.inference.quantization import dequantize_params
    from deepspeed_tpu_torch.inference.v2 import paged_model
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import \
        ragged_attention
    from deepspeed_tpu_torch.moe import sharded_moe

    t_phase = time.perf_counter()
    N, L = len(prompts), cfg.num_layers
    E, k, H = cfg.moe_num_experts, cfg.moe_top_k, cfg.hidden_size
    uids = list(range(2000, 2000 + N))
    grouped = paged_model._moe_mlp
    ep_mlp = partial(grouped, ep_route=sharded_moe.MoEGroups())
    dispatch = sharded_moe.moe_layer_dropless_ep
    seen = []

    def recording(x, *args, **kwargs):
        seen.append(int(x.shape[0] * x.shape[1]))
        return dispatch(x, *args, **kwargs)

    def run(mlp):
        paged_model._moe_mlp = mlp
        try:
            logits = eng.put(uids, prompts)
            for u in uids:
                eng.flush(u)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = eng.generate(prompts, max_new_tokens=new)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        finally:
            paged_model._moe_mlp = grouped
        ttft = eng.last_ttft_s
        return logits, gen, ttft, N * (new - 1) / (s - ttft)

    ref, ref_gen, ref_ttft, ref_tps = run(grouped)
    sharded_moe.moe_layer_dropless_ep = recording
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    ragged_attention.launches = 0
    try:
        # -- the main path: put() and generate() through the ep route -----
        logits, gen, ttft, tps = run(ep_mlp)
    finally:
        sharded_moe.moe_layer_dropless_ep = dispatch
    launches = dict(paged_attention=paged_attention.launches,
                    ragged_attention=ragged_attention.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    gap = float(np.abs(logits - ref).max())
    tol = 0.05 * float(np.abs(ref).max())
    div = [first_divergence(a, b) for a, b in zip(gen, ref_gen)]
    put_T, dec_T = max(seen), min(seen)
    buf = {T: E * k * T * H * 2 for T in (put_T, dec_T)}
    log(f"2g: ep route (one-rank expert group) put() logits max|ep - "
        f"grouped| = {gap:.4f} against {tol:.4f} (0.05 x max|grouped|), "
        f"argmax agreement "
        f"{float((logits.argmax(-1) == ref.argmax(-1)).mean()):.3f}; greedy "
        f"streams' first divergence {div} (None: identical)")
    log(f"2g: TTFT {ttft * 1e3:.1f} ms, decode {tps:.1f} tokens/s (grouped "
        f"GEMM on the same engine: {ref_ttft * 1e3:.1f} ms, {ref_tps:.1f}); "
        f"dispatch buffers [E, kT, H] at T = {put_T} (put) / {dec_T} "
        f"(decode) = {buf[put_T] / 2**20:.1f} / {buf[dec_T] / 2**20:.3f} "
        f"MiB a layer; peak {peak:.2f} GiB; launches {launches}; "
        f"{len(seen)} dispatch calls")
    if logits.shape != ref.shape or not np.isfinite(logits).all() or \
            not gap <= tol or launches["ragged_attention"] == 0 or \
            launches["paged_attention"] == 0 or not seen:
        raise AssertionError(f"2g: ep route logits off by {gap} > {tol}, "
                             f"or launches {launches}, or no dispatch")
    for g, p in zip(gen, prompts):
        if len(g) != len(p) + new or not ((g >= 0)
                                          & (g < cfg.vocab_size)).all():
            raise AssertionError("2g: a stream is short or out of vocab")
    # one layer's MoE MLP on both routes at the put and decode shapes
    lp = dequantize_params({n: v[0] for n, v in eng.params["layers"].items()})
    gen_x = torch.Generator(device=eng.device).manual_seed(6)
    no_flush = torch.empty(1, device=eng.device)
    for label, rows in (("put", put_T), ("decode", dec_T)):
        x = torch.randn((rows, H), generator=gen_x, device=eng.device,
                        dtype=eng.dtype)
        ms = {name: statistics.median(time_samples(
            lambda f=f: f(cfg, lp, x), no_flush, reps=10, warmup=2))
            for name, f in (("ep", ep_mlp), ("grouped", grouped))}
        log(f"2g MoE MLP, one layer, {label} shape ({rows} rows): ep route "
            f"{ms['ep']:.3f} ms, grouped GEMM {ms['grouped']:.3f} ms (CUDA "
            f"events, median of 10)")
    # the expert products alone at one rank's share of ep 2 / 4 / 8
    wg, wu, wd = lp["e_gate"], lp["e_up"], lp["e_down"]
    F = wg.shape[-1]
    for ep in (2, 4, 8):
        e_loc = E // ep
        for label, T in (("put", put_T), ("decode", dec_T)):
            rows = ep * k * T          # ep copies of the capacity C = k T
            x = torch.randn((e_loc, rows, H), generator=gen_x,
                            device=eng.device, dtype=eng.dtype)
            p = (wg[:e_loc], wu[:e_loc], wd[:e_loc])
            ms = statistics.median(time_samples(
                lambda: sharded_moe.swiglu_experts(p, x), no_flush, reps=5,
                warmup=1))
            tflops = 2 * 3 * e_loc * rows * H * F / (ms * 1e-3) / 1e12
            log(f"2g ep {ep}: {e_loc} local experts x {rows} rows "
                f"({label}, T {T}): {ms:.3f} ms, {tflops:.0f} TFLOP/s")
            del x
    log(f"phase 2g: {time.perf_counter() - t_phase:.0f}s")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_serve_phase(dev):
    """2f (a): Mixtral-8x7B width at 8 layers in bf16 through pipeline() and
    generate(), the serve phase's 8 prompts; then (b) all 32 layers under
    WOQ int8. Returns the launches of both main paths."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import \
        ragged_attention
    from deepspeed_tpu_torch.models import TransformerLM, mixtral_8x7b
    from deepspeed_tpu_torch.ops.decode_attention import \
        dense_decode_attention

    cfg = dataclasses.replace(mixtral_8x7b(), num_layers=MOE_SERVE_LAYERS)
    L = cfg.num_layers
    t0 = time.perf_counter()
    pipe = deepspeed_tpu_torch.pipeline(
        cfg, device=dev,
        config={"dtype": "bfloat16",
                "ragged": {"seed": 0, "decode_window": 8,
                           "state_manager": {"max_ragged_batch_size": 8192}}})
    eng = pipe.engine
    torch.cuda.synchronize()
    log(f"2f: mixtral_8x7b L={L} (of 32) hidden={cfg.hidden_size} "
        f"experts {cfg.moe_num_experts} top-{cfg.moe_top_k} bf16 seeded "
        f"weights in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (128, 256, 384, 512, 640, 768, 896, 1024)]
    new, N = 64, len(prompts)
    pipe([prompts[0][:64]], max_new_tokens=4)                   # warm-up

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
    log(f"2f: pipeline {N} requests in {pipe_s:.2f}s; generate in "
        f"{gen_s:.2f}s (TTFT {ttft * 1e3:.1f} ms for the {N}-prompt put, "
        f"decode {N * (new - 1) / (gen_s - ttft):.1f} tokens/s)")
    log(f"2f: steps {steps} launches {launches}; MoE experts through "
        f"torch._grouped_mm over the rows sorted by expert")
    for o, g, p in zip(outs, gen, prompts):
        if len(o) != new or len(g) != len(p) + new or not (
                ((o >= 0) & (o < cfg.vocab_size)).all()
                and ((g >= 0) & (g < cfg.vocab_size)).all()):
            raise AssertionError("2f: a request did not get all its tokens "
                                 "in [0, vocab)")
    if launches["ragged_attention"] != L * steps["ragged"] or \
            launches["paged_attention"] != L * steps["decode"] or \
            steps["ragged"] == 0 or steps["decode"] == 0:
        raise AssertionError(f"2f: launches {launches} != {L} x steps "
                             f"{steps}")
    if steps["syncs"] != steps["windows"]:
        raise AssertionError(f"2f: {steps['syncs']} host syncs for "
                             f"{steps['windows']} decode windows")
    gen2 = eng.generate(prompts, max_new_tokens=new)
    if not all(np.array_equal(a, b) for a, b in zip(gen, gen2)):
        raise AssertionError("2f: a repeated generate() gave other streams")
    # the same put() through the plain versions in bf16, its routing
    # recorded; the kernel engine's put() free and routed as the plain
    # engine routed: top-2 routing is discrete, so one bf16 rounding can
    # move a token to another expert, and only the routed comparison can
    # be held to the serve phase's rule (0.05 x max|plain|)
    uids = list(range(1000, 1000 + N))
    plain = InferenceEngineV2(
        TransformerLM(cfg), RaggedInferenceEngineConfig.from_dict(
            {"dtype": "bfloat16", "use_paged_kernel": False,
             "state_manager": {"max_ragged_batch_size": 8192}}),
        params=eng.params, device=dev)
    ref, tape, _ = routed_put(plain, uids, prompts)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    free, _, _ = routed_put(eng, uids, prompts)
    logits, _, moved = routed_put(eng, uids, prompts, tape)
    gap = float(np.abs(logits - ref).max())
    tol = 0.05 * float(np.abs(ref).max())
    for name, x in (("free kernel - plain", free),
                    ("routed kernel - plain", logits)):
        log(f"2f: put() logits max|{name}| = "
            f"{float(np.abs(x - ref).max()):.4f}, argmax agreement "
            f"{float((x.argmax(-1) == ref.argmax(-1)).mean()):.3f}")
    log(f"2f: routed kernel - plain {gap:.4f} against the tolerance "
        f"{tol:.4f} (0.05 x max|plain| {float(np.abs(ref).max()):.3f}); the "
        f"kernel engine's own top-2 differs from the plain engine's in "
        f"{moved} of {sum(t.shape[0] for t in tape)} (row, layer) routings; "
        f"repeat generate() identical")
    if logits.shape != (N, cfg.vocab_size) or not np.isfinite(logits).all() \
            or not np.isfinite(free).all() or not gap <= tol:
        raise AssertionError(f"2f: put() logits not finite or off the plain "
                             f"engine's by {gap} > {tol}")
    put_ms, win_ms, win_launches, win_k = window_device_ms(
        eng, prompts, eng.decode_window)
    log(f"2f profile: put() of {sum(map(len, prompts))} tokens {put_ms:.2f} "
        f"device ms; decode window {win_ms:.2f} device ms and "
        f"{win_launches:.0f} launches a step")
    for k, (t, c) in sorted(win_k.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"   {t / eng.decode_window:.3f} ms/step "
            f"{c / eng.decode_window:.0f}x  {k[:90]}")
    moe_mlp_share(cfg, eng, put_ms, win_ms, sum(map(len, prompts)), N)
    for k, n in ep_serve_phase(cfg, eng, prompts[:4], new).items():
        launches[k] = launches.get(k, 0) + n

    # the v1 engine on the same weights: 8 prompts of 512 tokens, 16 new
    v1 = deepspeed_tpu_torch.init_inference(
        TransformerLM(cfg), params=eng.params, dtype="bf16", device=dev)
    ids = np.stack([np.asarray(p[:128] * 4) for p in prompts])
    v1.generate(ids[:, :64], max_new_tokens=2)                   # warm-up
    dense_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = v1.generate(ids, max_new_tokens=16)
    torch.cuda.synchronize()
    v1_s = time.perf_counter() - t0
    launches["dense_decode_attention"] = dense_decode_attention.launches
    log(f"2f v1: generate {ids.shape} + 16 in {v1_s:.2f}s, dense decode "
        f"launches {launches['dense_decode_attention']} (want {L} x 15)")
    if launches["dense_decode_attention"] != L * 15 or not (
            (out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("2f v1: dense decode launches or tokens off")
    del v1, pipe, eng
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in moe_woq_phase(dev, prompts, new).items():
        launches[k] = launches.get(k, 0) + n
    return launches


def moe_woq_tree(cfg, dev, seed=0):
    """The WOQ int8 tree of ``cfg``, built a layer at a time: each layer's
    bf16 weights drawn on the card (the model's init at one layer, the
    output projections scaled to ``cfg``'s depth), quantized, freed. The
    embedding and head stay bf16 (the engine quantizes them). Returns the
    tree and the quantize launches."""
    import dataclasses

    from deepspeed_tpu_torch.inference.quantization import (QuantizedTensor,
                                                            quantize_params)
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.ops import quantizer_kernels as qk

    L = cfg.num_layers
    one = TransformerLM(dataclasses.replace(cfg, num_layers=1))
    gen = torch.Generator(device=dev).manual_seed(seed)
    qk.quantize_blocks.launches = 0
    layers, rest = {}, None
    for l in range(L):
        p = one.init_params(gen, dtype=torch.bfloat16)
        for k in ("wo", "e_down"):          # 0.02 / sqrt(2 L), as at depth L
            p["layers"][k].mul_(1.0 / np.sqrt(L))
        if rest is None:
            rest = {k: v for k, v in p.items() if k != "layers"}
            # the quantizer kernels against their plain versions on the
            # block sequence the main path quantizes and dequantizes: one
            # layer's [E, h, f] expert leaf (these launches do not count)
            counts = (qk.quantize_blocks.launches,
                      qk.dequantize_blocks.launches)
            leaf = p["layers"]["e_gate"][0]
            check_quant(f"Mixtral e_gate {tuple(leaf.shape)} bf16", leaf,
                        WOQ_BLOCK, 8)
            del leaf
            qk.quantize_blocks.launches, qk.dequantize_blocks.launches = \
                counts
        qp, _ = quantize_params({"layers": p["layers"]}, bits=8)
        del p
        for k, leaf in qp["layers"].items():
            if isinstance(leaf, QuantizedTensor):
                if k not in layers:
                    layers[k] = QuantizedTensor(
                        torch.empty((L,) + tuple(leaf.q.shape[1:]),
                                    dtype=leaf.q.dtype, device=dev),
                        torch.empty((L,) + tuple(leaf.s.shape[1:]),
                                    dtype=leaf.s.dtype, device=dev),
                        leaf.shape, leaf.dtype, bits=8, stacked=True)
                layers[k].q[l].copy_(leaf.q[0])
                layers[k].s[l].copy_(leaf.s[0])
            else:
                if k not in layers:
                    layers[k] = torch.empty((L,) + tuple(leaf.shape[1:]),
                                            dtype=leaf.dtype, device=dev)
                layers[k][l].copy_(leaf[0])
        del qp
    torch.cuda.synchronize()
    return dict(rest, layers=layers), qk.quantize_blocks.launches


def moe_woq_phase(dev, prompts, new):
    """2f (b): all 32 layers of Mixtral-8x7B under WOQ int8 (its bf16 form,
    93 GB, never exists on the card): init_inference(use_ragged=True,
    quant_bits=8) on the tree built a layer at a time, then generate() over
    the 8 prompts."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.quantization import (QuantizedTensor,
                                                            quantized_nbytes)
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import \
        ragged_attention
    from deepspeed_tpu_torch.models import TransformerLM, mixtral_8x7b
    from deepspeed_tpu_torch.ops import quantizer_kernels as qk

    cfg = mixtral_8x7b()
    L, N = cfg.num_layers, len(prompts)
    t0 = time.perf_counter()
    tree, q_build = moe_woq_tree(cfg, dev)
    build_s = time.perf_counter() - t0
    nq = sum(isinstance(v, QuantizedTensor) for v in tree["layers"].values())
    qk.quantize_blocks.launches = 0
    eng = deepspeed_tpu_torch.init_inference(
        TransformerLM(cfg), params=tree, device=dev,
        config={"dtype": "bfloat16", "use_ragged": True, "quant_bits": 8,
                "ragged": {"decode_window": 8, "state_manager": {
                    "max_ragged_batch_size": 8192}}})
    del tree
    torch.cuda.synchronize()
    q_launches = q_build + qk.quantize_blocks.launches
    resident = quantized_nbytes(eng.params)
    log(f"2f woq8: mixtral_8x7b all {L} layers built a layer at a time in "
        f"{build_s:.1f}s; {nq} quantized leaves a layer; quantize_blocks "
        f"launches {q_launches} (want {nq} x {L} + 2: embed, head); "
        f"resident weights {resident / 2**30:.2f} GiB "
        f"(prediction ~43.6 GiB), {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated with the KV pool")
    if q_launches != nq * L + 2:
        raise AssertionError(f"2f woq8: {q_launches} quantize launches")
    eng.generate([prompts[0][:64]], max_new_tokens=2)           # warm-up
    before = dict(ragged=eng.ragged_steps, decode=eng.decode_steps,
                  syncs=eng.host_syncs, windows=eng.decode_windows)
    qk.dequantize_blocks.launches = 0
    paged_attention.launches = 0
    ragged_attention.launches = 0
    # -- the main path: generate() ------------------------------------------
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"dequantize_blocks": qk.dequantize_blocks.launches,
                "quantize_blocks": q_launches,
                "paged_attention": paged_attention.launches,
                "ragged_attention": ragged_attention.launches}
    steps = dict(ragged=eng.ragged_steps - before["ragged"],
                 decode=eng.decode_steps - before["decode"],
                 syncs=eng.host_syncs - before["syncs"],
                 windows=eng.decode_windows - before["windows"])
    want = nq * L * (steps["ragged"] + steps["decode"]) \
        + 2 * (steps["ragged"] + steps["windows"])
    ttft = eng.last_ttft_s
    log(f"2f woq8: generate {N} requests, {new} new tokens, in {gen_s:.2f}s "
        f"(TTFT {ttft * 1e3:.1f} ms for the {N}-prompt put, decode "
        f"{N * (new - 1) / (gen_s - ttft):.1f} tokens/s); steps {steps}; "
        f"dequantize_blocks launches {launches['dequantize_blocks']} (want "
        f"{want})")
    for g, p in zip(gen, prompts):
        if len(g) != len(p) + new or not ((g >= 0)
                                          & (g < cfg.vocab_size)).all():
            raise AssertionError("2f woq8: a request did not get all its "
                                 "tokens in [0, vocab)")
    if launches["dequantize_blocks"] != want or steps["decode"] == 0 or \
            steps["syncs"] != steps["windows"] or \
            launches["paged_attention"] != L * steps["decode"] or \
            launches["ragged_attention"] != L * steps["ragged"]:
        raise AssertionError(f"2f woq8: launches {launches} for steps "
                             f"{steps}")
    put_ms, win_ms, _, win_k = window_device_ms(eng, prompts,
                                                 eng.decode_window)
    deq = [(t, c) for k, (t, c) in win_k.items() if "dequant" in k]
    log(f"2f woq8 profile: put() {put_ms:.2f} device ms; decode window "
        f"{win_ms:.2f} device ms a step (prediction >= ~40 ms from bytes), "
        f"dequantize {sum(t for t, _ in deq) / eng.decode_window:.2f} ms and "
        f"{sum(c for _, c in deq) / eng.decode_window:.0f} launches a step")
    logits = eng.put(list(range(2000, 2000 + N)), prompts)
    if not np.isfinite(logits).all():
        raise AssertionError("2f woq8: put() logits not finite")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 8g: Mixtral-8x7B width training, 2 layers
# ---------------------------------------------------------------------------
MOE_TRAIN_LAYERS = 2


def moe_train_config(stage, gas=2, **moe):
    return dict(TRAIN_CONFIG, gradient_accumulation_steps=gas,
                zero_optimization={"stage": stage},
                moe={"enabled": True, "num_experts": 8, **moe},
                telemetry={"enabled": False})


def leaf_prints(engine):
    """Each compute and master leaf's fingerprint (``utils.sanity``: two
    int64 sums over its bit pattern), on the host: equal prints are the
    same bits."""
    from deepspeed_tpu_torch.utils.sanity import _fingerprint

    leaves = list(engine._param_leaves) + list(engine._master_leaves or [])
    return torch.stack([_fingerprint(v) for v in leaves]).cpu()


def moe_train_phase(dev):
    """8g: Mixtral-8x7B width at 2 layers through initialize() /
    train_batch() at one NCCL rank: ZeRO 1, bf16, AdamW, clip 1.0, micro 2
    x gas 2 x S 2048, remat, top-2 at capacity 1.0; then one dropless top-1
    step. Returns the flash launches of the main path and the stage-1
    run (losses, leaf fingerprints, batch) phase 8j holds its engines
    to."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mixtral_8x7b
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(mixtral_8x7b(), num_layers=MOE_TRAIN_LAYERS)
    L, gas, steps = cfg.num_layers, 2, 3
    config = moe_train_config(1, gas)
    routed = {"kept": [], "aux": []}
    route = sharded_moe._route_top2

    def counting(*args, **kwargs):
        r = route(*args, **kwargs)
        routed["kept"].append(r.keep.sum())      # read after the steps
        routed["aux"].append(r.aux.detach())
        return r

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(cfg),
                                                config=config)
    torch.cuda.synchronize()
    log(f"8g: mixtral_8x7b width, L={L} (of 32), "
        f"{engine.param_count / 1e9:.3f} B params, ZeRO 1 bf16 + fp32 "
        f"master on {engine.device} in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (gas, TRAIN_B, TRAIN_S))}
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for kfn in kernels:
        kfn.launches = 0
    sharded_moe._route_top2 = counting
    try:
        # -- the main path: train_batch() x 3 -----------------------------
        losses, step_s = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(engine.train_batch(batch=batch))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    finally:
        sharded_moe._route_top2 = route
    launches = {kfn.__name__: kfn.launches for kfn in kernels}
    tokens = gas * TRAIN_B * TRAIN_S
    calls = len(routed["kept"])
    kept = float(torch.stack(routed["kept"]).sum())
    aux = torch.stack(routed["aux"]).float().cpu().numpy()
    dropped = 1.0 - kept / (calls * TRAIN_B * TRAIN_S * cfg.moe_top_k)
    med = statistics.median(step_s[1:])
    log(f"8g: losses {[f'{x:.4f}' for x in losses]}; aux per layer call "
        f"{aux.min():.4f}..{aux.max():.4f}; share of (token, choice) pairs "
        f"dropped by capacity 1.0: {dropped:.4f} over {calls} routings "
        f"(forward and remat recompute)")
    log(f"8g: step s {[f'{x:.3f}' for x in step_s]}; median of steps 2-"
        f"{steps} {med * 1e3:.1f} ms = {tokens / med:.0f} tokens/s; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}")
    want = {"flash_fwd": steps * 2 * L * gas,
            "flash_bwd_dq": steps * L * gas,
            "flash_bwd_dkv": steps * L * gas}
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and np.isfinite(aux).all()):
        raise AssertionError(f"8g: losses not finite and falling or aux not "
                             f"finite: {losses}")
    if launches != want:
        raise AssertionError(f"8g: launches {launches} != {want}")
    ref = {"losses": losses, "prints": leaf_prints(engine), "batch": batch}
    engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # one dropless top-1 step (the sorted grouped route) on the same batch
    dl = dataclasses.replace(cfg, moe_top_k=1, moe_dropless=True)
    engine, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(dl),
                                                config=config)
    t0 = time.perf_counter()
    loss = engine.train_batch(batch=batch)
    torch.cuda.synchronize()
    log(f"8g dropless top-1: one step, loss {loss:.4f} in "
        f"{time.perf_counter() - t0:.2f}s (first step)")
    if not np.isfinite(loss):
        raise AssertionError("8g: the dropless step's loss is not finite")
    engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ref


# ---------------------------------------------------------------------------
# phase 8j: the engine through the expert leaves' ZeRO groups, one rank
# ---------------------------------------------------------------------------
def moe_zero_phase(dev, ref):
    """8j: phase 8g's engine (Mixtral-8x7B width, 2 layers, bf16, micro 2 x
    gas 2 x S 2048, capacity 1.0, its seeded weights and batch) at ZeRO 1
    and ZeRO 3 with ``moe.expert_parallel_size`` 1 set, 3 steps each: the
    engine's per-leaf ZeRO groups (an expert leaf's is the ranks holding
    its experts: at one NCCL rank a single rank, the whole ZeRO group), its
    stage-3 gathers and reduce-scatters over them, the expert leaves'
    clip-norm sums and gradient scaling. Losses and every compute and
    master leaf torch.equal (by bit fingerprint) to 8g's stage-1 engine,
    as 8c holds the stages to stage 0; step ms and peak GiB.

    Only under gloo on the CPU (tests/test_torch_expert_zero_distributed.
    py, tests/test_torch_parallel_serving.py) run the parts of ROADMAP A8
    that need more than one rank: an expert leaf's shard over 2+
    expert-data ranks, the all-to-all dispatch at ep > 1 (training and
    serving), tp / sp / MiCS x ep, MiCS x sp, and the serving runtime's
    leader / follower loop. Returns the flash launches."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mixtral_8x7b
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(mixtral_8x7b(), num_layers=MOE_TRAIN_LAYERS)
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    launches = {kfn.__name__: 0 for kfn in kernels}
    bad = []
    for stage in (1, 3):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=TransformerLM(cfg),
            config=moe_train_config(stage, expert_parallel_size=1))
        groups = {i: engine._zero[i][1] for i in engine._expert_idx}
        for kfn in kernels:
            kfn.launches = 0
        # -- the main path: train_batch() x 3 -----------------------------
        losses, step_s = [], []
        for _ in range(len(ref["losses"])):
            t0 = time.perf_counter()
            losses.append(engine.train_batch(batch=ref["batch"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        got = {kfn.__name__: kfn.launches for kfn in kernels}
        steps, L = len(losses), cfg.num_layers
        if got != {"flash_fwd": steps * 2 * L * 2,
                   "flash_bwd_dq": steps * L * 2,
                   "flash_bwd_dkv": steps * L * 2}:
            bad.append(f"ZeRO {stage}: flash launches {got}")
        for k, n in got.items():
            launches[k] += n
        same = losses == ref["losses"] and torch.equal(leaf_prints(engine),
                                                       ref["prints"])
        log(f"8j ZeRO {stage}, ep 1: {len(groups)} expert leaves on their "
            f"expert ZeRO groups of {sorted(set(groups.values()))} rank(s); "
            f"losses {[f'{x:.4f}' for x in losses]}; losses and leaves "
            f"torch.equal to 8g's stage-1 engine: {same}; step s "
            f"{[f'{x:.3f}' for x in step_s]} (median of steps 2-3 "
            f"{statistics.median(step_s[1:]) * 1e3:.1f} ms); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not same or not groups:
            bad.append(f"ZeRO {stage}: equal {same}, expert leaves "
                       f"{len(groups)}")
        engine.close()
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("8j: " + "; ".join(bad))
    return launches


# ---------------------------------------------------------------------------
# phase 8m: the RLHF hybrid engine (a)-(c) and the multi-LoRA bank (d)
# ---------------------------------------------------------------------------
HYBRID_LAYERS = 2             # of 32: the time limit
HYBRID_NEW = 32
HYBRID_LEARN_S = 2048         # the learner's pow2 bucket of 1100-1532 tokens
HYBRID_SERVING = {"state_manager": {"max_tracked_sequences": 8,
                                    "max_seq_len": 2048, "block_size": 64,
                                    "num_blocks": 8 * 2048 // 64 + 1,
                                    "max_ragged_batch_size": 8192},
                  "engine": {"prefill_bucket": 64, "decode_window": 8}}
HYBRID_CONFIG = {"train_micro_batch_size_per_gpu": TRAIN_B,
                 "gradient_accumulation_steps": 1,
                 "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
                 "gradient_clipping": 1.0, "bf16": {"enabled": True},
                 "zero_optimization": {"stage": 2},
                 "hybrid_engine": {"enabled": True,
                                   "serving": HYBRID_SERVING},
                 "steps_per_print": 10 ** 9, "telemetry": {"enabled": False}}
LORA_SLOTS, LORA_RANK = 2, 16


def kernel_counts(reset=False):
    """{counter: launches} of the kernels the hybrid engine's path runs:
    flash forward / dq / dk-dv (the learner step), ragged and paged
    attention (serving) and the block quantizer (the int8 delta)."""
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_attention
    from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import \
        ragged_attention
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import quantizer_kernels as qk

    fns = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
           "flash_bwd_dkv": fa.flash_bwd_dkv,
           "ragged_attention": ragged_attention,
           "paged_attention": paged_attention,
           "quantize_blocks": qk.quantize_blocks}
    if reset:
        for f in fns.values():
            f.launches = 0
    return {k: f.launches for k, f in fns.items()}


def payload_engine(dev, cfg, payloads, delta=None):
    """A fresh v2 engine (the hybrid engine's serving geometry) from a full
    payload, with a delta payload applied when given."""
    from deepspeed_tpu_torch.checkpoint.state_checkpoint import \
        tree_from_paths
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.serve import weights as sw
    from deepspeed_tpu_torch.models import TransformerLM

    stager = sw.stage_payload(payloads)
    tree = tree_from_paths((n, np.array(v, np.float32))
                           for n, v in stager.leaves.items())
    eng = InferenceEngineV2(
        TransformerLM(cfg), RaggedInferenceEngineConfig.from_dict(
            dict(HYBRID_SERVING["engine"], dtype="bfloat16",
                 state_manager=dict(HYBRID_SERVING["state_manager"]))),
        params=tree, device=dev)
    eng.weight_version = stager.version
    sw.set_delta_base(eng, stager.leaves)
    if delta is not None:
        sw.apply_payload(eng, delta)
    return eng


def hybrid_phase(dev):
    """Phase 8m (a)-(c): the hybrid engine at Mistral-7B width and
    HYBRID_LAYERS layers (see the module docstring). Returns the launches
    of its kernels."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2.serve import weights as sw
    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b
    from deepspeed_tpu_torch.rl import CriticValueHead, PPOLearner
    from deepspeed_tpu_torch.runtime.hybrid_engine import \
        DeepSpeedHybridEngine

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(mistral_7b(), num_layers=HYBRID_LAYERS)
    V = cfg.vocab_size
    rng = np.random.default_rng(25)
    eng, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(cfg),
                                             config=HYBRID_CONFIG)
    if not isinstance(eng, DeepSpeedHybridEngine):
        raise AssertionError("8m: initialize() did not return the hybrid "
                             "engine")
    batch = {"input_ids": rng.integers(0, V, (1, TRAIN_B, TRAIN_S))}
    n_leaves = len(sw.flatten_params(eng.params))
    # warm-up outside the counted path: the cuBLAS handles of the shapes
    eng.train_batch(batch=batch)
    kernel_counts(reset=True)
    # -- the main path: train, publish, generate, rollout, learn, publish
    # the int8 delta ------------------------------------------------------
    losses = [eng.train_batch(batch=batch)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = eng.publish()
    publish_s = time.perf_counter() - t0
    full_bytes = sw.payload_bytes(payload)
    gen_prompts = rng.integers(1, V, (4, 1280))
    t0 = time.perf_counter()
    gen = eng.generate(gen_prompts, max_new_tokens=HYBRID_NEW)
    gen_s = time.perf_counter() - t0
    v1 = eng.weight_version
    losses.append(eng.train_batch(batch=batch))
    gen2 = eng.generate(gen_prompts, max_new_tokens=HYBRID_NEW)
    v2 = eng.weight_version
    roll_prompts = [list(map(int, rng.integers(1, V, n)))
                    for n in rng.integers(1100, 1501, 4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = eng.rollout(roll_prompts, max_new_tokens=HYBRID_NEW,
                          temperature=1.0, seed=7)
    roll_s = time.perf_counter() - t0
    for s in samples:
        s.reward = len(set(s.tokens)) / len(s.tokens)
    critic = CriticValueHead()
    critic.observe(samples)
    learner = PPOLearner(eng, value_fn=critic)
    before = kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = learner.step()
    torch.cuda.synchronize()
    learn_ms = (time.perf_counter() - t0) * 1e3
    learn = {k: v - before[k] for k, v in kernel_counts().items()}
    anchor = eng.publish_delta()
    losses.append(eng.train_batch(batch=batch))
    before = kernel_counts()
    t0 = time.perf_counter()
    pub = eng.publish_delta()
    delta_s = time.perf_counter() - t0
    q_delta = kernel_counts()["quantize_blocks"] - before["quantize_blocks"]
    launches = kernel_counts()
    # -- checks ---------------------------------------------------------
    log(f"8m (a): hybrid engine, mistral_7b width at {HYBRID_LAYERS} layers "
        f"(of 32), bf16, ZeRO 2, AdamW; losses "
        f"{[f'{x:.4f}' for x in losses]}; publish() {publish_s:.2f}s, "
        f"{full_bytes / 2**30:.3f} GiB fp32 payload ({n_leaves} leaves); "
        f"generate() of 4 x 1280 tokens, {HYBRID_NEW} new, {gen_s:.2f}s; "
        f"weight_version {v1} -> {v2}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"8m: losses {losses}")
    fresh = payload_engine(dev, cfg, payload)
    ref = fresh.generate([list(map(int, p)) for p in gen_prompts],
                         max_new_tokens=HYBRID_NEW)
    del fresh
    if not all(np.array_equal(g, r) for g, r in zip(gen, ref)):
        raise AssertionError("8m (a): the colocated engine's streams differ "
                             "from a fresh engine built from the payload")
    if gen.shape != gen2.shape != (4, 1280 + HYBRID_NEW) or not v2 > v1:
        raise AssertionError(f"8m (a): generate shape {gen.shape}, "
                             f"weight_version {v1} -> {v2}")
    n_tok = sum(len(s.tokens) for s in samples)
    lps = np.concatenate([np.asarray(s.logprobs) for s in samples])
    log(f"8m (b): rollout of 4 prompts ({[len(p) for p in roll_prompts]} "
        f"tokens), temperature 1, {HYBRID_NEW} new: {n_tok} tokens in "
        f"{roll_s:.2f}s = {n_tok / roll_s:.1f} tokens/s; logprobs in "
        f"[{lps.min():.3f}, {lps.max():.3f}]; learner step (S bucket "
        f"{res['seq_bucket']}, {res['samples']} samples, critic fit on "
        f"{critic.observed}) loss {res['loss']:.5f} in {learn_ms:.1f} ms; "
        f"its launches {learn}")
    if n_tok != 4 * HYBRID_NEW or not (np.isfinite(lps).all()
                                        and (lps <= 0).all()):
        raise AssertionError(f"8m (b): rollout tokens {n_tok}, logprobs "
                             f"finite and <= 0: {lps}")
    if (res["seq_bucket"] != HYBRID_LEARN_S or not np.isfinite(res["loss"])
            or not all(learn[k] > 0 for k in FLASH_NAMES)):
        raise AssertionError(f"8m (b): learner step {res}, flash launches "
                             f"{learn}")
    log(f"8m (c): publish_delta(): anchor v{anchor.version} (full), delta "
        f"v{pub.version} on base v{pub.base_version} in {delta_s:.2f}s: "
        f"{pub.delta_bytes / 2**20:.1f} MiB against "
        f"{pub.full_bytes / 2**20:.1f} MiB full ({pub.wire_ratio:.2f}x); "
        f"quantize launches {q_delta} for {n_leaves} leaves")
    if anchor.delta is not None or pub.delta is None or q_delta != n_leaves:
        raise AssertionError(f"8m (c): anchor delta {anchor.delta is None}, "
                             f"delta {pub.delta is None}, quantize "
                             f"launches {q_delta} != {n_leaves}")
    fresh = payload_engine(dev, cfg, anchor.full, delta=pub.delta)
    uids = [1, 2]
    ps = roll_prompts[:2]
    got = eng.serving_engine.put(uids, ps)
    want = fresh.put(uids, ps)
    for e in (eng.serving_engine, fresh):
        for u in uids:
            e.flush(u)
    if not torch.equal(torch.from_numpy(got), torch.from_numpy(want)):
        raise AssertionError(f"8m (c): the colocated engine's put() logits "
                             f"after the delta differ from a fresh engine "
                             f"of the full payload + the delta (max "
                             f"{float(np.abs(got - want).max())})")
    log(f"8m (c): colocated put() logits after the delta torch.equal to a "
        f"fresh engine of the anchor payload + the delta; phase 8m (a)-(c) "
        f"{time.perf_counter() - t_phase:.1f}s; launches {launches}")
    del fresh, eng, learner
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def seeded_adapter(cfg, seed, scale=0.02):
    from deepspeed_tpu_torch.models.transformer import lora_target_leaves
    rng = np.random.default_rng(seed)
    return {p: (rng.standard_normal((cfg.num_layers, i, LORA_RANK))
                .astype(np.float32) * scale,
                rng.standard_normal((cfg.num_layers, LORA_RANK, o))
                .astype(np.float32) * scale)
            for p, (i, o) in lora_target_leaves(cfg).items()}


def lora_bank_phase(dev, cfg, eng, prompts, tol):
    """Phase 8m (d): the multi-LoRA bank over the serve phase's 32-layer
    weight tensors (see the module docstring). ``tol`` is the serve phase's
    put() logit gap to the fp32 engine. Returns the ragged and paged
    launches."""
    import types

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.serve import weights as sw
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.runtime.hybrid_engine import \
        DeepSpeedHybridEngine

    t_phase = time.perf_counter()
    bank = InferenceEngineV2(
        TransformerLM(cfg), RaggedInferenceEngineConfig.from_dict(
            {"dtype": "bfloat16", "decode_window": eng.decode_window,
             "max_lora_adapters": LORA_SLOTS, "lora_rank": LORA_RANK,
             "state_manager": {"max_ragged_batch_size": 8192}}),
        params=eng.params, device=dev)
    shared = all(a.data_ptr() == b.data_ptr() for (_, a), (_, b) in zip(
        sw.flatten_params(bank.params), sw.flatten_params(eng.params)))
    if not shared:
        raise AssertionError("8m (d): the bank engine copied the weights")
    ada, adb = seeded_adapter(cfg, 1), seeded_adapter(cfg, 2)
    bank.load_adapter("A", ada)
    bank.load_adapter("B", adb, scale=0.5)
    kernel_counts(reset=True)
    uids = list(range(2000, 2008))
    # -- base rows with the bank on: put(), a decode step, generate() ----
    got = bank.put(uids, prompts)
    want = eng.put(uids, prompts)
    nxt = [int(t) for t in want.argmax(-1)]
    got_d = bank._decode_batch(uids, nxt)
    want_d = eng._decode_batch(uids, nxt)
    for e in (bank, eng):
        for u in uids:
            e.flush(u)
    if not (torch.equal(torch.from_numpy(got), torch.from_numpy(want))
            and all(torch.equal(torch.from_numpy(got_d[u]),
                                torch.from_numpy(want_d[u]))
                    for u in uids)):
        raise AssertionError("8m (d): base rows with the bank on differ "
                             "from the bank-less engine")
    gen_b = bank.generate(prompts, max_new_tokens=16)
    gen_e = eng.generate(prompts, max_new_tokens=16)
    if not all(np.array_equal(a, b) for a, b in zip(gen_b, gen_e)):
        raise AssertionError("8m (d): base streams with the bank on differ")
    # -- a put() mixing base, A and B rows against each row alone --------
    names = [None, "A", "B", None, "A", "B", "A", None]
    for u, n in zip(uids, names):
        bank.assign_adapter(u, n)
    mixed = bank.put(uids, prompts)
    for u in uids:
        bank.flush(u)
    gaps = []
    for u, n, p, row in zip(uids, names, prompts, mixed):
        bank.assign_adapter(u, n)
        alone = bank.put([u], [p])[0]
        bank.flush(u)
        gaps.append(float(np.abs(row - alone).max()))
    moved = [float(np.abs(mixed[i] - want[i]).max())
             for i, n in enumerate(names) if n]
    log(f"8m (d): bank of {LORA_SLOTS} x rank {LORA_RANK} over the serve "
        f"engine's tensors (shared); base rows torch.equal to the bank-less "
        f"engine in put() and a decode step, 16-token streams equal; mixed "
        f"put() (base / A / B) max|row - row alone| "
        f"{[f'{g:.4f}' for g in gaps]} (tolerance {tol:.4f}, the serve "
        f"put()'s gap to fp32); adapter rows moved by "
        f"{min(moved):.3f}-{max(moved):.3f} from base")
    if max(gaps) > tol or not min(moved) > 0:
        raise AssertionError(f"8m (d): mixed rows {gaps} beyond {tol}, or "
                             f"an adapter moved nothing ({moved})")
    streams = bank.generate(prompts, max_new_tokens=16, adapter=names)
    if not all(len(s) == len(p) + 16 for s, p in zip(streams, prompts)):
        raise AssertionError("8m (d): mixed generate() short")
    # -- a publish_adapter payload equals a direct load -------------------
    stub = types.SimpleNamespace(lora_adapters=adb, lora_scale=0.5,
                                 publisher=types.SimpleNamespace(version=0),
                                 _serving=None)
    payload = DeepSpeedHybridEngine.publish_adapter(stub, "B")
    direct = {k: v[:, bank._adapter_slots["B"]].clone()
              for k, v in bank.lora_bank.items()}
    bank.unload_adapter("B")
    sw.apply_payload(bank, payload)
    slot = bank._adapter_slots["B"]
    if not all(torch.equal(bank.lora_bank[k][:, slot], v)
               for k, v in direct.items()):
        raise AssertionError("8m (d): the publish_adapter payload differs "
                             "from a direct load_adapter")
    launches = kernel_counts()
    t_checks = time.perf_counter() - t_phase

    # -- device ms of the put() and of a decode-window step, the bank on
    # against the bank-less engine (the card's activity alone) ----------
    def device_ms(engine, adapter=None):
        w = engine.decode_window
        ms = [sum(t for t, _ in profiled(lambda: engine.generate(
            prompts, max_new_tokens=new, adapter=adapter),
            cpu=False)[2].values()) for new in (1, 1 + w)]
        return ms[0], (ms[1] - ms[0]) / w

    (put_e, win_e), (put_b, win_b), (put_m, win_m) = (
        device_ms(eng), device_ms(bank), device_ms(bank, names))
    log(f"8m (d): device ms of the 8-prompt put() / a decode-window step: "
        f"bank-less {put_e:.2f} / {win_e:.3f}, bank on with base rows "
        f"{put_b:.2f} / {win_b:.3f}, mixed base / A / B {put_m:.2f} / "
        f"{win_m:.3f}; the payload install equals a direct load; checks "
        f"{t_checks:.1f}s, phase {time.perf_counter() - t_phase:.1f}s")
    del bank
    gc.collect()
    torch.cuda.empty_cache()
    return {"ragged_attention": launches["ragged_attention"],
            "paged_attention": launches["paged_attention"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch.ops.op_builder import cuda as cuda_build

    clock = PhaseClock()
    dev = torch.device("cuda", 0)
    card = device_line()
    log(f"device: {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; torch._grouped_mm "
        f"{'present' if hasattr(torch, '_grouped_mm') else 'absent'} (the "
        f"serving MoE's grouped experts)")
    clock.run("build", cuda_build.build)
    log(f"kernel build: nvcc {cuda_build.build_seconds:.1f}s into "
        f"{cuda_build.BUILD_ROOT}")
    for name, text in sorted(cuda_build.build_logs.items()):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", text))
        if regs:
            log(f"  ptxas {name}: {len(regs)} kernels, {min(regs)}-"
                f"{max(regs)} registers, {spills} bytes spilled")

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    results = clock.run("kernels 1-4, 11", kernel_phases, dev, flush)
    results.update(clock.run("kernels 5-7", flash_phases, dev, flush))
    results.update(clock.run("kernels 12-14", sparse_phases, dev, flush))
    results.update(clock.run("kernels 8-10", woq_kernel_phases, dev, flush))
    rms_launches = results["rms_norm"].pop("launches")
    del flush
    if "--kernels-only" in sys.argv:
        return 0    # a build-and-compare run; no result line
    clock.run("small fp32", small_fp32_check, dev)
    clock.run("small woq", small_woq_check, dev)
    clock.run("small moe", small_moe_check, dev)
    launches = serve_phase(dev, clock)
    launches["rms_norm"] = rms_launches
    gc.collect()
    torch.cuda.empty_cache()    # the serving engine is gone

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    add(clock.run("2f", moe_serve_phase, dev))
    clock.run("small train", small_train_check, dev)
    train_launches, train_base = clock.run("8 train", train_phase, dev)
    add(train_launches)
    gc.collect()
    torch.cuda.empty_cache()    # the training engine is gone
    add(clock.run("8f", training_surface_phase, dev, card, train_base))
    gc.collect()
    torch.cuda.empty_cache()
    add(clock.run("8m (a)-(c)", hybrid_phase, dev))
    moe_launches, moe_ref = clock.run("8g", moe_train_phase, dev)
    add(moe_launches)
    add(clock.run("8j", moe_zero_phase, dev, moe_ref))
    del moe_ref
    dp_launches, zero_refs = clock.run("8c", zero_dp_phase, dev, card)
    add(dp_launches)
    add(clock.run("8h", parallel_phase, dev, card, zero_refs[3]))
    add(clock.run("8i", pipeline_phase, dev, card))
    add(clock.run("8k", zeropp_phase, dev, card, zero_refs))
    del zero_refs
    offload_launches, host_ops = clock.run("8b, 8l", offload_phase, dev)
    log(f"phase 8b: flash launches of the full-depth runs and 8l "
        f"{offload_launches}")
    add(offload_launches)
    tier_launches, _ = clock.run("8d-8e", memory_tiers_phase, dev)
    log(f"phases 8d-8e: flash launches {tier_launches}")
    add(tier_launches)
    launches.update(clock.run("sparse op", sparse_op_phase, dev))

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
    clock.seconds["total"] = round(time.perf_counter() - clock.start, 1)
    print(card)
    print(json.dumps(host_ops))
    print(json.dumps({"phase_seconds": clock.seconds}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

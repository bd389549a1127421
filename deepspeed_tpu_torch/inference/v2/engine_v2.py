"""Ragged/continuous-batching inference engine (FastGen-style).

Port of ``deepspeed_tpu/inference/v2/engine_v2.py`` (``InferenceEngineV2``,
:133). The serving loop calls ``put(batch_uids, batch_tokens)`` with a mix
of new prompts, prompt chunks and one next token per running sequence;
every put() packs into ONE :class:`~.ragged.batch.RaggedBatch` and runs
``paged_model.paged_ragged_step`` (the ragged attention kernel, once per
layer) and returns each entry's last-token logits. KV lives in a blocked
pool managed by ``DSStateManager``; ``flush`` frees a sequence.

Decode runs in fused windows (``decode_window`` = K > 1):
``paged_model.paged_decode_window`` takes K device steps — greedy, or
sampled with temperature / top-p / top-k from per-row keys
(``sampling.fold_in_rows``) — and the host reads the [N, K] token block
once per window (``host_syncs`` counts those reads). ``decode_window`` =
1 is the per-token path, greedy or sampled with the same keys, so the
two paths give the same streams for a fixed seed. There is no jit:
PyTorch runs eagerly, and CUDA-graph capture of the window is later work
(ROADMAP A6e).

Ported from the JAX engine beside ``put`` / ``generate`` / ``flush``:
``set_decode_window`` and ``set_ragged_mode`` (the serving runtime's
knobs), the telemetry of the JAX package (the ``inference_*`` metrics,
trace spans, flight-recorder events, the KV-pool gauges, the
``inference_kv_pool_quant_bytes_saved`` gauge), ``bind_trace`` for
distributed tracing, and ``memory_report`` (the CUDA caching allocator's
figures), and the KV spill tier (``engine.spill``, ``ragged/spill.py``).
Under ``ragged_attention="off"`` put() takes the stitched dispatch
instead (JAX :1583-1621): a new prompt through ``paged_prefill`` (its
causal self-attention on the flash forward kernel when its bucket is a
multiple of 128), a multi-token continuation through ``paged_continue``,
single tokens as batched decode steps on the paged decode kernel. Not
ported: speculative decoding and the LoRA bank (ROADMAP A11) and weight
hot-swaps (A7).

Under ``quant_bits`` 8 or 4 the weights rest quantized
(``inference/quantization.py``) and are dequantized right before use.
MoE models (Mixtral) serve at ``expert_parallel_size`` 1, any top-k, on
the grouped GEMM (``paged_model._moe_mlp``); at ``expert_parallel_size``
> 1 (JAX :140-199; top-1 / top-2) each rank holds ``E / ep`` experts of
every layer and the tokens go through the worst-case-capacity dispatch
and its all-to-alls over the expert group.

At ``tensor_parallel_size`` (or ``expert_parallel_size``) > 1 the engine
is SPMD over a process group of tp x ep ranks (``comm.init_distributed()``):
every rank runs the same scheduler on the same ``put()``s, holds its
slices of the weights and a pool of its ``kv_heads / tp`` heads, and runs
the paged and ragged kernels on them (``paged_model.ShardedServeConfig``);
the logits are all-gathered before sampling, and the sampler draws from a
counter hash, so every rank draws the same token.

The engine runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` and raises when no GPU is present. On the
CPU every attention call takes its kernel's plain version.
"""

import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ...models.transformer import TransformerConfig
from ...telemetry import memory as ds_memory
from ...telemetry import recorder as flight
from ...telemetry import trace, watchdog
from ...utils.bucketing import ceil_bucket, pow2_bucket
from ...utils.device import resolve_device
from ...utils.logging import log_dist
from .config_v2 import RaggedInferenceEngineConfig, check_ragged_mode
from .paged_model import (check_servable, init_paged_kv_cache,
                          paged_continue, paged_decode, paged_decode_window,
                          paged_prefill, paged_ragged_step)
from .ragged import batch as ragged_batch
from .ragged.blocked_allocator import NULL_BLOCK
from .ragged.ragged_manager import DSStateManager
from .sampling import (fold_in_rows, greedy_tokens, prng_key,
                       sample_tokens_rowwise)

DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}


class InferenceEngineV2:
    def __init__(self, model, config: Optional[RaggedInferenceEngineConfig]
                 = None, params=None, device=None):
        if isinstance(config, dict) or config is None:
            config = RaggedInferenceEngineConfig.from_dict(config or {})
        self.config = config
        self.model = model
        cfg: TransformerConfig = model.cfg
        check_servable(cfg)
        ep = config.expert_parallel_size
        if cfg.moe_num_experts > 0 and ep > 1:
            # as JAX (:140): ep > 1 routes through the capacity dispatch,
            # whose gating has the top-1 / top-2 conventions only
            assert cfg.moe_top_k <= 2, \
                f"expert-parallel serving is top-1/top-2 only " \
                f"(got moe_top_k={cfg.moe_top_k}); serve top-k>2 at ep=1"
        if ep > 1:
            assert cfg.moe_num_experts > 0, \
                "expert_parallel_size > 1 requires an MoE model"
            assert cfg.moe_num_experts % ep == 0, \
                f"num experts {cfg.moe_num_experts} not divisible by " \
                f"expert_parallel_size {ep}"
        self.device = resolve_device(device)
        sm = config.state_manager
        if sm.max_seq_len > cfg.max_seq_len:
            sm.max_seq_len = cfg.max_seq_len
        self.dtype = DTYPES[config.dtype]
        self.block_size = sm.block_size

        if params is not None:
            self.params = _cast_tree(params, self.device, self.dtype)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            self.params = model.init_params(gen, dtype=self.dtype)
        # the layer loop's view of the model: this rank's heads under
        # tensor parallelism
        self.topology = None
        self.serve_cfg = cfg
        tp = config.tensor_parallel_size
        if tp > 1 or ep > 1:
            from ..engine import expert_slices, tensor_parallel_topology, \
                tp_slices
            from .paged_model import shard_serve_config
            topo = tensor_parallel_topology(tp, self.device, ep=ep)
            self.topology = topo
            self.serve_cfg = shard_serve_config(
                cfg, tp, topo.tp_rank, topo.group("model") if tp > 1
                else None, ep, topo.ep_rank, topo.expert_group())
            self.params = expert_slices(model, tp_slices(
                model, self.params, topo), topo)
        if config.quant_bits:
            # weights rest as int8 / packed int4 with per-block scales,
            # quantized from the engine's dtype; paged_model dequantizes
            # the embedding and head per call and one layer at a time
            from ..quantization import quantize_params
            self.params, self._qmeta = quantize_params(
                self.params, bits=config.quant_bits)

        self.state_manager = DSStateManager(sm)
        # kv_quant: an int8 pool with per-(block, head) scales, about half
        # the bytes of a bf16 pool for the same blocks
        self.kv_cache = init_paged_kv_cache(self.serve_cfg, sm.num_blocks,
                                            sm.block_size, self.dtype,
                                            self.device,
                                            kv_quant=config.kv_quant)
        # the cold-block KV spill tier (ragged/spill.py), installed on the
        # state manager: prefix eviction demotes block content to host RAM
        # (and an optional disk tier), match_prefix restores it
        self.spill = None
        if sm.enable_kv_spill:
            from .ragged.spill import KVSpillTier
            self.spill = KVSpillTier(self, sm)
            self.state_manager.spill = self.spill
        # True: the hand-written kernels (CUDA) or their plain versions
        # (CPU tensors); False: the plain versions everywhere
        self.use_kernel = bool(config.use_paged_kernel)
        # device->host reads made by the decode loop: one per per-token
        # step, one per fused window
        self.host_syncs = 0
        self.decode_windows = 0      # fused windows run
        self.decode_steps = 0        # device decode steps (K per window)
        self.ragged_steps = 0        # ragged steps run (one per put())
        # per-uid distributed-trace ids (telemetry/context.py): the
        # scheduler binds them at submit so batch-level spans carry the
        # trace ids of every request they served; cleared on flush()
        self._uid_traces: Dict[int, str] = {}
        self._init_telemetry()
        self.ragged_enabled = check_ragged_mode(config.ragged_attention)
        self.decode_window = max(int(config.decode_window), 1)
        self._m_window_size.set(self.decode_window)
        # the compile points of the JAX engine, counted the port's way:
        # the first call at each new shape signature (telemetry/watchdog)
        self._ragged_fn = watchdog.watch("ragged_step", paged_ragged_step)
        self._decode_fn = watchdog.watch("decode", paged_decode)
        self._window_fn = watchdog.watch("decode_window",
                                         paged_decode_window)
        self._prefill_fn = watchdog.watch("prefill", paged_prefill)
        self._continue_fn = watchdog.watch("continue", paged_continue)
        if config.kv_quant:
            # the capacity win, as a live gauge: pool bytes the int8
            # layout frees vs the same pool at the serving dtype
            itemsize = torch.empty((), dtype=self.dtype).element_size()
            unquant = 2 * (cfg.num_layers * sm.num_blocks * sm.block_size
                           * self.serve_cfg.kv_heads * cfg.head_dim
                           * itemsize)
            quant = ds_memory.tree_bytes(self.kv_cache)
            self._m_kv_quant_saved.set(max(unquant - quant, 0))
        ds_memory.record_buffer("kv_pool",
                                ds_memory.tree_bytes(self.kv_cache))
        ds_memory.record_buffer("params", ds_memory.tree_bytes(self.params))
        log_dist(
            f"ragged inference engine: blocks={sm.num_blocks}x"
            f"{sm.block_size} max_seqs={sm.max_tracked_sequences} "
            f"device={self.device}", ranks=[0])

    # ------------------------------------------------------------------
    # Telemetry (unified registry, telemetry/registry.py; the JAX
    # engine's metric names, engine_v2.py:451)
    # ------------------------------------------------------------------
    def _init_telemetry(self):
        from ...telemetry import get_registry
        reg = get_registry()
        self._m_prefill_tokens = reg.counter(
            "inference_prefill_tokens_total",
            "prompt tokens run through prefill/continuation passes")
        self._m_decode_tokens = reg.counter(
            "inference_decode_tokens_total",
            "tokens produced by batched decode steps")
        self._m_decode_steps = reg.counter(
            "inference_decode_steps_total", "batched decode passes")
        self._m_decode_time = reg.histogram(
            "inference_decode_step_seconds",
            "batched decode pass wall time", unit="s")
        self._m_decode_tput = reg.gauge(
            "inference_decode_tokens_per_s",
            "last decode pass throughput (batch tokens / wall time)")
        self._m_ttft = reg.histogram(
            "inference_ttft_seconds",
            "generate(): time to the first token batch", unit="s")
        self._m_kv_util = reg.gauge(
            "inference_kv_pool_utilization",
            "fraction of usable KV blocks currently allocated")
        self._m_kv_util_peak = reg.gauge(
            "inference_kv_pool_utilization_peak",
            "high-water mark of inference_kv_pool_utilization")
        self._m_tracked = reg.gauge(
            "inference_tracked_sequences", "sequences with live KV state")
        self._m_window_size = reg.gauge(
            "inference_decode_window_size",
            "configured fused decode window K (1 = per-token decode)")
        self._m_host_syncs = reg.counter(
            "inference_decode_host_syncs_total",
            "device->host transfers made by the decode loop (one per "
            "per-token step, one per fused multi-step window)")
        self._m_fused_time = reg.histogram(
            "inference_fused_window_seconds",
            "fused multi-step decode window wall time", unit="s")
        self._m_ragged_steps = reg.counter(
            "inference_ragged_steps_total",
            "unified ragged steps run (mixed prefill+decode, one "
            "compiled program per step)")
        self._m_ragged_tokens = reg.counter(
            "inference_ragged_tokens_total",
            "valid tokens run through unified ragged steps")
        self._m_ragged_prefill_rows = reg.counter(
            "inference_ragged_prefill_rows_total",
            "ragged rows carrying prompt/continuation chunks")
        self._m_ragged_decode_rows = reg.counter(
            "inference_ragged_decode_rows_total",
            "ragged rows carrying a single decode token")
        self._m_ragged_time = reg.histogram(
            "inference_ragged_step_seconds",
            "unified ragged step wall time", unit="s")
        self._m_ragged_pad = reg.gauge(
            "inference_ragged_pad_fraction",
            "padding waste of the last ragged step's token bucket")
        self._m_ragged_host_syncs = reg.counter(
            "inference_ragged_host_syncs_total",
            "device->host transfers made by unified ragged steps (one "
            "per step)")
        self._m_kv_quant_saved = reg.gauge(
            "inference_kv_pool_quant_bytes_saved",
            "HBM the int8 KV pool frees vs the same pool at the serving "
            "dtype (0 when kv_quant is off) — the capacity headroom that "
            "admits ~2x concurrent sequences", unit="bytes")

    def _update_pool_telemetry(self):
        """KV-pool gauges from the block allocator's host counters (no
        device read)."""
        sm = self.state_manager
        usable = max(sm.config.num_blocks - 1, 1)  # block 0 is the null
        util = (usable - sm.free_blocks()) / usable
        self._m_kv_util.set(util)
        # the live gauge reads 0 between requests (flush returns blocks),
        # so pool-pressure tuning needs the high-water mark too
        if util > self._m_kv_util_peak.value:
            self._m_kv_util_peak.set(util)
        self._m_tracked.set(sm.tracked_sequences())

    # ------------------------------------------------------------------
    # Ragged mode and the fused decode window K (serving-runtime knobs)
    # ------------------------------------------------------------------
    def set_ragged_mode(self, mode: str) -> None:
        """Set the dispatch at runtime (ServingConfig.ragged_attention
        routes here): "auto" and "on" run every put() as one ragged step,
        "off" through the stitched prefill / continue / decode dispatch.
        Eager PyTorch keeps no compiled program per path, so flipping
        costs nothing."""
        self.ragged_enabled = check_ragged_mode(mode)
        self.config.ragged_attention = mode

    def set_decode_window(self, window: int, *,
                          source: str = "online") -> int:
        """Switch the fused decode window K at runtime (call it from the
        thread that owns the engine). Eager PyTorch keeps no compiled
        program per K, so the switch costs nothing."""
        from ...runtime import tunables
        window = tunables.check("serving.decode_window", window,
                                label="decode_window")
        if window == self.decode_window:
            return window
        self.decode_window = window
        self.config.decode_window = window
        self._m_window_size.set(window)
        tunables.observe("serving.decode_window", window, source)
        flight.record("tunable_set", name="serving.decode_window",
                      value=window, source=source)
        return window

    # ------------------------------------------------------------------
    # Schedulability (reference engine_v2.py:135 query / :161 can_schedule)
    # ------------------------------------------------------------------
    def query(self, uid: int) -> Dict[str, int]:
        seq = self.state_manager.seqs.get(uid)
        return {
            "seen_tokens": seq.seen_tokens if seq else 0,
            "free_blocks": self.state_manager.free_blocks(),
            "tracked_sequences": self.state_manager.tracked_sequences(),
            "max_seq_len": self.state_manager.config.max_seq_len,
        }

    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> bool:
        total_new = 0
        # retained prefix blocks are evictable on demand (ensure_blocks
        # evicts LRU), so they count as free
        free = self.state_manager.reclaimable_blocks()
        for uid, n in zip(uids, lengths):
            if not self.state_manager.can_schedule(uid, n):
                return False
            seq = self.state_manager.seqs.get(uid)
            if seq is not None:
                total_new += seq.blocks_needed(n, self.block_size)
            else:
                total_new += -(-n // self.block_size)
        return total_new <= free and \
            sum(lengths) <= self.state_manager.config.max_ragged_batch_size

    # ------------------------------------------------------------------
    # Decode batches
    # ------------------------------------------------------------------
    def _decode_bucket(self, count: int) -> int:
        """Pad the decode batch to the next power-of-two bucket."""
        return pow2_bucket(
            count, self.state_manager.config.max_tracked_sequences)

    def _i32(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int32)).to(self.device)

    def _assemble_decode_rows(self, uids: List[int], tokens: List[int],
                              new_tokens: List[int]):
        """Shared decode-batch assembly (per-token step AND fused window):
        pad rows to the power-of-two batch bucket, allocate each row's
        blocks for the ``new_tokens[i]`` KV writes it will make, and slice
        tables to the used-page bucket."""
        sm = self.state_manager
        N = self._decode_bucket(len(uids))
        MB = sm.max_blocks_per_seq
        toks = np.zeros(N, np.int32)
        pos = np.zeros(N, np.int32)
        tables = np.full((N, MB), NULL_BLOCK, np.int32)
        used_pages = 1
        for i, (uid, tok, k) in enumerate(zip(uids, tokens, new_tokens)):
            seq = sm.ensure_blocks(uid, int(k))
            toks[i] = tok
            pos[i] = seq.seen_tokens
            tables[i] = sm.block_table_for(uid)
            used_pages = max(used_pages, len(seq.blocks))
        tables = tables[:, :pow2_bucket(used_pages, MB)]
        return N, toks, pos, tables

    def _pad_i32(self, N: int, vals) -> torch.Tensor:
        """[N] int32 on the engine's device with ``vals`` in the leading
        rows, zeros as padding."""
        out = np.zeros(N, np.int32)
        out[:len(vals)] = vals
        return self._i32(out)

    def _decode_common(self, uids: List[int], tokens: List[int],
                       pick, extract=lambda v, i: int(v[i])
                       ) -> Dict[int, object]:
        """One decode step for ``uids`` (the ``decode_window`` = 1 path):
        ``pick(logits, N)`` turns the [N, V] logits into what the host
        reads once (by default [N] int32 tokens on the device), and
        ``extract(values, i)`` gives row i's result."""
        sm = self.state_manager
        t0 = time.perf_counter()
        with trace.span("decode_step", batch=len(uids),
                        uids=[int(u) for u in uids],
                        **self._trace_attrs(uids)):
            N, toks, pos, tables = self._assemble_decode_rows(
                uids, tokens, [1] * len(uids))
            active = np.zeros(N, bool)
            active[:len(uids)] = True
            logits = self._decode_fn(
                self.serve_cfg, self.params, self._i32(toks),
                self._i32(pos), self._i32(tables), self.kv_cache,
                torch.as_tensor(active).to(self.device), self.block_size,
                use_kernel=self.use_kernel)
            nxt = pick(logits, N).cpu().numpy()   # the step's one read
        self.host_syncs += 1
        self.decode_steps += 1
        dt = time.perf_counter() - t0
        self._m_host_syncs.inc()
        self._m_decode_steps.inc()
        self._m_decode_tokens.inc(len(uids))
        self._m_decode_time.observe(dt)
        if dt > 0:
            self._m_decode_tput.set(len(uids) / dt)
        flight.record("decode_step", batch=len(uids), dur_s=round(dt, 5))
        out = {}
        for i, uid in enumerate(uids):
            seq = sm.seqs[uid]
            seq.seen_tokens += 1
            if sm.config.enable_prefix_caching:
                seq.token_log.append(int(tokens[i]))
            out[uid] = extract(nxt, i)
        self._update_pool_telemetry()
        return out

    def _decode_batch_greedy(self, uids: List[int],
                             tokens: List[int]) -> Dict[int, int]:
        """One greedy decode step: device argmax, one [N] int32 read."""
        return self._decode_common(uids, tokens,
                                   lambda logits, N: greedy_tokens(logits))

    def _sampling_arrays(self, N: int, row_seeds: List[int],
                         gen_idx: List[int], temperature: float,
                         top_p: float, top_k: int):
        """Padded per-row sampling inputs shared by the per-token and
        fused-window sampled paths (one definition, so the two paths draw
        with the same keys)."""
        dev = self.device
        return (self._pad_i32(N, row_seeds), self._pad_i32(N, gen_idx),
                torch.full((N,), float(temperature), dtype=torch.float32,
                           device=dev),
                torch.full((N,), float(top_p), dtype=torch.float32,
                           device=dev),
                torch.full((N,), int(top_k), dtype=torch.int32,
                           device=dev))

    def _decode_batch_sample(self, uids: List[int], tokens: List[int],
                             rng: torch.Tensor, row_seeds: List[int],
                             gen_idx: List[int], temperature: float,
                             top_p: float,
                             top_k: int = 0) -> Dict[int, int]:
        """One sampled decode step (device-side temperature / top-p /
        top-k with per-row keys, ``sampling.fold_in_rows``)."""
        seeds, g0, temp, topp, topk = self._sampling_arrays(
            self._decode_bucket(len(uids)), row_seeds, gen_idx,
            temperature, top_p, top_k)
        return self._decode_common(
            uids, tokens,
            lambda logits, N: sample_tokens_rowwise(
                logits, fold_in_rows(rng, seeds, g0), temp, topp, topk))

    def _decode_window_common(self, uids: List[int], tokens: List[int],
                              steps_left: List[int], eos_ids: List[int],
                              sampling: Optional[dict]
                              ) -> Dict[int, List[int]]:
        """Run one fused window and fold the [N, K] result back into host
        state. Returns {uid: emitted tokens} (1..steps_left[i] each; the
        row's last emitted token is never fed or cached)."""
        sm = self.state_manager
        t0 = time.perf_counter()
        with trace.span("decode_window", batch=len(uids),
                        window=self.decode_window,
                        uids=[int(u) for u in uids],
                        **self._trace_attrs(uids)):
            # block pre-allocation contract: every block row i can write
            # during its steps_left[i] steps is allocated here, so the
            # device loop never needs the host mid-window
            N, toks, pos, tables = self._assemble_decode_rows(
                uids, tokens, steps_left)
            eos = np.full(N, -1, np.int32)
            eos[:len(uids)] = eos_ids
            out = self._window_fn(
                self.serve_cfg, self.params, self._i32(toks),
                self._i32(pos), self._i32(tables), self.kv_cache,
                self._pad_i32(N, steps_left), self._i32(eos),
                self.block_size, self.decode_window,
                use_kernel=self.use_kernel, **(sampling or {}))
            out = out.cpu().numpy()   # ONE transfer for the whole window
        self.host_syncs += 1
        self.decode_windows += 1
        self.decode_steps += self.decode_window
        dt = time.perf_counter() - t0
        log_tokens = sm.config.enable_prefix_caching
        emitted: Dict[int, List[int]] = {}
        total = 0
        for i, uid in enumerate(uids):
            row = out[i]
            e = int((row >= 0).sum())   # active steps are a prefix
            toks_out = [int(t) for t in row[:e]]
            seq = sm.seqs[uid]
            seq.seen_tokens += e        # e tokens were fed and cached
            if log_tokens:
                # fed tokens: the input token plus all but the last emit
                seq.token_log.extend([int(tokens[i])] + toks_out[:-1])
            emitted[uid] = toks_out
            total += e
        self._m_host_syncs.inc()
        self._m_decode_steps.inc()
        self._m_decode_tokens.inc(total)
        self._m_decode_time.observe(dt)
        self._m_fused_time.observe(dt)
        if dt > 0:
            self._m_decode_tput.set(total / dt)
        flight.record("decode_window", batch=len(uids), tokens=total,
                      window=self.decode_window, dur_s=round(dt, 5))
        self._update_pool_telemetry()
        return emitted

    def _decode_window_greedy(self, uids: List[int], tokens: List[int],
                              steps_left: List[int],
                              eos_ids: List[int]) -> Dict[int, List[int]]:
        return self._decode_window_common(uids, tokens, steps_left,
                                          eos_ids, None)

    def _decode_window_sample(self, uids: List[int], tokens: List[int],
                              steps_left: List[int], eos_ids: List[int],
                              rng: torch.Tensor, row_seeds: List[int],
                              gen_idx0: List[int], temperature: float,
                              top_p: float,
                              top_k: int = 0) -> Dict[int, List[int]]:
        seeds, g0, temp, topp, topk = self._sampling_arrays(
            self._decode_bucket(len(uids)), row_seeds, gen_idx0,
            temperature, top_p, top_k)
        return self._decode_window_common(
            uids, tokens, steps_left, eos_ids,
            dict(rng=rng, row_seeds=seeds, gen_idx0=g0, temp=temp,
                 topp=topp, topk=topk))

    def _window_steps_left(self, step_uids: List[int],
                           remaining: List[int]) -> List[int]:
        """Per-row step budgets for one window: the generation budget, the
        sequence-length room, and — when the KV pool is too tight for the
        full window everywhere — a halving cap so the window shrinks
        instead of failing. Only the block pool is checked:
        ``max_ragged_batch_size`` caps one put(), not K sequential steps."""
        sm = self.state_manager
        K = self.decode_window
        sl = [max(1, min(K, r,
                         sm.config.max_seq_len
                         - sm.seqs[u].seen_tokens))
              for u, r in zip(step_uids, remaining)]

        def blocks_ok(lengths):
            need = sum(sm.seqs[u].blocks_needed(n, self.block_size)
                       for u, n in zip(step_uids, lengths))
            return need <= sm.reclaimable_blocks()

        cap = K
        while cap > 1 and not blocks_ok([min(cap, s) for s in sl]):
            cap //= 2
        return [min(cap, s) for s in sl]

    # -- ragged unified step --------------------------------------------
    def step_ragged(self, batch_uids: Sequence[int],
                    batch_tokens: Sequence[Iterable[int]]) -> np.ndarray:
        """One ragged step for a MIXED batch: prompt chunks, continuations
        and decode rows pack into a single RaggedBatch and run through
        ``paged_ragged_step``. Returns [len(batch_uids), vocab] f32
        last-token logits per entry."""
        sm = self.state_manager
        entries = [(int(uid), np.atleast_1d(np.asarray(toks, np.int64)))
                   for uid, toks in zip(batch_uids, batch_tokens)]
        if not self.can_schedule([u for u, _ in entries],
                                 [len(t) for _, t in entries]):
            raise RuntimeError(
                "batch not schedulable (KV blocks / sequence budget); "
                "check can_schedule()/query() before put()")
        for i, (uid, toks) in enumerate(entries):
            if not sm.known_seq(uid) and len(toks) > 1:
                # prefix caching: shared full blocks shorten the row to its
                # unseen suffix
                _, n_reused = sm.match_prefix(uid, toks)
                if n_reused:
                    entries[i] = (uid, toks[n_reused:])
        # classify rows BEFORE packing mutates allocation state: a decode
        # row is one token for a sequence with cached history
        decode_rows = sum(
            1 for uid, toks in entries
            if len(toks) == 1 and sm.known_seq(uid)
            and sm.seqs[uid].seen_tokens > 0)
        t0 = time.perf_counter()
        rb = ragged_batch.pack(entries, sm)
        i32 = self._i32
        with trace.span("ragged_step", rows=len(entries),
                        tokens=rb.total_tokens,
                        uids=[u for u, _ in entries],
                        **self._trace_attrs(u for u, _ in entries)):
            logits = self._ragged_fn(
                self.serve_cfg, self.params, i32(rb.ids), i32(rb.row_ids),
                i32(rb.positions), i32(rb.lengths), i32(rb.write_blocks),
                i32(rb.write_offsets), i32(rb.block_tables),
                i32(rb.last_index), self.kv_cache, self.block_size,
                use_kernel=self.use_kernel,
                touched_blocks=i32(rb.touched_blocks))
            logits = logits[:len(entries)].cpu().numpy()   # the one read
        dt = time.perf_counter() - t0
        self.ragged_steps += 1
        log_tokens = sm.config.enable_prefix_caching
        for uid, toks in entries:
            seq = sm.seqs[uid]
            seq.seen_tokens += len(toks)
            if log_tokens:
                seq.token_log.extend(map(int, toks))
        chunk_tokens = rb.total_tokens - decode_rows
        self._m_ragged_steps.inc()
        self._m_ragged_tokens.inc(rb.total_tokens)
        self._m_ragged_prefill_rows.inc(len(entries) - decode_rows)
        self._m_ragged_decode_rows.inc(decode_rows)
        self._m_ragged_time.observe(dt)
        self._m_ragged_pad.set(rb.pad_fraction)
        self._m_ragged_host_syncs.inc()
        if chunk_tokens:
            self._m_prefill_tokens.inc(chunk_tokens)
        flight.record("ragged_step", rows=len(entries),
                      tokens=rb.total_tokens, bucket=rb.token_bucket,
                      dur_s=round(dt, 5))
        self._update_pool_telemetry()
        return logits

    # -- the stitched dispatch (ragged_attention="off", JAX :797-880) ----
    def _bucket(self, n: int) -> int:
        """Prefill chunk-length bucket (multiple of prefill_bucket,
        capped at the max_seq_len bucket)."""
        return ceil_bucket(n, self.config.prefill_bucket,
                           cap=self.state_manager.config.max_seq_len)

    def _chunk_write_set(self, seq, start: int, n: int, C: int):
        """(ids buffer, block ids, offsets, distinct blocks) of a chunk of
        ``n`` tokens at ``start`` padded to ``C``; padding writes go to
        the null block."""
        positions = start + np.arange(C)
        valid = np.arange(C) < n
        table = np.full(C, NULL_BLOCK, np.int32)
        table[valid] = np.asarray(seq.blocks, np.int32)[
            positions[valid] // self.block_size]
        offs = (positions % self.block_size).astype(np.int32)
        return table, offs, np.unique(table)

    def _prefill(self, uid: int, tokens: np.ndarray) -> np.ndarray:
        """A whole prompt in one pass (``paged_prefill``): [V] f32
        logits of its last token."""
        sm = self.state_manager
        n = len(tokens)
        seq = sm.ensure_blocks(uid, n)
        assert seq.seen_tokens == 0, \
            "a prompt continuation goes through _continue"
        C = self._bucket(n)
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = tokens
        table, offs, touched = self._chunk_write_set(seq, 0, n, C)
        with trace.span("prefill", uid=int(uid), tokens=int(n),
                        **self._trace_attr(uid)):
            logits = self._prefill_fn(
                self.serve_cfg, self.params, self._i32(ids), n,
                self.kv_cache, self._i32(table), self._i32(offs),
                use_kernel=self.use_kernel,
                touched_blocks=self._i32(touched))
            logits = logits.cpu().numpy()
        flight.record("prefill", uid=int(uid), tokens=int(n))
        seq.seen_tokens = n
        if sm.config.enable_prefix_caching:
            seq.token_log.extend(map(int, tokens))
        self._m_prefill_tokens.inc(n)
        self._update_pool_telemetry()
        return logits

    def _continue(self, uid: int, tokens: np.ndarray) -> np.ndarray:
        """A multi-token continuation of a cached sequence in one pass
        (``paged_continue``): [V] f32 logits of its last token."""
        sm = self.state_manager
        n = len(tokens)
        seq = sm.ensure_blocks(uid, n)
        start = seq.seen_tokens
        C = self._bucket(n)
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = tokens
        table, offs, touched = self._chunk_write_set(seq, start, n, C)
        with trace.span("continue", uid=int(uid), tokens=int(n),
                        spec=False, **self._trace_attr(uid)):
            logits = self._continue_fn(
                self.serve_cfg, self.params, self._i32(ids), start, n,
                self.kv_cache, self._i32(table), self._i32(offs),
                self._i32(sm.block_table_for(uid)), self.block_size,
                touched_blocks=self._i32(touched))
            logits = logits.cpu().numpy()
        seq.seen_tokens = start + n
        if sm.config.enable_prefix_caching:
            seq.token_log.extend(map(int, tokens))
        self._m_prefill_tokens.inc(n)
        self._update_pool_telemetry()
        return logits

    def _decode_batch(self, uids: List[int],
                      tokens: List[int]) -> Dict[int, np.ndarray]:
        """One decode step returning each row's [V] f32 logits (the
        stitched put()'s decode rows)."""
        return self._decode_common(uids, tokens,
                                   lambda logits, N: logits[:len(uids)],
                                   lambda v, i: v[i])

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[Iterable[int]]) -> np.ndarray:
        """Reference engine_v2.put: returns [len(batch_uids), vocab] logits
        for the last token of each entry. With ragged attention on
        ("auto" / "on") the whole batch runs as ONE ragged step;
        otherwise the stitched dispatch (JAX :1583-1621) runs each new
        prompt through ``paged_prefill``, each multi-token continuation
        through ``paged_continue``, and the single tokens of cached
        sequences as batched decode steps."""
        if self.ragged_enabled:
            return self.step_ragged(batch_uids, batch_tokens)
        sm = self.state_manager
        entries = [(int(uid), np.atleast_1d(np.asarray(toks, np.int64)))
                   for uid, toks in zip(batch_uids, batch_tokens)]
        if not self.can_schedule([u for u, _ in entries],
                                 [len(t) for _, t in entries]):
            raise RuntimeError(
                "batch not schedulable (KV blocks / sequence budget); "
                "check can_schedule()/query() before put()")
        results: Dict[int, np.ndarray] = {}
        decode_uids: List[int] = []
        decode_toks: List[int] = []
        for i, (uid, toks) in enumerate(entries):
            if not sm.known_seq(uid) and len(toks) > 1:
                # prefix caching: shared full blocks make this uid a known
                # sequence whose suffix continues below
                _, n_reused = sm.match_prefix(uid, toks)
                if n_reused:
                    toks = toks[n_reused:]
                    entries[i] = (uid, toks)
            known = sm.known_seq(uid) and sm.seqs[uid].seen_tokens > 0
            if not known and len(toks) >= 1:
                results[uid] = self._prefill(uid, toks)
            elif len(toks) == 1:
                decode_uids.append(uid)
                decode_toks.append(int(toks[0]))
            else:
                results[uid] = self._continue(uid, toks)
        step = sm.config.max_tracked_sequences
        for a in range(0, len(decode_uids), step):
            results.update(self._decode_batch(decode_uids[a:a + step],
                                              decode_toks[a:a + step]))
        return np.stack([results[uid] for uid, _ in entries])

    def flush(self, uid: int) -> None:
        """Release a finished sequence's KV blocks (reference flush)."""
        self._uid_traces.pop(int(uid), None)
        self.state_manager.flush_sequence(uid)
        self._update_pool_telemetry()

    # -- distributed tracing (telemetry/context.py) ---------------------
    def bind_trace(self, uid: int, trace_id: str) -> None:
        """Correlate ``uid``'s engine spans with a distributed trace:
        until flush(uid), every span that serves the uid carries the
        trace id (single-request spans as ``trace_id``, batch spans as a
        ``trace_ids`` list)."""
        self._uid_traces[int(uid)] = str(trace_id)

    def _trace_attr(self, uid: int) -> Dict[str, str]:
        tid = self._uid_traces.get(int(uid))
        return {"trace_id": tid} if tid is not None else {}

    def _trace_attrs(self, uids) -> Dict[str, List[str]]:
        seen: List[str] = []
        for u in uids:
            tid = self._uid_traces.get(int(u))
            if tid is not None and tid not in seen:
                seen.append(tid)
        return {"trace_ids": seen} if seen else {}

    # ------------------------------------------------------------------
    # Device-memory accounting (telemetry/memory.py)
    # ------------------------------------------------------------------
    def memory_report(self, batch: int = 1) -> Dict[str, object]:
        """The engine's device memory: the CUDA caching allocator's
        allocated / peak bytes and the CUDA driver's free / total on the
        engine's device (zeros on the CPU), beside the long-lived buffers
        (KV pool, weights). The JAX engine AOT-compiles its programs for
        XLA's per-program analysis; eager PyTorch has no program to
        analyze, so ``programs`` is empty. ``batch`` is accepted for the
        JAX signature and unused."""
        ds_memory.record_buffer("kv_pool",
                                ds_memory.tree_bytes(self.kv_cache))
        ds_memory.record_buffer("params", ds_memory.tree_bytes(self.params))
        return {"programs": {},
                "device": ds_memory.record_device(self.device),
                "buffers": ds_memory.buffers()}

    # convenience: serve-style generation over the ragged engine
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
                 uids: Optional[Sequence[int]] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, seed: int = 0, speculative: bool = False,
                 adapter=None) -> List[np.ndarray]:
        """Greedy by default; temperature > 0 samples with top_p / top_k
        on the device, deterministic for a given seed. The prompts go
        through put() (one ragged step), then fused decode windows (or
        per-token steps when ``decode_window`` is 1) until every row hits
        ``max_new_tokens`` or ``eos_token_id``. Each row draws with keys
        from (``seed``, its row index, its generated-token index), so the
        window and the per-token path give the same stream, whatever else
        is in the batch. Returns prompt + generated tokens per row.
        Speculative decoding and LoRA adapters are not ported and raise
        (ROADMAP A11)."""
        if speculative:
            raise NotImplementedError(
                "speculative decoding is not ported to deepspeed_tpu_torch "
                "yet (ROADMAP A11)")
        if adapter is not None:
            raise NotImplementedError(
                "LoRA adapters are not ported to deepspeed_tpu_torch yet "
                "(ROADMAP A11)")
        uids = list(uids) if uids is not None else list(range(len(prompts)))
        outs: List[List[int]] = [list(map(int, p)) for p in prompts]
        row_of = {uid: i for i, uid in enumerate(uids)}
        sampling = temperature > 0.0
        base_rng = prng_key(seed, self.device) if sampling else None
        t_start = time.perf_counter()
        try:
            logits = self.put(uids, prompts)
            self.last_ttft_s = time.perf_counter() - t_start
            self._m_ttft.observe(self.last_ttft_s)
            if sampling:
                # the first token from put()'s logits with the keys of
                # generated-token index 0 (both decode paths share them)
                n = len(uids)
                seeds, g0, temp, topp, topk = self._sampling_arrays(
                    n, list(range(n)), [0] * n, temperature, top_p, top_k)
                first = sample_tokens_rowwise(
                    torch.as_tensor(logits).to(self.device),
                    fold_in_rows(base_rng, seeds, g0), temp, topp,
                    topk).cpu().numpy()
                cur = {uid: int(t) for uid, t in zip(uids, first)}
            else:
                cur = {uid: int(t) for uid, t in
                       zip(uids, np.argmax(logits, axis=-1))}
            live = set(uids)
            prompt_lens = {uid: len(prompts[row_of[uid]]) for uid in uids}
            row_seed = {uid: i for i, uid in enumerate(uids)}
            while max_new_tokens > 0:   # 0 -> prompt-only rows (no emit)
                step_uids = []
                for uid in uids:
                    if uid not in live:
                        continue
                    tok = cur[uid]
                    row = outs[row_of[uid]]
                    row.append(tok)
                    if ((eos_token_id is not None and tok == eos_token_id)
                            or len(row) - prompt_lens[uid]
                            >= max_new_tokens):
                        live.discard(uid)
                    else:
                        step_uids.append(uid)
                if not step_uids:
                    break
                if not self.can_schedule(step_uids, [1] * len(step_uids)):
                    raise RuntimeError(
                        "generation not schedulable: prompt + generated "
                        "tokens exceed max_seq_len or the free KV block "
                        "pool; lower max_new_tokens or raise the limits")
                feed = [outs[row_of[u]][-1] for u in step_uids]
                gen_count = [len(outs[row_of[u]]) - prompt_lens[u]
                             for u in step_uids]
                if self.decode_window > 1:
                    sl = self._window_steps_left(
                        step_uids, [max_new_tokens - g for g in gen_count])
                    eos = -1 if eos_token_id is None else int(eos_token_id)
                    if sampling:
                        em = self._decode_window_sample(
                            step_uids, feed, sl, [eos] * len(step_uids),
                            base_rng, [row_seed[u] for u in step_uids],
                            gen_count, temperature, top_p, top_k)
                    else:
                        em = self._decode_window_greedy(
                            step_uids, feed, sl, [eos] * len(step_uids))
                    cur = {}
                    for uid in step_uids:
                        row = outs[row_of[uid]]
                        toks_out = em[uid]
                        finished = False
                        # all but the last emit are fed/cached already; the
                        # host re-applies the eos/budget cuts
                        for tok in toks_out[:-1]:
                            row.append(tok)
                            if ((eos_token_id is not None
                                 and tok == eos_token_id)
                                    or len(row) - prompt_lens[uid]
                                    >= max_new_tokens):
                                finished = True
                                break
                        if finished:
                            live.discard(uid)
                        else:
                            cur[uid] = toks_out[-1]
                elif sampling:
                    cur = self._decode_batch_sample(
                        step_uids, feed, base_rng,
                        [row_seed[u] for u in step_uids], gen_count,
                        temperature, top_p, top_k)
                else:
                    cur = self._decode_batch_greedy(step_uids, feed)
        finally:
            # flush even on the schedulability raise: a long-lived engine
            # must not leak this call's KV blocks / sequence slots
            for uid in uids:
                self.flush(uid)
        return [np.asarray(o) for o in outs]


def _cast_tree(tree, device, dtype):
    """Move a parameter tree of tensors (or arrays) onto ``device`` in
    ``dtype``; tensors already there are reused, not copied. An already
    quantized leaf (a ``QuantizedTensor``, e.g. a stack quantized one
    layer at a time because its dense form would not fit the card) is
    kept as it is, and raises ``ValueError`` unless it lies on ``device``
    and dequantizes to ``dtype``."""
    from ..quantization import QuantizedTensor

    if isinstance(tree, dict):
        return {k: _cast_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        want = torch.device(device)
        have = tree.q.device
        if tree.dtype != dtype or have.type != want.type or (
                want.index is not None and have.index != want.index):
            raise ValueError(
                f"a quantized leaf on {have} dequantizing to {tree.dtype} "
                f"cannot serve on {want} in {dtype}")
        return tree
    return torch.as_tensor(tree).to(device=device, dtype=dtype)

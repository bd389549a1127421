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
figures), the KV spill tier (``engine.spill``, ``ragged/spill.py``), and
the live weight version (``weight_version``, ``swap_params``,
``note_weight_swap``: ``serve/weights.py`` swaps the leaves in place).
Under ``ragged_attention="off"`` put() takes the stitched dispatch
instead (JAX :1583-1621): a new prompt through ``paged_prefill`` (its
causal self-attention on the flash forward kernel when its bucket is a
multiple of 128), a multi-token continuation through ``paged_continue``,
single tokens as batched decode steps on the paged decode kernel.

Multi-tenant LoRA (``max_lora_adapters`` > 0, JAX :243 / :636-760): a
stacked adapter bank on the card (``paged_model.init_lora_bank``; slot 0
all zeros for the base model), ``load_adapter`` / ``unload_adapter``
write a slot in place, ``assign_adapter`` routes a uid through a loaded
adapter, and every path adds each row's q / v delta in the layer loop
(the ragged step from ``RaggedBatch.adapter_slots``, decode steps and
windows from the rows' slots, prefill / continue from the sequence's).
Prefix caching keys on the adapter name. ``generate(adapter=)`` serves
rows through adapters.

Speculative decoding (greedy only, JAX :64-135 / :879-1245; output equal
to plain greedy): ``generate(speculative=True)`` routes each request, by
``spec_mode`` (the config's, or the call's), between prompt-lookup
drafting (``ngram_index.NGramIndex`` over the row's own history, verified
by one ``paged_continue(greedy_window=)`` pass, the cache position rolled
back over the rejected tokens; three missed rounds in a row stop a uid's
drafting) and a draft model attached with ``load_draft_model``
(``paged_model.paged_spec_decode_window``: the draft proposes over its
own pool on the paged decode kernel, the target verifies on the ragged
kernel, inside one window with one read of its tokens). ``SpecChooser``
routes "auto" requests by the sources' accept rates, with hysteresis.

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
from .paged_model import (check_servable, init_lora_bank,
                          init_paged_kv_cache, paged_continue, paged_decode,
                          paged_decode_window, paged_prefill,
                          paged_ragged_step, paged_spec_decode_window)
from .ragged import batch as ragged_batch
from .ragged.blocked_allocator import NULL_BLOCK
from .ragged.ragged_manager import DSStateManager
from .sampling import (fold_in_rows, greedy_tokens, prng_key,
                       sample_tokens_rowwise)

DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}


class DraftModelMismatchError(ValueError):
    """A draft model cannot verify-share with the serving target:
    greedy verification compares raw token ids, so the vocabularies
    must be the SAME id space, and the draft writes its KV through the
    target's block tables, so it must cover the same sequence range."""


class SpecChooser:
    """Routes each speculative request between the two draft sources —
    the host n-gram index (``"ngram"``, prompt-lookup) and the in-window
    draft model (``"draft"``) — by observed accept rate (JAX :64, a copy).

    Hysteresis-armed like the online autotuner (autotuning/online.py's
    armed/hold cycle): a switch commits only after the OTHER source's
    accept-rate EMA beats the current one by ``margin`` for ``hold``
    consecutive observations, so one noisy window never flips the
    route. Cold start (no accept history for either source) routes by a
    repetitiveness prior: histories whose trailing n-gram already
    recurs draft well from their own text; everything else goes to the
    draft model."""

    def __init__(self, mode: str = "auto", alpha: float = 0.3,
                 margin: float = 0.05, hold: int = 3):
        self.mode = mode
        self.alpha = float(alpha)
        self.margin = float(margin)
        self.hold = int(hold)
        self.rate: Dict[str, Optional[float]] = {"ngram": None,
                                                 "draft": None}
        self.current = "draft" if mode == "draft" else "ngram"
        self.switches = 0
        self._armed: Optional[str] = None
        self._streak = 0

    def observe(self, mode: str, drafted: int, accepted: int) -> None:
        """Fold one round's (drafted, accepted) counts into ``mode``'s
        accept-rate EMA; may arm or commit a route switch."""
        if drafted <= 0:
            return
        r = min(max(accepted / drafted, 0.0), 1.0)
        prev = self.rate.get(mode)
        self.rate[mode] = (r if prev is None
                           else (1 - self.alpha) * prev + self.alpha * r)
        self._maybe_switch()

    def _maybe_switch(self) -> None:
        if self.mode != "auto":
            return
        other = "draft" if self.current == "ngram" else "ngram"
        ro, rc = self.rate[other], self.rate[self.current]
        if ro is None or rc is None or ro <= rc + self.margin:
            self._armed, self._streak = None, 0
            return
        if self._armed != other:
            self._armed, self._streak = other, 1
        else:
            self._streak += 1
        if self._streak >= self.hold:
            self.current = other
            self.switches += 1
            self._armed, self._streak = None, 0

    def choose(self, has_draft_model: bool, ngram_hit: bool) -> str:
        """Route one incoming request. Pinned modes and a missing draft
        model short-circuit; "auto" returns the hysteresis-settled
        current source once any accept history exists."""
        if self.mode == "ngram" or not has_draft_model:
            return "ngram"
        if self.mode == "draft":
            return "draft"
        if self.rate["ngram"] is None and self.rate["draft"] is None:
            return "ngram" if ngram_hit else "draft"
        return self.current


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

        # the leaves that are the caller's own memory (_cast_tree reuses a
        # tensor already on the device in the dtype): a weight swap gives
        # them storage of their own first (serve/weights.py)
        self._borrowed_leaves = set()
        if params is not None:
            self.params = _cast_tree(params, self.device, self.dtype)
            self._borrowed_leaves = _borrowed_leaves(params, self.params)
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
        self.spec_windows = 0        # draft-model speculative windows run
        self.spec_rounds = 0         # their propose -> verify rounds
        # windows K whose program has run (the online adapter's steady
        # move set); the per-token path is window 1
        self._warmed_windows: set = set()
        # speculation: per-uid consecutive missed-verify counts and
        # incremental n-gram indexes, cleared on flush() and at generate()
        # entry, so a cold streak never bans a uid across requests
        self._spec_miss_streak: Dict[int, int] = {}
        self._draft_index: Dict[int, object] = {}
        # the draft model (load_draft_model): its own pool shares the
        # target's block tables; _draft_seen is each uid's fed history
        # the draft pool holds
        self.draft_model = None
        self.draft_params = None
        self.draft_cache = None
        self._draft_cfg = None
        self._draft_seen: Dict[int, int] = {}
        self.spec_chooser = SpecChooser(config.spec_mode)
        self._spec_mode_of: Dict[int, str] = {}
        self._spec_switches_seen = 0
        # per-uid distributed-trace ids (telemetry/context.py): the
        # scheduler binds them at submit so batch-level spans carry the
        # trace ids of every request they served; cleared on flush()
        self._uid_traces: Dict[int, str] = {}
        # live-weight version (serve/weights.py hot-swap): 0 = the boot
        # weights; set by each swap and advertised through /healthz, so
        # the router's blue/green rollout converges a fleet on one version
        self.weight_version = 0
        # multi-tenant LoRA: the stacked adapter bank on the engine's
        # device, slot 0 the all-zero base delta (rows without an adapter
        # add an exact +0.0); loading an adapter writes its slot in place
        self.lora_bank = None
        self._adapter_slots: Dict[str, int] = {}
        self._uid_adapter: Dict[int, str] = {}
        if config.max_lora_adapters > 0:
            if self.topology is not None:
                raise NotImplementedError(
                    "the LoRA adapter bank in an SPMD engine (tensor or "
                    "expert parallel) is not ported: its followers would "
                    "have to mirror every adapter load (ROADMAP A15)")
            self.lora_bank = init_lora_bank(
                cfg, config.max_lora_adapters + 1, config.lora_rank,
                self.dtype, self.device)
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
        self._spec_verify_fn = watchdog.watch("spec_verify", paged_continue)
        self._spec_window_fn = watchdog.watch("spec_decode_window",
                                              paged_spec_decode_window)
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
        self._m_weight_swaps = reg.counter(
            "inference_weight_swaps_total",
            "live param hot-swaps applied to this engine (in-place copies "
            "into the existing leaves; every leaf keeps its address)")
        self._m_weight_swap_time = reg.histogram(
            "inference_weight_swap_seconds",
            "param hot-swap apply time (the cast and in-place copy of "
            "every leaf)", unit="s",
            buckets=(1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0))
        self._m_weight_version = reg.gauge(
            "serving_weight_version",
            "live weight version this engine serves (0 = the boot "
            "checkpoint; bumped by each hot-swap)")
        self._m_spec_drafted = reg.counter(
            "inference_spec_drafted_tokens_total",
            "speculative tokens drafted for verification")
        self._m_spec_accepted = reg.counter(
            "inference_spec_accepted_tokens_total",
            "speculative tokens accepted by greedy verification")
        self._m_spec_miss_rounds = reg.counter(
            "inference_spec_miss_rounds_total",
            "speculative rounds whose whole draft was rejected")
        self._m_spec_window_rounds = reg.counter(
            "inference_spec_window_rounds_total",
            "draft-model propose->verify->accept rounds run inside "
            "fused speculative decode windows (per-row, summed on "
            "device)")
        self._m_spec_mode_requests = reg.counter(
            "inference_spec_mode_requests_total",
            "speculative requests routed per speculation source",
            labelnames=("mode",))
        self._m_spec_switches = reg.counter(
            "inference_spec_chooser_switches_total",
            "speculation-source switches committed by the hysteresis "
            "chooser")
        self._m_spec_rate = reg.gauge(
            "inference_spec_accept_rate",
            "EMA accept rate (accepted/drafted) per speculation source",
            labelnames=("mode",))
        self._m_adapter_loads = reg.counter(
            "inference_lora_adapter_loads_total",
            "LoRA adapters (re)loaded into device bank slots")
        self._m_adapters_live = reg.gauge(
            "inference_lora_adapters_live",
            "adapter names currently resident in the device bank")

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

    def warmed_decode_windows(self):
        """Window sizes whose decode path has run at least once (1 is the
        per-token path): the only K values the online adapter moves to at
        steady state (JAX :597)."""
        return sorted(self._warmed_windows)

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
    # Multi-tenant batched LoRA (config_v2.max_lora_adapters; JAX :636)
    # ------------------------------------------------------------------
    def load_adapter(self, name: str, adapters: Dict[str, tuple],
                     scale: float = 1.0) -> int:
        """Install a LoRA adapter into a bank slot (in place: serving goes
        on through the same code and tensors). ``adapters`` is the hybrid
        engine's external-adapter convention: ``{"layers/wq": (a, b),
        "layers/wv": (a, b)}`` with a [L, h, r] and b [L, r, out]
        (arrays or tensors). ``scale`` folds into b, so a row's delta is
        the fused weight's ``w + scale * (a @ b)``. Ranks below the bank's
        zero-pad (the extra rank adds exactly 0), larger ones raise;
        reloading a known name rewrites its slot. Returns the slot."""
        if self.lora_bank is None:
            raise ValueError(
                "adapter bank disabled: set max_lora_adapters > 0 in "
                "RaggedInferenceEngineConfig")
        from ...models.transformer import lora_target_leaves
        cfg = self.model.cfg
        targets = lora_target_leaves(cfg)
        if set(adapters) != set(targets):
            raise ValueError(
                f"adapter {name!r} leaves {sorted(adapters)} != serving "
                f"targets {sorted(targets)} (q/v projections only)")
        R = self.config.lora_rank
        L = cfg.num_layers
        staged = {}
        for leaf, keys in (("layers/wq", ("qa", "qb")),
                           ("layers/wv", ("va", "vb"))):
            # host copies (a staged payload leaf is a read-only view)
            a, b = (np.array(x.detach().to("cpu", torch.float32)
                             if isinstance(x, torch.Tensor) else x,
                             np.float32) for x in adapters[leaf])
            in_dim, out_dim = targets[leaf]
            if (a.ndim != 3 or b.ndim != 3 or a.shape[0] != L
                    or b.shape[0] != L or a.shape[1] != in_dim
                    or b.shape[2] != out_dim or a.shape[2] != b.shape[1]):
                raise ValueError(
                    f"adapter {name!r} leaf {leaf}: got a{a.shape} "
                    f"b{b.shape}, want a[{L},{in_dim},r] "
                    f"b[{L},r,{out_dim}]")
            r = a.shape[2]
            if r > R:
                raise ValueError(
                    f"adapter {name!r} rank {r} exceeds bank rank {R} "
                    f"(config_v2.lora_rank)")
            if r < R:   # zero-pad: the extra rank contributes exactly 0
                a = np.concatenate(
                    [a, np.zeros((L, in_dim, R - r), a.dtype)], axis=2)
                b = np.concatenate(
                    [b, np.zeros((L, R - r, out_dim), b.dtype)], axis=1)
            staged[keys] = (a, b * float(scale))
        slot = self._adapter_slots.get(name)
        if slot is None:
            used = set(self._adapter_slots.values())
            slot = next(
                (s for s in range(1, self.config.max_lora_adapters + 1)
                 if s not in used), None)
            if slot is None:
                raise RuntimeError(
                    f"adapter bank full ({self.config.max_lora_adapters} "
                    f"slots); unload_adapter() one or raise "
                    f"max_lora_adapters")
        bank = self.lora_bank
        with torch.no_grad():
            for (ka, kb), (a, b) in staged.items():
                bank[ka][:, slot].copy_(torch.from_numpy(a).to(
                    bank[ka].device, bank[ka].dtype))
                bank[kb][:, slot].copy_(torch.from_numpy(b).to(
                    bank[kb].device, bank[kb].dtype))
        self._adapter_slots[name] = slot
        self._m_adapter_loads.inc()
        self._m_adapters_live.set(len(self._adapter_slots))
        flight.record("adapter_load", name=str(name), slot=int(slot))
        return slot

    def unload_adapter(self, name: str) -> None:
        """Zero the adapter's slot (back to the base no-op delta) and free
        it; uids still routed to the name fall back to the base model."""
        slot = self._adapter_slots.pop(name, None)
        if slot is None:
            return
        with torch.no_grad():
            for t in self.lora_bank.values():
                t[:, slot].zero_()
        self._uid_adapter = {u: n for u, n in self._uid_adapter.items()
                             if n != name}
        self._m_adapters_live.set(len(self._adapter_slots))

    def assign_adapter(self, uid: int, name: Optional[str]) -> int:
        """Route ``uid``'s tokens through a loaded adapter's slot (None or
        "" clears it to the base slot 0). An unknown adapter raises
        ``KeyError`` here, at submit, not mid-batch."""
        uid = int(uid)
        if not name:
            self._uid_adapter.pop(uid, None)
            return 0
        if self.lora_bank is None:
            raise ValueError(
                f"adapter {name!r} requested but the bank is disabled "
                f"(max_lora_adapters=0)")
        slot = self._adapter_slots.get(name)
        if slot is None:
            raise KeyError(
                f"unknown adapter {name!r}: load_adapter() it first "
                f"(loaded: {sorted(self._adapter_slots)})")
        self._uid_adapter[uid] = str(name)
        seq = self.state_manager.seqs.get(uid)
        if seq is not None:
            seq.adapter = str(name)
            seq.adapter_slot = int(slot)
        return slot

    def adapter_of(self, uid: int) -> Optional[str]:
        """The adapter name serving ``uid`` (None = base). Names, not
        engine-local slots, key the prefix digests and router affinity, so
        they agree across replicas."""
        return self._uid_adapter.get(int(uid))

    def _adapter_slot_of(self, uid: int) -> int:
        name = self._uid_adapter.get(int(uid))
        if name is None:
            return 0
        return self._adapter_slots.get(name, 0)

    def _lora_rows(self, N: int, uids) -> dict:
        """The bank and the [N] per-row slots of a decode batch (padding
        rows on slot 0), as the families' keyword arguments."""
        if self.lora_bank is None:
            return {}
        return dict(lora=self.lora_bank, adapter_ids=self._pad_i32(
            N, [self._adapter_slot_of(u) for u in uids]))

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
                use_kernel=self.use_kernel, **self._lora_rows(N, uids))
            nxt = pick(logits, N).cpu().numpy()   # the step's one read
        self.host_syncs += 1
        self.decode_steps += 1
        self._warmed_windows.add(1)   # the per-token path is window 1
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
                use_kernel=self.use_kernel, **(sampling or {}),
                **self._lora_rows(N, uids))
            out = out.cpu().numpy()   # ONE transfer for the whole window
        self.host_syncs += 1
        self.decode_windows += 1
        self.decode_steps += self.decode_window
        self._warmed_windows.add(self.decode_window)
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
                # unseen suffix; keyed on the adapter name (a LoRA row's v
                # projection, so its KV, differs from the base model's)
                _, n_reused = sm.match_prefix(
                    uid, toks, adapter=self._uid_adapter.get(int(uid)))
                if n_reused:
                    entries[i] = (uid, toks[n_reused:])
        # classify rows BEFORE packing mutates allocation state: a decode
        # row is one token for a sequence with cached history
        decode_rows = sum(
            1 for uid, toks in entries
            if len(toks) == 1 and sm.known_seq(uid)
            and sm.seqs[uid].seen_tokens > 0)
        if self.lora_bank is not None:
            # each row's adapter into its descriptor: the packer carries
            # the slots (RaggedBatch.adapter_slots), flush-time prefix
            # registration the name
            for uid, _ in entries:
                seq = sm.get_or_create_sequence(uid)
                seq.adapter = self._uid_adapter.get(int(uid))
                seq.adapter_slot = self._adapter_slot_of(uid)
        t0 = time.perf_counter()
        rb = ragged_batch.pack(entries, sm)
        lora = ({} if self.lora_bank is None else
                dict(lora=self.lora_bank,
                     adapter_ids=self._i32(rb.adapter_slots)))
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
                touched_blocks=i32(rb.touched_blocks), **lora)
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
                touched_blocks=self._i32(touched), **self._lora_seq(uid))
            logits = logits.cpu().numpy()
        flight.record("prefill", uid=int(uid), tokens=int(n))
        seq.seen_tokens = n
        if sm.config.enable_prefix_caching:
            seq.token_log.extend(map(int, tokens))
        self._m_prefill_tokens.inc(n)
        self._update_pool_telemetry()
        return logits

    def _continue(self, uid: int, tokens: np.ndarray,
                  all_logits: int = 0) -> np.ndarray:
        """A multi-token continuation of a cached sequence in one pass
        (``paged_continue``): [V] f32 logits of its last token. With
        ``all_logits`` > 0 (speculative verification) the [all_logits]
        int32 greedy ids of the leading fed positions instead."""
        sm = self.state_manager
        n = len(tokens)
        seq = sm.ensure_blocks(uid, n)
        start = seq.seen_tokens
        C = self._bucket(n)
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = tokens
        table, offs, touched = self._chunk_write_set(seq, start, n, C)
        fn = self._spec_verify_fn if all_logits else self._continue_fn
        with trace.span("continue", uid=int(uid), tokens=int(n),
                        spec=bool(all_logits), **self._trace_attr(uid)):
            logits = fn(
                self.serve_cfg, self.params, self._i32(ids), start, n,
                self.kv_cache, self._i32(table), self._i32(offs),
                self._i32(sm.block_table_for(uid)), self.block_size,
                touched_blocks=self._i32(touched), greedy_window=all_logits,
                **self._lora_seq(uid))
            logits = logits.cpu().numpy()
        seq.seen_tokens = start + n
        if sm.config.enable_prefix_caching:
            seq.token_log.extend(map(int, tokens))
        if not all_logits:  # spec-verify feeds count via the spec counters
            self._m_prefill_tokens.inc(n)
        self._update_pool_telemetry()
        return logits

    # -- speculative decoding (prompt-lookup, JAX :879-1007) --------------
    _SPEC_SCAN_WINDOW = 512   # bound the per-round host scan (the scan
    # is O(window); an unbounded history would make draft lookup
    # quadratic over a long generation)

    @staticmethod
    def _lookup_draft(history: List[int], k: int, ngram: int) -> List[int]:
        """Draft the k tokens that followed the most recent earlier
        occurrence of the history's trailing n-gram (prompt-lookup
        decoding: the sequence's own text is the draft model). Scans at
        most the last _SPEC_SCAN_WINDOW tokens.

        This right-to-left scan is the REFERENCE implementation (O(window
        * ngram) per round); the hot path uses the incremental
        NGramIndex (ngram_index.py, held equal to this)."""
        W = InferenceEngineV2._SPEC_SCAN_WINDOW
        base = max(0, len(history) - W)
        win = history[base:]
        for n in range(ngram, 1, -1):
            if len(win) <= n:
                continue
            tail = win[-n:]
            # scan right-to-left for the most recent earlier match
            for i in range(len(win) - n - 1, -1, -1):
                if win[i:i + n] == tail:
                    start = base + i + n
                    draft = history[start:start + k]
                    if draft:
                        return list(draft)
        return []

    def _speculative_step(self, uid: int, cur: int,
                          draft: List[int]) -> List[int]:
        """Feed [cur] + draft through one fused continuation, accept the
        longest greedily-verified draft prefix, roll the cache position
        back over rejected tokens, and return the emitted tokens
        (1 + accepted; the last emitted token is NOT yet in the cache —
        same invariant as the normal decode loop).

        Rollback is a host-side counter reset: attention masks by
        position (ctx_pos <= pos), so the rejected tokens' stale KV
        slots are never attended and the next write overwrites them."""
        sm = self.state_manager
        seq = sm.seqs[uid]
        fed = [int(cur)] + list(map(int, draft))
        start = seq.seen_tokens
        greedy = self._continue(uid, np.asarray(fed, np.int64),
                                all_logits=len(fed))
        emitted = [int(greedy[0])]
        accepted = 0
        for j, d in enumerate(draft):
            if int(d) != emitted[-1]:
                break
            accepted += 1
            emitted.append(int(greedy[j + 1]))
        # rewind over the rejected fed tokens (cur + accepted stay)
        seq.seen_tokens = start + 1 + accepted
        if sm.config.enable_prefix_caching:
            rejected = len(fed) - 1 - accepted
            if rejected:
                del seq.token_log[-rejected:]
        return emitted

    def _speculative_round(self, step_uids, outs, row_of, prompt_lens,
                           live, max_new_tokens, eos_token_id,
                           spec_k, spec_ngram) -> Dict[int, int]:
        """One greedy round with prompt-lookup speculation: per uid,
        draft from its own history and verify in one fused pass. The
        accepted extras append to ``outs`` here (with per-token
        eos/budget checks); the final emitted token becomes the round's
        ``cur`` — the last-token-never-fed invariant the plain loop
        keeps. Sequences without a usable draft fall back to the normal
        batched greedy decode."""
        from .ngram_index import NGramIndex

        cur: Dict[int, int] = {}
        plain_uids: List[int] = []
        sm = self.state_manager
        for uid in step_uids:
            row = outs[row_of[uid]]
            remaining = max_new_tokens - (len(row) - prompt_lens[uid])
            # draft length budget: the generation budget, the sequence
            # length limit (1+k fed tokens must fit max_seq_len — the
            # loop's guard only covered 1), and a cold-streak cutoff
            # (natural text with recurring n-grams but divergent
            # continuations would otherwise pay a rejected verify pass
            # every round, slower than plain batched greedy)
            seq_room = sm.config.max_seq_len - sm.seqs[uid].seen_tokens - 1
            k = min(spec_k, remaining - 1, seq_room)
            if k > 0 and self._spec_miss_streak.get(uid, 0) < 3:
                idx = self._draft_index.get(uid)
                if idx is None:
                    idx = self._draft_index[uid] = NGramIndex(
                        spec_ngram, self._SPEC_SCAN_WINDOW)
                idx.sync(row)
                draft = idx.draft(k, spec_ngram)
            else:
                draft = []
            if draft and not self.can_schedule([uid], [1 + len(draft)]):
                draft = []
            if not draft:
                plain_uids.append(uid)
                continue
            emitted = self._speculative_step(uid, row[-1], draft)
            self._m_spec_drafted.inc(len(draft))
            self._m_spec_accepted.inc(len(emitted) - 1)
            self.spec_chooser.observe("ngram", len(draft),
                                      len(emitted) - 1)
            if len(emitted) == 1:
                self._m_spec_miss_rounds.inc()
                self._spec_miss_streak[uid] = \
                    self._spec_miss_streak.get(uid, 0) + 1
            else:
                self._spec_miss_streak[uid] = 0
            finished = False
            for tok in emitted[:-1]:
                row.append(tok)
                if ((eos_token_id is not None and tok == eos_token_id)
                        or len(row) - prompt_lens[uid] >= max_new_tokens):
                    finished = True
                    break
            if finished:
                live.discard(uid)
            else:
                cur[uid] = emitted[-1]
        if plain_uids:
            cur.update(self._decode_batch_greedy(
                plain_uids, [outs[row_of[u]][-1] for u in plain_uids]))
        self._observe_spec_rates()
        return cur

    # -- draft-model speculation (in-window propose->verify->accept) -----
    def load_draft_model(self, model, params=None) -> None:
        """Attach a small draft model for in-window speculative decoding
        (JAX :1010). The draft shares the TARGET's block tables against
        its own 16-bit paged KV pool (the target's ``num_blocks x
        block_size``), so the spec window needs no table of its own and
        rollback stays free. Raises :class:`DraftModelMismatchError` when
        the draft cannot verify-share with the target. ``params`` (a tree
        of tensors or arrays; tensors already on the device in the
        engine's dtype are used in place) defaults to a fresh seeded
        init."""
        dcfg = model.cfg
        cfg = self.model.cfg
        if dcfg.vocab_size != cfg.vocab_size:
            raise DraftModelMismatchError(
                f"draft vocab_size {dcfg.vocab_size} != target "
                f"{cfg.vocab_size}: greedy verification compares raw "
                f"token ids, so the vocabularies must be the same id "
                f"space")
        sm = self.state_manager
        if dcfg.max_seq_len < sm.config.max_seq_len:
            raise DraftModelMismatchError(
                f"draft max_seq_len {dcfg.max_seq_len} < serving "
                f"max_seq_len {sm.config.max_seq_len}: the draft must "
                f"decode at every position the target serves")
        if self.topology is not None:
            raise NotImplementedError(
                "a draft model in an SPMD engine (tensor or expert "
                "parallel) is not ported: its followers would have to "
                "mirror the draft pool (ROADMAP A15)")
        check_servable(dcfg)
        self.draft_model = model
        self._draft_cfg = dcfg
        if params is not None:
            self.draft_params = _cast_tree(params, self.device, self.dtype)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.config.seed + 1)
            self.draft_params = model.init_params(gen, dtype=self.dtype)
        self.draft_cache = init_paged_kv_cache(
            dcfg, sm.config.num_blocks, sm.block_size, self.dtype,
            self.device)
        self._draft_seen.clear()
        self._draft_catchup_fn = watchdog.watch("draft_catchup",
                                                paged_continue)
        ds_memory.record_buffer("draft_params",
                                ds_memory.tree_bytes(self.draft_params))
        ds_memory.record_buffer("draft_kv_pool",
                                ds_memory.tree_bytes(self.draft_cache))
        log_dist(
            f"draft model attached: layers={dcfg.num_layers} "
            f"hidden={dcfg.hidden_size} (target hidden="
            f"{cfg.hidden_size})", ranks=[0])

    def _draft_catchup(self, uid: int, row: List[int]) -> None:
        """Bring the draft KV pool level with the target's cache for
        ``uid``: feed the fed-token suffix the draft has not seen
        (``row[:seen_tokens]`` is exactly the fed history — the last
        emitted token is never fed, the loop invariant) through one
        ``paged_continue`` over the draft pool. No-op when the draft is
        already level (consecutive spec windows)."""
        sm = self.state_manager
        seq = sm.seqs[uid]
        seen = seq.seen_tokens
        d0 = self._draft_seen.get(uid, 0)
        if d0 >= seen:
            return
        toks = np.asarray(row[d0:seen], np.int64)
        n = len(toks)
        C = self._bucket(n)
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = toks
        table, offs, _ = self._chunk_write_set(seq, d0, n, C)
        with trace.span("draft_catchup", uid=int(uid), tokens=int(n),
                        **self._trace_attr(uid)):
            self._draft_catchup_fn(
                self._draft_cfg, self.draft_params, self._i32(ids), d0, n,
                self.draft_cache, self._i32(table), self._i32(offs),
                self._i32(sm.block_table_for(uid)), self.block_size)
        self._draft_seen[uid] = seen

    def _observe_spec_rates(self) -> None:
        """Publish the chooser's per-source accept-rate EMAs and any
        newly committed route switches."""
        for mode in ("ngram", "draft"):
            r = self.spec_chooser.rate.get(mode)
            if r is not None:
                self._m_spec_rate.labels(mode=mode).set(r)
        d = self.spec_chooser.switches - self._spec_switches_seen
        if d > 0:
            self._m_spec_switches.inc(d)
            self._spec_switches_seen = self.spec_chooser.switches

    def _spec_window_round(self, step_uids, outs, row_of, prompt_lens,
                           live, max_new_tokens, eos_token_id,
                           spec_k) -> Dict[int, int]:
        """One draft-model speculative window per batch (JAX :1134):
        propose(k) -> target-verify -> accept-prefix rounds on the device
        (``paged_spec_decode_window``), the window's tokens and stats read
        once. Rows without the sequence room / KV blocks the widened
        pre-allocation contract needs (``steps_left + spec_k`` writes)
        fall back to the plain batched greedy step."""
        sm = self.state_manager
        K = max(self.decode_window, spec_k + 1)
        spec_uids: List[int] = []
        plain_uids: List[int] = []
        sl: List[int] = []
        for uid in step_uids:
            row = outs[row_of[uid]]
            remaining = max_new_tokens - (len(row) - prompt_lens[uid])
            room = (sm.config.max_seq_len - sm.seqs[uid].seen_tokens
                    - spec_k)
            s = min(K, remaining, room)
            if s < 1 or not self.can_schedule([uid], [s + spec_k]):
                plain_uids.append(uid)
                continue
            spec_uids.append(uid)
            sl.append(s)
        cur: Dict[int, int] = {}
        if plain_uids:
            cur.update(self._decode_batch_greedy(
                plain_uids, [outs[row_of[u]][-1] for u in plain_uids]))
        if not spec_uids:
            return cur
        for uid in spec_uids:
            self._draft_catchup(uid, outs[row_of[uid]])
        tokens = [outs[row_of[u]][-1] for u in spec_uids]
        t0 = time.perf_counter()
        with trace.span("spec_decode_window", batch=len(spec_uids),
                        window=K, spec_k=spec_k,
                        uids=[int(u) for u in spec_uids],
                        **self._trace_attrs(spec_uids)):
            # widened pre-allocation contract: row i may write KV at
            # positions pos..pos+sl[i]+spec_k-1 (the final round's
            # unaccepted tail), so those blocks exist BEFORE dispatch
            N, toks, pos, tables = self._assemble_decode_rows(
                spec_uids, tokens, [s + spec_k for s in sl])
            eos = np.full(N, -1, np.int32)
            eos[:len(spec_uids)] = (
                -1 if eos_token_id is None else int(eos_token_id))
            out, stats, rounds = self._spec_window_fn(
                self.serve_cfg, self._draft_cfg, self.params,
                self.draft_params, self._i32(toks), self._i32(pos),
                self._i32(tables), self.kv_cache, self.draft_cache,
                self._pad_i32(N, sl), self._i32(eos), self.block_size, K,
                spec_k, use_kernel=self.use_kernel,
                **self._lora_rows(N, spec_uids))
            # one transfer for the whole window: tokens and stats
            both = torch.cat([out.reshape(-1).long(), stats]).cpu().numpy()
        out = both[:-4].reshape(N, K)
        stats = both[-4:]
        self.host_syncs += 1
        self.spec_windows += 1
        self.spec_rounds += rounds
        self._m_host_syncs.inc()
        dt = time.perf_counter() - t0
        drafted, accepted, miss, row_rounds = (int(x) for x in stats)
        self._m_spec_drafted.inc(drafted)
        self._m_spec_accepted.inc(accepted)
        self._m_spec_miss_rounds.inc(miss)
        self._m_spec_window_rounds.inc(row_rounds)
        self.spec_chooser.observe("draft", drafted, accepted)
        self._observe_spec_rates()
        log_tokens = sm.config.enable_prefix_caching
        total = 0
        for i, uid in enumerate(spec_uids):
            out_row = out[i]
            e = int((out_row >= 0).sum())   # emissions are a prefix
            toks_out = [int(t) for t in out_row[:e]]
            seq = sm.seqs[uid]
            seq.seen_tokens += e
            # accepted draft tokens ARE the canonical stream, so the
            # draft cache is level with the target after the window
            self._draft_seen[uid] = seq.seen_tokens
            if log_tokens:
                seq.token_log.extend([int(tokens[i])] + toks_out[:-1])
            total += e
            row = outs[row_of[uid]]
            finished = False
            # all but the last emit are fed/cached already; the host
            # re-applies the eos/budget cuts (defensively — the device
            # enforced them too), same fold-back as the plain window
            for tok in toks_out[:-1]:
                row.append(tok)
                if ((eos_token_id is not None and tok == eos_token_id)
                        or len(row) - prompt_lens[uid] >= max_new_tokens):
                    finished = True
                    break
            if finished or not toks_out:
                live.discard(uid)
            else:
                cur[uid] = toks_out[-1]
        self._m_decode_steps.inc()
        self._m_decode_tokens.inc(total)
        self._m_decode_time.observe(dt)
        self._m_fused_time.observe(dt)
        if dt > 0:
            self._m_decode_tput.set(total / dt)
        flight.record("spec_decode_window", batch=len(spec_uids),
                      tokens=total, window=K, spec_k=spec_k,
                      drafted=drafted, accepted=accepted,
                      dur_s=round(dt, 5))
        self._update_pool_telemetry()
        return cur

    def _lora_seq(self, uid: int) -> dict:
        """The bank and ``uid``'s slot for a one-sequence pass."""
        if self.lora_bank is None:
            return {}
        return dict(lora=self.lora_bank,
                    adapter_ids=self._adapter_slot_of(uid))

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
                # sequence whose suffix continues below (adapter-keyed)
                _, n_reused = sm.match_prefix(
                    uid, toks, adapter=self._uid_adapter.get(int(uid)))
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
        """Release a finished sequence's KV blocks (reference flush).
        Also forgets the uid's speculative cold-streak state: uids are
        caller-assigned and commonly reused, and a streak carried across
        independent requests would permanently ban drafting for them."""
        self._spec_miss_streak.pop(uid, None)
        self._draft_index.pop(uid, None)
        self._uid_traces.pop(int(uid), None)
        self._uid_adapter.pop(int(uid), None)
        self._spec_mode_of.pop(int(uid), None)
        self._draft_seen.pop(int(uid), None)
        self.state_manager.flush_sequence(uid)
        self._update_pool_telemetry()

    # -- weight hot-swap (serve/weights.py) -----------------------------
    def note_weight_swap(self, seconds: float) -> None:
        """Book-keeping after ``serve/weights.swap_engine_params`` wrote
        new values into ``self.params``: telemetry, a flight event, and
        the params buffer's bytes."""
        self._m_weight_swaps.inc()
        self._m_weight_swap_time.observe(seconds)
        self._m_weight_version.set(self.weight_version)
        flight.record("weight_swap", version=int(self.weight_version),
                      dur_s=round(float(seconds), 5))
        ds_memory.record_buffer("params", ds_memory.tree_bytes(self.params))

    def swap_params(self, flat_leaves, version: int) -> None:
        """Install published weight leaves (``{path: fp32 ndarray}``) in
        place (``serve/weights.swap_engine_params``)."""
        from .serve import weights as serve_weights
        serve_weights.swap_engine_params(self, flat_leaves, version)

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

    def _route_speculative(self, uids, outs, row_of, spec_ngram: int,
                           spec_mode: Optional[str]) -> None:
        """Validate ``spec_mode`` and route each request once, up front
        (JAX :1789-1820): the n-gram index over its prompt is the
        chooser's repetitiveness prior, the per-source accept-rate EMAs
        its learned history."""
        from .ngram_index import NGramIndex

        if spec_mode not in (None, "auto", "ngram", "draft"):
            raise ValueError(f"spec_mode must be auto|ngram|draft, "
                             f"got {spec_mode!r}")
        if spec_mode == "draft" and self.draft_model is None:
            raise ValueError("spec_mode='draft' requires a draft "
                             "model: call load_draft_model() first")
        for uid in uids:
            idx = self._draft_index[uid] = NGramIndex(
                spec_ngram, self._SPEC_SCAN_WINDOW)
            idx.sync(outs[row_of[uid]])
            if spec_mode in ("ngram", "draft"):
                mode = spec_mode
            else:
                mode = self.spec_chooser.choose(
                    self.draft_model is not None,
                    idx.has_candidate(spec_ngram))
            self._spec_mode_of[int(uid)] = mode
            self._m_spec_mode_requests.labels(mode=mode).inc()

    # convenience: serve-style generation over the ragged engine
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
                 uids: Optional[Sequence[int]] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, seed: int = 0, speculative: bool = False,
                 spec_k: int = 4, spec_ngram: int = 3,
                 spec_mode: Optional[str] = None,
                 adapter=None) -> List[np.ndarray]:
        """Greedy by default; temperature > 0 samples with top_p / top_k
        on the device, deterministic for a given seed. The prompts go
        through put() (one ragged step), then fused decode windows (or
        per-token steps when ``decode_window`` is 1) until every row hits
        ``max_new_tokens`` or ``eos_token_id``. Each row draws with keys
        from (``seed``, its row index, its generated-token index), so the
        window and the per-token path give the same stream, whatever else
        is in the batch. Returns prompt + generated tokens per row.
        ``adapter`` routes rows through loaded LoRA adapters: a name for
        every row, or a list of names (None = base) one per row.
        ``speculative`` (greedy only) turns on speculative decoding with
        drafts of up to ``spec_k`` tokens: per request the chooser routes
        between prompt-lookup drafting (``spec_ngram``-gram history
        matches, one verify pass a round) and the draft model's in-window
        path when one is loaded; ``spec_mode`` ("auto" / "ngram" /
        "draft") overrides the configured mode for this call. The output
        is the plain greedy stream either way."""
        uids = list(uids) if uids is not None else list(range(len(prompts)))
        sampling = temperature > 0.0
        if speculative and sampling:
            raise AssertionError(
                "speculative decoding is greedy-only (draft verification "
                "compares argmax)")
        # each generate() call is an independent request batch: spec
        # cold-streaks (and draft indexes) from earlier calls must not
        # leak into this one
        self._spec_miss_streak.clear()
        self._draft_index.clear()
        if adapter is not None:
            names = ([adapter] * len(uids) if isinstance(adapter, str)
                     else list(adapter))
            if len(names) != len(uids):
                raise ValueError(
                    f"adapter list length {len(names)} != batch size "
                    f"{len(uids)}")
            for uid, name in zip(uids, names):
                self.assign_adapter(uid, name)
        outs: List[List[int]] = [list(map(int, p)) for p in prompts]
        row_of = {uid: i for i, uid in enumerate(uids)}
        if speculative:
            self._route_speculative(uids, outs, row_of, spec_ngram,
                                    spec_mode)
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
                if speculative:
                    # per-request routing: draft-model rows take the
                    # in-window path, the rest prompt-lookup
                    draft_uids = [u for u in step_uids
                                  if self._spec_mode_of.get(int(u))
                                  == "draft"]
                    ngram_uids = [u for u in step_uids
                                  if u not in draft_uids]
                    cur = {}
                    if draft_uids:
                        cur.update(self._spec_window_round(
                            draft_uids, outs, row_of, prompt_lens, live,
                            max_new_tokens, eos_token_id, spec_k))
                    if ngram_uids:
                        cur.update(self._speculative_round(
                            ngram_uids, outs, row_of, prompt_lens, live,
                            max_new_tokens, eos_token_id, spec_k,
                            spec_ngram))
                elif self.decode_window > 1:
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


def _borrowed_leaves(src, dst, prefix: str = "") -> set:
    """Path names (``checkpoint/state_checkpoint.leaf_paths``) of the
    leaves of ``dst`` that start at the same address as their ``src``
    leaf: ``_cast_tree`` kept the caller's memory."""
    if isinstance(dst, dict):
        out = set()
        for k in dst:
            out |= _borrowed_leaves(src[k], dst[k], f"{prefix}{k}/")
        return out
    if not isinstance(dst, torch.Tensor):
        return set()
    if isinstance(src, torch.Tensor):
        ptr = src.data_ptr()
    elif isinstance(src, np.ndarray):
        ptr = src.__array_interface__["data"][0]
    else:
        return set()
    return {prefix[:-1]} if dst.data_ptr() == ptr else set()


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

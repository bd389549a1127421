"""Ragged/continuous-batching inference engine (FastGen-style).

Port of ``deepspeed_tpu/inference/v2/engine_v2.py`` (``InferenceEngineV2``,
:133). The serving loop calls ``put(batch_uids, batch_tokens)`` with a mix
of new prompts, prompt chunks and one next token per running sequence;
every put() packs into ONE :class:`~.ragged.batch.RaggedBatch` and runs
``paged_model.paged_ragged_step`` (the ragged attention kernel, once per
layer) and returns each entry's last-token logits. KV lives in a blocked
pool managed by ``DSStateManager``; ``flush`` frees a sequence.

Greedy decode runs in fused windows (``decode_window`` = K > 1):
``paged_model.paged_decode_window`` takes K device steps and the host
reads the [N, K] token block once per window (``host_syncs`` counts
those reads). There is no jit: PyTorch runs eagerly, and CUDA-graph
capture of the window is later work.

Under ``quant_bits`` 8 or 4 the weights rest quantized
(``inference/quantization.py``) and are dequantized right before use.

The engine runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` and raises when no GPU is present. On the
CPU every attention call takes its kernel's plain version.
"""

import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ...models.transformer import TransformerConfig
from ...utils.bucketing import pow2_bucket
from ...utils.device import resolve_device
from .config_v2 import RaggedInferenceEngineConfig
from .paged_model import (check_servable, init_paged_kv_cache,
                          paged_decode, paged_decode_window,
                          paged_ragged_step)
from .ragged import batch as ragged_batch
from .ragged.blocked_allocator import NULL_BLOCK
from .ragged.ragged_manager import DSStateManager
from .sampling import greedy_tokens

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
        self.kv_cache = init_paged_kv_cache(cfg, sm.num_blocks,
                                            sm.block_size, self.dtype,
                                            self.device,
                                            kv_quant=config.kv_quant)
        # True: the hand-written kernels (CUDA) or their plain versions
        # (CPU tensors); False: the plain versions everywhere
        self.use_kernel = bool(config.use_paged_kernel)
        self.decode_window = max(int(config.decode_window), 1)
        # device->host reads made by the decode loop: one per per-token
        # step, one per fused window
        self.host_syncs = 0
        self.decode_windows = 0      # fused windows run
        self.decode_steps = 0        # device decode steps (K per window)
        self.ragged_steps = 0        # ragged steps run (one per put())

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

    def _decode_batch_greedy(self, uids: List[int],
                             tokens: List[int]) -> Dict[int, int]:
        """One greedy decode step for ``uids`` (the ``decode_window`` = 1
        path): device argmax, one [N] int32 read."""
        sm = self.state_manager
        N, toks, pos, tables = self._assemble_decode_rows(
            uids, tokens, [1] * len(uids))
        active = np.zeros(N, bool)
        active[:len(uids)] = True
        logits = paged_decode(
            self.model.cfg, self.params, self._i32(toks), self._i32(pos),
            self._i32(tables), self.kv_cache,
            torch.as_tensor(active).to(self.device), self.block_size,
            use_kernel=self.use_kernel)
        nxt = greedy_tokens(logits).cpu().numpy()
        self.host_syncs += 1
        self.decode_steps += 1
        out = {}
        for i, uid in enumerate(uids):
            seq = sm.seqs[uid]
            seq.seen_tokens += 1
            if sm.config.enable_prefix_caching:
                seq.token_log.append(int(tokens[i]))
            out[uid] = int(nxt[i])
        return out

    def _decode_window_greedy(self, uids: List[int], tokens: List[int],
                              steps_left: List[int],
                              eos_ids: List[int]) -> Dict[int, List[int]]:
        """Run one fused greedy window and fold the [N, K] result back into
        host state. Returns {uid: emitted tokens} (1..steps_left[i] each;
        the row's last emitted token is never fed or cached)."""
        sm = self.state_manager
        # block pre-allocation contract: every block row i can write during
        # its steps_left[i] steps is allocated here, so the device loop
        # never needs the host mid-window
        N, toks, pos, tables = self._assemble_decode_rows(
            uids, tokens, steps_left)
        eos = np.full(N, -1, np.int32)
        eos[:len(uids)] = eos_ids
        sl = np.zeros(N, np.int32)
        sl[:len(uids)] = steps_left
        out = paged_decode_window(
            self.model.cfg, self.params, self._i32(toks), self._i32(pos),
            self._i32(tables), self.kv_cache, self._i32(sl), self._i32(eos),
            self.block_size, self.decode_window, use_kernel=self.use_kernel)
        out = out.cpu().numpy()   # ONE transfer for the whole window
        self.host_syncs += 1
        self.decode_windows += 1
        self.decode_steps += self.decode_window
        log_tokens = sm.config.enable_prefix_caching
        emitted: Dict[int, List[int]] = {}
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
        return emitted

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
        rb = ragged_batch.pack(entries, sm)
        i32 = self._i32
        logits = paged_ragged_step(
            self.model.cfg, self.params, i32(rb.ids), i32(rb.row_ids),
            i32(rb.positions), i32(rb.lengths), i32(rb.write_blocks),
            i32(rb.write_offsets), i32(rb.block_tables), i32(rb.last_index),
            self.kv_cache, self.block_size, use_kernel=self.use_kernel,
            touched_blocks=i32(rb.touched_blocks))
        logits = logits[:len(entries)].cpu().numpy()
        self.ragged_steps += 1
        log_tokens = sm.config.enable_prefix_caching
        for uid, toks in entries:
            seq = sm.seqs[uid]
            seq.seen_tokens += len(toks)
            if log_tokens:
                seq.token_log.extend(map(int, toks))
        return logits

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[Iterable[int]]) -> np.ndarray:
        """Reference engine_v2.put: returns [len(batch_uids), vocab] logits
        for the last token of each entry, from one ragged step
        (``ragged_attention`` "auto" and "on" both mean this; the stitched
        "off" dispatch is not ported)."""
        return self.step_ragged(batch_uids, batch_tokens)

    def flush(self, uid: int) -> None:
        """Release a finished sequence's KV blocks (reference flush)."""
        self.state_manager.flush_sequence(uid)

    # convenience: serve-style generation over the ragged engine
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
                 uids: Optional[Sequence[int]] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, seed: int = 0, speculative: bool = False,
                 adapter=None) -> List[np.ndarray]:
        """Greedy generation: the prompts go through put() (one ragged
        step), then fused decode windows (or per-token steps when
        ``decode_window`` is 1) until every row hits ``max_new_tokens`` or
        ``eos_token_id``. Returns prompt + generated tokens per row.
        Sampling (``temperature`` > 0), speculative decoding and LoRA
        adapters are not ported yet and raise."""
        if temperature > 0.0:
            raise NotImplementedError(
                "generate(temperature > 0) needs the device-side sampler "
                "(sampling.fold_in_rows / sample_tokens_rowwise), not "
                "ported yet; the SplitFuse scheduler samples on the host")
        if speculative or adapter is not None:
            raise NotImplementedError(
                "speculative decoding and LoRA adapters are not ported yet")
        uids = list(uids) if uids is not None else list(range(len(prompts)))
        outs: List[List[int]] = [list(map(int, p)) for p in prompts]
        row_of = {uid: i for i, uid in enumerate(uids)}
        t_start = time.perf_counter()
        try:
            logits = self.put(uids, prompts)
            self.last_ttft_s = time.perf_counter() - t_start
            cur = {uid: int(t) for uid, t in
                   zip(uids, np.argmax(logits, axis=-1))}
            live = set(uids)
            prompt_lens = {uid: len(prompts[row_of[uid]]) for uid in uids}
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
    ``dtype``; tensors already there are reused, not copied."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, device, dtype) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device=device, dtype=dtype)

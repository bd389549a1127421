"""Sequence state manager for the ragged engine.

Port of ``deepspeed_tpu/inference/v2/ragged/ragged_manager.py`` (reference
inference/v2/ragged/ragged_manager.py:19, DSStateManager): owns the block
allocator and the per-sequence descriptors, answers schedulability
questions, and materializes the per-step block tables the device program
consumes. The prefix-cache and KV-flow counters and the ``kv_alloc`` /
``kv_free`` flight-recorder events are the JAX package's; its KV spill
tier is not ported (ROADMAP A9).

Prefix caching (``enable_prefix_caching``, off by default): KV depends
only on the causal token prefix, so FULL blocks whose token content
matches a previously-served prefix are shared instead of recomputed.
Blocks are registered into a chain-hash index at flush time (holding
their own reference so they survive the sequence), matched on the next
arrival, and evicted LRU when the pool needs space. Only block-aligned
prefixes share, so shared blocks are never written again — no
copy-on-write is ever needed.
"""

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ....telemetry import recorder as flight
from ..config_v2 import DSStateManagerConfig
from .blocked_allocator import NULL_BLOCK, BlockedAllocator
from .sequence_descriptor import DSSequenceDescriptor

# seed of the chain-hash: every digest chain starts here, so digests are
# a pure function of (token content, block size) — stable across
# processes, engines and replicas (and identical to the JAX package's)
_DIGEST_SEED = b"prefix"


def _chain(digest: bytes, tokens) -> bytes:
    return hashlib.sha1(
        digest + np.asarray(tokens, np.int32).tobytes()).digest()


def _digest_seed(adapter: Optional[str]) -> bytes:
    """Chain seed for a (possibly adapter-scoped) digest walk: the
    adapter NAME is folded into the seed so the same token prefix under
    different adapters never shares blocks. Base-model chains keep the
    bare seed."""
    if not adapter:
        return _DIGEST_SEED
    return hashlib.sha1(
        _DIGEST_SEED + adapter.encode("utf-8")).digest()


def prefix_digest(tokens, block_size: int,
                  adapter: Optional[str] = None) -> List[bytes]:
    """Chain-hash digests of the FULL block-aligned prefixes of
    ``tokens``: digest ``i`` covers ``tokens[:(i + 1) * block_size]``."""
    toks = np.asarray(tokens, np.int64)
    digest = _digest_seed(adapter)
    out: List[bytes] = []
    for n in range(0, (len(toks) // block_size) * block_size, block_size):
        digest = _chain(digest, toks[n:n + block_size])
        out.append(digest)
    return out


class DSStateManager:
    def __init__(self, config: DSStateManagerConfig):
        self.config = config
        self.block_size = config.block_size
        self.allocator = BlockedAllocator(config.num_blocks)
        self.seqs: Dict[int, DSSequenceDescriptor] = {}
        self.max_blocks_per_seq = -(-config.max_seq_len // self.block_size)
        # chain-hash digest -> retained block id (insertion-ordered: LRU
        # eviction pops from the front)
        self._prefix: "OrderedDict[bytes, int]" = OrderedDict()
        from ....telemetry import get_registry
        reg = get_registry()
        self._m_lookups = reg.counter(
            "inference_prefix_lookups_total",
            "prefix-cache matches attempted for new sequences")
        self._m_hits = reg.counter(
            "inference_prefix_hits_total",
            "prefix-cache lookups that reused at least one block")
        self._m_reused_tokens = reg.counter(
            "inference_prefix_reused_tokens_total",
            "prompt tokens served from shared KV blocks")
        self._m_evicted = reg.counter(
            "inference_prefix_evicted_blocks_total",
            "retained prefix blocks LRU-evicted under pool pressure")
        # KV-pool flow accounting (the leak detector's reconciliation
        # inputs, and the flight recorder's kv_alloc/kv_free events):
        # allocated counts fresh blocks handed to sequences; freed counts
        # block REFERENCES returned (a prefix-shared block freed by one
        # owner still lives until its last reference drops)
        self._m_alloc = reg.counter(
            "inference_kv_blocks_allocated_total",
            "KV blocks allocated to sequences")
        self._m_freed = reg.counter(
            "inference_kv_blocks_freed_total",
            "KV block references released (sequence flush + prefix "
            "eviction)")

    # -- prefix caching -----------------------------------------------------
    _chain = staticmethod(_chain)

    def match_prefix(self, uid: int, tokens: np.ndarray,
                     adapter: Optional[str] = None
                     ) -> Tuple[List[int], int]:
        """Longest retained block-aligned prefix of ``tokens`` (capped one
        token short so the model still produces last-token logits),
        scoped to ``adapter``. Registers ``uid`` with the shared blocks;
        returns (blocks, n_reused_tokens) — (…, 0) when nothing
        matches."""
        if not self.config.enable_prefix_caching or uid in self.seqs:
            return [], 0
        self._m_lookups.inc()
        bs = self.block_size
        usable = ((len(tokens) - 1) // bs) * bs
        blocks: List[int] = []
        digest = _digest_seed(adapter)
        n = 0
        # incremental chain: the lookup stops hashing at the first
        # missing digest
        while n + bs <= usable:
            digest = _chain(digest, tokens[n:n + bs])
            blk = self._prefix.get(digest)
            if blk is None:
                break
            blocks.append(blk)
            self._prefix.move_to_end(digest)   # LRU touch
            self.allocator.touch(blk)
            n += bs
        if not n:
            return [], 0
        seq = self.get_or_create_sequence(uid)
        for b in blocks:
            self.allocator.share(b)
        seq.blocks = list(blocks)
        seq.seen_tokens = n
        seq.token_log = list(map(int, tokens[:n]))
        seq.adapter = adapter or None
        self._m_hits.inc()
        self._m_reused_tokens.inc(n)
        return blocks, n

    def _register_prefix(self, seq: DSSequenceDescriptor) -> None:
        """Index the sequence's full blocks at flush so the NEXT arrival
        with the same prefix reuses them (the index holds its own block
        references — retained blocks survive the flush)."""
        bs = self.block_size
        full = min(len(seq.token_log) // bs, len(seq.blocks))
        digests = prefix_digest(seq.token_log[:full * bs], bs,
                                adapter=seq.adapter)
        for i, digest in enumerate(digests):
            if digest not in self._prefix:
                self._prefix[digest] = int(seq.blocks[i])
                self.allocator.share(seq.blocks[i])

    def _evictable(self) -> int:
        """Retained blocks held ONLY by the index (reclaimable now).
        Memoized against the allocator's version stamp."""
        ver = self.allocator.version
        if getattr(self, "_evictable_ver", None) != ver:
            self._evictable_val = sum(
                1 for b in self._prefix.values()
                if self.allocator.refcount(b) == 1)
            self._evictable_ver = ver
        return self._evictable_val

    def _evict_retained(self, need: int, protect=()) -> None:
        """Free LRU index entries whose blocks the index alone holds
        until ``need`` blocks are free. Entries shared with live
        sequences, and ``protect`` blocks, are skipped."""
        protected = set(map(int, protect))
        while self.allocator.free_blocks < need:
            victim = next((d for d, b in self._prefix.items()
                           if self.allocator.refcount(b) == 1
                           and int(b) not in protected), None)
            if victim is None:
                return
            blk = self._prefix.pop(victim)
            self.allocator.free([blk])
            self._m_evicted.inc()
            self._m_freed.inc()

    def reclaimable_blocks(self) -> int:
        """Free blocks plus what eviction could free right now — the
        number schedulability checks should compare against."""
        return self.allocator.free_blocks + self._evictable()

    # -- queries (reference DSStateManager.query / engine can_schedule) ----
    def known_seq(self, uid: int) -> bool:
        return uid in self.seqs

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        if uid not in self.seqs:
            if len(self.seqs) >= self.config.max_tracked_sequences:
                raise RuntimeError(
                    f"tracked-sequence limit "
                    f"{self.config.max_tracked_sequences} reached")
            self.seqs[uid] = DSSequenceDescriptor(uid=uid)
        return self.seqs[uid]

    def can_schedule(self, uid: int, new_tokens: int) -> bool:
        seq = self.seqs.get(uid) or DSSequenceDescriptor(uid=uid)
        if seq.seen_tokens + new_tokens > self.config.max_seq_len:
            return False
        if uid not in self.seqs and \
                len(self.seqs) >= self.config.max_tracked_sequences:
            return False
        return seq.blocks_needed(new_tokens, self.block_size) \
            <= self.allocator.free_blocks + self._evictable()

    # -- allocation ---------------------------------------------------------
    def ensure_blocks(self, uid: int, new_tokens: int) -> DSSequenceDescriptor:
        seq = self.get_or_create_sequence(uid)
        need = seq.blocks_needed(new_tokens, self.block_size)
        if need:
            if need > self.allocator.free_blocks:
                self._evict_retained(need)
            seq.blocks.extend(int(b) for b in self.allocator.allocate(need))
            self._m_alloc.inc(need)
            flight.record("kv_alloc", uid=int(uid), blocks=int(need),
                          free=self.allocator.free_blocks)
        return seq

    def adopt_sequence(self, uid: int, n_blocks: int, seen_tokens: int,
                       token_log) -> DSSequenceDescriptor:
        """Install a sequence whose KV content the caller scatters into
        the returned descriptor's blocks (the KV handoff path): allocate
        ``n_blocks`` fresh blocks and create the descriptor with its
        cache-resident token count and fed-token log."""
        if uid in self.seqs:
            raise ValueError(
                f"cannot adopt uid {uid}: sequence already tracked")
        if seen_tokens > n_blocks * self.block_size:
            raise ValueError(
                f"handoff descriptor inconsistent: {seen_tokens} seen "
                f"tokens do not fit {n_blocks} blocks of "
                f"{self.block_size}")
        if n_blocks > self.allocator.free_blocks:
            self._evict_retained(n_blocks)
        # allocate BEFORE creating the descriptor: an exhausted pool
        # must not leave a blockless tracked sequence behind
        blocks = [int(b) for b in self.allocator.allocate(n_blocks)]
        try:
            seq = self.get_or_create_sequence(uid)
        except Exception:
            self.allocator.free(blocks)
            raise
        seq.blocks = blocks
        seq.seen_tokens = int(seen_tokens)
        if self.config.enable_prefix_caching:
            seq.token_log = list(map(int, token_log))
        self._m_alloc.inc(n_blocks)
        flight.record("kv_alloc", uid=int(uid), blocks=int(n_blocks),
                      free=self.allocator.free_blocks)
        return seq

    def flush_sequence(self, uid: int) -> None:
        """Reference flush: return the sequence's blocks to the pool
        (prefix caching first indexes the full blocks for reuse)."""
        seq = self.seqs.pop(uid, None)
        if seq is not None:
            if self.config.enable_prefix_caching:
                self._register_prefix(seq)
            self.allocator.free(seq.blocks)
            if seq.blocks:
                self._m_freed.inc(len(seq.blocks))
                flight.record("kv_free", uid=int(uid),
                              blocks=len(seq.blocks),
                              free=self.allocator.free_blocks)

    # -- device metadata ----------------------------------------------------
    def block_table_for(self, uid: int) -> np.ndarray:
        """[max_blocks_per_seq] int32 padded with the null block."""
        table = np.full(self.max_blocks_per_seq, NULL_BLOCK, np.int32)
        blocks = self.seqs[uid].blocks
        table[:len(blocks)] = blocks
        return table

    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    def tracked_sequences(self) -> int:
        return len(self.seqs)

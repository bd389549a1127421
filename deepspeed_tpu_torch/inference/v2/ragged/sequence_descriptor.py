"""Per-sequence bookkeeping.

Port of ``deepspeed_tpu/inference/v2/ragged/sequence_descriptor.py``
(reference DSSequenceDescriptor): tracks a sequence's uid, how many tokens
the KV cache has seen, and which cache blocks it owns.
"""

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class DSSequenceDescriptor:
    uid: int
    seen_tokens: int = 0            # tokens whose KV is in the cache
    blocks: List[int] = field(default_factory=list)
    in_flight_tokens: int = 0       # tokens scheduled in the current batch
    # token content in cache order — what prefix caching indexes at flush
    token_log: List[int] = field(default_factory=list)
    # multi-tenant LoRA identity (the adapter bank is not ported yet, so
    # every sequence keeps the base-model values (None, 0))
    adapter: Optional[str] = None
    adapter_slot: int = 0

    def blocks_needed(self, new_tokens: int, block_size: int) -> int:
        total = self.seen_tokens + new_tokens
        have = len(self.blocks)
        need = -(-total // block_size)  # ceil
        return max(0, need - have)

    @property
    def cur_allocated_tokens(self) -> int:
        return len(self.blocks)

"""Sequence / context parallelism over the seq group (port of
``deepspeed_tpu/sequence``): Ulysses all-to-all (``layer.py``) and ring
attention (``ring_attention.py``)."""

from .layer import (DistributedAttention, seq_all_to_all, sharded_attention,
                    ulysses_attention)
from .ring_attention import ring_attention, ring_attention_sharded

__all__ = [
    "DistributedAttention", "seq_all_to_all", "sharded_attention",
    "ulysses_attention", "ring_attention", "ring_attention_sharded",
]

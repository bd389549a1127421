"""Sequence parallelism (Ulysses) and the attention dispatch.

Port of ``deepspeed_tpu/sequence/layer.py`` (``seq_all_to_all`` :28,
``_inner_attention`` :66, ``sharded_attention`` :99,
``ulysses_attention`` :140, ``DistributedAttention`` :148). The routing is
the JAX one: the flash kernels when ``use_flash`` holds and both sequence
lengths are multiples of 128, else :func:`mha_reference`.

The port's tensors are already this rank's shards: the batch rows of its
data index, the heads of its tensor-parallel index and, under sequence
parallelism, its chunk of the sequence. So where JAX wraps the attention
in a ``shard_map``, here only the seq axis does anything: Ulysses
re-partitions ``[B, H, S / sp, D]`` into ``[B, H / sp, S, D]`` with an
all-to-all over the seq group (kv heads repeated up to sp first when
there are fewer), runs the flash kernel on whole sequences and reverses
the all-to-all; ``impl="ring"`` runs :func:`ring_attention` on the chunks.
"""

from typing import Callable, Optional

from ..comm import comm
from ..ops.flash_attention import flash_attention, mha_reference
from .ring_attention import ring_attention

SEQ_AXIS = "seq"


def seq_all_to_all(x, axis_name: str = SEQ_AXIS, scatter_dim: int = 1,
                   gather_dim: int = 2, group=None):
    """The Ulysses primitive (JAX :28): scatter ``scatter_dim`` across the
    seq group and gather ``gather_dim``; differentiable."""
    return comm.seq_all_to_all(x, scatter_dim, gather_dim,
                               axis_name=axis_name, group=group)


def _inner_attention(q, k, v, causal, use_flash, block_q, block_kv, sp_size,
                     impl="ulysses", scale=None, group=None):
    """q / k / v: this rank's [B, H_l, S_l, D] shards."""
    if sp_size > 1 and impl == "ring":
        return ring_attention(q, k, v, causal=causal, scale=scale,
                              q_chunk=block_q, kv_chunk=block_kv,
                              group=group)
    if sp_size > 1:
        if impl != "ulysses":
            raise ValueError(f"seq_parallel_impl must be 'ulysses' or "
                             f"'ring', got {impl!r}")
        nkv = k.shape[1]
        if nkv < sp_size:
            rep = sp_size // nkv
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        q = seq_all_to_all(q, scatter_dim=1, gather_dim=2, group=group)
        k = seq_all_to_all(k, scatter_dim=1, gather_dim=2, group=group)
        v = seq_all_to_all(v, scatter_dim=1, gather_dim=2, group=group)
    s = q.shape[2]
    if use_flash and s % 128 == 0 and k.shape[2] % 128 == 0:
        o = flash_attention(q, k, v, causal=causal, scale=scale,
                            block_q=block_q or None,
                            block_kv=block_kv or None)
    else:
        o = mha_reference(q, k, v, causal=causal, scale=scale)
    if sp_size > 1:
        o = seq_all_to_all(o, scatter_dim=2, gather_dim=1, group=group)
    return o


def sharded_attention(q, k, v, topo: Optional[object] = None,
                      causal: bool = True, use_flash: bool = True,
                      block_q: int = 128, block_kv: int = 128,
                      impl: str = "ulysses", scale=None):
    """Attention over this rank's [B, H, S, D] shards. ``topo`` (a
    ``parallel.topology.MeshTopology``, or None for one device) supplies
    the seq group; ``impl`` the sequence-parallel strategy when its seq
    axis is > 1: ``"ulysses"`` (all-to-all) or ``"ring"``."""
    sp = topo.axis_size(SEQ_AXIS) if topo is not None else 1
    group = topo.group(SEQ_AXIS) if sp > 1 else None
    return _inner_attention(q, k, v, causal, use_flash, block_q, block_kv,
                            sp, impl=impl, scale=scale, group=group)


def ulysses_attention(q, k, v, causal: bool = True, use_flash: bool = True,
                      block_q: int = 128, block_kv: int = 128,
                      topo: Optional[object] = None):
    """Explicit-SP entry (JAX :140)."""
    return sharded_attention(q, k, v, topo, causal=causal,
                             use_flash=use_flash, block_q=block_q,
                             block_kv=block_kv)


class DistributedAttention:
    """Reference-parity wrapper (JAX :148; reference sequence/layer.py:37):
    wraps a local attention callable with the Ulysses scatter / gather
    all-to-alls. ``local_attn`` receives [B, H / sp, S, D] tensors."""

    def __init__(self, local_attn: Callable, sequence_process_group=SEQ_AXIS,
                 scatter_idx: int = 1, gather_idx: int = 2):
        self.local_attn = local_attn
        if isinstance(sequence_process_group, str):
            self.axis, self.group = sequence_process_group, None
        else:
            self.axis, self.group = SEQ_AXIS, sequence_process_group
        self.scatter_idx = scatter_idx
        self.gather_idx = gather_idx

    def _a2a(self, x, scatter, gather):
        return seq_all_to_all(x, self.axis, scatter, gather, group=self.group)

    def __call__(self, query, key, value, *args, **kwargs):
        q = self._a2a(query, self.scatter_idx, self.gather_idx)
        k = self._a2a(key, self.scatter_idx, self.gather_idx)
        v = self._a2a(value, self.scatter_idx, self.gather_idx)
        out = self.local_attn(q, k, v, *args, **kwargs)
        return self._a2a(out, self.gather_idx, self.scatter_idx)

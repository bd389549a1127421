"""The ZeRO-3 parameter gather.

Port of ``make_zero3_gather`` (``deepspeed_tpu/comm/quantized.py:440``) on
its unquantized route, with the leaf-wise gather and reduce-scatter it is
made of (JAX ``reduce_scatter_leaf`` :145). A leaf's ZeRO shard is the
``1 / world`` slice of one dimension, rank-major: rank ``r`` holds indices
``[r * n, (r + 1) * n)`` of it (the JAX package's ``PartitionSpec`` on that
dimension). The quantized routes (ZeRO++ qwZ / qgZ, the int8 all-to-all
and the quantized rings) are ROADMAP A10.
"""

import torch

from . import comm

_UNPORTED = "ROADMAP A10 (ZeRO++ / quantized communication)"


def shard_of(full: torch.Tensor, dim: int, rank: int, world: int) -> torch.Tensor:
    """This rank's slice of ``full`` along ``dim`` (a view)."""
    n = full.shape[dim] // world
    return full.narrow(dim, rank * n, n)


def all_gather_leaf(shard: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``shard`` joined along ``dim``, as a new contiguous
    tensor (one ``all_gather_into_tensor``)."""
    world = comm.get_world_size(group)
    if world == 1:
        dim = 0     # one shard is the whole leaf: no need to move ``dim``
    moved = shard.movedim(dim, 0).contiguous()
    out = torch.empty((world * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=shard.dtype, device=shard.device)
    comm.all_gather_into_tensor(out, moved, group=group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def reduce_scatter_leaf(full: torch.Tensor, dim: int, group=None,
                        mean: bool = True) -> torch.Tensor:
    """The sum (``mean``: the mean) over the group of ``full``, keeping this
    rank's shard along ``dim``, as a new contiguous tensor (one
    ``reduce_scatter_tensor``)."""
    world = comm.get_world_size(group)
    if world == 1:
        dim = 0     # one shard is the whole leaf: no need to move ``dim``
    moved = full.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // world,) + tuple(moved.shape[1:]),
                      dtype=full.dtype, device=full.device)
    comm.reduce_scatter_tensor(out, moved, group=group)
    if mean and world > 1:
        out.div_(world)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


class _Zero3Gather(torch.autograd.Function):
    """Forward: all-gather the shard along ``dim``. Backward: reduce-scatter
    the cotangent back to the shard, as a mean over the group, so the
    shard's gradient is that of the mean loss (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_leaf(shard, dim, group)

    @staticmethod
    def backward(ctx, cot):
        return reduce_scatter_leaf(cot, ctx.dim, ctx.group, mean=True), \
            None, None


def make_zero3_gather(dim: int, group=None, fwd_quantized: bool = False,
                      bwd_quantized: bool = False, block: int = 2048,
                      bits: int = 8):
    """Shard -> full parameter gather with the ZeRO-3 gradient semantics in
    its backward: the reference's fetch-on-use all-gather
    (partitioned_param_coordinator.py:256) forward, and its grad-hook
    reduce-scatter (stage3.py:1135) backward, placed by autograd where the
    hooks would fire. Under activation checkpointing a gather inside the
    checkpointed function runs again in the recompute."""
    if fwd_quantized or bwd_quantized:
        raise NotImplementedError(
            f"quantized ZeRO-3 gathers (zero_quantized_weights / "
            f"zero_quantized_gradients) are not ported to "
            f"deepspeed_tpu_torch yet ({_UNPORTED})")

    def gather(shard: torch.Tensor) -> torch.Tensor:
        return _Zero3Gather.apply(shard, dim, group)

    return gather


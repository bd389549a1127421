"""Error-compensated 1-bit compressed allreduce.

Port of ``deepspeed_tpu/comm/compressed.py`` (the reference's
``NcclBackend.compressed_allreduce``, runtime/comm/nccl.py:51): a buffer
crosses the group as sign bits and one f32 scale per chunk, with a
persistent worker error and server error per rank so the compression
error is fed back next step (the 1-bit Adam algorithm). Two phases:

* reduce-scatter shaped: each rank adds its worker error, cuts the buffer
  in ``world`` chunks, sign-compresses them and routes chunk ``i`` to rank
  ``i`` (one all-to-all); each rank averages what it got into its server
  segment and keeps its new worker error;
* all-gather shaped: each rank sign-compresses its server segment (plus
  its server error) and the segments are all-gathered.

Signs travel packed 8 to a byte in ``jnp.packbits``'s order (the first
element in the most significant bit; ``x >= 0`` is a 1); the scale is the
L1 mean of a chunk. Sums follow what XLA compiles on the CPU, so the
scales are bit-equal to the JAX package's jitted function: a row of more
than 32 elements is zero-padded to a multiple of 32 (the pad split evenly
before and after), summed 32 at a time in order, and again until 32 or
fewer remain (:func:`xla_row_sum`); a mean multiplies by the f32
reciprocal of the count.
"""

import torch

from ..ops.quantizer import f32_reciprocal
from . import comm

_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """x [k, w] -> [k]: ((x0 + x1) + x2) + ... in f32."""
    acc = x[:, 0].clone()
    for j in range(1, x.shape[1]):
        acc.add_(x[:, j])
    return acc


def xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """x [k, m] f32 -> [k]: each row's sum in the order XLA's CPU tree
    reduction adds it (windows of 32 in order, level by level)."""
    while x.shape[1] > 32:
        m = x.shape[1]
        pad = -(-m // 32) * 32 - m
        if pad:
            x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        k, w = x.shape
        x = _seq_sum(x.reshape(k * (w // 32), 32).t().contiguous().t()
                     ).reshape(k, w // 32)
    return _seq_sum(x)


def _sign_compress(x: torch.Tensor):
    """x [k, m] -> (packed signs [k, ceil(m / 8)] uint8, scale [k, 1]):
    the scale is the L1 mean (the value that minimizes the L2 error of
    sign * scale)."""
    k, m = x.shape
    scale = (xla_row_sum(x.abs()) * f32_reciprocal(m).to(x.device))[:, None]
    bits = (x >= 0).to(torch.uint8)
    pad = (-m) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=x.device)
    packed = (bits.view(k, -1, 8) << shifts).sum(dim=2, dtype=torch.uint8)
    return packed, scale


def _sign_decompress(packed: torch.Tensor, scale: torch.Tensor, m: int):
    """(packed [k, nbytes], scale [k, 1]) -> [k, m] f32 of +-scale (JAX's
    ``(2 bit - 1) * scale``, exactly)."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=packed.device)
    bits = ((packed[..., None] >> shifts) & 1).reshape(packed.shape[0], -1)
    return torch.where(bits[:, :m].bool(), scale, -scale)


def compressed_allreduce(buf: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor, group=None):
    """1-bit averaged allreduce of ``buf`` (flat [numel], this rank's
    value) over the group. ``worker_error`` [numel] and ``server_error``
    [numel // n] are this rank's persistent errors. Returns (the averaged
    buffer [numel], the new worker error, the new server error). numel
    must be divisible by 8 * n (n = the group's size)."""
    n = comm.get_world_size(group)
    numel = buf.shape[0]
    seg = numel // n

    # phase 1: compensate, compress, all-to-all, the server average (the
    # new errors are computed in place: one buffer-sized temporary fewer)
    new_worker_error = buf + worker_error
    packed, scale = _sign_compress(new_worker_error.view(n, seg))
    new_worker_error.sub_(_sign_decompress(packed, scale, seg).reshape(-1))
    if n > 1:
        p_in, s_in = packed, scale
        packed, scale = torch.empty_like(p_in), torch.empty_like(s_in)
        comm.all_to_all_single(packed, p_in, group=group, axis_name="data")
        comm.all_to_all_single(scale, s_in, group=group, axis_name="data")
    # [n, seg] -> the mean over the n rows, plus the server error
    server_seg = _seq_sum(_sign_decompress(packed, scale, seg).t())
    server_seg.mul_(f32_reciprocal(n).to(buf.device)).add_(server_error)

    # phase 2: compress the server segment, all-gather
    packed2, scale2 = _sign_compress(server_seg[None, :])
    new_server_error = server_seg.sub_(
        _sign_decompress(packed2, scale2, seg)[0])
    if n > 1:
        packed_g = torch.empty((n,) + tuple(packed2.shape[1:]),
                               dtype=packed2.dtype, device=buf.device)
        scale_g = torch.empty((n, 1), dtype=scale2.dtype, device=buf.device)
        comm.all_gather_into_tensor(packed_g, packed2, group=group)
        comm.all_gather_into_tensor(scale_g, scale2, group=group)
    else:
        packed_g, scale_g = packed2, scale2
    out = _sign_decompress(packed_g, scale_g, seg).reshape(-1)
    return out, new_worker_error, new_server_error


def compressed_allreduce_padded(buf: torch.Tensor, worker_error: torch.Tensor,
                                server_error: torch.Tensor, group=None):
    """:func:`compressed_allreduce` for any numel: ``buf`` is zero-padded
    to the error buffers' size, ``padded_numel(numel, n)``."""
    flat = torch.zeros(worker_error.shape[0], dtype=buf.dtype,
                       device=buf.device)
    flat[:buf.shape[0]] = buf
    out, we, se = compressed_allreduce(flat, worker_error, server_error,
                                       group)
    return out[:buf.shape[0]], we, se


def padded_numel(numel: int, n: int) -> int:
    block = 8 * n
    return ((numel + block - 1) // block) * block

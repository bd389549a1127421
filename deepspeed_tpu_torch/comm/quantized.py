"""Quantized collectives for ZeRO++ (qwZ / qgZ) and the quantized rings.

Port of ``deepspeed_tpu/comm/quantized.py``:

* the ZeRO-3 parameter gather (``make_zero3_gather`` :440) with the
  leaf-wise gather and reduce-scatter it is made of (``reduce_scatter_leaf``
  :145). A leaf's ZeRO shard is the ``1 / world`` slice of one dimension,
  rank-major: rank ``r`` holds indices ``[r * n, (r + 1) * n)`` of it (the
  JAX package's ``PartitionSpec`` on that dimension);
* qwZ, :func:`quantized_all_gather` (:99): int8 blocks of the shard and
  their scales are gathered and dequantized on arrival;
* qgZ, :func:`all_to_all_quant_reduce` (:118): the gradient cut in
  ``world`` chunks, each quantized on its own blocks
  (:func:`_chunked_quantize`), routed by one all-to-all, dequantized and
  averaged: a reduce-scatter with int8 transport;
* the block-quantized ring transport (:func:`ring_reduce_scatter_quant`,
  :func:`ring_all_gather_quant`, :165-281) over an int8 or fp8 e4m3 wire
  (:func:`_quantize_wire`), each returning the quantization error this
  rank introduced (the error-feedback residual), and its two-level form
  (:func:`ring_reduce_scatter_hier`, :func:`ring_all_gather_hier`): exact
  f32 hops within a host, quantized hops between hosts.

The int8 blocks go through ``ops/quantizer.py``, which sends a CUDA tensor
to the hand-written kernels (``csrc/quantizer.cu``) and a CPU tensor to
their plain versions; q and the scales are bit-equal to the JAX package's
jitted functions. The fp8 wire is plain torch, as it is jnp in JAX, and
travels as a ``uint8`` view (gloo has no float8 type). Ring hops are
``comm.permute`` (one ``batch_isend_irecv`` a hop) over the group's ranks.

Under tensor parallelism a JAX ZeRO-3 leaf is quantized whole across its
tensor-parallel cut (the manual program sees the leaf's logical extent on
the auto ``model`` axis). ``tp=(group, dim)`` reproduces that: the qwZ
gather joins the shard over the tensor-parallel group first and keeps this
rank's slice after, and the qgZ reduce joins the cotangent likewise.
"""

from typing import Optional, Tuple

import torch

from ..ops import quantizer_kernels as qk
from ..ops.quantizer import _blocked, f32_reciprocal
from . import comm

# fp8 e4m3 wire format: one byte an element, as int8, but the exponent
# absorbs a block's dynamic range so outliers clip less
FP8_MAX = 448.0  # largest finite float8_e4m3fn


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


def _gather_rows(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """[world, *x.shape]: every rank's ``x``, rank-major."""
    out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    comm.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view((world,) + tuple(x.shape))


# ---------------------------------------------------------------------------
# qwZ / qgZ (JAX :79-142)
# ---------------------------------------------------------------------------
def _chunked_quantize(x: torch.Tensor, n: int, block: int, bits: int):
    """Split x's leading dim into n chunks and quantize each on blocks of
    its own (the JAX ``vmap``): each chunk is zero-padded to whole blocks,
    then one quantize call covers them all. Returns (q [n, nb, block],
    scales [n, nb, 1], chunk_shape)."""
    chunk_shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    flat = x.reshape(n, -1)
    m = flat.shape[1]
    pad = (-m) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    q, scale = qk.quantize_blocks(flat, block, bits)
    nb = (m + pad) // block
    return q.view(n, nb, block), scale.view(n, nb, 1), chunk_shape


def _dequantize_chunks(q, scale, chunk_shape, dtype):
    """(q [n, nb, block], scales [n, nb, 1]) -> [n, *chunk_shape] in
    ``dtype`` (one rounding from f32), each chunk cut to its size."""
    n, nb, block = q.shape
    vals = qk.dequantize_blocks(q.reshape(n * nb, block),
                                scale.reshape(n * nb, 1), dtype)
    numel = 1
    for s in chunk_shape:
        numel *= s
    return vals.view(n, nb * block)[:, :numel].reshape((n,) + tuple(chunk_shape))


def _tp_join(x: torch.Tensor, tp) -> torch.Tensor:
    """The tensor-parallel group's slices of ``x`` joined along its cut."""
    if tp is None:
        return x
    group, dim = tp
    return all_gather_leaf(x, dim, group)


def _tp_slice(x: torch.Tensor, tp) -> torch.Tensor:
    if tp is None:
        return x
    group, dim = tp
    world = comm.get_world_size(group)
    rank = comm.dist.get_rank(group) if world > 1 else 0
    return shard_of(x, dim, rank, world).contiguous()


def quantized_all_gather(shard: torch.Tensor, dim: int, group=None,
                         block: int = 2048, bits: int = 8, dtype=None,
                         tp: Optional[Tuple] = None) -> torch.Tensor:
    """qwZ: gather a parameter sharded on ``dim`` over the group,
    communicating int8 blocks and their f32 scales instead of the values.
    The shard is quantized with ``dim`` moved first, flat (JAX order)."""
    dtype = dtype or shard.dtype
    shard = _tp_join(shard, tp)
    world = comm.get_world_size(group)
    moved = shard.movedim(dim, 0)
    q, scale = qk.quantize_blocks(moved, block, bits)
    qg = _gather_rows(q, group, world)          # [n, nb, block]
    sg = _gather_rows(scale, group, world)      # [n, nb, 1]
    full = _dequantize_chunks(qg, sg, tuple(moved.shape), dtype)
    # [n, d_local, ...] -> [n * d_local, ...] -> the original dim order
    full = full.reshape((-1,) + tuple(full.shape[2:]))
    out = full if dim == 0 else full.movedim(0, dim).contiguous()
    return _tp_slice(out, tp)


def all_to_all_quant_reduce(grad: torch.Tensor, dim: int, group=None,
                            block: int = 2048, bits: int = 8,
                            mean: bool = True,
                            tp: Optional[Tuple] = None) -> torch.Tensor:
    """qgZ: reduce-scatter ``grad`` along ``dim`` over the group with int8
    transport. Each rank quantizes its gradient cut in ``world`` chunks,
    one all-to-all routes chunk ``i`` to rank ``i``, and each rank
    dequantizes what it got and averages (or sums) it in f32. Returns this
    rank's partition (``grad.shape`` with ``dim`` divided by the world)."""
    grad = _tp_join(grad, tp)
    n = comm.get_world_size(group)
    moved = grad.movedim(dim, 0)
    q, scale, chunk_shape = _chunked_quantize(moved, n, block, bits)
    if n > 1:
        q_in, s_in = q, scale
        q, scale = torch.empty_like(q_in), torch.empty_like(s_in)
        comm.all_to_all_single(q, q_in, group=group, axis_name="data")
        comm.all_to_all_single(scale, s_in, group=group, axis_name="data")
    # jnp.mean of the dequantized chunks as XLA compiles it: each chunk's
    # dequantize fused into the running sum (a multiply-add, rounded once),
    # then times f32(1 / n)
    numel = 1
    for d in chunk_shape:
        numel *= d
    red = qk.dequantize_blocks(q[0], scale[0], torch.float32, n=numel)
    for i in range(1, n):
        red = _dequant_add(q[i], scale[i], numel, red)
    if mean:
        red = red * f32_reciprocal(n).to(red.device)
    out = red.view(chunk_shape).to(grad.dtype)
    out = out if dim == 0 else out.movedim(0, dim).contiguous()
    return _tp_slice(out, tp)


# ---------------------------------------------------------------------------
# the quantized wire and its rings (JAX :165-281)
# ---------------------------------------------------------------------------
def _quantize_wire(x: torch.Tensor, block: int, mode: str):
    """Flat [M] f32 -> (q [nb, block] int8 | float8_e4m3fn, scales
    [nb, 1] f32). The block clamps to the message size (a 100-element
    bucket ships no 2048-element padded block; :func:`quant_wire_bytes`
    counts the same)."""
    block = max(1, min(int(block), int(x.numel())))
    if mode == "fp8":
        blocks, _ = _blocked(x.float(), block)
        absmax = blocks.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax > 0,
                            absmax * f32_reciprocal(FP8_MAX).to(x.device),
                            torch.ones_like(absmax))
        return (blocks / scale).to(torch.float8_e4m3fn), scale
    return qk.quantize_blocks(x, block, 8)


def _dequantize_wire(q: torch.Tensor, scale: torch.Tensor,
                     numel: int) -> torch.Tensor:
    """(q, scales) -> flat [numel] f32: what the sender and every receiver
    reconstruct, alike."""
    if q.dtype == torch.int8:
        return qk.dequantize_blocks(q, scale, torch.float32, n=numel)
    return (q.float() * scale).reshape(-1)[:numel]


def _wire_f64(q: torch.Tensor, scale: torch.Tensor,
              numel: int) -> torch.Tensor:
    """``q * scale`` in f64, where it is exact (a 1-byte value times an f32
    scale): flat [numel]."""
    return (q.double() * scale.double()).reshape(-1)[:numel]


def _dequant_add(q, scale, numel: int, other: torch.Tensor) -> torch.Tensor:
    """``q * scale + other`` rounded once to f32: XLA's CPU compiler fuses
    the dequantize into the add (a multiply-add), so the exact product
    meets ``other`` before any rounding."""
    return (_wire_f64(q, scale, numel) + other.double()).float()


def _sub_dequant(x: torch.Tensor, q, scale, numel: int) -> torch.Tensor:
    """``x - q * scale`` rounded once to f32 (the fused form, as above):
    the quantization error the sender keeps."""
    return (x.double() - _wire_f64(q, scale, numel)).float()


def _to_wire(q: torch.Tensor) -> torch.Tensor:
    return q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q


def _from_wire(q: torch.Tensor, mode: str) -> torch.Tensor:
    return q.view(torch.float8_e4m3fn) if mode == "fp8" else q


def _hop(payload, perm, group):
    """One ring hop of a (q, scale) payload: every rank's to its ``perm``
    successor, in one ``batch_isend_irecv``."""
    q, scale = payload
    mode = "fp8" if q.dtype == torch.float8_e4m3fn else "int8"
    q2, s2 = comm.permute([_to_wire(q), scale], perm, axis_name="data",
                          group=group)
    return _from_wire(q2, mode), s2


def _ring_perm(world: int):
    return [(i, (i + 1) % world) for i in range(world)]


def _group_rank(group) -> int:
    return comm.dist.get_rank(group) if comm.get_world_size(group) > 1 else 0


def ring_reduce_scatter_quant(buf: torch.Tensor, group, world: int,
                              block: int = 2048, mode: str = "int8"):
    """Quantized-wire ring reduce-scatter of [world, M] row partials.

    The running partial is requantized at each of the ``world - 1`` hops
    and sent to the next rank, which adds its own row. Returns ``(row,
    err)``: this rank's fully-summed row [M] (the last add is never
    quantized) and err [world, M], the quantization error this rank
    introduced in each row it sent, to be fed back next step."""
    if world == 1:
        return buf[0], torch.zeros_like(buf)
    M = buf.shape[1]
    perm = _ring_perm(world)
    idx = _group_rank(group)
    err = torch.zeros_like(buf)
    acc = buf[(idx - 1) % world]
    for s in range(world - 1):
        q, scale = _quantize_wire(acc, block, mode)
        err[(idx - s - 1) % world] = _sub_dequant(acc, q, scale, M)
        q, scale = _hop((q, scale), perm, group)
        acc = _dequant_add(q, scale, M, buf[(idx - s - 2) % world])
    return acc, err


def ring_all_gather_quant(row: torch.Tensor, group, world: int,
                          block: int = 2048, mode: str = "int8"):
    """Quantized-wire ring all-gather of a per-rank [M] row.

    The row is quantized once at its source and the same payload circles
    the ring; every rank, the source too, keeps the dequantized values,
    so the result is the same on every rank. Returns ``(full [world, M],
    err [M])``, err the source's own quantization error."""
    M = row.shape[0]
    if world == 1:
        return row[None], torch.zeros_like(row)
    perm = _ring_perm(world)
    idx = _group_rank(group)
    payload = _quantize_wire(row, block, mode)
    err = _sub_dequant(row, *payload, M)
    out = torch.zeros((world, M), dtype=row.dtype, device=row.device)
    out[idx] = _dequantize_wire(*payload, M)
    for s in range(world - 1):
        payload = _hop(payload, perm, group)
        out[(idx - s - 1) % world] = _dequantize_wire(*payload, M)
    return out, err


def _hier_shape(world: int, groups: int):
    groups = int(groups)
    if groups < 1 or world % groups != 0:
        raise ValueError(
            f"hierarchical ring needs groups to divide world "
            f"(got world={world}, groups={groups})")
    return groups, world // groups


def _intra_perm(G: int, H: int):
    return [(g * H + h, g * H + (h + 1) % H)
            for g in range(G) for h in range(H)]


def _inter_perm(G: int, H: int):
    return [(g * H + h, ((g + 1) % G) * H + h)
            for g in range(G) for h in range(H)]


def ring_reduce_scatter_hier(buf: torch.Tensor, group, world: int,
                             groups: int, block: int = 2048,
                             mode: str = "int8"):
    """Two-level ring reduce-scatter of [world, M] row partials over
    ``groups`` hosts of ``H = world // groups`` ranks (rank ``g * H + h`` is
    member ``h`` of host ``g``). Phase 1 sums each target row within the
    host in f32 (a ring over the members, payload [groups, M]); phase 2
    finishes the sum across hosts on a quantized ring over the ``groups``
    same-member peers. Same contract as the flat ring: ``(row, err)``,
    err nonzero only at the rows this rank quantized (none when
    ``groups == 1``)."""
    G, H = _hier_shape(world, groups)
    if world == 1:
        return buf[0], torch.zeros_like(buf)
    M = buf.shape[1]
    idx = _group_rank(group)
    g, h = idx // H, idx % H
    grouped = buf.reshape(G, H, M)
    acc = grouped[:, (h - 1) % H]
    for s in range(H - 1):
        acc = comm.permute(acc, _intra_perm(G, H), axis_name="data",
                           group=group) + grouped[:, (h - s - 2) % H]
    # acc[gt] = the sum over this host's members of row gt * H + h
    err = torch.zeros_like(buf)
    if G == 1:
        return acc[0], err
    perm = _inter_perm(G, H)
    err_g = torch.zeros((G, M), dtype=buf.dtype, device=buf.device)
    acc2 = acc[(g - 1) % G]
    for s in range(G - 1):
        q, scale = _quantize_wire(acc2, block, mode)
        err_g[(g - s - 1) % G] = _sub_dequant(acc2, q, scale, M)
        q, scale = _hop((q, scale), perm, group)
        acc2 = _dequant_add(q, scale, M, acc[(g - s - 2) % G])
    # this rank's group-row errors back at their global rows gt * H + h
    err[torch.arange(G, device=buf.device) * H + h] = err_g
    return acc2, err


def ring_all_gather_hier(row: torch.Tensor, group, world: int, groups: int,
                         block: int = 2048, mode: str = "int8"):
    """Two-level ring all-gather of a per-rank [M] row: the same-member
    rows gathered across hosts on a quantized ring (each quantized once
    at its source, every rank keeping the dequantized values), then the
    per-member [groups, M] blocks within the host in f32. Returns
    ``(full [world, M], err [M])`` (err zero when ``groups == 1``)."""
    G, H = _hier_shape(world, groups)
    M = row.shape[0]
    if world == 1:
        return row[None], torch.zeros_like(row)
    idx = _group_rank(group)
    g, h = idx // H, idx % H
    if G == 1:
        deq_rows = row[None]
        err = torch.zeros_like(row)
    else:
        perm = _inter_perm(G, H)
        payload = _quantize_wire(row, block, mode)
        err = _sub_dequant(row, *payload, M)
        deq_rows = torch.zeros((G, M), dtype=row.dtype, device=row.device)
        deq_rows[g] = _dequantize_wire(*payload, M)
        for s in range(G - 1):
            payload = _hop(payload, perm, group)
            deq_rows[(g - s - 1) % G] = _dequantize_wire(*payload, M)
    # deq_rows[gt] = the row of rank (gt, h); gather across members in f32
    out = torch.zeros((H, G, M), dtype=row.dtype, device=row.device)
    out[h] = deq_rows
    payload = deq_rows
    for s in range(H - 1):
        payload = comm.permute(payload, _intra_perm(G, H), axis_name="data",
                               group=group)
        out[(h - s - 1) % H] = payload
    # out[ht, gt] = the row of rank (gt, ht) -> [world, M] in rank order
    return out.transpose(0, 1).reshape(world, M), err


def hier_wire_bytes(numel: int, world: int, groups: int,
                    block: int = 2048) -> dict:
    """Wire bytes of one [world, numel]-row reduce-scatter by wire class
    (JAX :405): the flat f32 ring's ``(world - 1) x groups x numel x 4``
    bytes between hosts, against the hierarchy's ``world x (groups - 1)``
    quantized hops there and ``H - 1`` f32 hops of ``groups x numel x 4``
    within each host."""
    G, H = _hier_shape(world, groups)
    inter_fp32_flat = (world - 1) * G * numel * 4
    inter_quant = world * (G - 1) * quant_wire_bytes(numel, block)
    return {
        "inter_bytes_fp32_flat": inter_fp32_flat,
        "inter_bytes_quant": inter_quant,
        "intra_bytes_fp32": world * (H - 1) * G * numel * 4,
        "ratio": (inter_fp32_flat / inter_quant
                  if inter_quant else float("inf")),
    }


def quant_wire_bytes(numel: int, block: int = 2048) -> int:
    """Bytes on the wire for one quantized hop of a [numel] message: one
    byte an element (block-padded) and an f32 scale a block, the block
    clamped to the message size as :func:`_quantize_wire` clamps it."""
    block = max(1, min(int(block), int(numel)))
    nb = -(-int(numel) // block)
    return nb * block + nb * 4


# ---------------------------------------------------------------------------
# the ZeRO-3 gather (JAX :440)
# ---------------------------------------------------------------------------
class _Zero3Gather(torch.autograd.Function):
    """Forward: all-gather the shard along ``dim`` (qwZ: int8-quantized).
    Backward: reduce-scatter the cotangent back to the shard (qgZ: the int8
    all-to-all), as a mean over the group, so the shard's gradient is that
    of the mean loss (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, shard, dim, group, fwd_q, bwd_q, block, bits, tp):
        ctx.args = (dim, group, bwd_q, block, bits, tp)
        if fwd_q:
            return quantized_all_gather(shard, dim, group, block=block,
                                        bits=bits, dtype=shard.dtype, tp=tp)
        return all_gather_leaf(shard, dim, group)

    @staticmethod
    def backward(ctx, cot):
        dim, group, bwd_q, block, bits, tp = ctx.args
        if bwd_q:
            g = all_to_all_quant_reduce(cot, dim, group, block=block,
                                        bits=bits, mean=True, tp=tp)
        else:
            g = reduce_scatter_leaf(cot, dim, group, mean=True)
        return (g,) + (None,) * 7


def make_zero3_gather(dim: int, group=None, fwd_quantized: bool = False,
                      bwd_quantized: bool = False, block: int = 2048,
                      bits: int = 8, tp: Optional[Tuple] = None):
    """Shard -> full parameter gather with the ZeRO-3 gradient semantics in
    its backward: the reference's fetch-on-use all-gather
    (partitioned_param_coordinator.py:256) forward, and its grad-hook
    reduce-scatter (stage3.py:1135) backward, placed by autograd where the
    hooks would fire; ZeRO++ quantizes either side (``fwd_quantized``:
    qwZ, ``bwd_quantized``: qgZ). Under activation checkpointing a gather
    inside the checkpointed function runs again in the recompute.
    ``tp``: ``(group, dim)`` of the leaf's tensor-parallel cut, for the
    quantized sides."""

    def gather(shard: torch.Tensor) -> torch.Tensor:
        return _Zero3Gather.apply(shard, dim, group, fwd_quantized,
                                  bwd_quantized, block, bits, tp)

    return gather

"""Block-sparse flash attention: tables, kernels and their plain versions.

Port of ``deepspeed_tpu/ops/sparse_kernels.py``. The static per-head block
layout is compiled into per-row ACTIVE-block index tables
(:func:`build_tables`, numpy, memoized as in the JAX package):

  kv_idx/kv_valid [H, n_q, Jmax]  -- active kv blocks per q block (fwd, dq)
  q_idx/q_valid   [H, n_kv, Imax] -- active q blocks per kv block (dk/dv)

Padded slots repeat the last valid index with valid = 0 and are skipped.
Row ``b`` of the folded [B*H, S, D] tensors reads head ``b % H`` of the
tables. Inactive blocks are never loaded or multiplied, and the [S, S]
score matrix never exists: the online softmax runs over a q block's
active kv blocks in table order.

Three hand-written Hopper kernels, ``csrc/sparse_attention.cu``, take the
place of the TPU kernels:

* :func:`sparse_fwd` -- ``_fwd_kernel`` (:105): o and the f32 lse;
* :func:`sparse_bwd_dq` -- ``_bwd_dq_kernel`` (:190): dq;
* :func:`sparse_bwd_dkv` -- ``_bwd_dkv_kernel`` (:222): dk and dv.

Routes. The forward, dq and dk/dv on bf16 / fp16 inputs with S a multiple
of 64 run the tensor-core kernels of ``csrc/sparse_hopper.cuh`` (wgmma fed
by TMA) over 64-row tile tables (:func:`build_tile_tables`: per (q tile,
kv tile) step a 16-bit mask of active 16 x 16 sub-blocks, two tiles per
CUDA block, work items heaviest first; the forward walks dq's items),
which the caller passes as ``tiles=`` (:func:`device_tile_tables`). f32
inputs (the tensor cores take f32 only as TF32) and an S that is not a
multiple of 64 run the f32 CUDA-core tile kernels of
``csrc/flash_tiles.cuh`` over the per-block tables.

Each wrapper launches its kernel on CUDA tensors (built at first use by
``ops/op_builder/cuda.py``), with the tables as int32 tensors on the card
(:func:`device_tables` and :func:`device_tile_tables` upload them once per
layout; :func:`sparse_flash_attention` keys both by one serialization of
the layout a call, none for the read-only layouts that
``SparseSelfAttention`` caches), and counts the launch in
``<wrapper>.launches``; on CPU tensors it runs the plain version. There is
no fallback: a build or launch failure, or a shape the kernels do not
take, raises. ``delta = rowsum(do * o)`` stays one f32 torch expression,
as it is jnp in the JAX package (:266).

The plain versions (:func:`sparse_fwd_plain`, :func:`sparse_bwd_dq_plain`,
:func:`sparse_bwd_dkv_plain`) are the same arithmetic over the active
blocks: the same masks, ``NEG_INF``, safe substitutions and casts of ``p``
and ``ds``. They gather each q block's Jmax kv blocks (each kv block's
Imax q blocks) from the tables and walk the blocks in chunks, so that a
full-size call stays within a few GiB. The CPU tests hold them against
the JAX kernels; on the card ``chip_smoke.py`` holds the kernels against
them. Nothing on the card's path calls them.
"""

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .flash_attention import (_check_bwd_extra, _check_tensors, _delta,
                              _device_of, _DTYPE_CODE, _stream)
from .op_builder import cuda as cuda_build

NEG_INF = -1e30
_BLOCKS = (16, 32, 64, 128)     # layout blocks the CUDA kernels take
_HEAD_DIMS = (64, 128)
# f32 elements of the largest temporary of one chunk of the plain versions
_CHUNK_ELEMS = 1 << 26

TILE = 64                       # rows of a tensor-core tile (one wgmma M)
_SUB = 16                       # rows of a sub-block of a tile's mask
_TC_DTYPES = (torch.bfloat16, torch.float16)

_TABLE_CACHE: dict = {}
_DEVICE_TABLES: dict = {}
_TILE_CACHE: dict = {}
_DEVICE_TILES: dict = {}
_FROZEN_KEYS: dict = {}         # id(read-only layout) -> (layout, contents)


def _memo(cache, key, make):
    """cache[key], made by ``make()`` on a miss; a cache past 64 entries is
    emptied first (bounds host and device memory under layout churn)."""
    hit = cache.get(key)
    if hit is None:
        hit = make()
        if len(cache) > 64:
            cache.clear()
        cache[key] = hit
    return hit


def _layout_bytes(layout):
    """The layout's contents as a hashable key: its bool bytes and shape."""
    return np.asarray(layout, bool).tobytes(), np.shape(layout)


def _layout_key(layout, causal):
    """The tables' cache key: the layout's contents and the causal flag.

    A read-only array that owns its data (``SparseSelfAttention.get_layout``
    caches its layouts so) is taken as frozen: its contents are serialized
    once and found again by identity, so a repeated call costs O(1) in the
    layout's size (the bytes object caches its hash). Any other layout is
    serialized on every call, so one that the caller changes in place gets
    the tables of its new contents."""
    if isinstance(layout, np.ndarray) and not layout.flags.writeable \
            and layout.flags.owndata:
        # the entry holds the array, so no other object can take its id
        contents = _memo(_FROZEN_KEYS, id(layout),
                         lambda: (layout, _layout_bytes(layout)))[1]
    else:
        contents = _layout_bytes(layout)
    return (*contents, causal)


def build_tables(layout: np.ndarray, causal: bool
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """layout [H, n, n] (bool) -> (kv_idx, kv_valid, q_idx, q_valid).

    The reference builds the equivalent Triton look-up tables in
    make_lut (ops/sparse_attention/matmul.py). Tables are static per
    (layout, causal) and memoized: eager per-step callers would otherwise
    repeat the O(H * n^2) host scan every forward."""
    return _host_tables(_layout_key(layout, causal), layout, causal)


def _host_tables(key, layout, causal):
    return _memo(_TABLE_CACHE, key, lambda: _build_tables(layout, causal))


def _build_tables(layout: np.ndarray, causal: bool):
    lay = np.asarray(layout, bool)
    H, n_q, n_kv = lay.shape
    if causal:
        lay = lay & np.tril(np.ones((n_q, n_kv), bool))[None]

    def pack(rows):  # list of index-arrays -> padded [len(rows), max]
        width = max((len(r) for r in rows), default=1) or 1
        idx = np.zeros((len(rows), width), np.int32)
        valid = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            if len(r):
                idx[i, :len(r)] = r
                idx[i, len(r):] = r[-1]
                valid[i, :len(r)] = 1
        return idx, valid

    kv_i, kv_v, q_i, q_v = [], [], [], []
    for h in range(H):
        a, b = pack([np.nonzero(lay[h, i])[0] for i in range(n_q)])
        kv_i.append(a), kv_v.append(b)
        a, b = pack([np.nonzero(lay[h, :, j])[0] for j in range(n_kv)])
        q_i.append(a), q_v.append(b)

    def stack(parts):  # pad ragged widths across heads
        width = max(p.shape[1] for p in parts)
        return np.stack([np.pad(p, ((0, 0), (0, width - p.shape[1])))
                         for p in parts])

    return stack(kv_i), stack(kv_v), stack(q_i), stack(q_v)


def device_tables(layout: np.ndarray, causal: bool, device
                  ) -> Tuple[torch.Tensor, ...]:
    """The four :func:`build_tables` arrays as int32 tensors on ``device``,
    uploaded once per (layout, causal, device): an eager per-step call
    would otherwise copy them from pageable host memory every time."""
    return _device_tables(_layout_key(layout, causal), layout, causal,
                          device)


def _device_tables(key, layout, causal, device):
    return _memo(_DEVICE_TABLES, (key, str(torch.device(device))),
                 lambda: tuple(torch.from_numpy(t).to(device) for t in
                               _host_tables(key, layout, causal)))


# ---------------------------------------------------------------------------
# 64-row tile tables of the tensor-core kernels
# ---------------------------------------------------------------------------
class TileTables(NamedTuple):
    """The walk of the tensor-core forward, dq and dk/dv kernels.

    ``*_items`` [n, 5]: one work item per CUDA block (and batch row): head,
    tile0, tile1 (-1: none), start and count of its steps; heaviest (most
    steps) first. dq items (which the forward walks too) pair neighbouring
    q tiles, dk/dv items kv tiles of alike q lists. ``*_steps`` [m, 2]:
    the other tile of each step and the 16-bit sub-block masks of tile0
    and tile1 (``mask0 | mask1 << 16``, as int32); a step is in an item's
    list iff either mask is non-zero.
    ``*_max``: the longest list (the kernels' shared-memory budget).
    ``nheads`` and ``n_tiles`` (S / 64) are the shape they were built
    for, which the wrappers check."""
    dq_items: object
    dq_steps: object
    dq_max: int
    dkv_items: object
    dkv_steps: object
    dkv_max: int
    nheads: int
    n_tiles: int


def tile_masks(layout: np.ndarray, causal: bool, block: int) -> np.ndarray:
    """[H, nt, nt] int64: for q tile t and kv tile u (64 rows each), bit
    4 a + b is set iff q sub-block a and kv sub-block b (16 rows each) of
    the pair hold a visible (q, k) pair: their layout block is active and,
    under the causal flag, the q sub-block is not left of the diagonal
    (a block of 16 or 32 is 1 or 2 x 2 sub-blocks; one of 64 or 128 sets
    all 16 bits of its tile pairs)."""
    lay = np.asarray(layout, bool)
    H, n, _ = lay.shape
    rep = block // _SUB
    sub = np.repeat(np.repeat(lay, rep, axis=1), rep, axis=2)
    if causal:
        sub = sub & np.tril(np.ones(sub.shape[1:], bool))[None]
    nt = n * block // TILE
    weights = (1 << np.arange(16, dtype=np.int64)).reshape(4, 4)
    return np.einsum("htaub,ab->htu",
                     sub.reshape(H, nt, 4, nt, 4).astype(np.int64), weights)


def _work(masks: np.ndarray, pairs: np.ndarray):
    """Items, steps and longest list for tiles paired as ``pairs`` [H, P, 2]
    (tile ids, -1: none) over ``masks`` [H, tiles, other tiles]."""
    H, P, _ = pairs.shape
    heads = np.arange(H)[:, None]
    m0 = masks[heads, pairs[..., 0]]
    m1 = np.where((pairs[..., 1] >= 0)[..., None],
                  masks[heads, np.maximum(pairs[..., 1], 0)], 0)
    both = (m0 | (m1 << 16)).reshape(H * P, -1)
    counts = (both != 0).sum(-1)
    order = np.argsort(-counts, kind="stable")       # heaviest first
    rank, other = np.nonzero(both[order])
    steps = np.stack([other, both[order][rank, other]], -1)
    counts = counts[order]
    starts = np.cumsum(counts) - counts
    h, p = np.divmod(order, P)
    items = np.stack([h, pairs[h, p, 0], pairs[h, p, 1], starts, counts], -1)
    return (items.astype(np.int32),
            steps.astype(np.uint32).view(np.int32).reshape(-1, 2),
            int(counts.max(initial=0)))


def _build_tile_tables(layout, causal, block) -> TileTables:
    if np.shape(layout)[1] * block % TILE or block not in _BLOCKS:
        raise ValueError(f"tile tables need a layout block in {_BLOCKS} and "
                         f"S a multiple of {TILE}; got block {block}, "
                         f"{np.shape(layout)[1]} blocks")
    masks = tile_masks(layout, causal, block)             # [H, t, u]
    H, nt, _ = masks.shape
    # dq: neighbouring q tiles, whose kv lists are alike
    t = np.arange(0, nt, 2)
    pair = np.stack([t, np.where(t + 1 < nt, t + 1, -1)], -1)
    dq = _work(masks, np.broadcast_to(pair, (H, *pair.shape)))
    # dk/dv: kv tiles sorted by the length of their q list, then by its
    # first q tile, paired in that order, so that the long lists of global
    # columns pair with each other and not with a local column's few
    cols = masks.transpose(0, 2, 1)                       # [H, u, t]
    count = (cols != 0).sum(-1)
    first = np.where(count > 0, (cols != 0).argmax(-1), nt)
    order = np.stack([np.lexsort((first[h], -count[h])) for h in range(H)])
    if nt % 2:
        order = np.concatenate([order, np.full((H, 1), -1)], 1)
    dkv = _work(cols, order.reshape(H, -1, 2))
    return TileTables(*dq, *dkv, H, nt)


def build_tile_tables(layout: np.ndarray, causal: bool, block: int
                      ) -> TileTables:
    """The tensor-core kernels' tables for (layout, causal, block), numpy
    int32, memoized like :func:`build_tables`. S = n * block must be a
    multiple of 64."""
    return _host_tile_tables(_layout_key(layout, causal), layout, causal,
                             block)


def _host_tile_tables(key, layout, causal, block):
    return _memo(_TILE_CACHE, (key, block),
                 lambda: _build_tile_tables(layout, causal, block))


def device_tile_tables(layout: np.ndarray, causal: bool, block: int,
                       device) -> TileTables:
    """:func:`build_tile_tables` with the arrays as int32 tensors on
    ``device``, uploaded once per (layout, causal, block, device)."""
    return _device_tile_tables(_layout_key(layout, causal), layout, causal,
                               block, device)


def _device_tile_tables(key, layout, causal, block, device):
    def upload():
        host = _host_tile_tables(key, layout, causal, block)
        return TileTables(*(torch.from_numpy(x).to(device)
                            if isinstance(x, np.ndarray) else x
                            for x in host))

    return _memo(_DEVICE_TILES, (key, block, str(torch.device(device))),
                 upload)


def tensor_core_route(q: torch.Tensor) -> bool:
    """True where the forward, dq and dk/dv run the tensor-core kernels:
    bf16 / fp16 inputs with S a multiple of 64 (the head dims and blocks
    are those of every route)."""
    return q.dtype in _TC_DTYPES and q.shape[-2] % TILE == 0


# ---------------------------------------------------------------------------
# plain versions ([B*H, S, D] layout, as the kernels)
# ---------------------------------------------------------------------------
def _head_rows(table, bh, nheads):
    """[H, n, W] table -> [bh, n, W]: row b reads head b % H."""
    return table[torch.arange(bh, device=table.device) % nheads]


def _positions(ids, block):
    """Block ids [..., W] -> token positions [..., W * block]."""
    r = torch.arange(block, device=ids.device)
    return (ids[..., None] * block + r).flatten(-2)


def _gather(x, rows, ids, block):
    """Blocks ``ids`` [bh, c, W] of each row of x [bh, S, e] -> f32
    [bh, c, W * block, e]."""
    bh, s, e = x.shape
    g = x.view(bh, s // block, block, e)[rows, ids]
    return g.reshape(*ids.shape[:2], -1, e).float()


def _chunk(bh, width, block, d):
    """Blocks per chunk: the largest f32 temporary stays <= _CHUNK_ELEMS."""
    return max(1, _CHUNK_ELEMS // (bh * width * block * max(d, block)))


def _walk_rows(tables, bh, nheads, block, d):
    """Yields (row slice of blocks, their ids [bh, c, W], the visible-token
    mask of their slots [bh, c, 1, W * block]) over the table rows."""
    idx, valid = (_head_rows(t.long(), bh, nheads) for t in tables)
    n, width = idx.shape[1], idx.shape[2]
    c = _chunk(bh, width, block, d)
    for i0 in range(0, n, c):
        sl = slice(i0, min(n, i0 + c))
        ok = valid[:, sl].bool()[..., None].expand(*valid[:, sl].shape,
                                                   block)
        yield sl, idx[:, sl], ok.flatten(-2)[:, :, None, :]


def _rows_pos(sl, block, device):
    """Token positions of blocks sl.start .. sl.stop - 1: [c, block]."""
    ids = torch.arange(sl.start, sl.stop, device=device)
    return ids[:, None] * block + torch.arange(block, device=device)


def _q_block_scores(q, k, v, kv_idx, kv_valid, scale, causal, block,
                    nheads):
    """Per chunk of q blocks: (their slice, the masked f32 scores
    [bh, c, block, Jmax * block] over the gathered kv blocks, those K and
    V blocks in f32 [bh, c, Jmax * block, D])."""
    bh, s, d = q.shape
    rows = torch.arange(bh, device=q.device)[:, None, None]
    qb = q.view(bh, s // block, block, d)
    for sl, ids, ok in _walk_rows((kv_idx, kv_valid), bh, nheads, block, d):
        kg, vg = _gather(k, rows, ids, block), _gather(v, rows, ids, block)
        sc = torch.matmul(qb[:, sl].float(), kg.transpose(-1, -2)) * scale
        if causal:   # top-left: q_pos >= k_pos (Sq == Skv)
            qpos = _rows_pos(sl, block, q.device)[None, :, :, None]
            ok = ok & (qpos >= _positions(ids, block)[:, :, None, :])
        yield sl, torch.where(ok, sc, torch.full_like(sc, NEG_INF)), kg, vg


def sparse_fwd_plain(q, k, v, kv_idx, kv_valid, scale: float, causal: bool,
                     block: int, nheads: int):
    """q/k/v [bh, S, D] -> (o [bh, S, D] in q's dtype, lse [bh, S, 1]
    f32)."""
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s, 1), dtype=torch.float32, device=q.device)
    for sl, sc, _, vg in _q_block_scores(q, k, v, kv_idx, kv_valid, scale,
                                         causal, block, nheads):
        m = sc.amax(dim=-1, keepdim=True)
        m_safe = torch.where(m <= NEG_INF * 0.5, torch.zeros_like(m), m)
        p = torch.exp(sc - m_safe)
        l = p.sum(dim=-1, keepdim=True)
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        acc = torch.matmul(p.to(v.dtype).float(), vg)
        t0, t1 = sl.start * block, sl.stop * block
        o[:, t0:t1] = (acc / l_safe).to(q.dtype).reshape(bh, -1, d)
        lse[:, t0:t1] = torch.where(
            m <= NEG_INF * 0.5, torch.full_like(m, NEG_INF),
            m + torch.log(l_safe)).reshape(bh, -1, 1)
    return o, lse


def _lse_safe(lse):
    return torch.where(lse <= NEG_INF * 0.5, torch.zeros_like(lse), lse)


def sparse_bwd_dq_plain(q, k, v, do, lse, delta, kv_idx, kv_valid,
                        scale: float, causal: bool, block: int, nheads: int):
    """dq [bh, S, D] from do, the forward's lse and delta = rowsum(do*o)."""
    bh, s, d = q.shape
    n = s // block
    dq = torch.empty_like(q)
    dob = do.view(bh, n, block, d)
    lseb, deltab = lse.view(bh, n, block, 1), delta.view(bh, n, block, 1)
    for sl, sc, kg, vg in _q_block_scores(q, k, v, kv_idx, kv_valid, scale,
                                          causal, block, nheads):
        p = torch.exp(sc - _lse_safe(lseb[:, sl]))
        dp = torch.matmul(dob[:, sl].float(), vg.transpose(-1, -2))
        ds = (p * (dp - deltab[:, sl]) * scale).to(k.dtype)
        dq[:, sl.start * block:sl.stop * block] = torch.matmul(
            ds.float(), kg).to(q.dtype).reshape(bh, -1, d)
    return dq


def sparse_bwd_dkv_plain(q, k, v, do, lse, delta, q_idx, q_valid,
                         scale: float, causal: bool, block: int, nheads: int):
    """(dk, dv) [bh, S, D]: each kv block summed over its active q
    blocks."""
    bh, s, d = q.shape
    n = s // block
    rows = torch.arange(bh, device=q.device)[:, None, None]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kb, vb = k.view(bh, n, block, d), v.view(bh, n, block, d)
    for sl, ids, ok in _walk_rows((q_idx, q_valid), bh, nheads, block, d):
        ok = ok.transpose(-1, -2)                        # [bh, c, W*blk, 1]
        qg, dog = _gather(q, rows, ids, block), _gather(do, rows, ids, block)
        lse_g = _gather(lse, rows, ids, block)
        delta_g = _gather(delta, rows, ids, block)
        kc, vc = kb[:, sl].float(), vb[:, sl].float()
        sc = torch.matmul(qg, kc.transpose(-1, -2)) * scale
        if causal:
            kpos = _rows_pos(sl, block, q.device)[None, :, None, :]
            ok = ok & (_positions(ids, block)[:, :, :, None] >= kpos)
        sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
        p = torch.exp(sc - _lse_safe(lse_g))
        t0, t1 = sl.start * block, sl.stop * block
        dv[:, t0:t1] = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                                    dog).to(v.dtype).reshape(bh, -1, d)
        dp = torch.matmul(dog, vc.transpose(-1, -2))
        ds = (p * (dp - delta_g) * scale).to(q.dtype)
        dk[:, t0:t1] = torch.matmul(ds.float().transpose(-1, -2),
                                    qg).to(k.dtype).reshape(bh, -1, d)
    return dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check(name, block, nheads, q, k, v, *others, tables):
    """What the kernels take: one float dtype for q/k/v (and do),
    contiguous tensors on one CUDA device, q/k/v [bh, S, D] with head_dim
    64 or 128, a layout block of 16, 32, 64 or 128 dividing S, bh a
    multiple of the tables' heads, int32 tables [H, S / block, W]."""
    _check_tensors(name, q, k, v, *others, *tables)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q/k/v must be one [bh, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, d = q.shape
    if d not in _HEAD_DIMS or block not in _BLOCKS or s % block \
            or nheads <= 0 or bh % nheads:
        raise ValueError(
            f"{name}: the CUDA kernels take head_dim in {_HEAD_DIMS} and a "
            f"layout block in {_BLOCKS} dividing S; got q {tuple(q.shape)} "
            f"(bh, S, head_dim), block {block}, {nheads} heads")
    for t in tables:
        if t.dtype != torch.int32 or t.dim() != 3 \
                or tuple(t.shape[:2]) != (nheads, s // block):
            raise ValueError(f"{name}: tables must be int32 "
                             f"[{nheads}, {s // block}, W], got {t.dtype} "
                             f"{tuple(t.shape)}")


def sparse_fwd(q, k, v, kv_idx, kv_valid, scale: float, causal: bool,
               block: int, nheads: int, tiles: Optional[TileTables] = None):
    """Forward. q/k/v [bh, S, D] -> (o, lse [bh, S, 1]). On the
    tensor-core route (:func:`tensor_core_route`) the kernel walks the dq
    items and steps of ``tiles`` (:func:`device_tile_tables` of the same
    layout, causal flag and block), elsewhere the per-block tables."""
    if _device_of("sparse_fwd", q) == "cpu":
        return sparse_fwd_plain(q, k, v, kv_idx, kv_valid, scale, causal,
                                block, nheads)
    _check("sparse_fwd", block, nheads, q, k, v, tables=(kv_idx, kv_valid))
    tc = tensor_core_route(q)
    if tc:
        _check_tiles("sparse_fwd", q, nheads, tiles)
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s, 1), dtype=torch.float32, device=q.device)
    lib = cuda_build.load("sparse_attention")
    if tc:
        code = lib.ds_sparse_fwd_hopper(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            tiles.dq_items.data_ptr(), tiles.dq_steps.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, nheads, s, d,
            tiles.dq_items.shape[0], tiles.dq_max, _DTYPE_CODE[q.dtype],
            scale, int(causal), _stream(q))
    else:
        code = lib.ds_sparse_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_idx.data_ptr(),
            kv_valid.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, nheads, s,
            d, block, kv_idx.shape[-1], _DTYPE_CODE[q.dtype], scale,
            int(causal), _stream(q))
    cuda_build.check(code, "sparse_fwd")
    sparse_fwd.launches += 1
    return o, lse


def _check_tiles(name, q, nheads, tiles):
    """The tensor-core route's tables: present, built for these heads and
    this S, int32 on q's device."""
    if tiles is None:
        raise ValueError(
            f"{name}: bf16 / fp16 inputs with S a multiple of {TILE} run the "
            f"tensor-core kernel, which walks the tile tables: pass tiles="
            f"device_tile_tables(layout, causal, block, q.device)")
    if (tiles.nheads, tiles.n_tiles) != (nheads, q.shape[1] // TILE):
        raise ValueError(
            f"{name}: tile tables of {tiles.nheads} heads and "
            f"{tiles.n_tiles} tiles of {TILE} rows for {nheads} heads and S "
            f"{q.shape[1]}")
    for t in tiles:
        if isinstance(t, torch.Tensor) and (
                t.dtype != torch.int32 or t.device != q.device
                or t.dim() != 2 or not t.is_contiguous()):
            raise ValueError(f"{name}: tile tables must be contiguous 2-D "
                             f"int32 tensors on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def sparse_bwd_dq(q, k, v, do, lse, delta, kv_idx, kv_valid, scale: float,
                  causal: bool, block: int, nheads: int,
                  tiles: Optional[TileTables] = None):
    """dq [bh, S, D] from do, the forward's lse and delta = rowsum(do*o).
    On the tensor-core route (:func:`tensor_core_route`) the kernel walks
    ``tiles`` (:func:`device_tile_tables` of the same layout, causal flag
    and block), elsewhere the per-block tables."""
    if _device_of("sparse_bwd_dq", q) == "cpu":
        return sparse_bwd_dq_plain(q, k, v, do, lse, delta, kv_idx,
                                   kv_valid, scale, causal, block, nheads)
    _check("sparse_bwd_dq", block, nheads, q, k, v, do, lse, delta,
           tables=(kv_idx, kv_valid))
    _check_bwd_extra("sparse_bwd_dq", q, do, lse, delta)
    bh, s, d = q.shape
    tc = tensor_core_route(q)
    if tc:
        _check_tiles("sparse_bwd_dq", q, nheads, tiles)
    dq = torch.empty_like(q)
    lib = cuda_build.load("sparse_attention")
    if tc:
        code = lib.ds_sparse_bwd_dq_hopper(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), tiles.dq_items.data_ptr(),
            tiles.dq_steps.data_ptr(), dq.data_ptr(), bh, nheads, s, d,
            tiles.dq_items.shape[0], tiles.dq_max, _DTYPE_CODE[q.dtype],
            scale, int(causal), _stream(q))
    else:
        code = lib.ds_sparse_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), kv_idx.data_ptr(),
            kv_valid.data_ptr(), dq.data_ptr(), bh, nheads, s, d, block,
            kv_idx.shape[-1], _DTYPE_CODE[q.dtype], scale, int(causal),
            _stream(q))
    cuda_build.check(code, "sparse_bwd_dq")
    sparse_bwd_dq.launches += 1
    return dq


def sparse_bwd_dkv(q, k, v, do, lse, delta, q_idx, q_valid, scale: float,
                   causal: bool, block: int, nheads: int,
                   tiles: Optional[TileTables] = None):
    """(dk, dv) [bh, S, D]; ``tiles`` as in :func:`sparse_bwd_dq`."""
    if _device_of("sparse_bwd_dkv", q) == "cpu":
        return sparse_bwd_dkv_plain(q, k, v, do, lse, delta, q_idx, q_valid,
                                    scale, causal, block, nheads)
    _check("sparse_bwd_dkv", block, nheads, q, k, v, do, lse, delta,
           tables=(q_idx, q_valid))
    _check_bwd_extra("sparse_bwd_dkv", q, do, lse, delta)
    bh, s, d = q.shape
    tc = tensor_core_route(q)
    if tc:
        _check_tiles("sparse_bwd_dkv", q, nheads, tiles)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = cuda_build.load("sparse_attention")
    if tc:
        code = lib.ds_sparse_bwd_dkv_hopper(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), tiles.dkv_items.data_ptr(),
            tiles.dkv_steps.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
            nheads, s, d, tiles.dkv_items.shape[0], tiles.dkv_max,
            _DTYPE_CODE[q.dtype], scale, int(causal), _stream(q))
    else:
        code = lib.ds_sparse_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), q_idx.data_ptr(),
            q_valid.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, nheads, s,
            d, block, q_idx.shape[-1], _DTYPE_CODE[q.dtype], scale,
            int(causal), _stream(q))
    cuda_build.check(code, "sparse_bwd_dkv")
    sparse_bwd_dkv.launches += 1
    return dk, dv


sparse_fwd.launches = 0
sparse_bwd_dq.launches = 0
sparse_bwd_dkv.launches = 0


class _SparseCore(torch.autograd.Function):
    """The JAX ``custom_vjp`` (:333-353): forward saves (q, k, v, o, lse)
    and the tables; backward computes delta, then dq and dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, kv_idx, kv_valid, q_idx, q_valid, scale,
                causal, block, nheads, tiles):
        o, lse = sparse_fwd(q, k, v, kv_idx, kv_valid, scale, causal, block,
                            nheads, tiles=tiles)
        ctx.save_for_backward(q, k, v, o, lse, kv_idx, kv_valid, q_idx,
                              q_valid)
        ctx.args = (scale, causal, block, nheads)
        ctx.tiles = tiles
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_idx, kv_valid, q_idx, q_valid = ctx.saved_tensors
        do = do.contiguous()
        delta = _delta(do, o)
        dq = sparse_bwd_dq(q, k, v, do, lse, delta, kv_idx, kv_valid,
                           *ctx.args, tiles=ctx.tiles)
        dk, dv = sparse_bwd_dkv(q, k, v, do, lse, delta, q_idx, q_valid,
                                *ctx.args, tiles=ctx.tiles)
        return (dq, dk, dv, *(None,) * 9)


def sparse_flash_attention(q, k, v, layout: np.ndarray, block: int,
                           causal: bool = False,
                           scale: Optional[float] = None):
    """Block-sparse attention over [B, H, S, D] with a static [H, n, n]
    block layout; only active blocks are computed. A scale of 0 or None
    means 1 / sqrt(D)."""
    B, H, S, D = q.shape
    if S % block:
        raise ValueError(f"seq {S} not divisible by block {block}")
    scale = scale or 1.0 / math.sqrt(D)
    key = _layout_key(layout, causal)       # once a call, for both tables
    tables = _device_tables(key, layout, causal, q.device)
    tiles = (_device_tile_tables(key, layout, causal, block, q.device)
             if q.is_cuda and tensor_core_route(q) and block in _BLOCKS
             else None)
    o = _SparseCore.apply(*(x.reshape(B * H, S, D).contiguous()
                            for x in (q, k, v)),
                          *tables, float(scale), bool(causal), block, H,
                          tiles)
    return o.reshape(B, H, S, D)

"""Ragged paged attention — one launch for mixed batches.

Port of ``deepspeed_tpu/inference/v2/kernels/ragged_attention.py``
(``ragged_attention``, :234). A flat token buffer of prefill chunks,
continuations and decode rows (layout built by ``ragged.batch.pack``):

* ``q`` ``[T, nh, hd]`` — every row's fed tokens, padded to the bucket;
* ``row_ids`` ``[T]`` — token -> batch row (padding points at row 0);
* ``lengths`` ``[T]`` — per-token causal bound (position + 1; 0 = padding);
* ``block_tables`` ``[R, MB]`` — each row's paged block table;
* ``k_scale``/``v_scale`` ``[nb, kvh]`` — for the int8 ``kv_quant`` pool,
  the per-(block, head) f32 scales (dequantized as
  :func:`..paged_attention.gather_pages` does).

Each token attends over its row's pages up to its own bound, so in-chunk
causality and the cached prefix are one page walk; padding tokens output
exact zeros.

* :func:`ragged_attention` — the wrapper: a CUDA tensor launches the
  Hopper kernels (counted once a call in ``ragged_attention.launches``, or
  ``ragged_attention.q8_launches`` for an int8 pool), a CPU tensor takes
  the plain version. :func:`ragged_route` picks the route from shapes and
  dtypes: on ``"tiles"`` (bf16 / fp16, head_dim 64 or 128, a page size
  that is a multiple of 8, both pools) a call is two launches. The tokens
  of runs of two or more tokens (a run: consecutive tokens of one row
  with length > 0) go to the tensor-core query tiles
  (``csrc/ragged_hopper.cuh``), which also write the padding tokens'
  zeros; the single-token runs (decode rows) go to the paged decode
  kernel's split-K walk (``ds_paged_decode_rows``) with the plans of
  :func:`singleton_plans`: the decode plan for the table's R rows, so a
  pure-decode batch equals :func:`..paged_attention.paged_attention` of
  its rows bit for bit and a long decode row is split over blocks. A
  token's rank among the single-token runs, which picks its workspace
  slot, is read on the card from a scan the tile launch makes of the
  buffer. Each kernel
  classifies its tokens on the card from the token and its neighbours:
  the wrapper reads nothing back and does not synchronize. On
  ``"page_walk"`` (f32, other shapes) one launch walks each token's pages
  (``csrc/page_walk.cuh``), which agrees with the paged kernel to f32
  rounding. A build or launch error raises; nothing falls back.
* :func:`ragged_attention_plain` — the plain PyTorch version: gather each
  row's pages once, index them per token, mask, softmax in f32.
* :func:`run_classes`, :func:`ragged_tile_plan` and
  :func:`ragged_tiles_plain` — the tile route's classification, its
  64-token segments and its arithmetic in torch ops, for the tests;
  nothing on the main path calls them.
"""

import torch

from ....ops.flash_attention import _device_of, _stream
from ....ops.op_builder import cuda as cuda_build
from .paged_attention import (H100_SMS, NEG_INF, _DTYPE_CODE, _attend_plain,
                              _chunk_rows, _split_attend_plain, _workspace,
                              check_kernel_args, gather_pages,
                              grow_workspace, page_split_plan)

TILE_ROWS = 64                    # tokens of a query tile (csrc kWin)
_TILE_DTYPES = (torch.bfloat16, torch.float16)
_TILE_HEAD_DIMS = (64, 128)
# blocks of the singleton launch's grid, at most: each takes the (token,
# kv head) pairs b, b + blocks, ... and walks the single-token runs among
# them, so a prefill-heavy buffer does not launch a block per token
SINGLETON_BLOCKS = 8 * H100_SMS
# per device: the single-token walk's workspace under the plan for the
# table's rows, grown as needed
_fine_workspaces = {}


def _scan_buffers(device, T):
    """The tile launch's scan of the buffer (rank int32 [T], the count of
    single-token runs int32 [1]), which the single-token walk, a second
    launch, reads. Fresh for each call: engines serving from two threads
    enqueue on one stream, and another call's tile launch must not
    overwrite them between this call's two launches."""
    return (torch.empty(T, dtype=torch.int32, device=device),
            torch.empty(1, dtype=torch.int32, device=device))


def ragged_attention_plain(q, k_cache, v_cache, row_ids, lengths,
                           block_tables, k_scale=None, v_scale=None):
    """Same signature and result as :func:`ragged_attention`."""
    T, nh, hd = q.shape
    _, bs, kvh, _ = k_cache.shape
    tables = block_tables.long()
    kpages = gather_pages(k_cache, k_scale, tables, q.dtype)
    vpages = gather_pages(v_cache, v_scale, tables, q.dtype)
    rows = row_ids.long()
    outs = []
    step = _chunk_rows(kpages.shape[1], kvh, hd)
    for a in range(0, T, step):
        r = rows[a:a + step]
        outs.append(_attend_plain(q[a:a + step], kpages[r], vpages[r],
                                  lengths[a:a + step]))
    return torch.cat(outs) if outs else torch.empty_like(q)


def ragged_route(q, k_cache) -> str:
    """``"tiles"`` where a CUDA call runs the tensor-core query tiles and
    the split-K walk: bf16 / fp16 q, head_dim 64 or 128, a page size that
    is a multiple of 8 (a pool box of 8..64 slots: the largest power of
    two that divides it), either pool.
    ``"page_walk"`` for every other shape (f32: the tensor cores take f32
    only as TF32)."""
    hd, bs = q.shape[-1], k_cache.shape[1]
    if q.dtype in _TILE_DTYPES and hd in _TILE_HEAD_DIMS and bs % 8 == 0:
        return "tiles"
    return "page_walk"


def singleton_plans(T: int, R: int, kvh: int, MB: int, bs: int):
    """The single-token walk's two plans, ``(chunk_pages, n_split)`` each:
    the plan for N = T rows, which only a single-token run past the R-th
    takes (``ragged.batch.pack`` lays out none), and the plan for the
    table's R rows, which every other takes: the plan
    :func:`..paged_attention.paged_attention` uses for those rows, so a
    pure-decode batch equals it bit for bit."""
    return page_split_plan(T, kvh, MB, bs), page_split_plan(R, kvh, MB, bs)


def singleton_blocks(n_tok: int, kvh: int, n_split: int) -> int:
    """The x of the singleton launch's grid (x, n_split): one block per
    (token, kv head) pair, as a decode call launches, up to
    ``SINGLETON_BLOCKS`` in all."""
    return max(1, min(n_tok * kvh, SINGLETON_BLOCKS // max(n_split, 1)))


def run_classes(row_ids, lengths):
    """The kernels' classification of each buffer token (csrc
    ``ragged_runs.cuh``): ``multi`` [T] — the token's run (consecutive
    tokens of one row with length > 0) has two or more tokens (the query
    tiles); ``single`` [T] — a run of one (the split-K walk). Tokens of
    length <= 0 are neither: the tile kernel writes their zeros."""
    r, pos = row_ids.long(), lengths.long() > 0
    join = pos[1:] & pos[:-1] & (r[1:] == r[:-1])   # token i+1 joins i
    no = torch.zeros(1, dtype=torch.bool, device=row_ids.device)
    multi = torch.cat([no, join]) | torch.cat([join, no])
    return multi, pos & ~multi


def ragged_tile_plan(row_ids, lengths, cap: int):
    """The tile kernel's work: per 64-token window of the buffer, its
    segments — the stretches of one multi-token run inside it — as
    ``(first token, tokens, largest, smallest length)``, lengths capped at
    ``cap`` (the table's width in slots). A list per window."""
    multi, _ = run_classes(row_ids, lengths)
    rows, raw = row_ids.tolist(), lengths.tolist()
    lens, multi = lengths.clamp(0, cap).tolist(), multi.tolist()
    T = len(rows)
    plan = []
    for w0 in range(0, T, TILE_ROWS):
        segs, t = [], w0
        end = min(T, w0 + TILE_ROWS)
        while t < end:
            if not multi[t]:
                t += 1
                continue
            u = t + 1
            while u < end and rows[u] == rows[t] and raw[u] > 0:
                u += 1
            seg = lens[t:u]
            segs.append((t, u - t, max(seg), min(seg)))
            t = u
        plan.append(segs)
    return plan


def ragged_tiles_plain(q, k_cache, v_cache, row_ids, lengths, block_tables,
                       k_scale=None, v_scale=None):
    """The tile route's arithmetic in torch ops, the same signature and
    result as :func:`ragged_attention` (to f32 rounding): each segment of
    :func:`ragged_tile_plan` walks its row's pages (an int8 pool
    dequantized as :func:`..paged_attention.gather_pages` does) in 64-slot
    kv tiles up to its largest length, with the per-row mask ``slot <
    lengths[t]`` and an online softmax in f32. P.V takes p as the tensor
    cores' register operand: rounded once to fp16 for fp16 q (11
    significant bits), and for bf16 q kept to about f32 as the sum of
    three bf16 operands, so as f32 here. The single-token runs take the
    split-K arithmetic with the chunks of :func:`singleton_plans` (the
    plan for the table's R rows for the first R of them in buffer order,
    the plan for T for any later one); padding tokens are zeros."""
    T, nh, hd = q.shape
    _, bs, kvh, _ = k_cache.shape
    MB = block_tables.shape[1]
    group, cap = nh // kvh, MB * bs
    scale = 1.0 / (hd ** 0.5)
    out = torch.zeros_like(q)
    kp = gather_pages(k_cache, k_scale, block_tables.long(), q.dtype)
    vp = gather_pages(v_cache, v_scale, block_tables.long(), q.dtype)
    lens = lengths.long().clamp(0, cap)
    for segs in ragged_tile_plan(row_ids, lengths, cap):
        for t0, n, mx, _ in segs:
            row = int(row_ids[t0])
            qs = q[t0:t0 + n].float().transpose(0, 1)       # [nh, n, hd]
            lr = lens[t0:t0 + n]
            m = torch.full((nh, n, 1), NEG_INF)
            l = torch.zeros((nh, n, 1))
            acc = torch.zeros((nh, n, hd))
            for k0 in range(0, -(-mx // TILE_ROWS) * TILE_ROWS, TILE_ROWS):
                kt = kp[row, k0:k0 + TILE_ROWS].float()      # [64, kvh, hd]
                vt = vp[row, k0:k0 + TILE_ROWS].float()
                kt = kt.repeat_interleave(group, dim=1).transpose(0, 1)
                vt = vt.repeat_interleave(group, dim=1).transpose(0, 1)
                s = qs @ kt.transpose(1, 2) * scale          # [nh, n, 64]
                slot = k0 + torch.arange(kt.shape[1])
                s = torch.where(slot[None, None] < lr[None, :, None], s,
                                torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                ms = torch.where(m_new <= NEG_INF * 0.5,
                                 torch.zeros_like(m_new), m_new)
                corr = torch.exp(m - m_new)
                p = torch.exp(s - ms)
                l = l * corr + p.sum(-1, keepdim=True)
                if q.dtype == torch.float16:
                    p = p.half().float()
                acc = acc * corr + p @ vt
                m = m_new
            o = acc / torch.where(l == 0, torch.ones_like(l), l)
            out[t0:t0 + n] = o.transpose(0, 1).to(q.dtype)
    _, single = run_classes(row_ids, lengths)
    (coarse, _), (fine, _) = singleton_plans(T, block_tables.shape[0], kvh,
                                              MB, bs)
    rank = torch.cumsum(single.long(), 0) - 1
    fine_tok = single & (rank < block_tables.shape[0])
    for sel, chunk_pages in ((single & ~fine_tok, coarse), (fine_tok, fine)):
        idx = sel.nonzero().flatten()
        if idx.numel():
            rows = row_ids.long()[idx]
            out[idx] = _split_attend_plain(q[idx], kp[rows], vp[rows],
                                           lengths[idx], chunk_pages * bs)
    return out


def ragged_attention(q, k_cache, v_cache, row_ids, lengths, block_tables,
                     k_scale=None, v_scale=None):
    """Ragged paged attention. q [T, nh, hd]; k/v_cache [nb, bs, kvh, hd]
    in q's dtype, or int8 with k/v_scale [nb, kvh] f32; row_ids, lengths
    [T] int32; block_tables [R, MB] int32. Returns [T, nh, hd].

    CPU tensors run :func:`ragged_attention_plain`; CUDA tensors launch the
    Hopper kernels of :func:`ragged_route`'s route."""
    if _device_of("ragged_attention", q) == "cpu":
        return ragged_attention_plain(q, k_cache, v_cache, row_ids, lengths,
                                      block_tables, k_scale, v_scale)
    check_kernel_args("ragged_attention", q, k_cache, v_cache,
                      [row_ids, lengths], block_tables, k_scale, v_scale)
    T, nh, hd = q.shape
    nb, bs, kvh, _ = k_cache.shape
    MB = block_tables.shape[1]
    if row_ids.shape != (T,) or lengths.shape != (T,):
        raise ValueError("ragged_attention: row_ids and lengths must be [T]")
    out = torch.empty_like(q)
    pool = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
    scales = () if k_scale is None else (k_scale.data_ptr(),
                                         v_scale.data_ptr())
    common = (_DTYPE_CODE[q.dtype], 1.0 / (hd ** 0.5), _stream(q))
    lib = cuda_build.load("ragged_attention")
    if ragged_route(q, k_cache) == "page_walk":
        fn = (lib.ds_ragged_paged_attention if k_scale is None
              else lib.ds_ragged_paged_attention_q8)
        cuda_build.check(fn(
            *pool, *scales, row_ids.data_ptr(), lengths.data_ptr(),
            block_tables.data_ptr(), out.data_ptr(), T, nh, kvh, hd, bs, MB,
            *common), "ragged_attention")
    else:
        scales = scales or (None, None)     # null for a pool in q's dtype
        rank, scan = _scan_buffers(q.device, T)
        cuda_build.check(lib.ds_ragged_tiles(
            *pool, *scales, row_ids.data_ptr(), lengths.data_ptr(),
            block_tables.data_ptr(), out.data_ptr(), rank.data_ptr(),
            scan.data_ptr(), T, nh, kvh, hd, bs, MB, nb, *common),
            "ragged_attention tiles")
        R = block_tables.shape[0]
        (chunk_pages, n_split), (fine_pages, fine_split) = singleton_plans(
            T, R, kvh, MB, bs)
        # a single-split plan combines nothing: no partials to keep
        ws = _workspace(q.device, T * kvh if n_split > 1 else 0, n_split,
                        nh // kvh, hd)
        ws_f = grow_workspace(_fine_workspaces, q.device,
                              R * kvh if fine_split > 1 else 0, fine_split,
                              nh // kvh, hd)
        walk = cuda_build.load("paged_attention").ds_paged_decode_rows
        cuda_build.check(walk(
            *pool, *scales, block_tables.data_ptr(), lengths.data_ptr(),
            row_ids.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in ws),
            rank.data_ptr(), scan.data_ptr(), *(w.data_ptr() for w in ws_f),
            T, nh, kvh, hd, bs, MB, chunk_pages, n_split, R, fine_pages,
            fine_split, singleton_blocks(T, kvh, max(n_split, fine_split)),
            *common), "ragged_attention singletons")
    if k_scale is None:
        ragged_attention.launches += 1
    else:
        ragged_attention.q8_launches += 1
    return out


ragged_attention.launches = 0
ragged_attention.q8_launches = 0

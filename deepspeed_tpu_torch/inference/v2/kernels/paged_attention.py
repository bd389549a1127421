"""Paged (blocked-KV) decode attention.

Port of ``deepspeed_tpu/inference/v2/kernels/paged_attention.py``
(``paged_attention``, :260). One query token per sequence attends over
its block table's used pages (``ceil(len / bs)``), masks ``pos < length``
and runs the softmax in f32; GQA head ``h`` reads kv head ``h // group``.
For the int8 ``kv_quant`` pool, ``k_scale``/``v_scale`` ``[nb, kvh]`` are
the per-(block, head) f32 scales and each page dequantizes as the TPU
kernels' ``_dequant_tile`` (:51) does: ``q8.float() * scale``, cast to
the io dtype (``q.dtype``), then read as f32.

* :func:`paged_attention` — the wrapper. A CUDA tensor launches the
  hand-written Hopper kernel ``csrc/paged_attention.cu`` (built at first
  use, ``ops/op_builder/cuda.py``) and counts the launch in
  ``paged_attention.launches`` (a pool in q's dtype) or
  ``paged_attention.q8_launches`` (an int8 pool); a CPU tensor takes the
  plain version. There is no fallback: a build or launch failure raises.
* The kernel is a split-K page walk: :func:`page_split_plan` cuts each
  (sequence, kv head)'s table into chunks of whole pages, one block per
  chunk, and the last block of a (sequence, kv head) combines the chunks'
  partials in chunk order inside the same launch. The plan reads shapes
  only, never ``lengths``, so a call reads nothing back from the card.
  The partials and the combine's tickets live in a workspace that
  persists per device (tickets zeroed once, when the workspace is made;
  each combine resets its own), so calls on one device must come from
  one stream at a time, as the serving engine makes them.
* :func:`paged_attention_plain` — the plain PyTorch version of the same
  function (gather the row's pages, dequantize, mask, softmax in f32).
  The CPU tests hold it against the JAX kernel; on the card it is what
  the kernel is compared with, and what ``use_paged_kernel=False``
  selects.
* :func:`paged_decode_split_plain` — the kernel's split-and-combine
  arithmetic in torch ops, for the tests; nothing on the main path calls
  it.
"""

import math

import torch

from ....ops.op_builder import cuda as cuda_build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# plain version: cap on the f32 K (and V) gather per chunk of rows
_PLAIN_CHUNK_BYTES = 256 << 20
# split plans of the decode kernels (this one and ops/decode_attention.py)
TILE = 64                  # slots of a kernel stage, at most (csrc kTile)
H100_SMS = 132             # streaming multiprocessors of an H100 SXM
BLOCKS_PER_2SM = 5         # blocks the dense plan aims at per two SMs
# blocks page_split_plan aims at per two SMs: twice the dense plan's, since
# a decode batch's rows rarely fill their table (the plan cannot see the
# lengths), and the chunks past a row's length launch blocks that return
# at once
PAGE_BLOCKS_PER_2SM = 10


def _attend_plain(q, k, v, lengths):
    """q [n, nh, hd]; k/v [n, ctx, kvh, hd] (each query's gathered
    context); lengths [n]. Masked f32 softmax; a query with length 0
    outputs exact zeros, as the kernel does."""
    n, nh, hd = q.shape
    ctx, kvh = k.shape[1], k.shape[2]
    group = nh // kvh
    scale = 1.0 / (hd ** 0.5)
    q4 = q.float().reshape(n, kvh, group, hd)
    s = torch.einsum("nkgd,nckd->nkgc", q4, k.float()) * scale
    mask = (torch.arange(ctx, device=q.device)[None, :]
            < lengths.to(q.device).long()[:, None])[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("nkgc,nckd->nkgd", p, v.float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(n, nh, hd).to(q.dtype)


def _split_attend_plain(q, k, v, lengths, chunk: int):
    """The split kernels' arithmetic on gathered context: q [n, nh, hd];
    k/v [n, ctx, kvh, hd]; lengths [n] (clamped to ctx). Per chunk of
    ``chunk`` slots a masked f32 softmax state (m, l, acc); chunks that
    start at or past a row's length take no part; the states combined in
    chunk order. Same result as :func:`_attend_plain` up to f32
    rounding."""
    n, nh, hd = q.shape
    ctx, kvh = k.shape[1], k.shape[2]
    group = nh // kvh
    q4 = q.float().reshape(n, kvh, group, hd)
    lens = lengths.to(q.device).long().clamp(0, ctx)
    ms, ls, accs = [], [], []
    for lo in range(0, max(ctx, 1), chunk):
        hi = min(ctx, lo + chunk)
        kc = k[:, lo:hi].float()
        vc = v[:, lo:hi].float()
        s = torch.einsum("nkgd,nckd->nkgc", q4, kc) * (1.0 / hd ** 0.5)
        valid = (lo + torch.arange(hi - lo, device=q.device))[None] \
            < lens[:, None]
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, -math.inf))
        m = s.amax(dim=-1, keepdim=True) if hi > lo else \
            torch.full((n, kvh, group, 1), -math.inf, device=q.device)
        p = torch.exp(s - torch.where(torch.isfinite(m), m,
                                      torch.zeros_like(m)))
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("nkgc,nckd->nkgd", p, vc))
    m_all = torch.stack(ms).amax(dim=0)
    m_all = torch.where(torch.isfinite(m_all), m_all,
                        torch.zeros_like(m_all))
    l = torch.zeros_like(ls[0])
    acc = torch.zeros_like(accs[0])
    for m, lc, ac in zip(ms, ls, accs):     # chunk order
        w = torch.exp(m - m_all)            # a chunk past the length: 0
        l = l + lc * w
        acc = acc + ac * w
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(n, nh, hd).to(q.dtype)


def _chunk_rows(ctx: int, kvh: int, hd: int) -> int:
    return max(1, _PLAIN_CHUNK_BYTES // max(ctx * kvh * hd * 4, 1))


def gather_pages(cache, scales, tables, dtype):
    """Pages of ``tables`` [..., MB] from one layer's pool [nb, bs, kvh,
    hd] as [..., MB * bs, kvh, hd]. An int8 pool dequantizes with its
    per-(block, head) ``scales`` [nb, kvh] into ``dtype``, as
    ``_dequant_tile`` does; ``scales`` None returns the pages as stored."""
    pages = cache[tables]                       # [..., MB, bs, kvh, hd]
    if scales is not None:
        pages = (pages.float() * scales[tables][..., None, :, None]).to(dtype)
    return pages.flatten(-4, -3)


def paged_attention_plain(q, k_cache, v_cache, block_tables, lengths,
                          k_scale=None, v_scale=None):
    """q [N, nh, hd]; k/v_cache [nb, bs, kvh, hd]; block_tables [N, MB];
    lengths [N] (valid tokens incl. the current one); k/v_scale [nb, kvh]
    for an int8 pool. Returns [N, nh, hd] in q's dtype."""
    N, nh, hd = q.shape
    _, bs, kvh, _ = k_cache.shape
    ctx = block_tables.shape[1] * bs
    tables = block_tables.long()
    outs = []
    step = _chunk_rows(ctx, kvh, hd)
    for a in range(0, N, step):
        t = tables[a:a + step]
        k = gather_pages(k_cache, k_scale, t, q.dtype)
        v = gather_pages(v_cache, v_scale, t, q.dtype)
        outs.append(_attend_plain(q[a:a + step], k, v, lengths[a:a + step]))
    return torch.cat(outs) if outs else torch.empty_like(q)


def page_split_plan(N: int, kvh: int, MB: int, bs: int):
    """(chunk_pages, n_split) of the kernel's grid (N * kvh, n_split): the
    fewest whole pages per chunk (in units of at least one 64-slot tile)
    that still give about 5 blocks per SM when every row fills its table.
    Three 16-bit blocks of head_dim 128 fit an SM, so a full table takes
    about two waves, and a batch that fills a third of its tables about
    one, with the chunks of its long rows spread over the card. Reads
    shapes only. ``n_split * chunk_pages >= MB``, and a table of one page
    is one chunk."""
    unit = max(1, -(-TILE // max(bs, 1)))       # pages per unit
    n_units = max(1, -(-MB // unit))
    want = max(1, -(-(PAGE_BLOCKS_PER_2SM * H100_SMS)
                    // (2 * max(1, N * kvh))))
    chunk_pages = -(-n_units // want) * unit
    return chunk_pages, max(1, -(-MB // chunk_pages))


def paged_decode_split_plain(q, k_cache, v_cache, block_tables, lengths,
                             chunk_pages: int, k_scale=None, v_scale=None):
    """The kernel's arithmetic in torch ops: the rows' pages gathered (an
    int8 pool dequantized as :func:`gather_pages` does), then per chunk of
    ``chunk_pages`` pages a masked f32 (m, l, acc), combined in chunk
    order. Same signature as :func:`paged_attention` plus the chunk; same
    result as :func:`paged_attention_plain` up to f32 rounding."""
    bs = k_cache.shape[1]
    tables = block_tables.long()
    k = gather_pages(k_cache, k_scale, tables, q.dtype)
    v = gather_pages(v_cache, v_scale, tables, q.dtype)
    return _split_attend_plain(q, k, v, lengths, chunk_pages * bs)


def grow_workspace(store, device, pairs, n_split, group, hd):
    """A split kernel's partials (f32) and tickets (int32, zero between
    launches) for at least this size, kept in ``store`` per device. A
    workspace is made (tickets zeroed) only when none is large enough."""
    need = (pairs * n_split * 2 * group, pairs * n_split * group * hd, pairs)
    ws = store.get(device)
    if ws is None or any(t.numel() < n for t, n in zip(ws, need)):
        if ws is not None:
            need = tuple(max(n, t.numel()) for t, n in zip(ws, need))
        ws = (torch.empty(need[0], dtype=torch.float32, device=device),
              torch.empty(need[1], dtype=torch.float32, device=device),
              torch.zeros(need[2], dtype=torch.int32, device=device))
        store[device] = ws
    return ws


_workspaces = {}    # device -> (ws_ml, ws_acc, tickets), grown as needed


def _workspace(device, pairs, n_split, group, hd):
    return grow_workspace(_workspaces, device, pairs, n_split, group, hd)


def check_kernel_args(name, q, k_cache, v_cache, int_args, tables,
                      k_scale=None, v_scale=None):
    """What the kernels take: q in one float dtype with a pool of the same
    dtype, or an int8 pool with f32 scales [nb, kvh] for both K and V;
    contiguous tensors on one CUDA device, int32 index tensors, 16-byte
    rows."""
    quant = k_scale is not None or v_scale is not None
    scales = [k_scale, v_scale] if quant else []
    if quant and (k_scale is None or v_scale is None):
        raise ValueError(f"{name}: an int8 pool needs both k_scale and "
                         f"v_scale")
    tensors = [q, k_cache, v_cache, tables, *int_args, *scales]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {q.device}")
    pool_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != pool_dtype \
            or v_cache.dtype != pool_dtype:
        raise TypeError(f"{name}: q must be one of {list(_DTYPE_CODE)} and "
                        f"k/v {'int8' if quant else 'of the same dtype'}, "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if any(s.dtype != torch.float32 for s in scales):
        raise TypeError(f"{name}: k_scale/v_scale must be float32")
    if any(t.dtype != torch.int32 for t in (tables, *int_args)):
        raise TypeError(f"{name}: index tensors must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    nh, hd = q.shape[1], q.shape[2]
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 \
            or k_cache.shape[3] != hd or nh % k_cache.shape[2]:
        raise ValueError(f"{name}: pool {tuple(k_cache.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    nb, _, kvh, _ = k_cache.shape
    if any(tuple(s.shape) != (nb, kvh) for s in scales):
        raise ValueError(f"{name}: scales must be [nb, kvh] = {(nb, kvh)}")
    if any((hd * t.element_size()) % 16 or t.data_ptr() % 16
           for t in (q, k_cache, v_cache)):
        raise ValueError(f"{name}: rows must be 16-byte multiples and "
                         f"16-byte aligned (head_dim {hd}, {q.dtype}, pool "
                         f"{k_cache.dtype})")


def paged_attention(q, k_cache, v_cache, block_tables, lengths,
                    k_scale=None, v_scale=None):
    """Paged decode attention. q [N, nh, hd]; k/v_cache [nb, bs, kvh, hd]
    in q's dtype, or int8 with k/v_scale [nb, kvh] f32; block_tables
    [N, MB] int32; lengths [N] int32. Returns [N, nh, hd].

    CPU tensors run :func:`paged_attention_plain`; CUDA tensors launch the
    Hopper kernel once (grid (N * kvh, n_split) of
    :func:`page_split_plan`)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_cache, v_cache, block_tables,
                                     lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    check_kernel_args("paged_attention", q, k_cache, v_cache, [lengths],
                      block_tables, k_scale, v_scale)
    N, nh, hd = q.shape
    _, bs, kvh, _ = k_cache.shape
    MB = block_tables.shape[1]
    if block_tables.shape[0] != N or lengths.shape != (N,):
        raise ValueError("paged_attention: block_tables [N, MB] and "
                         "lengths [N] must match q's N")
    chunk_pages, n_split = page_split_plan(N, kvh, MB, bs)
    ws_ml, ws_acc, tickets = _workspace(q.device, N * kvh, n_split,
                                        nh // kvh, hd)
    out = torch.empty_like(q)
    lib = cuda_build.load("paged_attention")
    scales = () if k_scale is None else (k_scale.data_ptr(),
                                         v_scale.data_ptr())
    fn = (lib.ds_paged_decode_attention if k_scale is None
          else lib.ds_paged_decode_attention_q8)
    code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales,
              block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
              ws_ml.data_ptr(), ws_acc.data_ptr(), tickets.data_ptr(),
              N, nh, kvh, hd, bs, MB, chunk_pages, n_split,
              _DTYPE_CODE[q.dtype], 1.0 / (hd ** 0.5),
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(code, "paged_attention")
    if k_scale is None:
        paged_attention.launches += 1
    else:
        paged_attention.q8_launches += 1
    return out


paged_attention.launches = 0
paged_attention.q8_launches = 0

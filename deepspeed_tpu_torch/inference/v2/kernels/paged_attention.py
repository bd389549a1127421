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
* :func:`paged_attention_plain` — the plain PyTorch version of the same
  function (gather the row's pages, dequantize, mask, softmax in f32).
  The CPU tests hold it against the JAX kernel; on the card it is what
  the kernel is compared with, and what ``use_paged_kernel=False``
  selects.
"""

import torch

from ....ops.op_builder import cuda as cuda_build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# plain version: cap on the f32 K (and V) gather per chunk of rows
_PLAIN_CHUNK_BYTES = 256 << 20


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
    Hopper kernel (one block per (sequence, kv head))."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_cache, v_cache, block_tables,
                                     lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    check_kernel_args("paged_attention", q, k_cache, v_cache, [lengths],
                      block_tables, k_scale, v_scale)
    N, nh, hd = q.shape
    _, bs, kvh, _ = k_cache.shape
    if block_tables.shape[0] != N or lengths.shape != (N,):
        raise ValueError("paged_attention: block_tables [N, MB] and "
                         "lengths [N] must match q's N")
    out = torch.empty_like(q)
    lib = cuda_build.load("paged_attention")
    scales = () if k_scale is None else (k_scale.data_ptr(),
                                         v_scale.data_ptr())
    fn = (lib.ds_paged_decode_attention if k_scale is None
          else lib.ds_paged_decode_attention_q8)
    code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales,
              block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
              N, nh, kvh, hd, bs, block_tables.shape[1], _DTYPE_CODE[q.dtype],
              1.0 / (hd ** 0.5),
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(code, "paged_attention")
    if k_scale is None:
        paged_attention.launches += 1
    else:
        paged_attention.q8_launches += 1
    return out


paged_attention.launches = 0
paged_attention.q8_launches = 0

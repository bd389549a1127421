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
  Hopper kernel ``csrc/ragged_attention.cu`` (counted in
  ``ragged_attention.launches``, or ``ragged_attention.q8_launches`` for
  an int8 pool), a CPU tensor takes the plain version. Its page walk is
  not the paged decode kernel's split walk, so a pure-decode ragged batch
  agrees with :func:`..paged_attention.paged_attention` to f32 rounding,
  not bit for bit.
* :func:`ragged_attention_plain` — the plain PyTorch version: gather each
  row's pages once, index them per token, mask, softmax in f32.
"""

import torch

from ....ops.op_builder import cuda as cuda_build
from .paged_attention import (_DTYPE_CODE, _attend_plain, _chunk_rows,
                              check_kernel_args, gather_pages)


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


def ragged_attention(q, k_cache, v_cache, row_ids, lengths, block_tables,
                     k_scale=None, v_scale=None):
    """Ragged paged attention. q [T, nh, hd]; k/v_cache [nb, bs, kvh, hd]
    in q's dtype, or int8 with k/v_scale [nb, kvh] f32; row_ids, lengths
    [T] int32; block_tables [R, MB] int32. Returns [T, nh, hd].

    CPU tensors run :func:`ragged_attention_plain`; CUDA tensors launch the
    Hopper kernel (one block per (token, kv head))."""
    if q.device.type == "cpu":
        return ragged_attention_plain(q, k_cache, v_cache, row_ids, lengths,
                                      block_tables, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_attention: unsupported device {q.device}")
    check_kernel_args("ragged_attention", q, k_cache, v_cache,
                      [row_ids, lengths], block_tables, k_scale, v_scale)
    T, nh, hd = q.shape
    _, bs, kvh, _ = k_cache.shape
    if row_ids.shape != (T,) or lengths.shape != (T,):
        raise ValueError("ragged_attention: row_ids and lengths must be [T]")
    out = torch.empty_like(q)
    lib = cuda_build.load("ragged_attention")
    scales = () if k_scale is None else (k_scale.data_ptr(),
                                         v_scale.data_ptr())
    fn = (lib.ds_ragged_paged_attention if k_scale is None
          else lib.ds_ragged_paged_attention_q8)
    code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales,
              row_ids.data_ptr(), lengths.data_ptr(), block_tables.data_ptr(),
              out.data_ptr(), T, nh, kvh, hd, bs, block_tables.shape[1],
              _DTYPE_CODE[q.dtype], 1.0 / (hd ** 0.5),
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(code, "ragged_attention")
    if k_scale is None:
        ragged_attention.launches += 1
    else:
        ragged_attention.q8_launches += 1
    return out


ragged_attention.launches = 0
ragged_attention.q8_launches = 0

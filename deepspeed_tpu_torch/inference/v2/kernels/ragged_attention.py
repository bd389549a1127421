"""Ragged paged attention — one launch for mixed batches.

Port of ``deepspeed_tpu/inference/v2/kernels/ragged_attention.py``
(``ragged_attention``, :234). A flat token buffer of prefill chunks,
continuations and decode rows (layout built by ``ragged.batch.pack``):

* ``q`` ``[T, nh, hd]`` — every row's fed tokens, padded to the bucket;
* ``row_ids`` ``[T]`` — token -> batch row (padding points at row 0);
* ``lengths`` ``[T]`` — per-token causal bound (position + 1; 0 = padding);
* ``block_tables`` ``[R, MB]`` — each row's paged block table.

Each token attends over its row's pages up to its own bound, so in-chunk
causality and the cached prefix are one page walk; padding tokens output
exact zeros.

* :func:`ragged_attention` — the wrapper: a CUDA tensor launches the
  Hopper kernel ``csrc/ragged_attention.cu`` (counted in
  ``ragged_attention.launches``), a CPU tensor takes the plain version.
  The kernel shares the decode kernel's page walk, so a pure-decode
  ragged batch is bit-identical to :func:`..paged_attention.paged_attention`.
* :func:`ragged_attention_plain` — the plain PyTorch version: gather each
  row's pages once, index them per token, mask, softmax in f32.
"""

import torch

from ....ops.op_builder import cuda as cuda_build
from .paged_attention import (_DTYPE_CODE, _attend_plain, _chunk_rows,
                              check_kernel_args)


def ragged_attention_plain(q, k_cache, v_cache, row_ids, lengths,
                           block_tables):
    """Same signature and result as :func:`ragged_attention`."""
    T, nh, hd = q.shape
    _, bs, kvh, _ = k_cache.shape
    R, MB = block_tables.shape
    ctx = MB * bs
    kpages = k_cache[block_tables.long()].reshape(R, ctx, kvh, hd)
    vpages = v_cache[block_tables.long()].reshape(R, ctx, kvh, hd)
    rows = row_ids.long()
    outs = []
    step = _chunk_rows(ctx, kvh, hd)
    for a in range(0, T, step):
        r = rows[a:a + step]
        outs.append(_attend_plain(q[a:a + step], kpages[r], vpages[r],
                                  lengths[a:a + step]))
    return torch.cat(outs) if outs else torch.empty_like(q)


def ragged_attention(q, k_cache, v_cache, row_ids, lengths, block_tables):
    """Ragged paged attention. q [T, nh, hd]; k/v_cache [nb, bs, kvh, hd];
    row_ids, lengths [T] int32; block_tables [R, MB] int32. Returns
    [T, nh, hd].

    CPU tensors run :func:`ragged_attention_plain`; CUDA tensors launch the
    Hopper kernel (one block per (token, kv head))."""
    if q.device.type == "cpu":
        return ragged_attention_plain(q, k_cache, v_cache, row_ids, lengths,
                                      block_tables)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_attention: unsupported device {q.device}")
    check_kernel_args("ragged_attention", q, k_cache, v_cache,
                      [row_ids, lengths], block_tables)
    T, nh, hd = q.shape
    _, bs, kvh, _ = k_cache.shape
    if row_ids.shape != (T,) or lengths.shape != (T,):
        raise ValueError("ragged_attention: row_ids and lengths must be [T]")
    out = torch.empty_like(q)
    lib = cuda_build.load("ragged_attention")
    code = lib.ds_ragged_paged_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        row_ids.data_ptr(), lengths.data_ptr(), block_tables.data_ptr(),
        out.data_ptr(), T, nh, kvh, hd, bs, block_tables.shape[1],
        _DTYPE_CODE[q.dtype], 1.0 / (hd ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(code, "ragged_attention")
    ragged_attention.launches += 1
    return out


ragged_attention.launches = 0

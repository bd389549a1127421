"""Dense-cache decode attention (the v1 engine's decode).

Port of ``deepspeed_tpu/ops/decode_attention.py``
(``dense_decode_attention``, :80). One query token per sequence attends
over its dense cache ``[B, kvh, M, hd]`` up to ``lengths[b]`` (valid cache
tokens including the current one); GQA head ``h`` reads kv head
``h // group`` without repeating the cache; the softmax runs in f32.

* :func:`dense_decode_attention` — the wrapper. A CUDA tensor launches the
  hand-written Hopper kernel ``csrc/dense_decode_attention.cu`` (built at
  first use) and counts the launch in ``dense_decode_attention.launches``;
  a CPU tensor takes the plain version. There is no fallback: a build or
  launch failure raises.
* The kernel is a split-K walk: :func:`split_plan` cuts each (row, kv
  head)'s cache into chunks of whole 64-slot tiles, one block per chunk,
  and the last block of a (row, kv head) combines the chunks' partials in
  chunk order inside the same launch. The partials and the combine's
  tickets live in a workspace that persists per device (tickets zeroed
  once, when the workspace is made; each combine resets its own), so calls
  on one device must come from one stream at a time, as the v1 engine
  makes them.
* :func:`dense_decode_attention_plain` — the plain PyTorch version (masked
  f32 softmax over the whole cache), which the CPU tests hold against the
  JAX kernel and ``chip_smoke.py`` holds the kernel against.
* :func:`dense_decode_split_plain` — the kernel's split-and-combine
  arithmetic in torch ops, for the tests; nothing on the main path calls
  it.
"""

import torch

from ..inference.v2.kernels.paged_attention import (BLOCKS_PER_2SM, H100_SMS,
                                                     TILE, _DTYPE_CODE,
                                                     _attend_plain,
                                                     _split_attend_plain,
                                                     grow_workspace)
from .op_builder import cuda as cuda_build


def dense_decode_attention_plain(q, k_cache, v_cache, lengths):
    """Same signature and result as :func:`dense_decode_attention`; a row
    of length 0 outputs zeros."""
    # [B, kvh, M, hd] -> [B, M, kvh, hd]: the gathered-context layout
    return _attend_plain(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2),
                         lengths)


def split_plan(B: int, kvh: int, M: int):
    """(chunk, n_split) of the kernel's grid (B * kvh, n_split): the
    fewest whole tiles per chunk that still give about 2.5 blocks per SM,
    so small batches fill the card in one wave (three 16-bit blocks of
    head_dim 128 fit an SM). ``n_split * chunk >= M``, and a cache of
    M <= 64 slots is one chunk."""
    n_tiles = max(1, -(-M // TILE))
    want = max(1, -(-(BLOCKS_PER_2SM * H100_SMS) // (2 * max(1, B * kvh))))
    per = -(-n_tiles // want)
    return per * TILE, -(-n_tiles // per)


def dense_decode_split_plain(q, k_cache, v_cache, lengths, chunk: int):
    """The kernel's arithmetic in torch ops: per chunk of ``chunk`` slots
    a masked f32 softmax state (m, l, acc); chunks that start at or past a
    row's length take no part; the states combined in chunk order. Same
    result as :func:`dense_decode_attention_plain` up to f32 rounding."""
    # [B, kvh, M, hd] -> [B, M, kvh, hd]: the gathered-context layout
    return _split_attend_plain(q, k_cache.transpose(1, 2),
                               v_cache.transpose(1, 2), lengths, chunk)


def _check_args(q, k_cache, v_cache, lengths):
    tensors = (q, k_cache, v_cache, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"dense_decode_attention: all tensors must be on "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"dense_decode_attention: q/k/v must share one of "
                        f"{list(_DTYPE_CODE)}, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError("dense_decode_attention: lengths must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dense_decode_attention: every tensor must be "
                         "contiguous")
    B, nh, hd = q.shape
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 \
            or k_cache.shape[0] != B or k_cache.shape[3] != hd \
            or nh % k_cache.shape[1] or lengths.shape != (B,):
        raise ValueError(f"dense_decode_attention: cache "
                         f"{tuple(k_cache.shape)} and lengths "
                         f"{tuple(lengths.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if (hd * q.element_size()) % 16 or any(
            t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError(f"dense_decode_attention: rows must be 16-byte "
                         f"multiples and 16-byte aligned (head_dim {hd}, "
                         f"{q.dtype})")


_workspaces = {}    # device -> (ws_ml, ws_acc, tickets), grown as needed


def _workspace(device, pairs, n_split, group, hd):
    """The kernel's partials and tickets (``grow_workspace``), kept per
    device."""
    return grow_workspace(_workspaces, device, pairs, n_split, group, hd)


def dense_decode_attention(q, k_cache, v_cache, lengths):
    """q [B, nh, hd]; k/v_cache [B, kvh, M, hd] in q's dtype; lengths [B]
    int32. Returns [B, nh, hd].

    CPU tensors run :func:`dense_decode_attention_plain`; CUDA tensors
    launch the Hopper kernel once (grid (B * kvh, n_split) of
    :func:`split_plan`)."""
    if q.device.type == "cpu":
        return dense_decode_attention_plain(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"dense_decode_attention: unsupported device "
                         f"{q.device}")
    _check_args(q, k_cache, v_cache, lengths)
    B, nh, hd = q.shape
    _, kvh, M, _ = k_cache.shape
    chunk, n_split = split_plan(B, kvh, M)
    ws_ml, ws_acc, tickets = _workspace(q.device, B * kvh, n_split,
                                        nh // kvh, hd)
    out = torch.empty_like(q)
    code = cuda_build.load("dense_decode_attention").ds_dense_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws_ml.data_ptr(),
        ws_acc.data_ptr(), tickets.data_ptr(), B, nh, kvh, hd, M, chunk,
        n_split, _DTYPE_CODE[q.dtype], 1.0 / (hd ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(code, "dense_decode_attention")
    dense_decode_attention.launches += 1
    return out


dense_decode_attention.launches = 0

"""Blockwise symmetric quantize / dequantize kernels.

Port of ``deepspeed_tpu/ops/quantizer_kernels.py``. Two hand-written
Hopper kernels, ``csrc/quantizer.cu``, take the place of the two TPU
kernels:

* :func:`quantize_blocks` — ``_quant_kernel`` (:28): per block of
  ``block`` elements the absmax, the scale ``absmax * f32(1 / qrange)``
  (1.0 for an all-zero block), then ``clip(round_half_even(x / scale),
  -qrange, qrange)`` as int8, with one f32 scale per block. The kernel
  reads the source dtype (f32, bf16, fp16) and treats elements past the
  logical end as zeros, so no f32 or padded copy of a weight is made;
* :func:`dequantize_blocks` — ``_dequant_kernel`` (:37): ``f32(q) *
  scale`` with one round-to-nearest-even cast, written in the target dtype,
  optionally only the first ``n`` elements.

Each wrapper launches its kernel on CUDA tensors (built at first use by
``ops/op_builder/cuda.py``) and counts the launch in
``<wrapper>.launches``; on CPU tensors it runs the plain version. There is
no fallback: a build or launch failure raises.

The plain versions (:func:`quantize_blocks_plain`,
:func:`dequantize_blocks_plain`) are the same arithmetic in torch ops; the
CPU tests hold them against the JAX kernels and the jitted JAX quantizer
bit for bit, and ``chip_smoke.py`` holds the kernels against them on the
card. :func:`quantize_symmetric_kernel` and
:func:`dequantize_symmetric_kernel` are the drop-ins for
``ops/quantizer.py`` (the counterparts of ``quantize_symmetric_pallas``
:87 and ``dequantize_symmetric_pallas`` :95).
"""

import math

import torch

from .flash_attention import _device_of, _DTYPE_CODE, _stream
from .op_builder import cuda as cuda_build
from .quantizer import _blocked, f32_reciprocal, qrange_for


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def quantize_blocks_plain(x: torch.Tensor, block: int, bits: int = 8):
    """x (any shape, flattened; the tail block zero-padded) -> (int8
    [nb, block], f32 scales [nb, 1])."""
    qrange = qrange_for(bits)
    blocks, _ = _blocked(x.float(), block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * f32_reciprocal(qrange),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale), -qrange, qrange)
    return q.to(torch.int8), scale


def dequantize_blocks_plain(q: torch.Tensor, scale: torch.Tensor,
                            out_dtype: torch.dtype = torch.float32,
                            n: int = None) -> torch.Tensor:
    """(int8 [nb, block], f32 [nb, 1]) -> [nb, block] in ``out_dtype``, or
    its first ``n`` elements flat."""
    out = (q.float() * scale).to(out_dtype)
    return out if n is None else out.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def quantize_blocks(x: torch.Tensor, block: int, bits: int = 8):
    """Quantize ``x`` (any shape, read flat) in blocks of ``block``
    elements -> (int8 q [nb, block], f32 scales [nb, 1]),
    nb = ceil(numel / block). For ``x`` of shape [nb, block] this is
    ``quantize_blocks_pallas(x, bits)``."""
    if _device_of("quantize_blocks", x) == "cpu":
        return quantize_blocks_plain(x, block, bits)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_blocks: x must be one of "
                        f"{list(_DTYPE_CODE)}, got {x.dtype}")
    if bits not in (4, 8) or block < 1:
        raise ValueError(f"quantize_blocks: bits must be 4 or 8 and block "
                         f">= 1, got bits={bits}, block={block}")
    flat = x.reshape(-1)          # a copy only for a non-contiguous x
    n = flat.numel()
    nb = -(-n // block)
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    s = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    if nb:
        code = cuda_build.load("quantizer").ds_quantize_blocks(
            flat.data_ptr(), q.data_ptr(), s.data_ptr(), n, nb, block,
            _DTYPE_CODE[x.dtype], bits, _stream(x))
        cuda_build.check(code, "quantize_blocks")
        quantize_blocks.launches += 1
    return q, s


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32,
                      n: int = None) -> torch.Tensor:
    """(int8 q [nb, block], f32 scales [nb, 1]) -> values [nb, block] in
    ``out_dtype``; with ``n``, only the first ``n`` elements, flat."""
    if _device_of("dequantize_blocks", q) == "cpu":
        return dequantize_blocks_plain(q, scale, out_dtype, n)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"dequantize_blocks: out_dtype must be one of "
                        f"{list(_DTYPE_CODE)}, got {out_dtype}")
    if q.dim() != 2 or q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"dequantize_blocks: q must be contiguous int8 "
                         f"[nb, block], got {q.dtype} {tuple(q.shape)}")
    nb, block = q.shape
    if (scale.shape != (nb, 1) or scale.dtype != torch.float32
            or not scale.is_contiguous() or scale.device != q.device):
        raise ValueError(f"dequantize_blocks: scale must be contiguous f32 "
                         f"[{nb}, 1] on {q.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    total = nb * block
    if n is not None and not 0 <= n <= total:
        raise ValueError(f"dequantize_blocks: n={n} outside [0, {total}]")
    out = torch.empty((total if n is None else n,), dtype=out_dtype,
                      device=q.device)
    if out.numel():
        code = cuda_build.load("quantizer").ds_dequantize_blocks(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), out.numel(), nb,
            block, _DTYPE_CODE[out_dtype], _stream(q))
        cuda_build.check(code, "dequantize_blocks")
        dequantize_blocks.launches += 1
    return out.reshape(nb, block) if n is None else out


quantize_blocks.launches = 0
dequantize_blocks.launches = 0


# ---------------------------------------------------------------------------
# drop-ins for ops/quantizer.py
# ---------------------------------------------------------------------------
def quantize_symmetric_kernel(x: torch.Tensor, block: int = 2048,
                              bits: int = 8):
    """Drop-in for ``quantizer.quantize_symmetric``: the kernel reads ``x``
    in its own dtype, flat, with the tail block zero-padded."""
    return quantize_blocks(x, block, bits)


def dequantize_symmetric_kernel(q: torch.Tensor, scale: torch.Tensor, shape,
                                dtype: torch.dtype = torch.float32):
    """Drop-in for ``quantizer.dequantize_symmetric``: the kernel writes
    ``dtype`` directly and stops at the logical end (no f32 round trip, no
    copy for the cut)."""
    return dequantize_blocks(q, scale, dtype, n=math.prod(shape)).reshape(
        shape)

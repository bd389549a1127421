"""Blockwise quantization.

Port of ``deepspeed_tpu/ops/quantizer.py``: symmetric and asymmetric
int8/int4 with one fp32 scale per block of ``block`` consecutive elements
(the tensor flattened, the tail block zero-padded), int4 packing two per
byte, and the dequantize-average-requantize reduction. Layouts are the JAX
package's: ``q [nb, block]`` int8 and scales ``[nb, 1]``.

:func:`quantize_symmetric` and :func:`dequantize_symmetric` dispatch on the
tensor's device: a CUDA tensor goes to the hand-written kernels
(``ops/quantizer_kernels.py``), a CPU tensor to their plain versions.
Everything else here is plain torch on either device, as it is jnp in JAX.

Divisions follow what XLA compiles, so that ``q`` and the scales are
bit-equal to the JAX package's jitted functions: a division by a constant
(the scale ``absmax / qrange``, ``(hi - lo) / levels``, the mean's count)
is a multiply by the f32 reciprocal of the constant, while ``x / scale``
stays a true division. Rounding is half to even (``torch.round``, as
``jnp.round``).
"""

import math
from typing import Tuple

import torch

INT8_QRANGE = 127.0
INT4_QRANGE = 7.0


def qrange_for(bits: int) -> float:
    """The symmetric range: 127 for 8 bits, 7 for anything else (as the
    JAX package picks it)."""
    return INT8_QRANGE if bits == 8 else INT4_QRANGE


def f32_reciprocal(c: float) -> torch.Tensor:
    """``1 / c`` rounded to f32: what XLA multiplies by in place of a
    division by the constant ``c``."""
    return torch.tensor(1.0, dtype=torch.float32) / c


def _blocked(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """Flatten to [n_blocks, block], padding the tail with zeros."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block), n


def quantize_symmetric(x: torch.Tensor, block: int = 2048, bits: int = 8):
    """x -> (int8 values [nb, block], fp32 scales [nb, 1]).

    Symmetric per block: scale = absmax / qrange (1.0 for an all-zero
    block), q = clip(round(x / scale), -qrange, qrange)."""
    from .quantizer_kernels import quantize_symmetric_kernel
    return quantize_symmetric_kernel(x, block=block, bits=bits)


def dequantize_symmetric(q: torch.Tensor, scale: torch.Tensor, shape,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``f32(q) * scale``, cut to the logical size and ``shape``, cast once
    to ``dtype``."""
    from .quantizer_kernels import dequantize_symmetric_kernel
    return dequantize_symmetric_kernel(q, scale, shape, dtype=dtype)


def quantize_asymmetric(x: torch.Tensor, block: int = 2048, bits: int = 8):
    """x -> (int8 values, scales, zero-points). q = round((x - zp) / scale),
    recentred into int8 by -128."""
    levels = 255.0 if bits == 8 else 15.0
    blocks, _ = _blocked(x.float(), block)
    lo = blocks.amin(dim=1, keepdim=True)
    hi = blocks.amax(dim=1, keepdim=True)
    scale = torch.where(hi > lo, (hi - lo) * f32_reciprocal(levels),
                        torch.ones_like(hi))
    q = torch.clamp(torch.round((blocks - lo) / scale), 0, levels)
    return (q - 128.0).to(torch.int8), scale, lo


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (one per int8, range [-7, 7]) two per byte:
    [..., block] int8 -> [..., block // 2] int8, the even element in the
    high nibble."""
    hi = q[..., 0::2].to(torch.int32)
    lo = q[..., 1::2].to(torch.int32)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: [..., block // 2] int8 -> [..., block]
    int8. Arithmetic shifts on int32 sign-extend both nibbles."""
    p = packed.to(torch.int32)
    hi = p >> 4
    lo = (p << 28) >> 28
    out = torch.stack([hi, lo], dim=-1).reshape(*p.shape[:-1], -1)
    return out.to(torch.int8)


def dequantize_asymmetric(q, scale, zp, shape, dtype=torch.float32):
    out = ((q.float() + 128.0) * scale + zp).reshape(-1)
    return out[:math.prod(shape)].reshape(shape).to(dtype)


def quantized_reduction(q, scale, n_groups: int, block: int = 2048,
                        bits: int = 8):
    """Dequantize ``n_groups`` interleaved quantized gradients, average
    them and requantize at the same width (the qgZ reduction)."""
    vals = (q.float() * scale).reshape(n_groups, -1, block)
    # jnp.mean compiles to a sum times the f32 reciprocal of the count
    avg = vals.sum(dim=0) * f32_reciprocal(n_groups)
    return quantize_symmetric(avg.reshape(-1), block=block, bits=bits)

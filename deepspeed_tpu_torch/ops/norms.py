"""RMSNorm / LayerNorm.

Port of ``deepspeed_tpu/ops/norms.py``. The plain paths ``rms_norm_ref``
(:53) and ``layer_norm_ref`` (:66) compute in f32 and cast back to the
input dtype; the serving and training paths call them, as the JAX package
does (its ``rms_norm`` defaults to the jnp path).

``rms_norm(use_pallas=True)`` is the entry of the fused RMSNorm kernel,
:func:`rms_norm_kernel`, the counterpart of ``rms_norm_pallas`` (:30,
``_rms_kernel`` :23): the hand-written Hopper kernel ``csrc/rms_norm.cu``
on CUDA tensors (built at first use, launches counted in
``rms_norm_kernel.launches``), ``rms_norm_ref`` on CPU tensors. Like the
Pallas kernel it has no gradient: under grad mode with ``x`` or ``weight``
requiring grad it raises instead of returning a tensor cut off from
autograd.
"""

import torch

from .flash_attention import _device_of, _DTYPE_CODE, _stream
from .op_builder import cuda as cuda_build


def rms_norm_ref(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rms_norm_kernel(x: torch.Tensor, weight: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` [..., h] (leading dims
    flattened) by the fused kernel: ``mean(x^2)`` in f32, then ``x *
    rsqrt(var + eps) * w`` in f32, cast to ``x.dtype``."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise RuntimeError(
            "rms_norm(use_pallas=True) has no gradient (as the JAX "
            "package's Pallas kernel has no VJP); call it under "
            "torch.no_grad() or use rms_norm(use_pallas=False)")
    if _device_of("rms_norm_kernel", x) == "cpu":
        return rms_norm_ref(x, weight, eps)
    h = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or weight.dtype not in _DTYPE_CODE:
        raise TypeError(f"rms_norm_kernel: x and weight must be one of "
                        f"{list(_DTYPE_CODE)}, got {x.dtype}, {weight.dtype}")
    if weight.shape != (h,) or weight.device != x.device:
        raise ValueError(f"rms_norm_kernel: weight must be [{h}] on "
                         f"{x.device}, got {tuple(weight.shape)} on "
                         f"{weight.device}")
    xf = x.reshape(-1, h)         # a copy only for a non-contiguous x
    w = weight.contiguous()
    out = torch.empty_like(xf)
    if xf.shape[0]:
        code = cuda_build.load("rms_norm").ds_rms_norm(
            xf.data_ptr(), w.data_ptr(), out.data_ptr(), xf.shape[0], h,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], float(eps),
            _stream(x))
        cuda_build.check(code, "rms_norm_kernel")
        rms_norm_kernel.launches += 1
    return out.reshape(x.shape)


rms_norm_kernel.launches = 0


def rms_norm(x, weight, eps: float = 1e-6, use_pallas: bool = False):
    """Differentiable plain path by default; ``use_pallas=True`` takes the
    fused kernel (no gradient)."""
    if use_pallas:
        return rms_norm_kernel(x, weight, eps)
    return rms_norm_ref(x, weight, eps)


def layer_norm_ref(x, weight, bias=None, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


layer_norm = layer_norm_ref

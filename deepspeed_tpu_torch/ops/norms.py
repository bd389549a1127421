"""RMSNorm / LayerNorm, plain PyTorch.

Port of the reference paths of ``deepspeed_tpu/ops/norms.py``
(``rms_norm_ref`` :53, ``layer_norm_ref`` :66): f32 math, then a cast back
to the input dtype. The serving path uses these, as the JAX package does
(``rms_norm`` defaults to the jnp path there); the Pallas ``rms_norm_pallas``
kernel is not ported yet.
"""

import torch


def rms_norm_ref(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm_ref(x, weight, bias=None, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


rms_norm = rms_norm_ref
layer_norm = layer_norm_ref

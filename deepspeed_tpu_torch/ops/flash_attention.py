"""Flash attention forward and backward.

Port of ``deepspeed_tpu/ops/flash_attention.py``: the memory-efficient
online-softmax attention (never an [S, S] score matrix in device memory)
with a causal mask aligned bottom-right for Sq != Skv and grouped-query
attention (kv head = q head // group). Hand-written Hopper kernels,
``csrc/flash_attention.cu``, take the place of the three TPU kernels:

* :func:`flash_fwd` — ``_fwd_kernel`` (:63): o and the f32 lse;
* :func:`flash_bwd_dq` — ``_bwd_dq_kernel`` (:155): dq;
* :func:`flash_bwd_dkv` — ``_bwd_dkv_kernel`` (:196): dk and dv, the GQA
  group reduced inside one block.

The dtype picks the kernel. bf16 and fp16 inputs of all three run on the
tensor cores (``csrc/flash_hopper.cuh``: wgmma fed by TMA); f32 inputs run
the f32 CUDA-core tile kernels of ``csrc/flash_tiles.cuh`` (the tensor
cores would take f32 only as TF32). TMA reads from 16-byte-aligned
addresses, so every tensor handed to a kernel must start 16-byte aligned.

Each wrapper launches its kernel on CUDA tensors (built at first use by
``ops/op_builder/cuda.py``) and counts the launch in ``<wrapper>.launches``;
on CPU tensors it runs the plain version. There is no fallback: a build or
launch failure raises. ``delta = rowsum(do * o)`` stays one torch
expression, as it is jnp in the JAX package (:250).

The plain versions (:func:`flash_fwd_plain`, :func:`flash_bwd_dq_plain`,
:func:`flash_bwd_dkv_plain`, :func:`flash_bwd_plain`) are the same
arithmetic in whole-matrix torch ops: the same mask, ``NEG_INF``, safe
substitutions and casts of ``p`` and ``ds`` to the input dtype. The CPU
tests hold them against the JAX kernels; on the card ``chip_smoke.py``
holds the kernels against them. Nothing on the card's main path calls them.

:func:`flash_attention` is the differentiable entry over [B, H, S, D];
:func:`mha_reference` (:363) is the plain attention ``sequence/layer.py``
uses below the flash threshold.
"""

import math
from typing import Optional

import torch

from .op_builder import cuda as cuda_build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (64, 128)      # head dims the kernels are built for
_SEQ_MULTIPLE = 128         # what sequence/layer.py's routing guarantees


def _pick_block(s: int, target: int) -> int:
    """Largest power-of-two-ish divisor of s that is <= target (the JAX
    wrapper's block choice; the CUDA kernels tile by 64 rows whatever it
    says)."""
    b = min(target, s)
    while b > 1 and s % b:
        b //= 2
    return max(b, 1)


# ---------------------------------------------------------------------------
# plain versions ([B*H, S, D] layout, as the kernels)
# ---------------------------------------------------------------------------
def _causal_mask(sq: int, skv: int, device) -> torch.Tensor:
    """[sq, skv] bool: key c visible to query r iff (skv - sq) + r >= c."""
    r = torch.arange(sq, device=device)[:, None]
    c = torch.arange(skv, device=device)[None, :]
    return (skv - sq) + r >= c


def _scores(q, k, scale, causal):
    """Scaled, masked f32 scores [bh, sq, skv]; k [bhk, skv, d] expanded to
    its GQA group."""
    group = q.shape[0] // k.shape[0]
    kf = k.float().repeat_interleave(group, dim=0)
    s = torch.matmul(q.float(), kf.transpose(1, 2)) * scale
    if causal:
        s = torch.where(_causal_mask(q.shape[1], k.shape[1], q.device), s,
                        torch.full_like(s, NEG_INF))
    return s


def _probs(q, k, lse, scale, causal):
    """p = exp(s - lse_safe): fully masked rows (lse == -1e30) give 0."""
    lse_safe = torch.where(lse <= NEG_INF * 0.5, torch.zeros_like(lse), lse)
    return torch.exp(_scores(q, k, scale, causal) - lse_safe)


def _group_sum(x, bhk):
    """[bh, s, d] per-q-head products -> [bhk, s, d] summed over the group."""
    return x.reshape(bhk, -1, *x.shape[1:]).sum(dim=1)


def flash_fwd_plain(q, k, v, scale: float, causal: bool):
    """q [bh, sq, d], k/v [bhk, skv, d] -> (o [bh, sq, d] in q's dtype,
    lse [bh, sq, 1] f32)."""
    group = q.shape[0] // k.shape[0]
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF * 0.5, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    vf = v.float().repeat_interleave(group, dim=0)
    acc = torch.matmul(p.to(q.dtype).float(), vf)
    return (acc / l_safe).to(q.dtype), m + torch.log(l_safe)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale: float, causal: bool):
    group = q.shape[0] // k.shape[0]
    p = _probs(q, k, lse, scale, causal)
    dp = torch.matmul(do.float(),
                      v.float().repeat_interleave(group, dim=0).transpose(1, 2))
    ds = (p * (dp - delta) * scale).to(k.dtype)
    kf = k.float().repeat_interleave(group, dim=0)
    return torch.matmul(ds.float(), kf).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float, causal: bool):
    bhk, group = k.shape[0], q.shape[0] // k.shape[0]
    p = _probs(q, k, lse, scale, causal)
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dp = torch.matmul(do.float(),
                      v.float().repeat_interleave(group, dim=0).transpose(1, 2))
    ds = (p * (dp - delta) * scale).to(q.dtype)
    dk = torch.matmul(ds.float().transpose(1, 2), q.float())
    return (_group_sum(dk, bhk).to(k.dtype), _group_sum(dv, bhk).to(v.dtype))


def _delta(do, o):
    return (do.float() * o.float()).sum(dim=-1, keepdim=True)


def flash_bwd_plain(q, k, v, o, lse, do, scale: float, causal: bool):
    """(dq, dk, dv) of the forward above, for output cotangent ``do``."""
    delta = _delta(do, o)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_tensors(name, q, k, v, *others):
    """One float dtype for q/k/v, contiguous tensors on q's device."""
    tensors = [q, k, v, *others]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share one of "
                        f"{list(_DTYPE_CODE)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")


def _check(name, q, k, v, *others):
    """What the kernels take: one float dtype for q/k/v (and do), contiguous
    tensors on one CUDA device that start 16-byte aligned, head_dim 64 or
    128, sequence lengths that are multiples of 128, q heads a multiple of
    kv heads."""
    _check_tensors(name, q, k, v, *others)
    if any(t.data_ptr() % 16 for t in (q, k, v, *others)):
        raise ValueError(f"{name}: every tensor must start 16-byte aligned "
                         f"(a view at a storage offset may not)")
    bh, sq, d = q.shape
    bhk, skv, dk_ = k.shape
    if v.shape != k.shape or dk_ != d or bh % bhk:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {_HEAD_DIMS}")
    if sq % _SEQ_MULTIPLE or skv % _SEQ_MULTIPLE:
        raise ValueError(f"{name}: sequence lengths ({sq}, {skv}) must be "
                         f"multiples of {_SEQ_MULTIPLE}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _device_of(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type


def flash_fwd(q, k, v, scale: float, causal: bool):
    """Forward. q [bh, sq, d], k/v [bhk, skv, d] -> (o, lse [bh, sq, 1])."""
    if _device_of("flash_fwd", q) == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal)
    _check("flash_fwd", q, k, v)
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    code = cuda_build.load("flash_attention").ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, k.shape[0], sq, k.shape[1], d,
        _DTYPE_CODE[q.dtype], scale, int(causal), _stream(q))
    cuda_build.check(code, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def _check_bwd_extra(name, q, do, lse, delta):
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do must match q")
    for t in (lse, delta):
        if t.shape != (q.shape[0], q.shape[1], 1) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: lse/delta must be contiguous f32 "
                             f"[bh, sq, 1]")


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool):
    """dq [bh, sq, d] from do, the forward's lse and delta = rowsum(do*o)."""
    if _device_of("flash_bwd_dq", q) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)
    _check("flash_bwd_dq", q, k, v, do, lse, delta)
    _check_bwd_extra("flash_bwd_dq", q, do, lse, delta)
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    code = cuda_build.load("flash_attention").ds_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, k.shape[0], sq,
        k.shape[1], d, _DTYPE_CODE[q.dtype], scale, int(causal), _stream(q))
    cuda_build.check(code, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool):
    """(dk, dv) [bhk, skv, d], each summed over its GQA group of q heads."""
    if _device_of("flash_bwd_dkv", q) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    _check("flash_bwd_dkv", q, k, v, do, lse, delta)
    _check_bwd_extra("flash_bwd_dkv", q, do, lse, delta)
    bh, sq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    code = cuda_build.load("flash_attention").ds_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        k.shape[0], sq, k.shape[1], d, _DTYPE_CODE[q.dtype], scale,
        int(causal), _stream(q))
    cuda_build.check(code, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class _FlashCore(torch.autograd.Function):
    """The JAX ``custom_vjp`` (:319-334): forward saves (q, k, v, o, lse);
    backward computes delta, then dq and dk/dv. The forward's result is
    the model's ``attn_out``: a selective checkpoint that keeps that name
    (``save_attn``, ``save_dots_and_attn``) keeps ``(o, lse)`` and its
    recompute launches no kernel."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        from ..runtime.activation_checkpointing.checkpointing import \
            named_output
        o, lse = named_output("attn_out",
                              lambda: flash_fwd(q, k, v, scale, causal))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = _delta(do, o)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.scale,
                               ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None):
    """Flash attention over [batch, num_heads, seq, head_dim] inputs.

    k/v may have fewer heads (GQA); num_heads % num_kv_heads == 0. The
    causal mask is bottom-right aligned. ``block_q`` / ``block_kv`` are the
    JAX wrapper's block hints; they are checked as it checks them and the
    CUDA kernels, which tile by 64 rows, do not read them."""
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    assert h % hk == 0, f"GQA requires h({h}) % hk({hk}) == 0"
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    bq = _pick_block(sq, block_q or 256)
    bk = _pick_block(skv, block_kv or 512)
    assert sq % bq == 0 and skv % bk == 0, \
        f"seq lengths ({sq},{skv}) must be multiples of block sizes ({bq},{bk})"
    # fold batch into the head axis keeping kv-head grouping contiguous
    qf = q.reshape(b * h, sq, d).contiguous()
    kf = k.reshape(b * hk, skv, d).contiguous()
    vf = v.reshape(b * hk, skv, d).contiguous()
    o = _FlashCore.apply(qf, kf, vf, float(scale), bool(causal))
    return o.reshape(b, h, sq, d)


def mha_reference(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Plain attention in torch ops (O(S^2) memory): f32 scores, the same
    bottom-right causal mask, fully masked rows (sq > skv) output zeros."""
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if h != hk:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(sq, skv, q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if causal:
        any_valid = mask.any(dim=-1)[None, None, :, None]
        p = torch.where(any_valid, p, torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)

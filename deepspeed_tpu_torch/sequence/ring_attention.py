"""Ring attention: blockwise context parallelism over the seq group.

Port of ``deepspeed_tpu/sequence/ring_attention.py``. The sequence stays
cut into ``[B, H, S / sp, D]`` chunks, one per rank of the seq group, and
the K/V chunks rotate around the ring (rank i sends to rank i + 1, one
``batch_isend_irecv`` a step) while each rank folds every chunk into its
queries' online softmax, so no rank ever holds the ``[S, S]`` scores or
the whole sequence.

As in JAX (:226-300) the op is an ``autograd.Function``: the forward keeps
only (q, k, v, o, lse), and the backward is a second ring pass that
recomputes each score block from the saved log-sum-exp and rotates the
(k, v, dk, dv) quartet, so dk / dv arrive back at their owner after sp
steps. ``q_chunk`` / ``kv_chunk`` cut the work inside a step into
``[B, H, q_chunk, kv_chunk]`` f32 score blocks. The JAX original is
``jnp`` and reaches no Pallas kernel: this port is plain torch products
with f32 accumulation, the JAX arithmetic term for term. A causal block
that lies wholly above the diagonal is skipped; in JAX it contributes an
exact zero (its probabilities are masked to 0 and its correction is
``exp(0)``), so the skip changes no bit.
"""

import logging
import math
from typing import Optional

import torch

from ..comm import comm

logger = logging.getLogger(__name__)

NEG_INF = -1e30


def _positions(off: int, n: int, device) -> torch.Tensor:
    return off + torch.arange(n, device=device)


def _mask(q_off, sq, k_off, skv, device):
    return (_positions(q_off, sq, device)[:, None]
            >= _positions(k_off, skv, device)[None, :])


def _visible(q_off, qb, k_off, causal) -> bool:
    """False when every key of the block is after every query of it."""
    return not causal or k_off <= q_off + qb - 1


def _chunk_update(q, k, v, o, m, l, q_off, k_off, scale, causal):
    """One online-softmax step against a K/V block (JAX :49); all f32,
    k / v at the query heads. Updates o, m, l in place."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        mask = _mask(q_off, q.shape[2], k_off, k.shape[2], q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    l.mul_(corr).add_(p.sum(dim=-1, keepdim=True))
    o.mul_(corr).add_(torch.matmul(p, v))
    m.copy_(m_new)


def _expand(x, rep):
    return x.repeat_interleave(rep, dim=1) if rep > 1 else x


def _fwd_chunk_pass(q, k_cur, v_cur, o, m, l, q_off, k_off, scale, causal,
                    qb, kb, rep):
    """Fold one ring chunk into (o, m, l), block by block (JAX :81)."""
    s_l = q.shape[2]
    for a in range(0, s_l, qb):
        qs = q[:, :, a:a + qb]
        for c in range(0, k_cur.shape[2], kb):
            if not _visible(q_off + a, qb, k_off + c, causal):
                continue
            _chunk_update(qs, _expand(k_cur[:, :, c:c + kb], rep),
                          _expand(v_cur[:, :, c:c + kb], rep),
                          o[:, :, a:a + qb], m[:, :, a:a + qb],
                          l[:, :, a:a + qb], q_off + a, k_off + c, scale,
                          causal)


def _bwd_block(qs, ks, vs, dos, deltas, lses, q_off, k_off, scale, causal):
    """(dq, dk, dv) of one (q block, kv block) pair, f32, dk / dv at the
    query heads (JAX :168)."""
    s = torch.matmul(qs, ks.transpose(-1, -2)) * scale
    if causal:
        mask = _mask(q_off, qs.shape[2], k_off, ks.shape[2], qs.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    lse_safe = torch.where(lses <= NEG_INF * 0.5, torch.zeros_like(lses),
                           lses)
    p = torch.exp(s - lse_safe)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    dv = torch.matmul(p.transpose(-1, -2), dos)
    dp = torch.matmul(dos, vs.transpose(-1, -2))
    ds = p * (dp - deltas)
    dq = torch.matmul(ds, ks) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs) * scale
    return dq, dk, dv


def _bwd_chunk_pass(q, do, delta, lse, k_cur, v_cur, dq, dk_cur, dv_cur,
                    q_off, k_off, scale, causal, qb, kb, rep):
    """One ring chunk of the backward (JAX :198): into the local dq and
    the travelling dk_cur / dv_cur (kv heads), in place."""
    b, h, s_l, d = q.shape
    hkv = k_cur.shape[1]
    for a in range(0, s_l, qb):
        qs, dos = q[:, :, a:a + qb], do[:, :, a:a + qb]
        deltas, lses = delta[:, :, a:a + qb], lse[:, :, a:a + qb]
        for c in range(0, k_cur.shape[2], kb):
            if not _visible(q_off + a, qb, k_off + c, causal):
                continue
            dq_b, dk_b, dv_b = _bwd_block(
                qs, _expand(k_cur[:, :, c:c + kb], rep),
                _expand(v_cur[:, :, c:c + kb], rep), dos, deltas, lses,
                q_off + a, k_off + c, scale, causal)
            if rep > 1:     # the expanded heads back to their kv head
                dk_b = dk_b.reshape(b, hkv, rep, -1, d).sum(2)
                dv_b = dv_b.reshape(b, hkv, rep, -1, d).sum(2)
            dq[:, :, a:a + qb].add_(dq_b)
            dk_cur[:, :, c:c + kb].add_(dk_b)
            dv_cur[:, :, c:c + kb].add_(dv_b)


def _ring_fwd(q, k, v, group, causal, scale, qb, kb):
    """The forward ring pass: (o in q's dtype, lse f32 [B, H, S_l, 1])."""
    sp = comm.get_world_size(group)
    idx = comm.get_rank(group) if sp > 1 else 0
    b, h, s_l, d = q.shape
    rep = h // k.shape[1]
    q32 = q.float()
    o = torch.zeros((b, h, s_l, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_l, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_l, 1), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for t in range(sp):
        src = (idx - t) % sp
        if not causal or src <= idx:
            _fwd_chunk_pass(q32, k_cur.float(), v_cur.float(), o, m, l,
                            idx * s_l, src * s_l, scale, causal, qb, kb, rep)
        if sp > 1:
            k_cur, v_cur = comm.send_next([k_cur, v_cur], "seq", sp, group)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    lse = torch.where(empty, torch.full_like(l, NEG_INF),
                      m + torch.log(l_safe))
    return (o / l_safe).to(q.dtype), lse


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, qb, kb):
        o, lse = _ring_fwd(q, k, v, group, causal, scale, qb, kb)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (group, causal, scale, qb, kb)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, scale, qb, kb = ctx.args
        sp = comm.get_world_size(group)
        idx = comm.get_rank(group) if sp > 1 else 0
        s_l = q.shape[2]
        rep = q.shape[1] // k.shape[1]
        do32 = do.float()
        delta = torch.sum(do32 * o.float(), dim=-1, keepdim=True)
        q32 = q.float()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for t in range(sp):
            src = (idx - t) % sp
            if not causal or src <= idx:
                _bwd_chunk_pass(q32, do32, delta, lse, k_cur.float(),
                                v_cur.float(), dq, dk_cur, dv_cur,
                                idx * s_l, src * s_l, scale, causal, qb, kb,
                                rep)
            if sp > 1:
                # dk / dv travel with their chunk: after sp rotations they
                # are back at the rank that owns it
                k_cur, v_cur, dk_cur, dv_cur = comm.send_next(
                    [k_cur, v_cur, dk_cur, dv_cur], "seq", sp, group)
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None, None)


def ring_attention(q, k, v, axis_name: str = "seq", causal: bool = True,
                   scale: Optional[float] = None, use_remat: bool = True,
                   q_chunk: int = 0, kv_chunk: int = 0, group=None):
    """Ring attention over this rank's sequence chunk (JAX :303).

    q: [B, H, S_l, D]; k / v: [B, Hkv, S_l, D], the rank's contiguous
    chunk of a sequence cut over the seq group (``group``, else the
    ``axis_name`` axis's). Returns [B, H, S_l, D] in q's dtype.
    ``q_chunk`` / ``kv_chunk`` (0: off) sub-block the work of a step; a
    value that does not divide S_l turns the sub-blocking off for that
    dimension, with a warning, as in JAX."""
    del use_remat
    group = comm.resolve_group(group, axis_name)
    s_l, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qb = q_chunk if (0 < q_chunk < s_l and s_l % q_chunk == 0) else s_l
    kb = kv_chunk if (0 < kv_chunk < s_l and s_l % kv_chunk == 0) else s_l
    for name, want, got in (("q_chunk", q_chunk, qb),
                            ("kv_chunk", kv_chunk, kb)):
        if 0 < want < s_l and got == s_l:
            logger.warning(
                f"ring_attention: {name}={want} does not divide the local "
                f"sequence shard {s_l}; sub-blocking DISABLED for this "
                f"dim (score block grows to {s_l}x{s_l})")
    return _Ring.apply(q, k, v, group, causal, scale, qb, kb)


def ring_attention_sharded(q, k, v, topo, causal: bool = True,
                           scale: Optional[float] = None):
    """Topology-level entry (JAX :338): ``sharded_attention(...,
    impl="ring")`` over ``topo``'s seq group."""
    from .layer import sharded_attention
    return sharded_attention(q, k, v, topo, causal=causal, impl="ring",
                             scale=scale)

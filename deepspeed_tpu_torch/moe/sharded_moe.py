"""Mixture-of-Experts gating and dispatch.

Port of ``deepspeed_tpu/moe/sharded_moe.py`` (``_capacity`` :24,
``top1gating`` :34, ``top2gating`` :73, ``moe_layer`` :127,
``ragged_swiglu_experts`` :208, ``dropless_topk_dispatch`` :222,
``moe_layer_dropless`` :241, ``moe_layer_dropless_ep`` :285,
``residual_moe_combine`` :321), the reference's
``deepspeed/moe/sharded_moe.py``.

The JAX package dispatches with a one-hot ``[T, E, C]`` mask and two
einsums. Here the same function runs on indices: each kept (token,
choice) goes to row ``expert * C + position`` of a flat ``[E * C + 1, H]``
buffer (the last row takes the dropped choices and is never read), the
experts run batched over ``[E, C, H]``, and each token gathers its at most
``k`` rows back, weighted by its gate. The dispatch is exact, the combine
sums ``k`` terms, and nothing of size ``T * E * C`` is built (at training
shape the f32 mask is 134 MB a layer and micro-batch). ``top1gating`` /
``top2gating`` still return the dense masks, built from the same routing.

The JAX gating is one SPMD program over the global batch, so capacity,
positions and the load-balancing statistics are global over the data-
parallel ranks. Across ranks (:class:`MoEGroups`) the per-expert counts
are all-gathered (a rank's positions start after the lower ranks'), and
the sums behind the aux loss are all-reduced; autograd sees this rank's
part scaled by the world, so the engine's mean over the ranks gives the
gradient of the global loss. Under expert parallelism (``ep`` > 1) each
rank of an expert group holds ``E / ep`` experts: the capacity buffer is
exchanged with an all-to-all over the group, the owner runs its experts
on every peer's rows, and a second all-to-all sends the outputs back, as
JAX ``moe_layer_manual`` does by hand (reference ``_AllToAll`` :95).

Serving (``serve_moe``, ep 1) routes without capacity and runs the
experts as grouped GEMMs over the tokens sorted by expert, the group
offsets on the device (``torch._grouped_mm``, JAX's ``ragged_dot``), so
a decode window reads no size on the host. ``moe_mlp`` is the training
layer shared by ``TransformerLM`` and the ``MoE`` facade.

Inside the 1F1B schedule (pp x ep) the layer dispatches through
``moe_layer_manual`` (JAX :160): the same exchange with the gating local
to this rank's tokens, as in the JAX package's manual pipeline program.
"""

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..comm import comm


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    cap = int(math.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


class MoEGroups:
    """The process groups of one MoE layer's collectives.

    ``group`` (``world`` ranks, this one ``rank``) is the data-parallel
    group the gating statistics are global over; ``expert_group`` (``ep``
    ranks, this one ``ep_rank``) holds one copy of the experts, this rank
    experts ``[ep_rank * E / ep, (ep_rank + 1) * E / ep)``. Under sequence
    parallelism (``sp`` > 1) the group is the data x seq ranks (seq
    innermost), each holding its chunk of the sequence of its rows."""

    def __init__(self, group=None, world: int = 1, rank: int = 0,
                 expert_group=None, ep: int = 1, ep_rank: int = 0,
                 sp: int = 1):
        self.group, self.world, self.rank = group, world, rank
        self.expert_group, self.ep, self.ep_rank = expert_group, ep, ep_rank
        self.sp = sp


def _world(groups: Optional[MoEGroups]) -> int:
    return 1 if groups is None else groups.world


def _ep(groups: Optional[MoEGroups]) -> int:
    return 1 if groups is None else groups.ep


class _AllToAll(torch.autograd.Function):
    """Equal-split all-to-all along dim 0 over a group; its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        comm.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        comm.all_to_all_single(out, g, group=ctx.group)
        return out, None


def _global_counts(mask: torch.Tensor, groups: Optional[MoEGroups],
                   rows: int = 1):
    """(each token's exclusive prefix [T, E] or [E], the total [E]) of the
    per-expert counts of a [T, E] mask over the global token order: the
    data-parallel ranks' tokens rank 0's first and, under sequence
    parallelism, row by row, each row's chunks in seq order (JAX's
    ``[B * S]`` order). ``rows``: the batch rows of this rank's T tokens,
    row-major."""
    if _world(groups) == 1:
        counts = mask.sum(0)
        return torch.zeros_like(counts), counts
    sp = groups.sp
    E = mask.shape[-1]
    mine = mask.reshape(rows, -1, E).sum(1)                      # [R, E]
    every = torch.empty((groups.world * rows, E), dtype=mine.dtype,
                        device=mine.device)
    comm.all_gather_into_tensor(every, mine.contiguous(), group=groups.group)
    every = every.view(groups.world // sp, sp, rows, E)
    d, r = divmod(groups.rank, sp)
    here = every[d]                                              # [sp, R, E]
    # before row b of this chunk: the lower data ranks, rows < b of every
    # chunk, row b of the lower chunks; less this rank's rows < b, which
    # the local cumsum counts
    before = (every[:d].sum((0, 1, 2))
              + torch.cumsum(here.sum(0), 0) - here.sum(0)
              - (torch.cumsum(mine, 0) - mine)
              + here[:r].sum(0))                                 # [R, E]
    return (before.repeat_interleave(mask.shape[0] // rows, dim=0),
            every.sum((0, 1, 2)))


def _global_mean(x: torch.Tensor, groups: Optional[MoEGroups]):
    """Mean over the global token axis (dim 0) of a [T, E] tensor: the
    value is the global mean; its gradient reaches this rank's rows scaled
    by the world (1 / T_local), so averaging the ranks' gradients gives
    the global loss's."""
    if _world(groups) == 1:
        return torch.mean(x, dim=0)
    local = torch.sum(x, dim=0)
    total = local.detach().clone()
    comm.all_reduce(total, group=groups.group)
    t_local = x.shape[0]
    return (total / (t_local * groups.world)
            + (local - local.detach()) / t_local)


def _with_noise(logits, noisy_gate_policy, generator):
    """The logits top-1 routing takes its argmax of: under "RSample" with a
    generator, plus Gumbel noise (JAX: ``jax.random.gumbel``)."""
    if noisy_gate_policy != "RSample" or generator is None:
        return logits
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device).clamp(min=tiny)
    return logits - torch.log((-torch.log(u)).clamp(min=tiny))


class Routing(NamedTuple):
    """Each token's ``k`` choices: ``experts`` / ``positions`` [T, k]
    (int64; a position is the global slot in the expert's capacity),
    ``keep`` [T, k] bool, ``weights`` [T, k] f32 (0 where dropped), the
    capacity ``C`` and the aux loss (f32 scalar)."""

    experts: torch.Tensor
    positions: torch.Tensor
    keep: torch.Tensor
    weights: torch.Tensor
    capacity: int
    aux: torch.Tensor


def _route_top1(logits, capacity_factor, min_capacity, noisy_gate_policy,
                generator, groups, rows=1):
    T, E = logits.shape
    C = _capacity(T * _world(groups), E, capacity_factor, min_capacity)
    gates = torch.softmax(logits, dim=-1)                       # [T, E]
    idx = torch.argmax(_with_noise(logits, noisy_gate_policy, generator),
                       dim=-1)                                  # [T]
    mask1 = F.one_hot(idx, E).float()
    me = _global_mean(gates, groups)
    ce = _global_mean(mask1, groups)
    aux = torch.sum(me * ce) * E
    prefix, _ = _global_counts(mask1, groups, rows)
    pos = (torch.cumsum(mask1, dim=0) - mask1 + prefix)         # [T, E]
    pos1 = torch.sum(pos * mask1, dim=-1)
    keep = pos1 < C
    w = torch.gather(gates, 1, idx[:, None])[:, 0] * keep.float()
    return Routing(idx[:, None], pos1.long()[:, None], keep[:, None],
                   w[:, None], C, aux)


def _route_top2(logits, capacity_factor, min_capacity, groups, rows=1):
    T, E = logits.shape
    C = _capacity(T * _world(groups), E, capacity_factor * 2.0,
                  min_capacity)
    gates = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx1, E).float()
    idx2 = torch.argmax(gates * (1.0 - mask1), dim=-1)
    mask2 = F.one_hot(idx2, E).float()
    me = _global_mean(gates, groups)
    ce = _global_mean(mask1, groups)
    aux = torch.sum(me * ce) * E
    prefix1, total1 = _global_counts(mask1, groups, rows)
    prefix2, _ = _global_counts(mask2, groups, rows)
    pos1 = torch.sum((torch.cumsum(mask1, 0) - mask1 + prefix1) * mask1, -1)
    # expert-2 positions come after every expert-1 claim (reference
    # locations2 += sum of mask1)
    pos2 = torch.sum((torch.cumsum(mask2, 0) - mask2 + prefix2 + total1)
                     * mask2, -1)
    keep1, keep2 = pos1 < C, pos2 < C
    g1 = torch.gather(gates, 1, idx1[:, None])[:, 0] * keep1.float()
    g2 = torch.gather(gates, 1, idx2[:, None])[:, 0] * keep2.float()
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    return Routing(torch.stack([idx1, idx2], 1),
                   torch.stack([pos1, pos2], 1).long(),
                   torch.stack([keep1, keep2], 1),
                   torch.stack([g1, g2], 1), C, aux)


def _dense_masks(r: Routing, num_experts: int):
    """The JAX ``(combine, dispatch)`` ``[T, E, C]`` of a routing."""
    T, k = r.experts.shape
    dispatch = torch.zeros((T, num_experts, r.capacity),
                           dtype=torch.float32, device=r.weights.device)
    combine = torch.zeros_like(dispatch)
    for j in range(k):
        t = torch.arange(T, device=dispatch.device)[r.keep[:, j]]
        e, p = r.experts[r.keep[:, j], j], r.positions[r.keep[:, j], j]
        dispatch[t, e, p] = 1.0
        combine[t, e, p] = r.weights[r.keep[:, j], j]
    return combine, dispatch


def top1gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               noisy_gate_policy: Optional[str] = None, generator=None,
               drop_tokens: bool = True, groups: Optional[MoEGroups] = None):
    """Switch-style top-1 gating (reference sharded_moe.py:184).

    logits: [T, E]. Returns (aux_loss, combine [T, E, C], dispatch mask
    [T, E, C]); ``generator`` draws the RSample noise (JAX: ``rng``)."""
    if not drop_tokens:
        raise NotImplementedError(
            "use moe_layer_dropless (the sorted-token grouped GEMM) for "
            "drop_tokens=False; the dispatch path is capacity-based")
    r = _route_top1(logits, capacity_factor, min_capacity,
                    noisy_gate_policy, generator, groups)
    combine, dispatch = _dense_masks(r, logits.shape[-1])
    return r.aux, combine, dispatch


def top2gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               generator=None, drop_tokens: bool = True,
               groups: Optional[MoEGroups] = None):
    """GShard top-2 gating (reference sharded_moe.py:282); deterministic
    second expert (argmax after masking expert 1)."""
    if not drop_tokens:
        raise NotImplementedError(
            "dropless MoE is not supported; see top1gating")
    r = _route_top2(logits, capacity_factor, min_capacity, groups)
    combine, dispatch = _dense_masks(r, logits.shape[-1])
    return r.aux, combine, dispatch


def _gate_and_route(xt, gate_w, top_k, capacity_factor, min_capacity,
                    noisy_gate_policy, generator, groups, rows=1) -> Routing:
    """The gating prologue of every capacity-routed variant: f32 router
    logits, then top-1 / top-2 routing (JAX ``_gate_and_dispatch``);
    ``rows``: the batch rows of ``xt``'s tokens."""
    logits = xt.float() @ gate_w.float()
    if top_k == 1:
        return _route_top1(logits, capacity_factor, min_capacity,
                           noisy_gate_policy, generator, groups, rows)
    return _route_top2(logits, capacity_factor, min_capacity, groups, rows)


def _dispatch_combine(xt, r: Routing, num_experts: int, expert_params,
                      expert_fn, groups):
    """Run the routed experts: scatter, (exchange,) compute, (exchange,)
    gather and weight. Returns [T, H] in xt's dtype."""
    T, H = xt.shape
    k = r.experts.shape[1]
    E, C = num_experts, r.capacity
    dest = torch.where(r.keep, r.experts * C + r.positions,
                       torch.full_like(r.experts, E * C)).reshape(-1)
    rows = xt[:, None, :].expand(T, k, H).reshape(T * k, H)
    buf = xt.new_zeros((E * C + 1, H)).index_put((dest,), rows)
    xe = buf[:E * C].view(E, C, H)
    ep = _ep(groups)
    if ep > 1:
        e_loc = E // ep
        # block o = my rows for peer o's experts; received block p = peer
        # p's rows for mine
        xr = _AllToAll.apply(xe, groups.expert_group)
        xr = xr.view(ep, e_loc, C, H).transpose(0, 1).reshape(
            e_loc, ep * C, H)
        ye = expert_fn(expert_params, xr)                 # [e_loc, ep*C, H]
        ye = ye.reshape(e_loc, ep, C, H).transpose(0, 1).reshape(E, C, H)
        ye = _AllToAll.apply(ye, groups.expert_group)
    else:
        ye = expert_fn(expert_params, xe)                 # [E, C, H]
    ye = torch.cat([ye.reshape(E * C, H), ye.new_zeros((1, H))])
    y = ye[dest].view(T, k, H)
    return (y * r.weights[..., None].to(y.dtype)).sum(1)


def moe_layer(x, gate_w, expert_params, expert_fn,
              groups: Optional[MoEGroups] = None, top_k: int = 1,
              capacity_factor: float = 1.0, min_capacity: int = 4,
              generator=None, noisy_gate_policy: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a capacity-routed MoE layer.

    x: [B, S, H]; gate_w: [H, E]; expert_params: tensors with a leading
    expert dim (``E / ep`` of them under expert parallelism);
    ``expert_fn(expert_params, xe)`` applies the expert stack to
    ``[E', C', H]`` batched (JAX vmaps a one-expert function).

    Returns (output [B, S, H], aux_loss f32 scalar)."""
    B, S, H = x.shape
    xt = x.reshape(B * S, H)
    r = _gate_and_route(xt, gate_w, top_k, capacity_factor, min_capacity,
                        noisy_gate_policy, generator, groups, rows=B)
    out = _dispatch_combine(xt, r, gate_w.shape[-1], expert_params,
                            expert_fn, groups)
    return out.reshape(B, S, H), r.aux.float()


def moe_layer_manual(x, gate_w, expert_params_local, expert_fn,
                     groups: Optional[MoEGroups] = None, top_k: int = 1,
                     capacity_factor: float = 1.0, min_capacity: int = 4,
                     generator=None, noisy_gate_policy: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with the explicit all-to-all dispatch for the
    1F1B schedule (JAX :160): capacity routing of this rank's tokens alone
    (capacity, positions and the aux loss local, no collective over the
    data ranks) into ``[E, C, H]``, one ``all_to_all_single`` to the
    expert owners of ``groups.expert_group``, the local experts on
    ``[E / ep, ep * C, H]``, and one back. ``expert_params_local``: this
    rank's ``E / ep`` experts. Returns (output [B, S, H], aux f32)."""
    E, ep = gate_w.shape[-1], _ep(groups)
    if E % ep:
        raise ValueError(f"num_experts {E} not divisible by ep {ep}")
    local = (MoEGroups(None, 1, 0, groups.expert_group, ep, groups.ep_rank)
             if ep > 1 else None)
    return moe_layer(x, gate_w, expert_params_local, expert_fn, local,
                     top_k=top_k, capacity_factor=capacity_factor,
                     min_capacity=min_capacity, generator=generator,
                     noisy_gate_policy=noisy_gate_policy)


def swiglu_experts(expert_params, xe):
    """The SwiGLU expert stack over [E, C, H] rows, batched."""
    wg, wu, wd = expert_params
    return (F.silu(xe @ wg) * (xe @ wu)) @ wd


def ragged_swiglu_experts(expert_params, xs, group_sizes):
    """SwiGLU expert stack as grouped GEMMs over token groups (JAX :208,
    ``jax.lax.ragged_dot``): xs [N, H] sorted by expert, group_sizes [E].
    One matmul per expert over its contiguous rows, the sizes read on the
    host (one sync)."""
    wg, wu, wd = expert_params
    outs, a = [], 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            seg = xs[a:a + n]
            outs.append((F.silu(seg @ wg[e]) * (seg @ wu[e])) @ wd[e])
            a += n
    if not outs:
        return xs.new_zeros((0, wd.shape[-1]))
    return torch.cat(outs)


def dropless_topk_dispatch(xt, topi, topv, expert_params, num_experts: int,
                           ragged_expert_fn=None):
    """Sorted-token grouped-GEMM core of the training dropless MoE (JAX
    :222): route every (token, choice) row to its expert
    with one stable argsort and the grouped expert function, unsort, and
    weight by the gate. xt: [T, H]; topi / topv: [T, k]. Returns [T, H]."""
    T, H = xt.shape
    k = topi.shape[-1]
    idx = topi.reshape(-1)
    order = torch.argsort(idx, stable=True)
    xs = xt[order // k]                       # row t*k+j <-> (token t, j)
    group_sizes = torch.bincount(idx, minlength=num_experts)
    fn = ragged_expert_fn or ragged_swiglu_experts
    ys = fn(expert_params, xs, group_sizes)   # [T*k, H]
    ys = ys[torch.argsort(order)]             # unsort
    return torch.sum(ys.reshape(T, k, H) * topv[..., None].to(ys.dtype),
                     dim=1)


def serve_topk_experts(xt, topi, topv, expert_params):
    """The serving MoE's SwiGLU experts over [T, H] rows, the same function
    as :func:`dropless_topk_dispatch` with no host sync: the rows sorted by
    expert go through ``torch._grouped_mm`` with the group offsets on the
    device, so a decode window keeps its one sync. xt: [T, H]; topi / topv:
    [T, k]. Returns [T, H]. On the card a 16-bit row must span a multiple
    of 16 bytes (H and the FFN width multiples of 8)."""
    wg, wu, wd = expert_params
    T, H = xt.shape
    k = topi.shape[-1]
    idx = topi.reshape(-1)
    order = torch.argsort(idx, stable=True)
    xs = xt[order // k]                       # row t*k+j <-> (token t, j)
    # each expert's end offset in the sorted rows (bincount would read its
    # length on the host)
    offs = torch.searchsorted(
        idx[order], torch.arange(wg.shape[0], device=idx.device),
        right=True, out_int32=True)
    h = F.silu(torch._grouped_mm(xs, wg, offs=offs)) \
        * torch._grouped_mm(xs, wu, offs=offs)
    ys = torch._grouped_mm(h, wd, offs=offs)
    ys = torch.empty_like(ys).index_copy_(0, order, ys)          # unsort
    return torch.sum(ys.reshape(T, k, H) * topv[..., None].to(ys.dtype),
                     dim=1)


def route_topk(probs, k: int, renormalize_top1: bool):
    """A serving step's routing: the top-``k`` experts of each row of the
    f32 gate probabilities [T, E] and their weights, renormalized over the
    chosen set for k >= 2 (and for k = 1 where ``renormalize_top1``).
    Returns (topv, topi) [T, k]."""
    topv, topi = torch.topk(probs, k, dim=-1)
    if k > 1 or renormalize_top1:
        topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    return topv, topi


def serve_moe(xt, gate_w, expert_params, k: int, renormalize_top1: bool,
              logits_in_f32: bool):
    """The routed experts of a serving step (ep 1, dropless) over [T, H]
    rows: the gate's softmax in f32 (the logits computed in f32, or in
    ``xt``'s dtype and cast up), top-k routing, the grouped experts. The
    v2 paged model keeps the raw gate probability at k = 1 and gates in
    f32 (JAX ``paged_model._moe_mlp``); the v1 cached forward renormalizes
    at k = 1 too and casts its logits up (JAX ``transformer.py:1192``)."""
    logits = (xt.float() @ gate_w.float()) if logits_in_f32 \
        else (xt @ gate_w).float()
    topv, topi = route_topk(torch.softmax(logits, dim=-1), k,
                            renormalize_top1)
    return serve_topk_experts(xt, topi, topv, expert_params)


def moe_layer_dropless(x, gate_w, expert_params, ragged_expert_fn=None,
                       groups: Optional[MoEGroups] = None, generator=None,
                       noisy_gate_policy: Optional[str] = None):
    """Dropless top-1 MoE (the reference's drop_tokens=False mode) through
    sorted tokens and the grouped GEMM: no token is dropped and no
    capacity buffer is built (JAX :241). Experts must be local (ep 1):
    for ep > 1 use :func:`moe_layer_dropless_ep`."""
    if _ep(groups) > 1:
        raise NotImplementedError(
            "ragged dropless MoE needs device-local experts (expert axis "
            "must be 1): ragged group sizes are data-dependent and cannot "
            "ride a static expert all-to-all. For ep>1 use "
            "moe_layer_dropless_ep (worst-case static capacity).")
    B, S, H = x.shape
    T = B * S
    E = gate_w.shape[-1]
    xt = x.reshape(T, H)
    logits = xt.float() @ gate_w.float()
    gates = torch.softmax(logits, dim=-1)
    idx = torch.argmax(_with_noise(logits, noisy_gate_policy, generator),
                       dim=-1)
    me = _global_mean(gates, groups)
    ce = _global_mean(F.one_hot(idx, E).float(), groups)
    aux = torch.sum(me * ce) * E
    gate_p = torch.gather(gates, 1, idx[:, None])               # [T, 1]
    out = dropless_topk_dispatch(xt, idx[:, None], gate_p, expert_params, E,
                                 ragged_expert_fn)
    return out.reshape(B, S, H), aux.float()


def moe_layer_dropless_ep(x, gate_w, expert_params, expert_fn,
                          groups: Optional[MoEGroups], top_k: int = 1,
                          generator=None,
                          noisy_gate_policy: Optional[str] = None,
                          max_dispatch_elems: int = 1 << 28
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless top-1 / top-2 MoE under expert parallelism (JAX :285): the
    capacity path at the worst case (C = T global tokens for top-1, 2T for
    top-2), so the capacity never binds. The buffer is [E, k*T, H] a
    rank: ``max_dispatch_elems`` refuses a T where ``T * E * k*T``
    passes it, as JAX does."""
    B, S, _ = x.shape
    T = B * S * _world(groups)
    E = gate_w.shape[-1]
    if T * E * (top_k * T) > max_dispatch_elems:
        raise NotImplementedError(
            f"dropless-under-ep worst-case dispatch is [T,E,k*T] = "
            f"[{T},{E},{top_k * T}] (> {max_dispatch_elems} elements): "
            f"quadratic in tokens. Chunk the sequence (smaller prefill "
            f"bucket), use capacity routing, or serve with ep=1.")
    return moe_layer(x, gate_w, expert_params, expert_fn, groups,
                     top_k=top_k, capacity_factor=float(E), min_capacity=1,
                     generator=generator,
                     noisy_gate_policy=noisy_gate_policy)


def residual_moe_combine(x, moe_out, mlp_out, coef_w, coef_b=None):
    """Residual-MoE mixture (reference moe/layer.py:118-123, the PR-MoE
    building block): a 2-way softmax over a learned coefficient head
    weighs the routed-expert output against a dense MLP on the same
    input."""
    coef = x @ coef_w.to(x.dtype)
    if coef_b is not None:
        coef = coef + coef_b.to(x.dtype)
    coef = torch.softmax(coef.float(), dim=-1).to(x.dtype)
    return moe_out * coef[..., 0:1] + mlp_out * coef[..., 1:2]


def moe_mlp(x, gate_w, expert_params, expert_fn,
            groups: Optional[MoEGroups] = None, top_k: int = 1,
            capacity_factor: float = 1.0, min_capacity: int = 4,
            dropless: bool = False, residual=None, generator=None,
            noisy_gate_policy: Optional[str] = None, ragged_expert_fn=None,
            dense_fn=swiglu_experts, manual: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed MLP of a training MoE layer, shared by
    ``TransformerLM`` (JAX ``transformer.py:640-697``) and the ``MoE``
    facade (JAX ``layer.py``): capacity routing (:func:`moe_layer`), or
    dropless top-1 (:func:`moe_layer_dropless` through
    ``ragged_expert_fn``; at ep > 1 the worst-case capacity of
    :func:`moe_layer_dropless_ep`), then the residual MoE's SwiGLU dense
    branch ``dense_fn`` where ``residual`` holds ``(res_gate, res_up,
    res_down, coef_w, coef_b)``. ``manual``: the capacity routing of the
    1F1B schedule at ep > 1 (:func:`moe_layer_manual`). x: [B, S, H].
    Returns (output, aux)."""
    if dropless and _ep(groups) > 1:
        out, aux = moe_layer_dropless_ep(
            x, gate_w, expert_params, expert_fn, groups, generator=generator,
            noisy_gate_policy=noisy_gate_policy)
    elif dropless:
        out, aux = moe_layer_dropless(
            x, gate_w, expert_params, ragged_expert_fn, groups=groups,
            generator=generator, noisy_gate_policy=noisy_gate_policy)
    else:
        out, aux = (moe_layer_manual if manual else moe_layer)(
            x, gate_w, expert_params, expert_fn, groups, top_k=top_k,
            capacity_factor=capacity_factor, min_capacity=min_capacity,
            generator=generator, noisy_gate_policy=noisy_gate_policy)
    if residual is not None:
        dense = dense_fn(residual[:3], x)
        out = residual_moe_combine(x, out, dense, *residual[3:])
    return out, aux

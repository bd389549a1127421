"""Pipeline parallelism over the ``pipe`` axis: the 1F1B schedule.

Port of ``deepspeed_tpu/runtime/pipe/pipeline.py`` (``pipeline_scan`` :42,
``broadcast_from_last`` :104, ``pipeline_1f1b`` :110), the reference's
``runtime/pipe/schedule.py:189`` ``TrainSchedule`` with its p2p sends
(``p2p.py:50``). The JAX package runs one SPMD program on every stage and
masks the slots a stage has no micro-batch for; here each rank is one
stage of the pipe group and runs only its own slots, and the stages meet
through point-to-point transfers (``comm.exchange``).

:func:`pipeline_1f1b` is the training schedule: T = M + 2 (pp - 1) ticks
of one forward and one backward slot each (:func:`tick_table`). Stage s
runs the forward of micro-batch t - s without autograd, keeps its input
and sends the output to s + 1; it runs the backward of micro-batch
t - 2 (pp - 1) + s by running the stage again from the kept input with
autograd and back-propagating the cotangent that came from s + 1 (the
last stage the loss, cotangent 1, in the tick its input arrives, so it
has no forward slot), and sends the input's cotangent to s - 1. A stage
keeps at most 2 pp - 1 inputs whatever M is. Both ends of every transfer
derive it from the same (t, s, M, pp) arithmetic, and a tick's sends and
receives go in one ``batch_isend_irecv``.

:func:`pipeline_scan` is the GPipe-shaped forward the eval path and the
fp16 fallback use; under autograd its permutes are differentiable
(``comm.permute_grad``) and chained by a token, so every rank runs their
backward in the same tick order.
"""

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ...comm import comm
from ...parallel.topology import PIPE_AXIS
from ..engine import _flatten, _unflatten

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def stage_index(group=None) -> int:
    """This rank's pipeline stage (its rank in the pipe group)."""
    return comm.get_rank(comm.resolve_group(group, PIPE_AXIS)) \
        if comm.is_initialized() else 0


def last_stage_mask(num_stages: int, group=None) -> bool:
    return stage_index(group) == num_stages - 1


def _fwd_micro(t: int, s: int, M: int) -> Optional[int]:
    """The micro-batch of stage s's forward slot at tick t, if any."""
    m = t - s
    return m if 0 <= m < M else None


def _bwd_micro(t: int, s: int, M: int, pp: int) -> Optional[int]:
    """The micro-batch of stage s's backward slot at tick t, if any."""
    m = t - 2 * (pp - 1) + s
    return m if 0 <= m < M else None


def tick_table(M: int, pp: int) -> List[Dict[str, list]]:
    """The 1F1B schedule, one entry a tick: ``forward[s]`` / ``backward[s]``
    the micro-batch stage s runs in that slot (None: idle; the last stage
    has no forward slot, its backward slot runs the forward again) and
    ``sends`` the transfers at the tick's end as ``(src, dst, kind, m)``
    (kind "act" forward, "grad" backward)."""
    out = []
    for t in range(M + 2 * (pp - 1)):
        fwd = [_fwd_micro(t, s, M) if s < pp - 1 else None
               for s in range(pp)]
        bwd = [_bwd_micro(t, s, M, pp) for s in range(pp)]
        sends = [(s, s + 1, "act", _fwd_micro(t, s, M))
                 for s in range(pp - 1) if _fwd_micro(t, s, M) is not None]
        sends += [(s, s - 1, "grad", bwd[s]) for s in range(1, pp)
                  if bwd[s] is not None]
        out.append({"forward": fwd, "backward": bwd, "sends": sends})
    return out


def broadcast_from_last(x, num_stages: int, group=None):
    """The last stage's ``x`` on every stage: zeros elsewhere, summed over
    the pipe group. Its backward is the identity, so only the last
    stage's ``x`` receives the cotangent (JAX: the psum trick)."""
    group = comm.resolve_group(group, PIPE_AXIS)
    if not last_stage_mask(num_stages, group):
        # zeros that stay in the graph (their cotangent reaches x as 0)
        x = torch.where(torch.zeros((), dtype=torch.bool, device=x.device),
                        x, torch.zeros_like(x))
    return comm.tp_reduce(x, axis_name=PIPE_AXIS, group=group)


def pipeline_scan(stage_fn: Callable, x_microbatches, num_stages: int,
                  remat: bool = True, stage_aux: bool = False, group=None,
                  anchor=None):
    """Run ``stage_fn(h) -> h`` as a pipeline over the pipe group: tick t,
    stage s runs micro-batch t - s on what s - 1 sent it (stage 0 on
    ``x_microbatches[m]``), for M + pp - 1 ticks. Activations keep the
    micro-batches' shape and dtype.

    Returns the last stage's outputs ``[M, ...]`` (zeros on the other
    stages: callers mask with the stage, e.g. :func:`broadcast_from_last`).
    ``stage_aux``: ``stage_fn`` returns ``(h, aux)``, a stage-local
    auxiliary loss; the return is then ``(ys, aux_sum)``, this stage's aux
    summed over its micro-batches (callers sum it over the pipe group and
    divide by M). Under autograd the permutes are differentiable and
    ordered by a token that ends in the outputs (times 0). ``autograd.grad``
    runs only the nodes on a path to the tensors it is asked for, so the
    token starts from ``anchor`` (times 0), a tensor that requires grad on
    every stage (a parameter the caller differentiates): every stage then
    runs every backward permute, as its peers do."""
    pp = num_stages
    group = comm.resolve_group(group, PIPE_AXIS)
    s = stage_index(group)
    M = x_microbatches.shape[0]
    template = torch.zeros_like(x_microbatches[0])
    body = stage_fn
    grad = torch.is_grad_enabled()
    if remat and grad:
        import torch.utils.checkpoint as tuc

        def body(h):
            return tuc.checkpoint(stage_fn, h, use_reentrant=False)

    token = None
    if grad and pp > 1:
        token = (anchor.float().sum() * 0 if anchor is not None else
                 torch.zeros((), device=template.device, requires_grad=True))
    buf, ys = None, [None] * M
    aux_sum = torch.zeros((), dtype=torch.float32, device=template.device)
    for t in range(M + pp - 1):
        m = _fwd_micro(t, s, M)
        out = None
        if m is not None:
            r = body(x_microbatches[m] if s == 0 else buf)
            out, aux = r if stage_aux else (r, None)
            if aux is not None:
                aux_sum = aux_sum + aux.float()
            if s == pp - 1:
                ys[m] = out
        if pp == 1:
            continue
        perm = [(i, i + 1) for i in range(pp - 1)
                if _fwd_micro(t, i, M) is not None]
        send = out if out is not None and s < pp - 1 else template
        if token is not None:
            buf, token = comm.permute_grad(send, perm, token, group=group)
        else:
            buf = comm.permute(send, perm, group=group)
    ys = torch.stack([y if y is not None else template for y in ys])
    if token is not None:
        ys = ys + (0 * token).to(ys.dtype)
    return (ys, aux_sum) if stage_aux else ys


def _probe_spec(fn, params, x0, group):
    """(shape, dtype) of the inter-stage activation: stage 0 runs its
    first micro-batch and broadcasts it over the pipe group. Returns the
    spec and stage 0's output (reused in its first forward slot)."""
    s = stage_index(group)
    out0, meta = None, torch.zeros(8, dtype=torch.int64)
    if s == 0:
        with torch.no_grad():
            out0 = fn(params, x0, None)
        out0 = out0[0] if isinstance(out0, tuple) else out0
        meta[0] = _DTYPES.index(out0.dtype)
        meta[1] = out0.dim()
        meta[2:2 + out0.dim()] = torch.tensor(out0.shape)
    if comm.get_backend(group) == "nccl":
        meta = meta.to(x0.device)
    comm.broadcast(meta, src=comm._global_rank(group, 0), group=group)
    meta = meta.tolist()
    return (tuple(meta[2:2 + meta[1]]), _DTYPES[meta[0]]), out0


def backward_slot(run, params, leaves, diff, acc, x_mb, h_b, cot=None,
                  loss_fn=None, loss_args: Sequence = ()):
    """One backward slot of :func:`pipeline_1f1b`: the stage runs again
    from its kept input ``h_b`` (None on stage 0, which reads ``x_mb``)
    with autograd, ``run(x_mb, h) -> (h_out, aux or None)``. With
    ``loss_fn`` (the last stage) the root is the micro-batch's loss
    ``loss_fn(params, h_out, *loss_args)``, cotangent 1; otherwise
    ``h_out`` with the cotangent ``cot`` from the next stage. A stage's
    aux loss is a root with cotangent 1. The gradient of ``leaves[i]``,
    for each i in ``diff``, is added into ``acc[i]`` (f32, without an f32
    copy of it). Returns (the slot's share of the loss, f32, or None; the
    cotangent of ``h_b``, or None on stage 0)."""
    with torch.enable_grad():
        h_in = h_b.detach().requires_grad_(True) if h_b is not None else None
        out, aux = run(x_mb, h_in)
        if loss_fn is not None:
            lval = loss_fn(params, out, *loss_args).float()
            if aux is not None:
                lval = lval + aux.float()
            roots, cots, share = [lval], [torch.ones_like(lval)], lval
        else:
            roots, cots, share = [out], [cot.to(out.dtype)], None
            if aux is not None:
                roots.append(aux)
                cots.append(torch.ones_like(aux))
                share = aux.float()
        inputs = [leaves[i] for i in diff] + ([h_in] if h_in is not None
                                              else [])
        gs = torch.autograd.grad(roots, inputs, cots, allow_unused=True)
    with torch.no_grad():
        for i, g in zip(diff, gs):
            if g is not None:
                acc[i].add_(g)
    return (share.detach() if share is not None else None,
            gs[-1] if h_in is not None else None)


def pipeline_1f1b(stage_fn, loss_fn, params, x_microbatches, num_stages: int,
                  h_spec=None, loss_args: Sequence = (),
                  pipe_reduce_mask=None, stage_aux: bool = False,
                  group=None,
                  grad_acc: Optional[Sequence[torch.Tensor]] = None):
    """The 1F1B schedule of :func:`tick_table`, at most 2 pp - 1 kept
    inputs a stage (module docstring).

    ``stage_fn(params, x_raw, h) -> h_out``, or a list of pp of them (this
    rank runs its stage's): stage 0 reads ``x_raw``, the others ``h``.
    Every stage's output has the shape and dtype of ``h_spec`` (``(shape,
    dtype)``; None: stage 0's first output, broadcast). ``stage_aux``:
    ``stage_fn`` returns ``(h_out, aux)``, a stage-local scalar loss
    (MoE load balancing) that the stage differentiates in its own
    backward slot. ``loss_fn(params, h_last, *loss_args_m)``: the loss of
    one micro-batch on the last stage. ``params``: a tree of tensors;
    gradients are taken for the leaves that require them.
    ``x_microbatches`` and each of ``loss_args``: ``[M, ...]``.
    ``grad_acc``: the f32 buffers to accumulate into, one a leaf of
    ``params`` in its flattened (sorted-key) order, zeroed here (None:
    allocated here).

    Returns ``(loss, grads)``: the mean micro-batch loss (plus the
    stages' aux) summed over the pipe group, the same on every stage, and
    the f32 gradients' sum over the micro-batches divided by M (the
    ``grad_acc`` buffers where given), with every leaf that
    ``pipe_reduce_mask`` marks True (default: all; False for a leaf cut
    over the pipe axis) summed over the pipe group. The mean over the
    data-parallel ranks is the caller's (the engine's reduction)."""
    pp = num_stages
    group = comm.resolve_group(group, PIPE_AXIS)
    s = stage_index(group)
    last = s == pp - 1
    fn = stage_fn[s] if isinstance(stage_fn, (list, tuple)) else stage_fn
    M = x_microbatches.shape[0]
    items = _flatten(params)
    leaves = [v for _, v in items]
    diff = [i for i, v in enumerate(leaves)
            if isinstance(v, torch.Tensor) and v.requires_grad]
    dev = x_microbatches.device
    if grad_acc is None:
        acc = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
               for v in leaves]
    else:
        acc = list(grad_acc)
        if len(acc) != len(leaves) or any(
                a.shape != v.shape or a.dtype != torch.float32
                for a, v in zip(acc, leaves)):
            raise ValueError("grad_acc must hold one f32 buffer of each "
                             "leaf's shape, in the flattened order")
        for a in acc:
            a.zero_()
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)

    def run(x_raw, h):
        r = fn(params, x_raw, h)
        return r if stage_aux else (r, None)

    out0 = None
    if pp > 1 and h_spec is None:
        h_spec, out0 = _probe_spec(fn, params, x_microbatches[0], group)
    if h_spec is not None:
        h_shape, h_dtype = tuple(h_spec[0]), h_spec[1]
    fwd_buf = bwd_buf = None
    stash: Dict[int, Optional[torch.Tensor]] = {}
    for t, row in enumerate(tick_table(M, pp)):
        sends, recvs, got = [], [], {}
        # what crosses at this tick's end, as both ends read it
        for src, dst, kind, _ in row["sends"]:
            if dst == s:
                got[kind] = torch.empty(h_shape, dtype=h_dtype, device=dev)
                recvs.append((got[kind], src))
        # -- forward slot (none on the last stage) --
        m_f = row["forward"][s]
        if m_f is not None:
            if t == 0 and out0 is not None:
                out = out0
            else:
                with torch.no_grad():
                    out = run(x_microbatches[m_f], fwd_buf)[0]
            stash[m_f] = fwd_buf
            sends.append((out.to(h_dtype), s + 1))
        # -- backward slot --
        m_b = row["backward"][s]
        if m_b is not None:
            share, gh = backward_slot(
                run, params, leaves, diff, acc, x_microbatches[m_b],
                fwd_buf if last else stash.pop(m_b), cot=bwd_buf,
                loss_fn=loss_fn if last else None,
                loss_args=tuple(a[m_b] for a in loss_args))
            if share is not None:
                loss_acc += share
            if s > 0:
                # cotangents travel in the activation dtype, as in JAX
                sends.append((torch.zeros(h_shape, dtype=h_dtype, device=dev)
                              if gh is None else gh.to(h_dtype), s - 1))
            del gh
        if pp > 1:
            comm.exchange(sends, recvs, group=group)
        fwd_buf, bwd_buf = got.get("act"), got.get("grad")
    with torch.no_grad():
        if pp > 1:
            comm.all_reduce(loss_acc, group=group)
        loss = loss_acc / M
        mask = (dict(_flatten(pipe_reduce_mask))
                if pipe_reduce_mask is not None else None)
        for i in diff:
            acc[i].div_(M)
            if pp > 1 and (mask is None or mask.get(items[i][0], True)):
                comm.all_reduce(acc[i], group=group)
    return loss, _unflatten([(n, a) for (n, _), a in zip(items, acc)])

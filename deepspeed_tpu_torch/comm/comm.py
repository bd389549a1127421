"""Backend-agnostic communication API over ``torch.distributed``.

Port of ``deepspeed_tpu/comm/comm.py`` (``init_distributed`` :41,
``timed_op`` :128, the collectives :195-330), the reference's
``deepspeed/comm/comm.py``. Two faces, as there:

1. **Process bootstrap** — :func:`init_distributed` starts the process
   group on the accelerator's backend (``nccl`` on the card, ``gloo`` on
   the CPU) from the launcher's environment, or a one-rank group on a free
   local port when nothing is set.
2. **Collectives** — the reference's in-place signatures
   (``all_reduce(tensor, ...)``, ``all_gather_into_tensor(out, in)``,
   ``reduce_scatter_tensor(out, in)``). Where the JAX package names a mesh
   axis (``axis_name="data"``) this takes a process group; the data-like
   axes (``data``, ``shard``, ``expert``) default to the world group (an
   expert group is passed as ``group``, ``parallel/topology.py``). A
   topology registers this rank's model and seq groups
   (:func:`set_axis_groups`), and those axis names then resolve to them. The tensor-parallel pair :func:`tp_copy` /
   :func:`tp_reduce` (autograd functions), the Ulysses
   :func:`seq_all_to_all` and the ring's :func:`permute` /
   :func:`send_next` / :func:`send_prev` run over those groups, and so do
   the pipeline's point-to-point transfers over the pipe axis:
   :func:`exchange` (one ``batch_isend_irecv`` of a tick's sends and
   receives, the 1F1B schedule's) and :func:`permute_grad` (``permute``
   whose backward is the opposite permute, JAX's VJP of ``ppermute``).

At world 1 without a process group every collective is local (a copy or
nothing); with a group, even at world 1, it runs on the backend, so the
card's path is the distributed one. Every collective routes through
:func:`timed_op`, feeding the ``CommsLogger`` when logging is configured.
"""

import functools
import os
import socket
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.logging import logger

_comms_logger = None

# mesh axes that default to the data-parallel world
_DATA_AXES = ("data", "shard", "expert")
# this rank's process group of the model, seq and pipe axes of the current
# topology (``parallel/topology.MeshTopology`` registers them)
_AXIS_GROUPS = {}


def set_axis_groups(groups) -> None:
    """Register this rank's process group of each mesh axis name (a dict
    ``{axis: group}``), replacing the previous topology's."""
    _AXIS_GROUPS.clear()
    _AXIS_GROUPS.update(groups or {})


# ---------------------------------------------------------------------------
# Process bootstrap
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     distributed_port: int = 29500,
                     verbose: bool = True,
                     timeout=None,
                     init_method: Optional[str] = None,
                     dist_init_required: Optional[bool] = None,
                     config=None,
                     rank: int = -1,
                     world_size: int = -1) -> None:
    """Start the default process group (once per process).

    The environment is read in the JAX package's precedence: this
    launcher's ``DS_TPU_COORDINATOR`` / ``DS_TPU_NUM_PROCESSES`` /
    ``DS_TPU_PROCESS_ID``, then torch's ``MASTER_ADDR`` (``MASTER_PORT``,
    else ``distributed_port``) / ``RANK`` / ``WORLD_SIZE``. With neither,
    a one-rank group on a free local port. ``dist_backend`` defaults to
    the accelerator's (``nccl`` on the card, ``gloo`` on the CPU); on
    ``nccl`` the process binds the card of its ``LOCAL_RANK``.
    """
    if dist.is_initialized():
        return
    env = os.environ
    coord = env.get("DS_TPU_COORDINATOR") or (
        f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', distributed_port)}"
        if "MASTER_ADDR" in env and "RANK" in env else None)
    if coord is not None:
        nproc = world_size if world_size > 0 else int(
            env.get("DS_TPU_NUM_PROCESSES", env.get("WORLD_SIZE", 1)))
        pid = rank if rank >= 0 else int(
            env.get("DS_TPU_PROCESS_ID", env.get("RANK", 0)))
    else:
        coord = f"127.0.0.1:{_free_port()}"
        nproc = world_size if world_size > 0 else 1
        pid = rank if rank >= 0 else 0
        if nproc > 1:
            raise ValueError(
                f"world_size={nproc} needs a rendezvous: launch with "
                f"deepspeed_tpu_torch.launcher.launch or set MASTER_ADDR / "
                f"MASTER_PORT / RANK / WORLD_SIZE")
    if dist_backend is None:
        from ..accelerator import get_accelerator
        dist_backend = get_accelerator().communication_backend_name()
    kwargs = {}
    if dist_backend == "nccl":
        local = get_local_rank()
        torch.cuda.set_device(local)
        # bind the communicator to its card at once (no lazy init on the
        # first collective)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        dist_backend, init_method=init_method or f"tcp://{coord}",
        world_size=nproc, rank=pid,
        timeout=timeout if timeout is not None else timedelta(minutes=10),
        **kwargs)
    if verbose:
        logger.info(f"torch.distributed initialized: backend={dist_backend} "
                    f"rank {pid}/{nproc} @ {coord}")


def is_initialized() -> bool:
    return dist.is_initialized()


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def get_backend(group=None) -> Optional[str]:
    return dist.get_backend(group) if dist.is_initialized() else None


def get_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def get_device_count() -> int:
    from ..accelerator import get_accelerator
    return get_accelerator().device_count()


def barrier(group=None):
    if dist.is_initialized():
        dist.barrier(group=group)


# ---------------------------------------------------------------------------
# Comms logging (reference utils/comms_logging.py + comm.py:101 timed_op)
# ---------------------------------------------------------------------------

def configure(comms_config=None, enabled=None, prof_all=None, prof_ops=None,
              verbose=None, debug=None):
    global _comms_logger
    from ..utils.comms_logging import CommsLogger

    if comms_config is not None:
        cl = comms_config.comms_logger if hasattr(comms_config, "comms_logger") else comms_config
        if getattr(cl, "enabled", False):
            _comms_logger = CommsLogger(verbose=cl.verbose, debug=cl.debug,
                                        prof_all=cl.prof_all, prof_ops=list(cl.prof_ops),
                                        world_size=get_world_size())
        else:   # re-applying a config with logging off disables it
            _comms_logger = None
    elif enabled:
        _comms_logger = CommsLogger(verbose=bool(verbose), debug=bool(debug),
                                    prof_all=prof_all is not False,
                                    prof_ops=list(prof_ops or []),
                                    world_size=get_world_size())
    elif enabled is False:   # explicit disable (None = leave unchanged)
        _comms_logger = None


def get_comms_logger():
    return _comms_logger


def log_summary(show_straggler: bool = False):
    if _comms_logger is not None:
        _comms_logger.log_summary(show_straggler=show_straggler)


def timed_op(fn):
    """Log a collective (reference comm/comm.py:101) through a
    ``utils.timer`` timer: CUDA events around the call on the card, so the
    latency is the collective's own time on the current stream (an
    ``async_op`` call records its enqueue only); the host clock on the
    CPU. The message size is the bytes of the tensor the caller
    contributes (a shard for the gathers and scatters)."""

    @functools.wraps(fn)
    def wrapper(*args, log_name=None, **kwargs):
        if _comms_logger is None:
            return fn(*args, **kwargs)
        from ..utils.timer import _Timer

        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        timer = _Timer(fn.__name__,
                       use_cuda=bool(tensors) and tensors[0].is_cuda)
        timer.start()
        out = fn(*args, **kwargs)
        timer.stop()
        msg = (tensors[0] if fn.__name__ == "reduce_scatter_tensor"
               else tensors[-1]) if tensors else None
        _comms_logger.append(log_name or fn.__name__, fn.__name__,
                             timer.elapsed(),
                             msg.numel() * msg.element_size()
                             if msg is not None else 0)
        return out

    return wrapper


# ---------------------------------------------------------------------------
# Collectives over the data-parallel group
# ---------------------------------------------------------------------------

class ReduceOp:
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PROD = "prod"


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN",
              ReduceOp.PROD: "PRODUCT", ReduceOp.AVG: "SUM"}


def resolve_group(group=None, axis_name="data"):
    """The process group of ``group`` or of the JAX package's mesh axis
    name(s); None is the default (world) group."""
    if group is not None:
        return group
    key = tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else axis_name
    if key in _AXIS_GROUPS:
        return _AXIS_GROUPS[key]
    names = key if isinstance(key, tuple) else (key,)
    bad = [a for a in names if a not in _DATA_AXES]
    if bad:
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(
                f"no process group for the {bad} mesh axes: build a "
                f"MeshTopology with them (parallel/topology.py) first")
        return None     # one rank: every axis is the whole world
    return None


# the flat-tensor collectives under their newer names where torch has
# them (the ``*_into_tensor`` / ``*_tensor`` names are deprecated there)
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def _op(op):
    return getattr(dist.ReduceOp, _TORCH_OPS[op])


class _Done:
    """The handle an ``async_op`` call returns where nothing ran."""

    def wait(self, timeout=None):
        return True

    def is_completed(self):
        return True


@timed_op
def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM, group=None,
               async_op: bool = False, axis_name="data"):
    """In place over the group (reference comm/comm.py:483). ``AVG`` is a
    sum divided by the group size (gloo has no average); it cannot be
    ``async_op``."""
    group = resolve_group(group, axis_name)
    if op == ReduceOp.AVG and async_op:
        raise ValueError("all_reduce(op=AVG) is synchronous; issue a SUM "
                         "and divide after wait()")
    if not dist.is_initialized():
        return _Done() if async_op else None
    work = dist.all_reduce(tensor, op=_op(op), group=group,
                           async_op=async_op)
    if op == ReduceOp.AVG:
        tensor.div_(dist.get_world_size(group))
    return work


def inference_all_reduce(tensor, op: str = ReduceOp.SUM, group=None,
                         axis_name="model"):
    """The tensor-parallel all-reduce (JAX comm.py:213), in place over the
    model axis's group (or ``group``)."""
    return all_reduce(tensor, op=op, group=resolve_group(group, axis_name))


@timed_op
def all_gather_into_tensor(output_tensor: torch.Tensor,
                           input_tensor: torch.Tensor, group=None,
                           async_op: bool = False, axis_name="data"):
    """Rank-major concatenation of every rank's ``input_tensor`` into the
    flat ``output_tensor`` (reference comm/comm.py:297)."""
    group = resolve_group(group, axis_name)
    if not dist.is_initialized():
        output_tensor.view(-1).copy_(input_tensor.reshape(-1))
        return _Done() if async_op else None
    return _all_gather_single(output_tensor, input_tensor, group=group,
                              async_op=async_op)


# capability probes (reference comm/comm.py:308,:239): both backends the
# port uses have the fused tensor collectives
def has_all_gather_into_tensor() -> bool:
    return True


def has_reduce_scatter_tensor() -> bool:
    return True


@timed_op
def reduce_scatter_tensor(output_tensor: torch.Tensor,
                          input_tensor: torch.Tensor, op: str = ReduceOp.SUM,
                          group=None, async_op: bool = False,
                          axis_name="data"):
    """Reduce the flat ``input_tensor`` over the group and keep this rank's
    contiguous ``1 / world`` of it in ``output_tensor`` (reference
    comm/comm.py:280)."""
    group = resolve_group(group, axis_name)
    if op == ReduceOp.AVG and async_op:
        raise ValueError("reduce_scatter_tensor(op=AVG) is synchronous")
    if not dist.is_initialized():
        output_tensor.view(-1).copy_(input_tensor.reshape(-1))
        return _Done() if async_op else None
    work = _reduce_scatter_single(output_tensor, input_tensor, op=_op(op),
                                  group=group, async_op=async_op)
    if op == ReduceOp.AVG:
        output_tensor.div_(dist.get_world_size(group))
    return work


@timed_op
def broadcast(tensor: torch.Tensor, src: int = 0, group=None,
              async_op: bool = False, axis_name="data"):
    group = resolve_group(group, axis_name)
    if not dist.is_initialized():
        return _Done() if async_op else None
    return dist.broadcast(tensor, src, group=group, async_op=async_op)


@timed_op
def all_to_all_single(output: torch.Tensor, input: torch.Tensor,
                      output_split_sizes=None, input_split_sizes=None,
                      group=None, async_op: bool = False,
                      axis_name="expert"):
    """Scatter ``input``'s dim-0 blocks to the ranks and gather theirs into
    ``output``, rank-major (reference comm/comm.py:331; equal blocks unless
    split sizes are given): the MoE expert dispatch."""
    group = resolve_group(group, axis_name)
    if not dist.is_initialized():
        output.copy_(input)
        return _Done() if async_op else None
    return dist.all_to_all_single(output, input, output_split_sizes,
                                  input_split_sizes, group=group,
                                  async_op=async_op)


all_to_all = all_to_all_single


# --- Megatron-style tensor-parallel boundary ops (JAX comm.py:222-262) ---

class _TPCopy(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: a replicated activation
    entering a column-parallel region (Megatron's ``f``). Over several
    tensors it is one node: its backward runs once, when every output's
    gradient is in (a zero for an unused one), and reduces them in the
    inputs' order, the same on every rank."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            g = g.contiguous()
            if get_world_size(ctx.group) > 1:
                g = g.clone()
                dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


class _TPReduce(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the partial outputs of
    a row-parallel region summed to the replicated activation (Megatron's
    ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        if get_world_size(group) <= 1:
            return x.view_as(x)
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x, axis_name="model", group=None):
    """Identity forward / all-reduce backward over the model group (JAX
    :224); the identity at one rank. ``x``: a tensor, or a list of them
    (returned as a list, their gradients reduced by one node)."""
    group = resolve_group(group, axis_name)
    if get_world_size(group) <= 1:
        return x
    if isinstance(x, (list, tuple)):
        return list(_TPCopy.apply(group, *x))
    return _TPCopy.apply(group, x)[0]


def tp_reduce(x: torch.Tensor, axis_name="model", group=None) -> torch.Tensor:
    """All-reduce forward / identity backward over the model group (JAX
    :246); the identity at one rank."""
    group = resolve_group(group, axis_name)
    if get_world_size(group) <= 1:
        return x
    return _TPReduce.apply(x, group)


# --- the Ulysses all-to-all (JAX sequence/layer.py:28) ---

def _all_to_all_dims(x, group, scatter_dim: int, gather_dim: int):
    world = get_world_size(group)
    if world == 1:
        return x
    # [world, ...] blocks of the scattered dim, rank-major
    parts = x.movedim(scatter_dim, 0)
    n = parts.shape[0] // world
    send = parts.reshape((world, n) + tuple(parts.shape[1:])).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[r]: rank r's block of our scattered slice; join on gather_dim
    recv = recv.movedim(1, scatter_dim + 1)
    return torch.cat(torch.unbind(recv, 0), dim=gather_dim).contiguous()


class _SeqAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scatter_dim, gather_dim):
        ctx.group, ctx.dims = group, (scatter_dim, gather_dim)
        return _all_to_all_dims(x, group, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, g):
        s, d = ctx.dims
        return _all_to_all_dims(g, ctx.group, d, s), None, None, None


def seq_all_to_all(x: torch.Tensor, scatter_dim: int, gather_dim: int,
                   axis_name="seq", group=None) -> torch.Tensor:
    """Scatter ``scatter_dim`` over the group and gather ``gather_dim``
    (JAX ``lax.all_to_all(tiled=True)``; the reference's
    ``_SeqAllToAll``), differentiable: its backward is the reverse
    all-to-all."""
    group = resolve_group(group, axis_name)
    if get_world_size(group) <= 1:
        return x
    return _SeqAllToAll.apply(x, group, scatter_dim, gather_dim)


# --- point-to-point over an axis (JAX :316-352) ---

def _global_rank(group, r: int) -> int:
    return dist.get_global_rank(group, r) if group is not None else r


def exchange(sends=(), recvs=(), axis_name="pipe", group=None):
    """Point-to-point transfers over an axis's group in one
    ``batch_isend_irecv``: ``sends`` are ``(tensor, dst)``, ``recvs``
    ``(out, src)`` (group ranks); the receives land in their ``out``
    tensors. Both ends of each transfer must name it in the same call
    (the pipeline derives both from one tick table). At one rank nothing
    may cross."""
    group = resolve_group(group, axis_name)
    ops = [dist.P2POp(dist.isend, t.contiguous(), _global_rank(group, d),
                      group) for t, d in sends]
    ops += [dist.P2POp(dist.irecv, o, _global_rank(group, s), group)
            for o, s in recvs]
    if not ops:
        return
    if get_world_size(group) == 1:
        raise ValueError("exchange: a transfer at one rank")
    for w in dist.batch_isend_irecv(ops):
        w.wait()


def permute(x, perm=None, axis_name="pipe", group=None):
    """``lax.ppermute``: each ``(src, dst)`` of ``perm`` (group ranks)
    sends ``src``'s tensor to ``dst``; a rank no pair sends to gets
    zeros. ``x`` is a tensor, or a list of tensors that all travel in
    one ``batch_isend_irecv`` (a list comes back). The pipe axis is the
    JAX default."""
    group = resolve_group(group, axis_name)
    many = isinstance(x, (list, tuple))
    xs = [t.contiguous() for t in (x if many else [x])]
    if get_world_size(group) == 1:
        keep = any(s == d == 0 for s, d in perm)
        outs = [t.clone() if keep else torch.zeros_like(t) for t in xs]
        return outs if many else outs[0]
    me = dist.get_rank(group)
    outs = [torch.zeros_like(t) for t in xs]
    exchange([(t, d) for s, d in perm if s == me for t in xs],
             [(o, s) for s, d in perm if d == me for o in outs],
             axis_name=axis_name, group=group)
    return outs if many else outs[0]


class _Permute(torch.autograd.Function):
    """``permute`` forward; the opposite permute of the cotangent
    backward (JAX's VJP of ``ppermute``). ``token`` orders the nodes: it
    passes from each permute to the next, so every rank runs the
    backward permutes in the reverse of the forward order."""

    @staticmethod
    def forward(ctx, x, token, perm, group):
        ctx.perm, ctx.group = perm, group
        return permute(x, perm, group=group), token.clone()

    @staticmethod
    def backward(ctx, g, g_token):
        back = [(d, s) for s, d in ctx.perm]
        return permute(g, back, group=ctx.group), g_token, None, None


def permute_grad(x, perm, token, axis_name="pipe", group=None):
    """Differentiable :func:`permute`: returns ``(received, token)``.
    Thread one ``token`` (a 0-d tensor that requires grad) through a
    sequence of calls and add the last one, times 0, to the loss: the
    backward permutes then run in reverse order on every rank, as
    point-to-point pairs must."""
    return _Permute.apply(x, token, perm, resolve_group(group, axis_name))


def _axis_world(axis_name, group) -> int:
    return get_world_size(resolve_group(group, axis_name))


def send_next(x, axis_name="pipe", n: Optional[int] = None, group=None):
    """Ring shift: rank i's ``x`` (a tensor or a list of tensors) goes to
    rank i + 1 (mod n); returns what rank i - 1 sent."""
    n = n or _axis_world(axis_name, group)
    return permute(x, [(i, (i + 1) % n) for i in range(n)], axis_name,
                   group)


def recv_prev(x, axis_name="pipe", n: Optional[int] = None, group=None):
    return send_next(x, axis_name, n, group)


def send_prev(x, axis_name="pipe", n: Optional[int] = None, group=None):
    n = n or _axis_world(axis_name, group)
    return permute(x, [(i, (i - 1) % n) for i in range(n)], axis_name,
                   group)


def axis_rank(axis_name="data") -> int:
    group = resolve_group(None, axis_name)
    return dist.get_rank(group) if dist.is_initialized() else 0


def axis_size(axis_name="data") -> int:
    return get_world_size(resolve_group(None, axis_name))


# dispatch helpers mirroring reference comm.py:315/:246
def allgather_fn(output_tensor, input_tensor, group=None, async_op=False):
    return all_gather_into_tensor(output_tensor, input_tensor, group=group,
                                  async_op=async_op)


def reduce_scatter_fn(output_tensor, input_tensor, op=ReduceOp.SUM,
                      group=None, async_op=False):
    return reduce_scatter_tensor(output_tensor, input_tensor, op=op,
                                 group=group, async_op=async_op)

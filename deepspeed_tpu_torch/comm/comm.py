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
   axes (``data``, ``shard``, ``expert``) are the default (world) group,
   since the port runs data parallelism only. Tensor, sequence, pipeline
   and expert groups come with ROADMAP A8, and their functions raise.

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

_UNPORTED = "ROADMAP A8 (parallel modes)"
# mesh axes whose groups the port has: the data-parallel world
_DATA_AXES = ("data", "shard", "expert")


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
    names = axis_name if isinstance(axis_name, (tuple, list)) else (axis_name,)
    bad = [a for a in names if a not in _DATA_AXES]
    if bad:
        raise NotImplementedError(
            f"collectives over the {bad} mesh axes are not ported to "
            f"deepspeed_tpu_torch yet ({_UNPORTED}); the port runs data "
            f"parallelism only")
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
    """The tensor-parallel all-reduce (JAX comm.py:213) over the model
    axis: ROADMAP A8."""
    resolve_group(group, axis_name)
    return all_reduce(tensor, op=op, group=group)


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


def _unported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"comm.{name} is not ported to deepspeed_tpu_torch yet "
            f"({_UNPORTED})")
    fn.__name__ = name
    return fn


# the tensor-, sequence- and pipeline-parallel primitives (JAX comm.py:222-
# 352): their groups come with A8
tp_copy = _unported("tp_copy")
tp_reduce = _unported("tp_reduce")
all_to_all_single = _unported("all_to_all_single")
all_to_all = all_to_all_single
permute = _unported("permute")
send_next = _unported("send_next")
recv_prev = _unported("recv_prev")
send_prev = _unported("send_prev")


def axis_rank(axis_name="data") -> int:
    return get_rank(resolve_group(None, axis_name))


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

"""Activation checkpointing (rematerialization).

Port of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``
(``configure`` :68, ``active_policy`` :108, ``checkpoint_wrapper`` :121).
The JAX default policy ``nothing_saveable`` saves only a layer's inputs and
re-runs the whole layer in backward; here that is
``torch.utils.checkpoint.checkpoint(fn, ..., use_reentrant=False)``.
``everything_saveable`` keeps every activation (no checkpoint at all).

``cpu_checkpointing`` is the JAX
``offload_dot_with_no_batch_dims("device", "pinned_host")`` policy: a
selective checkpoint that keeps the outputs of the matmuls without batch
dimensions (``mm`` / ``addmm``: activations against a 2-D weight) in host
memory instead of recomputing them, and recomputes everything else. The
checkpoint's ``context_fn`` installs two dispatch modes: in the forward
each such output is copied to page-locked host memory on a side stream
(``non_blocking``, an event recorded after the copy, the device tensor
kept alive for the side stream until the copy ends); in the recompute the
same calls, in the same order, return the host copies brought back to
the device after that event, and every other op runs again. The saved
outputs live in the checkpoint's own cache, not in autograd's saved
tensors, so ``saved_tensors_hooks`` never see them; the modes are where
they pass. The results are ``nothing_saveable``'s bit for bit: the key
only trades the matmuls' recompute for two copies of their outputs over
PCIe, which on an H100 costs more than the recompute it spares (README,
``chip_smoke.py`` phase 8d). It is here for parity with the JAX config.

Not ported yet (raise ``NotImplementedError``): the selective policies
``save_attn`` / ``save_dots_and_attn`` and the other jax policy names
(ROADMAP A3).
"""

from collections import deque
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

_DEFAULTS: Dict[str, Any] = {
    "partition_activations": False,
    "cpu_checkpointing": False,
    "contiguous_memory_optimization": False,
    "number_checkpoints": None,
    "synchronize_checkpoint_boundary": False,
    "profile": False,
    "policy": "nothing_saveable",
}
_config: Dict[str, Any] = dict(_DEFAULTS)
_POLICIES = ("nothing_saveable", "everything_saveable")
# cpu_checkpointing's policy, named as JAX names it
OFFLOAD_DOTS = "offload_dot_with_no_batch_dims"


def _resolve_policy(name: str, cpu_checkpointing: bool = False) -> str:
    if cpu_checkpointing:
        return OFFLOAD_DOTS
    if name not in _POLICIES:
        raise NotImplementedError(
            f"activation-checkpointing policy {name!r} is not ported to "
            f"deepspeed_tpu_torch yet (ROADMAP A3); ported: {_POLICIES}")
    return name


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None,
              policy=None):
    """Reference configure() signature (checkpointing.py:1057); also accepts
    the ActivationCheckpointingConfig dataclass via deepspeed_config."""
    if deepspeed_config is not None:
        ac = getattr(deepspeed_config, "activation_checkpointing",
                     deepspeed_config)
        _config.update(
            partition_activations=ac.partition_activations,
            cpu_checkpointing=ac.cpu_checkpointing,
            contiguous_memory_optimization=ac.contiguous_memory_optimization,
            number_checkpoints=ac.number_checkpoints,
            synchronize_checkpoint_boundary=ac.synchronize_checkpoint_boundary,
            profile=ac.profile,
            policy=ac.policy,
        )
    overrides = {
        "partition_activations": partition_activations,
        "contiguous_memory_optimization": contiguous_checkpointing,
        "number_checkpoints": num_checkpoints,
        "cpu_checkpointing": checkpoint_in_cpu,
        "synchronize_checkpoint_boundary": synchronize,
        "profile": profile,
        "policy": policy,
    }
    _config.update({k: v for k, v in overrides.items() if v is not None})
    _resolve_policy(_config["policy"], _config["cpu_checkpointing"])


def active_policy() -> str:
    return _resolve_policy(_config["policy"], _config["cpu_checkpointing"])


def _dot_ops():
    aten = torch.ops.aten
    return (aten.mm.default, aten.addmm.default)


def _to_host(t: torch.Tensor, side):
    """(host copy, event after the copy): page-locked and asynchronous on
    the card, on the side stream ``side``; a plain copy on the CPU."""
    if t.device.type != "cuda":
        return t.clone(), None
    side.wait_stream(torch.cuda.current_stream(t.device))
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(side):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    t.record_stream(side)
    return host, done


def _to_device(saved, device: torch.device) -> torch.Tensor:
    host, done = saved
    if done is None:
        return host
    torch.cuda.current_stream(device).wait_event(done)
    return host.to(device, non_blocking=True)


class _OffloadDots(TorchDispatchMode):
    """Forward of a checkpointed region: each weight matmul's output is
    copied to host memory, in call order."""

    def __init__(self, saved: deque):
        super().__init__()
        self.saved = saved
        self.dots = _dot_ops()
        self.side = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.dots:
            if self.side is None and out.device.type == "cuda":
                self.side = torch.cuda.Stream(out.device)
            self.saved.append((_to_host(out, self.side), out.device))
        return out


class _RestoreDots(TorchDispatchMode):
    """Recompute of the same region: the weight matmuls return their host
    copies, in the same order; every other op runs again."""

    def __init__(self, saved: deque):
        super().__init__()
        self.saved = saved
        self.dots = _dot_ops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.dots and self.saved:
            copy, device = self.saved.popleft()
            return _to_device(copy, device)
        return func(*args, **(kwargs or {}))


def _offload_dot_contexts():
    saved: deque = deque()
    return _OffloadDots(saved), _RestoreDots(saved)


def checkpoint_wrapper(function: Callable,
                       policy_name: Optional[str] = None) -> Callable:
    """Wrap once, call many times (what models use around a layer body).
    The layer bodies draw no random numbers, so the RNG state is not
    stashed and restored around the recompute."""
    pol = (_resolve_policy(policy_name) if policy_name is not None
           else active_policy())
    if pol == "everything_saveable":
        return function
    if pol == OFFLOAD_DOTS:
        def wrapped(*args):
            if not torch.is_grad_enabled():    # nothing is saved
                return function(*args)
            return torch.utils.checkpoint.checkpoint(
                function, *args, use_reentrant=False,
                preserve_rng_state=False, context_fn=_offload_dot_contexts)

        return wrapped

    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(
            function, *args, use_reentrant=False, preserve_rng_state=False)

    return wrapped


def reset():
    """Testing hook: restore defaults."""
    _config.clear()
    _config.update(_DEFAULTS)

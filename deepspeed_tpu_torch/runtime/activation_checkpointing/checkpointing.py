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

The selective policies keep some outputs on the card and recompute the
rest (JAX :43-65 and ``jax.checkpoint_policies``):

* ``dots_with_no_batch_dims_saveable`` (alias
  ``checkpoint_dots_with_no_batch_dims``): the outputs of ``mm`` /
  ``addmm`` (activations against a 2-D weight), the on-card twin of
  ``cpu_checkpointing``'s selection;
* ``dots_saveable`` (alias ``checkpoint_dots``): those and the batched
  ``bmm`` / ``baddbmm`` outputs;
* ``save_attn``: the attention output, named ``attn_out`` as the JAX
  model tags it (``models/transformer.py:591,604``);
* ``save_dots_and_attn``: both of the first and the third.

Dots are kept by the same pair of dispatch modes as ``cpu_checkpointing``
(kept on the card, no copy). The attention output cannot be: the flash
forward is a ``torch.autograd.Function`` whose kernel is a bound C call,
which no dispatch mode sees. So the flash op names its result itself
(:func:`named_output` around ``flash_fwd`` in
``ops/flash_attention._FlashCore``): under a policy that keeps
``attn_out`` the checkpoint's forward keeps the kernel's ``(o, lse)``
and its recompute returns them without launching the kernel. ``lse``
(f32, one value per query row: 1/64 of ``o`` at head_dim 128 in bf16) is
kept with ``o`` because the flash backward needs both; keeping ``o``
alone would run the forward kernel again in backward, as JAX's
``save_only_these_names("attn_out")`` does for its Pallas call. A step
under ``save_attn`` launches ``flash_fwd`` L x gas times instead of 2 x L
x gas. The plain attention path (no flash kernel) keeps nothing under
the name: its backward needs the softmax probabilities, not the output,
so it recomputes as under ``nothing_saveable``. Every policy computes the
same values as ``nothing_saveable``: it changes what is kept, not what is
computed.

The other names of ``jax.checkpoint_policies`` are factories of policies
(``save_only_these_names``, ``save_anything_except_these_names``,
``offload_dot_with_no_batch_dims`` as a policy name, ...). The JAX
package hands such a name's factory to ``jax.checkpoint`` as the policy
itself, which then fails with ``TypeError`` when the checkpoint is
differentiated, so no JAX run takes them; here they raise ``ValueError``
at :func:`configure`, as an unknown name does in both packages.
"""

import threading
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
POLICIES = ("nothing_saveable", "everything_saveable", "save_attn",
             "save_dots_and_attn", "dots_with_no_batch_dims_saveable",
             "checkpoint_dots_with_no_batch_dims", "dots_saveable",
             "checkpoint_dots")
# what each selective policy keeps: (dot-op family, output names)
_KEEP = {"save_attn": ("", ("attn_out",)),
         "save_dots_and_attn": ("no_batch", ("attn_out",)),
         "dots_with_no_batch_dims_saveable": ("no_batch", ()),
         "checkpoint_dots_with_no_batch_dims": ("no_batch", ()),
         "dots_saveable": ("all", ()),
         "checkpoint_dots": ("all", ())}
# cpu_checkpointing's policy, named as JAX names it
OFFLOAD_DOTS = "offload_dot_with_no_batch_dims"
# the factories among the jax.checkpoint_policies names (jax 0.9.0)
FACTORIES = ("save_only_these_names", "save_anything_except_these_names",
             "save_any_names_but_these", "save_and_offload_only_these_names",
             "save_from_both_policies", OFFLOAD_DOTS)


def _resolve_policy(name: str, cpu_checkpointing: bool = False) -> str:
    if cpu_checkpointing:
        return OFFLOAD_DOTS
    if name in FACTORIES:
        raise ValueError(
            f"activation-checkpointing policy {name!r} names a factory of "
            f"jax.checkpoint_policies, not a policy: the JAX package cannot "
            f"run it either (jax.checkpoint raises TypeError when it is "
            f"differentiated); policies: {POLICIES}")
    if name not in POLICIES:
        raise ValueError(
            f"unknown activation-checkpointing policy {name!r}; policies: "
            f"{POLICIES}")
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


def _dot_ops(family: str = "no_batch"):
    aten = torch.ops.aten
    if family == "all":
        return (aten.mm.default, aten.addmm.default, aten.bmm.default,
                aten.baddbmm.default)
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


class _ToHost:
    """Moves a dot output to page-locked host memory, on a side stream
    made at first use: ((host copy, event), device)."""

    def __init__(self):
        self.side = None

    def __call__(self, out: torch.Tensor):
        if self.side is None and out.device.type == "cuda":
            self.side = torch.cuda.Stream(out.device)
        return _to_host(out, self.side), out.device


def _offload_dot_contexts():
    saved: deque = deque()
    dots = _dot_ops()
    return (_SaveDots(saved, dots, _ToHost()),
            _RestoreDots(saved, dots, lambda item: _to_device(*item)))


# the names the running checkpoint keeps, per thread (a recompute runs on
# the thread of the backward that needs it)
_local = threading.local()


def named_output(name: str, compute: Callable[[], Any]) -> Any:
    """``compute()``, kept under ``name`` by a selective checkpoint whose
    policy keeps that name: its forward stores the result (detached
    aliases of its tensors, no copy), its recompute returns the stored
    result without calling ``compute``. Anywhere else, just
    ``compute()``."""
    keep = getattr(_local, "keep", None)
    if keep is None or name not in keep[0]:
        return compute()
    names, store, replay = keep
    if replay:
        return store.popleft()
    out = compute()
    store.append(tuple(t.detach() for t in out)
                 if isinstance(out, tuple) else out.detach())
    return out


class _Named:
    """Sets the running checkpoint's kept names on this thread."""

    def __init__(self, names, store: deque, replay: bool):
        self.state = (frozenset(names), store, replay)
        self.prev = None

    def __enter__(self):
        self.prev = getattr(_local, "keep", None)
        _local.keep = self.state
        return self

    def __exit__(self, *exc):
        _local.keep = self.prev
        return False


class _SaveDots(TorchDispatchMode):
    """Forward of a checkpointed region: each dot's output goes into
    ``saved`` through ``move`` (to host memory for ``cpu_checkpointing``,
    a detached alias on the card for the selective policies), in call
    order; ``named``, if given, sets the region's kept names while the
    mode is on."""

    def __init__(self, saved: deque, dots, move: Callable,
                 named: Optional[_Named] = None):
        super().__init__()
        self.saved, self.dots, self.move, self.named = saved, dots, move, \
            named

    def __enter__(self):
        if self.named is not None:
            self.named.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self.named is not None:
                self.named.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.dots:
            self.saved.append(self.move(out))
        return out


class _RestoreDots(_SaveDots):
    """Recompute of the same region: the dots return their saved outputs
    (through ``move``, back to the card where they left it), in the same
    order; every other op runs again."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.dots and self.saved:
            return self.move(self.saved.popleft())
        return func(*args, **(kwargs or {}))


def _selective_contexts(policy: str):
    family, names = _KEEP[policy]

    def contexts():
        named_store: deque = deque()
        fwd = _Named(names, named_store, replay=False)
        rec = _Named(names, named_store, replay=True)
        if not family:
            return fwd, rec
        dots, saved = _dot_ops(family), deque()
        return (_SaveDots(saved, dots, torch.Tensor.detach, fwd),
                _RestoreDots(saved, dots, lambda t: t, rec))

    return contexts


def checkpoint_wrapper(function: Callable,
                       policy_name: Optional[str] = None) -> Callable:
    """Wrap once, call many times (what models use around a layer body).
    The layer bodies draw no random numbers, so the RNG state is not
    stashed and restored around the recompute."""
    pol = (_resolve_policy(policy_name) if policy_name is not None
           else active_policy())
    if pol == "everything_saveable":
        return function
    if pol == OFFLOAD_DOTS or pol in _KEEP:
        context_fn = (_offload_dot_contexts if pol == OFFLOAD_DOTS
                      else _selective_contexts(pol))

        def wrapped(*args):
            if not torch.is_grad_enabled():    # nothing is saved
                return function(*args)
            return torch.utils.checkpoint.checkpoint(
                function, *args, use_reentrant=False,
                preserve_rng_state=False, context_fn=context_fn)

        return wrapped

    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(
            function, *args, use_reentrant=False, preserve_rng_state=False)

    return wrapped


def reset():
    """Testing hook: restore defaults."""
    _config.clear()
    _config.update(_DEFAULTS)

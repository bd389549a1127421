"""Activation checkpointing (rematerialization).

Port of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``
(``configure`` :68, ``active_policy`` :108, ``checkpoint_wrapper`` :121).
The JAX default policy ``nothing_saveable`` saves only a layer's inputs and
re-runs the whole layer in backward; here that is
``torch.utils.checkpoint.checkpoint(fn, ..., use_reentrant=False)``.
``everything_saveable`` keeps every activation (no checkpoint at all).

Not ported yet (raise ``NotImplementedError``): the selective policies
``save_attn`` / ``save_dots_and_attn`` and the other jax policy names
(ROADMAP A3), and ``cpu_checkpointing`` (ROADMAP A9).
"""

from typing import Any, Callable, Dict, Optional

import torch.utils.checkpoint

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


def _resolve_policy(name: str, cpu_checkpointing: bool = False) -> str:
    if cpu_checkpointing:
        raise NotImplementedError(
            "activation_checkpointing.cpu_checkpointing is not ported to "
            "deepspeed_tpu_torch yet (ROADMAP A9)")
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


def checkpoint_wrapper(function: Callable,
                       policy_name: Optional[str] = None) -> Callable:
    """Wrap once, call many times (what models use around a layer body).
    The layer bodies draw no random numbers, so the RNG state is not
    stashed and restored around the recompute."""
    pol = (_resolve_policy(policy_name) if policy_name is not None
           else active_policy())
    if pol == "everything_saveable":
        return function

    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(
            function, *args, use_reentrant=False, preserve_rng_state=False)

    return wrapped


def reset():
    """Testing hook: restore defaults."""
    _config.clear()
    _config.update(_DEFAULTS)

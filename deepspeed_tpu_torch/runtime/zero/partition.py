"""ZeRO partitioning: which dimension of each leaf a rank holds a shard of.

Port of ``deepspeed_tpu/runtime/zero/partition.py`` (``add_zero_axes`` :43,
``ZeroPlan`` / ``build_zero_plan`` :86-168, ``estimate_zero_memory`` :170).
The JAX package states the plan as sharding specs and lets XLA insert the
collectives; here the plan records, for each leaf, the dimension its ZeRO
shard is cut along (or None: replicated), and the engine issues the
collectives itself (reference stage_1_and_2.py:96, stage3.py:72):

  stage 1: master weights and moments sharded -> each rank updates its
           shard, then the params are all-gathered;
  stage 2: + gradients sharded -> reduce-scatter instead of all-reduce;
  stage 3: + parameters sharded -> all-gathered on use in the forward and
           again in the recompute (``comm/quantized.make_zero3_gather``).

The dimension is the JAX choice: the largest dimension divisible by the
ZeRO world. Compute params below ``stage3_param_persistence_threshold``
elements stay replicated (their master is still sharded). One difference:
at world 1 the JAX plan is replicated, while this plan keeps the
dimensions — one shard is the whole leaf, so a one-rank run goes through
every collective of the sharded path (each a copy).
"""

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def _numel(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def zero_dim(shape: Sequence[int], zero_size: int, threshold: int = 0,
             free=None) -> Optional[int]:
    """The dimension a ZeRO shard is cut along: the largest of the ``free``
    dimensions (all by default) divisible by ``zero_size`` (the first on a
    tie); None below ``threshold`` elements or when none divides."""
    if threshold and _numel(shape) < threshold:
        return None
    free = range(len(shape)) if free is None else free
    candidates = [(d, shape[d]) for d in free if shape[d] % zero_size == 0]
    if not candidates:
        return None
    return max(candidates, key=lambda t: t[1])[0]


def add_zero_axes(shape: Tuple[int, ...],
                  base_spec: Optional[tuple],
                  zero_axes: Tuple[str, ...],
                  zero_size: int,
                  threshold: int = 0,
                  axis_sizes: Optional[dict] = None) -> tuple:
    """Extend ``base_spec`` (a partition spec as a tuple of axis names,
    tuples of them, or None per dimension) with the ZeRO axes on the best
    free dimension — the JAX function, spec for spec. Returns the base
    spec unchanged when nothing qualifies, when the ZeRO world is 1 or the
    tensor is below the persistence threshold."""
    base = tuple(base_spec) if base_spec is not None else ()
    base = base + (None,) * (len(shape) - len(base))
    used = set()
    for entry in base:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                used.add(a)
    free_axes = tuple(a for a in zero_axes if a not in used)
    if axis_sizes is not None:
        zero_size = 1
        for a in free_axes:
            zero_size *= axis_sizes[a]
    if not free_axes or zero_size <= 1:
        return base
    dim = zero_dim(shape, zero_size, threshold,
                   free=[d for d in range(len(shape)) if base[d] in (None, ())])
    if dim is None:
        return base
    new = list(base)
    new[dim] = free_axes if len(free_axes) > 1 else free_axes[0]
    return tuple(new)


@dataclass
class ZeroPlan:
    """Per-leaf shard dimensions of one training state, keyed by the
    leaf's path (``"layers/wq"``); None is replicated."""

    stage: int
    world: int
    param_dims: Dict[str, Optional[int]]   # compute params (fwd/bwd)
    grad_dims: Dict[str, Optional[int]]    # reduced gradients
    master_dims: Dict[str, Optional[int]]  # fp32 master + optimizer moments

    def sharded(self) -> bool:
        return any(d is not None for d in self.master_dims.values())


def build_zero_plan(world: int, stage: int,
                    param_shapes: Dict[str, Tuple[int, ...]],
                    persistence_threshold: int = 0) -> ZeroPlan:
    """The plan of ``stage`` over a ZeRO world of ``world`` ranks for the
    leaves ``{path: shape}`` (JAX ``build_zero_plan``: master, moments and
    gradient shards always partition; stage-3 compute params only from
    ``persistence_threshold`` elements up)."""
    none = {k: None for k in param_shapes}
    opt = {k: zero_dim(s, world) for k, s in param_shapes.items()}
    if stage <= 0:
        return ZeroPlan(stage, world, none, none, none)
    if stage == 1:
        return ZeroPlan(stage, world, none, none, opt)
    if stage == 2:
        return ZeroPlan(stage, world, none, opt, opt)
    param3 = {k: zero_dim(s, world, persistence_threshold)
              for k, s in param_shapes.items()}
    return ZeroPlan(stage, world, param3, opt, opt)


def estimate_zero_memory(param_count: int, stage: int, dp: int,
                         bytes_per_param_low: int = 2) -> dict:
    """Model-state memory per device, the reference's 4+K breakdown
    (ZeRO paper / docs/_pages/training.md:67): 2-byte params, 2-byte grads,
    12-byte fp32 master+moments for Adam."""
    p, g, o = 2, 2, 12
    if stage >= 1:
        o /= dp
    if stage >= 2:
        g /= dp
    if stage >= 3:
        p /= dp
    total = param_count * (p + g + o)
    return {"params_bytes": param_count * p, "grads_bytes": param_count * g,
            "optstate_bytes": param_count * o, "total_bytes": total}

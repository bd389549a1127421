"""Cross-rank consistency and non-finite checks (safe mode).

Port of ``deepspeed_tpu/utils/sanity.py``: ``check_replicated_consistency``
(:35), ``check_cross_process_value`` (:73), ``find_nonfinite`` (:94) and
``check_engine_sanity`` (:114) — the reference's ZeRO-3 safe-mode checks
(``assert_ints_same_as_other_ranks``, stage3.py:1152; the NaN/Inf scan,
stage3.py:2055) that catch a desync before it reaches a checkpoint.

A JAX array knows its sharding; a rank's tensor here does not, so the
caller names the group whose ranks must hold the same bits. A leaf's
fingerprint is two int64 sums over its bit pattern (a plain sum and a
position-weighted one, on the leaf's device, in chunks), all-gathered
over the group: any rank whose fingerprint differs from rank 0's is
reported. ``check_engine_sanity`` picks the group of each leaf of a
training engine: the whole world for a leaf no axis cuts, the ranks of one
tensor-parallel index for a tensor-parallel slice, the ranks holding the
same experts for an expert leaf under expert parallelism, and under MiCS
the replica group for a ZeRO shard; the step counters are compared over
the world. Paths read as JAX's ``keystr`` (``params['layers']['wq']``).
"""

from typing import Any, Dict, List, Tuple

import torch

from ..comm import comm

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_CHUNK = 1 << 24


def _leaf_paths(tree, prefix="") -> List[Tuple[str, Any]]:
    """(JAX keystr path, leaf) in the pytree order (sorted dict keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaf_paths(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_leaf_paths(v, f"{prefix}[{i}]"))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _fingerprint(t: torch.Tensor) -> torch.Tensor:
    """[2] int64 on the tensor's device: the sum of its elements' bit
    patterns and their sum weighted by (position mod 65521) + 1."""
    flat = t.detach().contiguous().reshape(-1)
    flat = flat.view(_BITS[flat.element_size()])
    out = torch.zeros(2, dtype=torch.int64, device=flat.device)
    for a in range(0, flat.numel(), _CHUNK):
        c = flat[a:a + _CHUNK].to(torch.int64)
        w = torch.arange(a, a + c.numel(), device=c.device) % 65521 + 1
        out[0] += c.sum()
        out[1] += (c * w).sum()
    return out


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """[world, ...] of every rank's ``x`` over ``group``."""
    import torch.distributed as dist

    world = comm.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def check_replicated_consistency(tree, name: str = "params",
                                 group=None) -> List[str]:
    """Desync descriptions (empty: consistent): every tensor leaf of
    ``tree`` must hold the same bits on every rank of ``group`` (None: the
    default group). A collective: every rank of the group calls it on a
    tree of the same structure."""
    leaves = [(p, v) for p, v in _leaf_paths(tree)
              if isinstance(v, torch.Tensor)]
    world = comm.get_world_size(group)
    if world <= 1 or not leaves:
        return []
    dev = leaves[0][1].device
    mine = torch.stack([_fingerprint(v).to(dev) for _, v in leaves])
    every = _gather(mine, group).cpu()
    problems = []
    for i, (path, _) in enumerate(leaves):
        bad = [r for r in range(world)
               if not torch.equal(every[r, i], every[0, i])]
        if bad:
            problems.append(f"{name}{path}: replicated tensor differs "
                            f"between group ranks 0 and {bad}")
    return problems


def check_cross_process_value(value, label: str = "value",
                              group=None) -> List[str]:
    """A host scalar must agree on every rank of ``group`` (the reference's
    same-as-other-ranks int assert). No-op at one rank."""
    world = comm.get_world_size(group)
    if world <= 1:
        return []
    dev = "cuda" if comm.get_backend(group) == "nccl" else "cpu"
    mine = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    every = _gather(mine, group)[:, 0].cpu()
    if not bool((every == every[0]).all()):
        return [f"{label}: processes disagree "
                f"({dict(enumerate(every.tolist()))})"]
    return []


def find_nonfinite(tree, name: str = "params") -> List[str]:
    """Tree paths holding NaN / Inf, with their counts (reference
    ``_has_inf_or_nan``, the tensor named). One reduction per floating
    leaf on its device."""
    import numpy as np

    bad = []
    for path, leaf in _leaf_paths(tree):
        if isinstance(leaf, np.ndarray):
            if leaf.dtype.kind != "f":
                continue
            n = int((~np.isfinite(leaf)).sum())
            size = int(leaf.size)
        elif isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            n = int((~torch.isfinite(leaf.detach())).sum())
            size = leaf.numel()
        else:
            continue
        if n:
            bad.append(f"{name}{path}: {n}/{size} non-finite values")
    return bad


def _engine_groups(engine, dims) -> Dict[Any, List[int]]:
    """Leaf indices by the group whose ranks hold the same bits of them:
    the world (key ``"world"``) for a leaf no axis cuts, the ranks of the
    same coordinates on the axes that cut a slice (tensor, seq, pipe, and
    the expert axis for an expert leaf at ep > 1; a whole expert leaf is
    held alike by the ranks of its expert index), the MiCS replica group
    (an expert leaf's has no expert axis) for a ZeRO shard under MiCS
    (elsewhere a shard is this rank's own)."""
    from ..parallel.topology import AXIS_ORDER

    topo = engine.topology
    cuts = getattr(engine, "_cuts", {})
    expert_dims = (getattr(engine, "_expert_dims", {})
                   if getattr(engine, "ep", 1) > 1 else {})
    replica = getattr(engine, "_replica", {})
    out: Dict[Any, List[int]] = {}
    for i, (n, d) in enumerate(zip(engine._leaf_names, dims)):
        if d is not None:
            if not replica:
                continue
            key = ("replica", replica[n in expert_dims][0])
        else:
            # the axes whose ranks hold other slices: those that cut the
            # leaf, and for an expert leaf the expert axis (other experts)
            drop = set(cuts.get(n, {})) | (
                {"expert"} if n in expert_dims else set())
            if not drop:
                key = ("world", None)
            else:
                axes = tuple(a for a in AXIS_ORDER if a not in drop)
                key = ("same_" + "_".join(sorted(drop)), topo.group(axes))
        out.setdefault(key, []).append(i)
    return out


def check_engine_sanity(engine, check_finite: bool = True,
                        raise_on_error: bool = True) -> Dict[str, Any]:
    """The safe-mode sweep over a training engine (JAX :114): replicated
    params and master consistent across the ranks that must hold them
    alike, the step counters agreed, optionally the NaN / Inf scan of
    params and optimizer state. Returns the report; raises
    ``RuntimeError`` on problems unless told not to. Every rank calls
    it."""
    problems: List[str] = []
    sets = [("params", engine._param_leaves, engine._pdims)]
    if getattr(engine, "_master_leaves", None) is not None:
        sets.append(("master_params", engine._master_leaves, engine._odims))
    from ..runtime.engine import _unflatten

    names = engine._leaf_names
    for label, leaves, dims in sets:
        # the same labels in the same order on every rank
        for (_, group), idx in sorted(_engine_groups(engine, dims).items(),
                                      key=lambda kv: kv[0][0]):
            sub = _unflatten([(names[i], leaves[i]) for i in idx])
            problems += check_replicated_consistency(sub, label, group)
    problems += check_cross_process_value(engine.global_steps,
                                          "global_steps")
    problems += check_cross_process_value(engine._step, "device_step")
    if check_finite:
        problems += find_nonfinite(engine.params, "params")
        if getattr(engine, "opt_state", None):
            problems += find_nonfinite(engine.opt_state, "opt_state")
    report = {"ok": not problems, "problems": problems}
    if problems and raise_on_error:
        raise RuntimeError("sanity check failed:\n  " +
                           "\n  ".join(problems))
    return report

"""Bucketed gradient reduction, overlapped with the backward.

Port of ``deepspeed_tpu/runtime/grad_overlap.py``: the unit and bucket
plan (``GradUnit`` … ``build_bucket_plan`` :68-240, copied), the mode
resolution (``overlap_blockers`` / ``resolve_overlap_mode`` :563-645) and,
in place of the JAX manual ``shard_map`` program (``make_overlapped_grad_fn``
:648, ``apply_bucketed_reduction`` :384), :class:`BucketedReducer`:

  * the gradient tree is cut into units — whole leaves, and the per-layer
    slices of the stacked ``[L, ...]`` layer leaves — in production order
    (reversed: the loss-head end and the last layer finish their backward
    first) and packed into size-capped buckets
    (``zero_optimization.reduce_bucket_size`` / ``allgather_bucket_size``,
    in elements, as the reference counts them);
  * in the last micro-batch of a step, a gradient hook on each unit's
    tensor (the leaf, or the per-layer view the model's layer loop walks)
    copies the unit's accumulated gradient into its bucket's flat buffer;
    the hook only copies, so ``torch.autograd.grad`` returns what it would
    without it;
  * a full bucket issues one asynchronous collective on its flat buffer —
    ``all_reduce`` (then the mean) for replicated gradients (ZeRO 0/1),
    ``reduce_scatter_tensor`` for sharded ones (ZeRO 2 and stage 3's
    persistent leaves) — while the backward goes on. Buckets are issued in
    plan order on every rank, whatever order the hooks fire in.

Stage-3 leaves gathered through ``make_zero3_gather`` are reduced by the
gather's backward (the JAX ``VJP`` kind) and stay out of the buckets.

``overlap_grad_reduce="off"`` reduces after the backward, leaf by leaf, in
tree order (:func:`reduce_leaves`). Both give the same per-element sums:
packing never mixes elements, and a sum of two ranks' values does not
depend on the order the backend adds them in; from three ranks on, a
backend may add in a layout-dependent order. The flat buffers place each
unit at a 256-byte boundary, so a unit read back from a bucket is as
aligned as a fresh allocation.

Not ported: the quantized transports (ZeRO++ qgZ, ``quantized_reduce``'s
rings, ``quant_reduce_layout``), ROADMAP A10.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..comm import comm
from ..comm.quantized import reduce_scatter_leaf

# leaf reduction categories
VJP = "vjp"                      # reduced by the stage-3 gather's VJP
REDUCE_SCATTER = "reduce_scatter"  # dim-sharded grad: bucketed reduce-scatter
ALL_REDUCE = "all_reduce"        # replicated grad: bucketed all-reduce (mean)
CROSS_GROUP = "cross_group"      # hpZ: cross-group mean of a VJP-reduced leaf

# 256 bytes of f32: where every unit of a flat bucket starts
ALIGN_ELEMS = 64

_UNPORTED = "ROADMAP A10 (quantized communication)"


@dataclass(frozen=True)
class GradUnit:
    """One reducible unit: a whole grad leaf, or one layer-slice of a
    stacked layer leaf (``layer >= 0``)."""

    leaf: int          # flat leaf index in the grad pytree
    layer: int         # -1 = whole leaf; else slice index along dim 0
    numel: int
    name: str
    kind: str


@dataclass(frozen=True)
class GradBucket:
    """One fused collective: the units (by position in plan.units) it
    carries."""

    kind: str
    indices: Tuple[int, ...]
    numel: int
    nbytes: int


@dataclass
class GradBucketPlan:
    """Static partition of the gradient tree into collective buckets."""

    buckets: Tuple[GradBucket, ...]
    units: Tuple[GradUnit, ...]
    vjp_leaves: Tuple[str, ...]
    reduce_bucket_numel: int
    allreduce_bucket_numel: int

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def max_bucket_bytes(self) -> int:
        return max((b.nbytes for b in self.buckets), default=0)

    @property
    def total_bucket_bytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)

    def layout_key(self) -> Tuple:
        """Hashable identity of the collective layout."""
        return tuple(
            (b.kind, tuple((self.units[u].leaf, self.units[u].layer)
                           for u in b.indices))
            for b in self.buckets)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "reduce_bucket_size": self.reduce_bucket_numel,
            "allgather_bucket_size": self.allreduce_bucket_numel,
            "num_buckets": self.num_buckets,
            "max_bucket_bytes": self.max_bucket_bytes,
            "total_bucket_bytes": self.total_bucket_bytes,
            "vjp_leaves": list(self.vjp_leaves),
            "buckets": [{
                "kind": b.kind,
                "numel": b.numel,
                "bytes": b.nbytes,
                "leaves": [self.units[u].name for u in b.indices],
            } for b in self.buckets],
        }

    def summary(self) -> str:
        lines = [f"grad buckets: {self.num_buckets} "
                 f"(cap {self.reduce_bucket_numel} elems, "
                 f"largest {self.max_bucket_bytes / 2 ** 20:.1f} MiB)"]
        for b in self.buckets:
            lines.append(f"  [{b.kind:<14}] {b.numel:>10} elems x "
                         f"{len(b.indices)} units")
        if self.vjp_leaves:
            lines.append(f"  [vjp (stage-3) ] {len(self.vjp_leaves)} leaves "
                         f"reduced inside backward")
        return "\n".join(lines)


def order_units(names: Sequence[str], numels: Sequence[int],
                kinds: Sequence[str], layers: Sequence[int],
                stacked: Sequence[bool]) -> List[GradUnit]:
    """Production-ordered reducible units: reversed tree order (backward
    emits the loss-head end of the tree first), with the stacked layer
    block expanded LAYER-major in reversed layer order — layer L-1's
    backward completes first, so its units bucket together and their
    collective becomes issuable while layers L-2..0 are still computing
    (the reference reduces "last produced first" the same way).
    ``layers[i]`` is the slice count for leaf i (0 = not sliceable)."""
    units: List[GradUnit] = []
    n = len(names)
    stack_leaves = [i for i in range(n) if stacked[i]]
    emitted_stack = False
    for i in reversed(range(n)):
        if stacked[i]:
            if emitted_stack:
                continue
            emitted_stack = True
            depth = max(layers[j] for j in stack_leaves)
            for layer in reversed(range(depth)):
                for j in reversed(stack_leaves):
                    if layer < layers[j]:
                        units.append(GradUnit(
                            j, layer, numels[j] // layers[j],
                            f"{names[j]}[{layer}]", kinds[j]))
        else:
            units.append(GradUnit(i, -1, numels[i], names[i], kinds[i]))
    return units


def build_bucket_plan(units: Sequence[GradUnit],
                      reduce_bucket_size: int,
                      allgather_bucket_size: int,
                      grad_itemsize: int = 4) -> GradBucketPlan:
    """Greedy size-capped packing in the given (production) order.

    ``reduce_bucket_size`` caps reduce-scatter buckets;
    ``min(reduce_bucket_size, allgather_bucket_size)`` caps all-reduce
    buckets (an all-reduce is a reduce + the implicit allgather of the
    result, so BOTH knobs bound it). Caps are element counts, matching the
    reference's ``reduce_bucket_size`` semantics. A single unit larger
    than its cap gets a bucket of its own (the reference overflows its ipg
    bucket the same way).
    """
    if reduce_bucket_size <= 0 or allgather_bucket_size <= 0:
        raise ValueError(
            f"bucket sizes must be > 0 (reduce_bucket_size="
            f"{reduce_bucket_size}, allgather_bucket_size="
            f"{allgather_bucket_size})")
    caps = {REDUCE_SCATTER: int(reduce_bucket_size),
            ALL_REDUCE: min(int(reduce_bucket_size),
                            int(allgather_bucket_size)),
            CROSS_GROUP: int(reduce_bucket_size)}
    open_buckets: Dict[str, List[int]] = {}
    buckets: List[GradBucket] = []
    vjp: List[str] = []

    def close(kind):
        idxs = open_buckets.pop(kind, None)
        if idxs:
            numel = sum(units[u].numel for u in idxs)
            buckets.append(GradBucket(kind, tuple(idxs), numel,
                                      numel * grad_itemsize))

    for u, unit in enumerate(units):
        if unit.kind == VJP:
            vjp.append(unit.name)
            continue
        cur = open_buckets.setdefault(unit.kind, [])
        cur_numel = sum(units[j].numel for j in cur)
        if cur and cur_numel + unit.numel > caps[unit.kind]:
            close(unit.kind)
            open_buckets[unit.kind] = [u]
        else:
            cur.append(u)
    for kind in list(open_buckets):
        close(kind)
    return GradBucketPlan(tuple(buckets), tuple(units), tuple(vjp),
                          int(reduce_bucket_size),
                          min(int(reduce_bucket_size),
                              int(allgather_bucket_size)))


def leaf_kinds(names: Sequence[str], zero_plan) -> List[str]:
    """Each leaf's reduction kind under a ``ZeroPlan``."""
    out = []
    for n in names:
        if zero_plan.stage == 3 and zero_plan.param_dims[n] is not None:
            out.append(VJP)
        elif zero_plan.grad_dims[n] is None:
            out.append(ALL_REDUCE)
        else:
            out.append(REDUCE_SCATTER)
    return out


def plan_grad_buckets(names: Sequence[str], shapes: Sequence[Tuple[int, ...]],
                      zero_plan, reduce_bucket_size: int,
                      allgather_bucket_size: int,
                      stack_keys: Sequence[str] = ("layers",)
                      ) -> GradBucketPlan:
    """The bucket plan of a tree of leaves ``names`` / ``shapes`` (paths as
    ``"layers/wq"``). Leaves under a ``stack_keys`` subtree are stacked
    ``[L, ...]`` and reduce per layer — the port's layer loop always walks
    them layer by layer — unless their gradient shard is cut along the
    layer dimension."""
    kinds = leaf_kinds(names, zero_plan)

    def sliceable(i):
        sh, name = shapes[i], names[i]
        if kinds[i] == VJP or len(sh) < 2 or sh[0] < 2:
            return False
        if not any(name.startswith(k + "/") for k in stack_keys):
            return False
        return not (kinds[i] == REDUCE_SCATTER
                    and zero_plan.grad_dims[name] == 0)

    numels = [int(torch.Size(s).numel()) for s in shapes]
    stacked = [sliceable(i) for i in range(len(names))]
    layer_counts = [shapes[i][0] if stacked[i] else 0
                    for i in range(len(names))]
    units = order_units(names, numels, kinds, layer_counts, stacked)
    return build_bucket_plan(units, reduce_bucket_size,
                             allgather_bucket_size)


def _aligned(n: int) -> int:
    return -(-n // ALIGN_ELEMS) * ALIGN_ELEMS


class _Slot:
    """Where a unit lives in its bucket: ``off`` / ``cols`` of each of the
    ``world`` rows (one row for an all-reduce bucket)."""

    __slots__ = ("unit", "off", "cols", "dim")

    def __init__(self, unit, off, cols, dim):
        self.unit, self.off, self.cols, self.dim = unit, off, cols, dim


def _unit_dim(unit: GradUnit, grad_dim: Optional[int]) -> Optional[int]:
    if grad_dim is None:
        return None
    return grad_dim if unit.layer < 0 else grad_dim - 1


def reduce_leaves(acc: List[torch.Tensor], kinds: Sequence[str],
                  grad_dims: Sequence[Optional[int]], out: List[torch.Tensor],
                  group=None) -> None:
    """``overlap_grad_reduce="off"``: after the backward, one synchronous
    collective per leaf in tree order. An all-reduce leaf is reduced in
    place in ``acc`` (the mean over the group), a reduce-scatter leaf into
    ``out`` (this rank's shard of the mean). Stage-3 (``VJP``) leaves are
    already reduced."""
    world = comm.get_world_size(group)
    for i, (a, kind) in enumerate(zip(acc, kinds)):
        if kind == ALL_REDUCE:
            comm.all_reduce(a, group=group)
            a.div_(world)
        elif kind == REDUCE_SCATTER:
            out[i].copy_(reduce_scatter_leaf(a, grad_dims[i], group))


class BucketedReducer:
    """The bucket plan's flat buffers, hooks and asynchronous collectives.

    Per step: :meth:`hook_for` gives the hook of each unit's tensor in the
    last micro-batch; :meth:`finish` (after that backward) issues what the
    hooks left, waits for every collective and delivers the reduced
    gradients — the mean over the group, into ``acc`` for an all-reduce
    unit and into ``out`` (this rank's shard) for a reduce-scatter one.
    The buffers persist across steps."""

    def __init__(self, plan: GradBucketPlan, grad_dims: Sequence[Optional[int]],
                 device, group=None):
        self.plan = plan
        self.group = group
        self.world = comm.get_world_size(group)
        self.slots: List[List[_Slot]] = []
        self.buffers: List[torch.Tensor] = []
        self.outputs: List[Optional[torch.Tensor]] = []
        self.bucket_of: Dict[int, Tuple[int, int]] = {}
        for bi, b in enumerate(plan.buckets):
            slots, off = [], 0
            rows = self.world if b.kind == REDUCE_SCATTER else 1
            for k, u in enumerate(b.indices):
                unit = plan.units[u]
                cols = unit.numel // rows
                # one rank's shard is the whole unit: it goes flat
                dim = (0 if self.world == 1 else
                       _unit_dim(unit, grad_dims[unit.leaf]))
                slots.append(_Slot(unit, off, cols, dim))
                self.bucket_of[u] = (bi, k)
                off += _aligned(cols)
            self.buffers.append(torch.zeros(rows * off, dtype=torch.float32,
                                            device=device))
            self.outputs.append(
                torch.zeros(off, dtype=torch.float32, device=device)
                if b.kind == REDUCE_SCATTER else None)
            self.slots.append(slots)
        self._reset()

    def _reset(self):
        self._pending = [len(s) for s in self.slots]
        self._filled = [[False] * len(s) for s in self.slots]
        self._work: List[Any] = []
        self._next = 0

    @staticmethod
    def unit_of(t: torch.Tensor, unit: GradUnit) -> torch.Tensor:
        return t if unit.layer < 0 else t[unit.layer]

    def _fill(self, bi: int, k: int, value: torch.Tensor):
        slot, buf = self.slots[bi][k], self.buffers[bi]
        if self.plan.buckets[bi].kind == REDUCE_SCATTER:
            C = buf.numel() // self.world
            dst = buf.view(self.world, C)[:, slot.off:slot.off + slot.cols]
            dst.copy_(value.movedim(slot.dim, 0).reshape(self.world,
                                                         slot.cols))
        else:
            buf[slot.off:slot.off + slot.cols].view(value.shape).copy_(value)
        self._filled[bi][k] = True
        self._pending[bi] -= 1
        self._issue_ready()

    def _issue_ready(self):
        # plan order on every rank: a collective's turn never depends on
        # the order the hooks fired in
        while self._next < len(self.buffers) and \
                self._pending[self._next] == 0:
            bi = self._next
            if self.plan.buckets[bi].kind == REDUCE_SCATTER:
                w = comm.reduce_scatter_tensor(self.outputs[bi],
                                               self.buffers[bi],
                                               group=self.group,
                                               async_op=True)
            else:
                w = comm.all_reduce(self.buffers[bi], group=self.group,
                                    async_op=True)
            self._work.append(w)
            self._next += 1

    def hook_for(self, u: int, acc_unit: torch.Tensor) -> Callable:
        """The gradient hook of unit ``u``: the unit's accumulated gradient
        (``acc_unit``, the earlier micro-batches' sum, plus this one's) goes
        to its bucket. Returns nothing, so the gradient is unchanged."""
        bi, k = self.bucket_of[u]

        def hook(grad):
            with torch.no_grad():
                self._fill(bi, k, acc_unit + grad)

        return hook

    def finish(self, acc: List[torch.Tensor], out: List[torch.Tensor]):
        """Issue the buckets whose units got no gradient (unused params:
        their accumulated value), wait for every collective, deliver."""
        with torch.no_grad():
            for bi, slots in enumerate(self.slots):
                for k, slot in enumerate(slots):
                    if not self._filled[bi][k]:
                        self._fill(bi, k, self.unit_of(acc[slot.unit.leaf],
                                                       slot.unit))
            for w in self._work:
                w.wait()
            for bi, slots in enumerate(self.slots):
                rs = self.plan.buckets[bi].kind == REDUCE_SCATTER
                src = self.outputs[bi] if rs else self.buffers[bi]
                for slot in slots:
                    piece = src[slot.off:slot.off + slot.cols]
                    if rs:
                        dst = self.unit_of(out[slot.unit.leaf], slot.unit)
                        moved = dst.movedim(slot.dim, 0)
                        torch.div(piece.view(moved.shape), self.world,
                                  out=piece.view(moved.shape))
                        moved.copy_(piece.view(moved.shape))
                    else:
                        dst = self.unit_of(acc[slot.unit.leaf], slot.unit)
                        torch.div(piece.view(dst.shape), self.world, out=dst)
        self._reset()


def overlap_blockers(engine, forced: bool) -> List[Tuple[str, str]]:
    """(severity, reason) list; empty means the bucketed path can run
    (JAX :563, for the compositions the port has)."""
    out: List[Tuple[str, str]] = []
    if engine.offload_device:
        out.append(("hard", "offload_optimizer moves the gradients to the "
                            "host tier after the backward"))
    if not forced:
        if not engine.config.zero_optimization.overlap_comm:
            out.append(("soft", "overlap_comm is disabled"))
        if engine.zero_stage == 3:
            out.append(("soft", "stage-3 gathers reduce in their own "
                                "backward"))
        if engine.topology.dp_world_size <= 1:
            out.append(("soft", "data-parallel world is 1 (nothing to "
                                "reduce)"))
    return out


def resolve_overlap_mode(engine) -> str:
    """'bucketed' | 'off' for this engine build.

    ``zero_optimization.overlap_grad_reduce``: 'auto' buckets on a
    data-parallel world > 1 with ``overlap_comm`` at stages 0-2; 'bucketed'
    forces it (hard blockers raise); 'off' reduces leaf by leaf after the
    backward. (ZeRO++, which always takes the JAX manual program, is
    rejected by the config, ROADMAP A10.)"""
    from .config import ConfigError
    mode = engine.config.zero_optimization.overlap_grad_reduce
    if mode == "off":
        return "off"
    blockers = overlap_blockers(engine, forced=(mode == "bucketed"))
    if mode == "bucketed":
        hard = [r for s, r in blockers if s == "hard"]
        if hard:
            raise ConfigError(
                "zero_optimization.overlap_grad_reduce='bucketed' is not "
                "supported here: " + "; ".join(hard))
        return "bucketed"
    return "off" if blockers else "bucketed"


def _unported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"grad_overlap.{name} is not ported to deepspeed_tpu_torch yet "
            f"({_UNPORTED})")
    fn.__name__ = name
    return fn


quant_reduce_layout = _unported("quant_reduce_layout")
ring_wire_bytes = _unported("ring_wire_bytes")

"""Process topology.

Port of ``deepspeed_tpu/parallel/topology.py`` (``TopologyConfig`` :35,
``MeshTopology`` :55, ``build_topology`` :194): the same named axes and
the same answers (``sizes``, ``axis_size``, ``mics_enabled``,
``dp_axes``, ``zero_shard_axes``, ``batch_axes``, ``dp_world_size``),
over ``torch.distributed`` process groups instead of a device mesh. A
JAX collective over a mesh axis is a collective over the axis's process
group here (:meth:`MeshTopology.group`).

Ranks are laid out in the JAX ``AXIS_ORDER`` (pipe, data, shard, expert,
seq, model; model innermost), so rank ``r`` has the mesh coordinates of
JAX device ``r`` of a mesh built on ``jax.devices()[:world]``. MiCS
(``mics_shard`` > 1) factors the data-parallel world into the ``shard``
axis (the within-group ZeRO axis) and the ``data`` axis (the replica
groups), as JAX does (:84-99). Every rank builds every group of the axis
sets the engines use (``torch.distributed.new_group`` is collective) and
keeps its own; a group spanning the whole world is the default group
(None). The pipeline axis (``pipe``, outermost) holds the stages of the
1F1B schedule (``runtime/pipe/``); it is never a data axis, so the batch,
the ZeRO shard and the data-parallel world exclude it (JAX
``runtime/config.py:576-580``). ZeRO++ hpZ (``hpz_shard`` > 1) sizes the
``shard`` axis too, as JAX does (:78-93): the stage-3 compute params shard
over it alone (``secondary_axes``), within groups of ``hpz_shard``
consecutive ranks, while master, moments and gradients span the whole
data-parallel world.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..comm import comm

# Canonical axis names (single source of truth), as in the JAX package.
PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SHARD_AXIS = "shard"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

AXIS_ORDER = (PIPE_AXIS, DATA_AXIS, SHARD_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)


@dataclass(frozen=True)
class TopologyConfig:
    pipe: int = 1
    model: int = 1  # tensor parallel
    seq: int = 1  # Ulysses sequence parallel
    expert: int = 1  # expert parallel
    mics_shard: int = 1
    hpz_shard: int = 1


def _key(axes) -> Tuple[str, ...]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in AXIS_ORDER if a in names)


class MeshTopology:
    """The process group's mesh: this rank's coordinates and its group on
    each axis set.

    ``world_size`` / ``rank`` default to the default group's (1 / 0 when
    no group is initialized: then every collective is local)."""

    def __init__(self, topo: TopologyConfig = TopologyConfig(),
                 world_size: Optional[int] = None, rank: Optional[int] = None):
        self.topo = topo
        self.world = comm.get_world_size() if world_size is None else world_size
        self.rank = comm.get_rank() if rank is None else rank
        mp = topo.pipe * topo.model * topo.seq * topo.expert
        if self.world % mp:
            raise ValueError(f"{self.world} ranks not divisible by "
                             f"pipe*model*seq*expert={mp}")
        data, shard = self.world // mp, 1
        if topo.mics_shard > 1 and topo.hpz_shard > 1:
            raise ValueError(
                "mics_shard_size and zero_hpz_partition_size both claim the "
                "shard sub-axis with opposite replication semantics; enable "
                "at most one")
        group = max(topo.mics_shard, topo.hpz_shard)
        if group > 1:
            name = ("mics_shard_size" if topo.mics_shard > 1
                    else "zero_hpz_partition_size")
            if data % group:
                raise ValueError(
                    f"{name}={group} does not divide the "
                    f"data-parallel world of {data}")
            shard, data = group, data // group
        self.sizes: Dict[str, int] = {
            PIPE_AXIS: topo.pipe, DATA_AXIS: data, SHARD_AXIS: shard,
            EXPERT_AXIS: topo.expert, SEQ_AXIS: topo.seq,
            MODEL_AXIS: topo.model,
        }
        self.coords: Dict[str, int] = self._coords_of(self.rank)
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._live = (comm.is_initialized()
                      and self.world == comm.get_world_size()
                      and self.world > 1)
        if self._live:
            for axes in self._used_axis_sets():
                self._build(axes)
            # the axes that name a group by themselves; an explicit None
            # group stays the default (world) group for the data axes
            comm.set_axis_groups({MODEL_AXIS: self.group(MODEL_AXIS),
                                  SEQ_AXIS: self.group(SEQ_AXIS),
                                  PIPE_AXIS: self.group(PIPE_AXIS)})

    # -- coordinates and groups ------------------------------------------
    def _coords_of(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(AXIS_ORDER):
            out[a] = rank % self.sizes[a]
            rank //= self.sizes[a]
        return out

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in AXIS_ORDER:
            r = r * self.sizes[a] + coords[a]
        return r

    def _used_axis_sets(self):
        sets = [(PIPE_AXIS,), (MODEL_AXIS,), (SEQ_AXIS,), (EXPERT_AXIS,),
                (SHARD_AXIS,), (DATA_AXIS,), (DATA_AXIS, SHARD_AXIS),
                self.batch_axes,
                self.dp_axes, self.zero_shard_axes,
                self.batch_axes + (SEQ_AXIS,)]
        out = []
        for s in sets:
            k = _key(s)
            if k not in out:
                out.append(k)
        return out

    def _build(self, axes: Tuple[str, ...]):
        """Every partition of the world into groups along ``axes`` (the
        same calls in the same order on every rank); keeps this rank's."""
        import itertools
        import torch.distributed as dist

        n = 1
        for a in axes:
            n *= self.sizes[a]
        if n == self.world:
            self._groups[axes] = None          # the default group
            return
        others = [a for a in AXIS_ORDER if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(self.sizes[a])
                                         for a in others)):
            base = dict(zip(others, fixed))
            ranks = sorted(
                self._rank_of({**base, **dict(zip(axes, idx))})
                for idx in itertools.product(*(range(self.sizes[a])
                                               for a in axes)))
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        self._groups[axes] = mine

    def group(self, axes=DATA_AXIS):
        """This rank's process group over a mesh axis or tuple of axes
        (None: the default group, also at one rank)."""
        k = _key(axes)
        if not self._live:
            return None
        if k not in self._groups:
            self._build(k)          # collective: every rank asks alike
        return self._groups[k]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def group_rank(self, axes) -> int:
        """This rank's index inside its group over ``axes`` (row-major in
        the axis order)."""
        r = 0
        for a in _key(axes):
            r = r * self.sizes[a] + self.coords[a]
        return r

    def group_size(self, axes) -> int:
        n = 1
        for a in _key(axes):
            n *= self.sizes[a]
        return n

    # -- the JAX answers ---------------------------------------------------
    @property
    def world_size(self) -> int:
        return self.world

    def axis_size(self, axis: str) -> int:
        return self.sizes[axis]

    @property
    def mics_enabled(self) -> bool:
        return self.sizes[SHARD_AXIS] > 1 and self.topo.mics_shard > 1

    @property
    def hpz_enabled(self) -> bool:
        return self.sizes[SHARD_AXIS] > 1 and self.topo.hpz_shard > 1

    @property
    def secondary_axes(self) -> Tuple[str, ...]:
        """hpZ's secondary partition (JAX :124): the stage-3 compute params
        shard over the within-group axis only."""
        return (SHARD_AXIS,)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """Axes a dense parameter's ZeRO shard spans (JAX :124): the MiCS
        shard axis alone under MiCS, else the data-parallel world."""
        if self.mics_enabled:
            return (SHARD_AXIS,)
        axes = (DATA_AXIS, SHARD_AXIS)
        if self.sizes[EXPERT_AXIS] > 1:
            axes = axes + (EXPERT_AXIS,)
        return axes

    @property
    def zero_shard_axes(self) -> Tuple[str, ...]:
        """Axes ZeRO storage may span (JAX :143): the seq axis joins the
        dp axes when it is > 1."""
        axes = self.dp_axes
        if self.sizes[SEQ_AXIS] > 1:
            axes = axes + (SEQ_AXIS,)
        return axes

    @staticmethod
    def expert_axes(axes) -> Tuple[str, ...]:
        """The axes of ``axes`` (a dense leaf's ZeRO axes: ``dp_axes`` or
        ``zero_shard_axes``) an expert leaf's ZeRO shard spans: all but the
        expert axis, which already cuts the leaf by experts (JAX
        ``add_zero_axes`` :56-66). Its group is the ranks holding the same
        experts."""
        return tuple(a for a in _key(axes) if a != EXPERT_AXIS)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Axes the global batch is split over (JAX :160)."""
        axes = (DATA_AXIS, SHARD_AXIS)
        if self.sizes[EXPERT_AXIS] > 1:
            axes = axes + (EXPERT_AXIS,)
        return axes

    @property
    def dp_world_size(self) -> int:
        return (self.sizes[DATA_AXIS] * self.sizes[SHARD_AXIS]
                * self.sizes[EXPERT_AXIS])

    @property
    def dp_rank(self) -> int:
        """This rank's index among the data-parallel (batch) ranks."""
        return self.group_rank(self.batch_axes)

    @property
    def ep_rank(self) -> int:
        """This rank's index on the expert axis."""
        return self.coords[EXPERT_AXIS]

    @property
    def tp_size(self) -> int:
        return self.sizes[MODEL_AXIS]

    @property
    def tp_rank(self) -> int:
        return self.coords[MODEL_AXIS]

    @property
    def pp_size(self) -> int:
        return self.sizes[PIPE_AXIS]

    @property
    def pp_rank(self) -> int:
        """This rank's pipeline stage."""
        return self.coords[PIPE_AXIS]

    @property
    def sp_size(self) -> int:
        return self.sizes[SEQ_AXIS]

    @property
    def sp_rank(self) -> int:
        return self.coords[SEQ_AXIS]

    def expert_group(self):
        """The ``ep`` ranks sharing this rank's data index (one copy of
        every expert); None at ep 1."""
        if self.sizes[EXPERT_AXIS] == 1:
            return None
        return self.group(EXPERT_AXIS)

    def __repr__(self):
        return f"MeshTopology({self.sizes})"


def build_topology(config=None, *, pipe=None, model=None, seq=None,
                   expert=None) -> MeshTopology:
    """Build from a DeepSpeedConfig (runtime.config) or explicit sizes."""
    if config is not None:
        c = config.cfg
        topo = TopologyConfig(
            pipe=pipe or c.pipeline.stages,
            model=model or c.tensor_parallel_size,
            seq=seq or c.sequence_parallel_size,
            expert=expert or (c.moe.expert_parallel_size if c.moe.enabled else 1),
            mics_shard=max(c.zero_optimization.mics_shard_size, 1),
            hpz_shard=max(c.zero_optimization.zero_hpz_partition_size, 1),
        )
    else:
        topo = TopologyConfig(pipe=pipe or 1, model=model or 1, seq=seq or 1,
                              expert=expert or 1)
    return MeshTopology(topo)

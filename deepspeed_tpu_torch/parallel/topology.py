"""Process topology.

Port of ``deepspeed_tpu/parallel/topology.py`` (``MeshTopology`` :55,
``build_topology`` :194): the same named axes and the same answers
(``sizes``, ``axis_size``, ``dp_axes``, ``zero_shard_axes``,
``dp_world_size``), over ``torch.distributed`` process
groups instead of a device mesh. A JAX collective over a mesh axis is a
collective over the axis's process group here (:meth:`MeshTopology.group`).

The port runs data and expert parallelism. The data-parallel group is the
default (world) group. The expert axis factors it, as in JAX (:41,
:59-62): rank ``d * ep + j`` is data index ``d``, expert index ``j`` (the
JAX mesh order, expert inside data), its expert group the ``ep`` ranks of
its data index (one copy of every expert between them) and its
expert-data group the ranks of its expert index (the replicas of its
experts). A pipeline, tensor or sequence axis > 1 raises (ROADMAP A8), as
do the ZeRO sub-groups: MiCS (A4) and ZeRO++ hpZ (A10).
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


_UNPORTED_AXES = (
    ("pipe", "pipeline parallelism", "A8 (parallel modes)"),
    ("model", "tensor parallelism", "A8 (parallel modes)"),
    ("seq", "sequence parallelism", "A8 (parallel modes)"),
    ("mics_shard", "MiCS shard groups (mics_shard_size)",
     "A4 (ZeRO over torch.distributed)"),
    ("hpz_shard", "ZeRO++ hpZ (zero_hpz_partition_size)", "A10 (ZeRO++)"),
)


class MeshTopology:
    """The data-parallel world of this process group, factored by the
    expert axis.

    ``world_size`` / ``rank`` default to the default group's (1 / 0 when
    no group is initialized: then every collective is local). With an
    expert axis > 1 over the process group's world, every rank builds
    every expert and expert-data group (``torch.distributed.new_group``
    is collective) and keeps its own."""

    def __init__(self, topo: TopologyConfig = TopologyConfig(),
                 world_size: Optional[int] = None, rank: Optional[int] = None):
        for field, what, item in _UNPORTED_AXES:
            if getattr(topo, field) > 1:
                raise NotImplementedError(
                    f"{what} = {getattr(topo, field)} is not ported to "
                    f"deepspeed_tpu_torch yet (ROADMAP {item}); the port "
                    f"runs data parallelism only")
        self.topo = topo
        self.world = comm.get_world_size() if world_size is None else world_size
        self.rank = comm.get_rank() if rank is None else rank
        ep = topo.expert
        if self.world % ep:
            raise ValueError(f"{self.world} ranks not divisible by "
                             f"expert={ep}")
        self.sizes: Dict[str, int] = {
            PIPE_AXIS: 1, DATA_AXIS: self.world // ep, SHARD_AXIS: 1,
            EXPERT_AXIS: ep, SEQ_AXIS: 1, MODEL_AXIS: 1,
        }
        self._expert_group = self._expert_data_group = None
        if ep > 1 and comm.is_initialized() and \
                self.world == comm.get_world_size():
            import torch.distributed as dist
            for d in range(self.world // ep):
                g = dist.new_group(list(range(d * ep, (d + 1) * ep)))
                if d == self.rank // ep:
                    self._expert_group = g
            for j in range(ep):
                g = dist.new_group(list(range(j, self.world, ep)))
                if j == self.rank % ep:
                    self._expert_data_group = g

    def axis_size(self, axis: str) -> int:
        return self.sizes[axis]

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """Axes a dense parameter's ZeRO shard spans (JAX :124)."""
        axes = (DATA_AXIS, SHARD_AXIS)
        if self.sizes[EXPERT_AXIS] > 1:
            axes = axes + (EXPERT_AXIS,)
        return axes

    @property
    def zero_shard_axes(self) -> Tuple[str, ...]:
        """Axes ZeRO storage may span (JAX :143); the seq axis joins them
        only when it is > 1, which the port does not run."""
        return self.dp_axes

    @property
    def dp_world_size(self) -> int:
        return (self.sizes[DATA_AXIS] * self.sizes[SHARD_AXIS]
                * self.sizes[EXPERT_AXIS])

    @property
    def dp_rank(self) -> int:
        return self.rank

    @property
    def ep_rank(self) -> int:
        """This rank's index on the expert axis."""
        return self.rank % self.sizes[EXPERT_AXIS]

    def expert_group(self):
        """The ``ep`` ranks sharing this rank's data index (one copy of
        every expert); None at ep 1."""
        return self._expert_group

    def expert_data_group(self):
        """The ranks holding this rank's experts (its expert index); the
        default group at ep 1."""
        return self._expert_data_group

    def group(self, axes=DATA_AXIS):
        """The process group of a mesh axis (or tuple of axes): the expert
        group for the expert axis alone, the default group for the other
        data-like axes."""
        if axes == EXPERT_AXIS and self.sizes[EXPERT_AXIS] > 1:
            return self._expert_group
        return comm.resolve_group(None, axes)

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

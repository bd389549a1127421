"""Training engine: ZeRO stages 0-3 over torch.distributed, optimizer
offload, checkpoints.

Port of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedTpuEngine`` :117).
The engine owns the train state — compute-dtype params, an fp32 master
under bf16/fp16 (the JAX ``has_master``), optimizer moments, the step
counter and the fp16 loss-scale state — and one ``train_batch`` that does
what the JAX compiled ``train_step`` (:1049) does, eagerly:

* the GAS loop (the ``micro_fn`` scan, :1091-1107): per micro-batch, the
  gradient of ``loss * scale`` by autograd, accumulated in f32;
* :func:`unscale_clip_check` (:69): unscale by ``1 / (gas * scale)``, the
  global inf/nan check under fp16, the global norm and clipping;
* :func:`apply_update_with_skip` (:98): the optimizer update unless the
  step overflowed; then the master -> compute-dtype cast (:1132-1136) and
  the fp16 ``update_scale`` (:1148);
* the host bookkeeping of :1735-1740: ``global_steps``, ``skipped_steps``
  and ``lr_scheduler.step()`` only on non-skipped steps.

The JAX step selects on the device; here the host reads ``finite`` once
per fp16 step (other precisions never skip) and updates in place, so the
master, moments and params are never copied.

Data parallelism (JAX :151, :621, :933): the engine builds its
``topology`` (``parallel/topology.py``) from the process group, its
``zero_plan`` (``runtime/zero/partition.py``) and its
``grad_overlap_mode`` (``runtime/grad_overlap.py``). Each rank keeps rows
``[rank * micro, (rank + 1) * micro)`` of every global micro-batch (the
JAX batch sharding on the data axis) and:

* stage 0: replicated state; gradients all-reduced (the mean);
* stage 1: master and moments sharded along each leaf's plan dimension;
  each rank updates its shard, then the params are all-gathered;
* stage 2: + gradients reduce-scattered into those shards;
* stage 3: + params kept as shards and gathered on use through
  ``comm/quantized.make_zero3_gather`` — each layer inside the model's
  layer loop (so inside its activation checkpoint: the recompute gathers
  again), the other leaves before the forward; the gather's backward
  reduce-scatters their gradients. Leaves under
  ``stage3_param_persistence_threshold`` elements stay replicated.

Gradients reduce in size-capped buckets during the last micro-batch's
backward (``overlap_grad_reduce``: bucketed) or leaf by leaf after it
(off). The gradient norm sums the shards' partial sums of squares over the
group, the fp16 overflow check is agreed over the group (a rank that sees
an overflow makes every rank skip), and ``train_batch`` returns the mean
loss over the group. At one rank every shard is the whole leaf and every
collective a copy, so a stage 1/2/3 step equals the stage-0 step bit for
bit.

The optimizer state may leave the card
(``zero_optimization.offload_optimizer``, the selection of JAX :215-228):

* ``{device: cpu, pin_memory: true}`` (stages 1/2): the tiered offload
  (``runtime/offload.py``): master and moments in page-locked host memory,
  the update streamed bucket by bucket through the same
  ``apply_update_with_skip`` on the card, bit-identical to the resident
  step; the first fetches are issued before the forward;
* ``{device: cpu}`` or ``{device: nvme, nvme_path}``: the host C++
  optimizer (``runtime/zero/offload.py``): the gradients cross to the
  host in the transfer dtype, the host updates master and moments (in
  RAM, or swapped from files) and writes the compute params back.

At one rank the ZeRO plan of an offloaded engine is the identity. At more
than one, each rank's host tier holds only its ZeRO shard of the master
and moments (of its tensor-parallel slices, over the MiCS shard group
under MiCS, over the data ranks alone under Ulysses, as JAX keeps the
offload's shard off the seq axis), updates it with its shard of the
reduced gradients (reduced, normed and clipped as the resident step's,
then re-cut for the tier), and its slice of the compute params reaches
the other ranks through an all-gather as a resident stage-1/2 step's (a
stage-3 compute leaf cut like the master is the shard itself). LAMB
streams whole leaves through the tiered tier, its trust ratio summed over
the ranks holding their pieces (``norm_reduce``); the host C++ tier has
no LAMB, as in JAX. An fp16 step that overflows leaves either host state
untouched.

The parameters may leave the card too
(``zero_optimization.offload_param``, stage 3, a model that declares
``supports_param_offload``; the gates of JAX :229-264):

* ``{device: cpu}``: the stacked ``layers/*`` compute leaves live in
  page-locked host memory and the model's layer loop brings one layer at
  a time to the card (``runtime/offload.HostLayerStream``) inside the
  layer's checkpoint; the rest of the engine is the resident stage-3 one,
  or an offloaded one, bit for bit;
* ``{device: nvme, nvme_path}``: ZeRO-Infinity
  (``runtime/zero/infinity.py``): the layers' params and optimizer state
  in per-layer files, each rank's piece over the data ranks of its
  tensor-parallel slices, a per-layer executor gathering each layer over
  the data ranks before it runs, with host gradients reduce-scattered into
  the pieces and the host C++ optimizer; bf16 / fp32, causal pre-LN dense
  models, data x tensor parallelism (JAX ``_check_infinity_supported``
  :544 refuses the rest, and so does the port).
``save_checkpoint`` / ``load_checkpoint`` (JAX :1983 / :2061) write and
read the JAX package's fragment format (``checkpoint/state_checkpoint.py``)
for the resident and both offloaded engines, in the background under
``checkpoint.async_save``; ``save_16bit_model`` (:2172) writes the
consolidated weights; ``load_universal_checkpoint`` (:2183) loads a
universal directory (``checkpoint/universal.py``) into the resident
engine at ZeRO 0-3 and both optimizer offloads, moments included (not
under ZeRO-Infinity, where JAX's loader fails too).

Observability (JAX :363-534, :1693-1810): the training series of the
metrics registry (``telemetry``), flushed into ``MonitorMaster``
(``monitor/monitor.py``: TensorBoard, wandb, CSV) every
``telemetry.flush_interval`` steps; ``Train/loss`` and ``Train/lr`` to the
monitor on every applied step; the step spans ``train_data``,
``train_step``, ``train_device_dispatch``, ``train_host_sync``; under
``diagnostics``, a flight-recorder event and the loss / gradient anomaly
check per batch, attributed by the per-leaf squared norms the step stacks
on the card and fetches once (only then), post-mortem bundles, and the
host-sync stall watchdog, armed only while a step is in flight;
``memory_breakdown`` logs ``utils/memory.see_memory_usage`` after init.

The torch-style ``forward`` (``__call__``) / ``backward`` / ``step``
shims (JAX :1828-1960) accumulate micro-batches and apply them as
``train_batch`` does, bit for bit, for the resident engine at ZeRO 0-3
and the optimizer offloads; they refuse ``offload_param``. A model's
``frozen_mask`` holds its frozen leaves on both paths.

MoE models train with their aux loss in the model's loss. Under expert
parallelism (``moe.expert_parallel_size`` = ep > 1) each rank holds the
``E / ep`` experts of its place in its expert group (the expert leaves
are cut along their expert dimension at build, and a checkpoint holds
them whole: gathered from the expert group at save, cut again at load,
so it reloads under another ep). Every leaf has its own ZeRO group
(``_zero``): an expert leaf's is the ranks of the ZeRO axes holding the
same experts (``MeshTopology.expert_axes``; JAX ``add_zero_axes``), over
which its master and moments shard, its stage-3 gather and gradient
reduce-scatter run and its checkpoint fragments join. An expert leaf's
gradient already sums its expert group's tokens (the dispatch's
all-to-all backward): its mean over that group divided by ep is the mean
loss's gradient; a dense leaf takes the mean over the whole ZeRO group.
The clip norm counts each expert shard once. The gating's statistics are
global over the data-parallel (and under Ulysses the seq) ranks
(``model.moe_groups``). As in JAX, bucketed reduction refuses ep > 1 and
``offload_param`` nvme refuses MoE.

Tensor and sequence parallelism and MiCS (the topology's model, seq and
shard axes; ``_init_groups``): a tensor-parallel rank holds its slices of
the leaves (``model.tp_shard_dims``; with the pipe and a model-owned seq
axis, ``_cuts``), on which the ZeRO plan is made, and a checkpoint
gathers them whole. The batch splits over the data
ranks only; under sequence parallelism each rank's ``model.apply``
embeds its chunk of the sequence and returns the whole loss, and the
backward starts from ``loss * sp``, so the mean over the ZeRO group
(data x seq ranks, the JAX ``include_seq``) is the gradient of the mean
loss. The global norm sums a tensor-parallel leaf's squares over the
model group too; LAMB's trust ratio reads whole-leaf norms
(``norm_reduce``). Under MiCS the ZeRO group is the shard group and the
gradients are also averaged over the replica groups (the data axis, with
the seq axis under Ulysses, whose ranks hold the same shards as JAX
leaves ``include_seq`` off, and the expert axis for a dense leaf).

Pipeline parallelism (``pipeline.stages`` = pp > 1, JAX :993-1080):
each rank is one stage of the pipe group and holds its slice of the
layer stack (``model.pipe_shard_dims``); ``train_batch`` hands the whole
``[M, micro, ...]`` batch (M = gas) to ``model.loss_and_grads``, the 1F1B
schedule (``runtime/pipe/``), which accumulates into the engine's f32
buffers (``grad_acc``) the mean over the micro-batches, summed over the
pipe group where a leaf is replicated over it; the data-parallel
reduction, the norms (a stage's leaves summed over the pipe group) and
the update follow as at pp 1.
ZeRO 1 at most; tensor / seq parallelism only for a model that owns
those axes (``pp_manual_axes``, ``PipelineModule``), expert parallelism
only for ``supports_pp_ep`` (``TransformerLM``, gating local to each
rank as in JAX); fp16 takes autograd through the pipelined forward
(``model.apply``, whose gradients the model makes whole over the pipe
group) with a warning; the optimizer offload only in bf16 / fp32;
``eval_batch`` through ``model.apply``; the shims and ``offload_param``
refuse.

ZeRO++ and the quantized transports (JAX :913-991):
``zero_quantized_weights`` gathers stage-3 params as int8 blocks (qwZ)
and ``zero_quantized_gradients`` reduces the gradients of stages 2-3 by
the int8 all-to-all (qgZ), both where the group has more than one rank
(JAX quantizes nothing at a data-parallel world of 1);
``zero_hpz_partition_size`` (hpZ) cuts the stage-3 compute params within
groups of that many ranks, the gathers staying inside a group and the gradients averaged
across the groups (``CROSS_GROUP``). ``quantized_reduce`` (int8 / fp8,
stages 0-2) reduces the bucketed gradients on quantized rings, flat or
two-level (``quantized_reduce_hierarchy``), carrying each rank's
error-feedback residuals (``quant_reduce_state``) across steps; an fp16
step that overflows keeps the old ones. These transports reduce after
the backward on JAX's bucket layout (``runtime/grad_overlap.py``).
The 1-bit optimizers (``runtime/fp16/onebit``) replace the step: local
gradients, then the optimizer's own compressed allreduce.

Not ported (``runtime/config.check_ported`` raises, naming the ROADMAP
item): compression, curriculum and the profilers (A12). The hybrid engine
(``runtime/hybrid_engine.py``) subclasses this engine and reads its
weights through :meth:`DeepSpeedTpuEngine.consolidated_param_buckets`.
"""

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import state_checkpoint as ckpt
from ..comm import comm
from ..comm.quantized import (all_gather_leaf, make_zero3_gather,
                              shard_of)
from ..ops.optimizers import TpuOptimizer, build_optimizer
from ..parallel.topology import MeshTopology, build_topology
from ..telemetry import trace
from ..utils.device import resolve_device
from ..utils.timer import ThroughputTimer
from .activation_checkpointing import checkpointing as ds_ckpt
from .config import ConfigError, DeepSpeedConfig, OptimizerConfig, check_ported
from .fp16.loss_scaler import (LossScaleConfig, from_fp16_config,
                               grads_finite, init_scale_state, update_scale)
from .grad_overlap import (ALL_REDUCE, CROSS_GROUP, REDUCE_SCATTER, VJP,
                           BucketedReducer, apply_bucketed_reduction,
                           leaf_kinds, plan_grad_buckets, quant_reduce_layout,
                           reduce_leaves, resolve_overlap_mode,
                           ring_wire_bytes)
from .lr_schedules import LRScheduler, build_lr_schedule
from .offload import HostLayerStream, PinnedHost, copy_rows
from .zero.partition import ZeroPlan, build_zero_plan

logger = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}


def _flatten(tree, prefix="") -> List[Tuple[str, Any]]:
    """(path, leaf) in the JAX dict-pytree order (sorted keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def _unflatten(items: List[Tuple[str, Any]]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in items:
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def unscale_clip_check(grads: List[torch.Tensor], inv, clip: float,
                       fp16: bool, sharded: Optional[List[bool]] = None,
                       group=None, frozen: Sequence[int] = (),
                       with_leaf_sqnorms: bool = False,
                       replicas: Optional[Dict[int, int]] = None,
                       splits: Sequence[Tuple[Any, List[bool]]] = ()):
    """In place: unscale by ``inv`` (1 / (gas * loss_scale)), zero the
    frozen leaves' gradients (indices ``frozen``), global inf/nan check
    under fp16 (on the unclipped grads: clipping an inf makes a nan),
    global norm, norm clipping. Returns (grads, finite, gnorm), plus the
    per-leaf squared norms stacked into one f32 tensor on the device when
    ``with_leaf_sqnorms`` (the anomaly detector's attribution input: the
    global norm's own sums, taken before clipping and whether or not the
    step is finite); ``finite`` is None when the precision cannot
    overflow.

    Across a data-parallel group of more than one rank, ``sharded[i]``
    marks a gradient each rank holds a shard of: its partial sum of
    squares is summed over the group (one all-reduce for all of them) and
    the leaves' squares are then added in leaf order, as at one rank; the
    overflow check is agreed over the group. ``replicas[i]``: leaf ``i``'s
    part is held by that many ranks of the group (expert leaves replicated
    over their expert-data group), so its partial sum counts once.
    ``splits``: ``(group, flags)`` for each model-parallel axis (model,
    seq, pipe) of more than one rank; ``flags[i]`` marks a leaf cut over
    that group: its (ZeRO-summed) square is then summed over the group
    too, while a replicated leaf counts once; the overflow check is
    agreed over those groups too."""
    for g in grads:
        g.mul_(inv)
    for i in frozen:
        grads[i].zero_()
    world = comm.get_world_size(group)
    finite = grads_finite(grads) if fp16 else None
    splits = [(g, f) for g, f in splits if comm.get_world_size(g) > 1]
    if finite is not None and (world > 1 or splits):
        flag = finite.to(torch.float32).reshape(1)
        if world > 1:
            comm.all_reduce(flag, op=comm.ReduceOp.MIN, group=group)
        for g, _ in splits:
            comm.all_reduce(flag, op=comm.ReduceOp.MIN, group=g)
        finite = flag[0] > 0
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    idx = [i for i, s in enumerate(sharded or []) if s]
    if idx and world > 1:
        part = torch.stack([sq[i] / replicas[i] if replicas and i in replicas
                            else sq[i] for i in idx])
        comm.all_reduce(part, group=group)
        for j, i in enumerate(idx):
            sq[i] = part[j]
    for g, flags in splits:
        tidx = [i for i, s in enumerate(flags) if s]
        if tidx:
            part = torch.stack([sq[i] for i in tidx])
            comm.all_reduce(part, group=g)
            for j, i in enumerate(tidx):
                sq[i] = part[j]
    gnorm = torch.sqrt(sum(sq))
    if clip and clip > 0:
        factor = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(factor)
    if with_leaf_sqnorms:
        return grads, finite, gnorm, torch.stack(sq)
    return grads, finite, gnorm


def apply_update_with_skip(optimizer: TpuOptimizer, target, grads,
                           opt_state, step: int, lr: float,
                           finite: bool, frozen: Sequence[int] = (),
                           **kw) -> int:
    """The optimizer update unless the step overflowed (reference
    stage3.py:2018): a skipped step leaves target, moments and step
    untouched. Frozen leaves (indices ``frozen``) are restored after the
    update, which undoes decoupled weight decay on them too (JAX :106).
    Returns the new (1-based count of applied) step. ``kw`` reaches the
    optimizer (LAMB's ``norm_reduce`` on a master cut over ranks)."""
    if not finite:
        return step
    held = [target[i].detach().clone() for i in frozen]
    optimizer.apply(target, grads, opt_state, step + 1, lr=lr, **kw)
    with torch.no_grad():
        for i, h in zip(frozen, held):
            target[i].copy_(h)
    return step + 1


class DeepSpeedTpuEngine:
    """Training engine over the data-parallel process group.

    ``model`` follows the JAX package's protocol: ``init_params(generator,
    dtype)`` and ``apply(params, batch, train=...) -> loss``; a model with
    a stacked layer tree (``param_offload_keys``) and a ``layer_gather``
    attribute has its stage-3 layers gathered inside its layer loop.
    ``params`` (a tree of tensors or numpy arrays in the JAX layout, e.g.
    from ``checkpoint/interop.params_from_numpy``, the same on every rank)
    replaces the seeded init. ``device=None`` means the GPU and raises
    without one. ``dataloader`` feeds ``train_batch()`` when it gets no
    batch.
    """

    def __init__(self, model, config: DeepSpeedConfig, params=None,
                 device=None, seed: int = 0, lr_scheduler=None,
                 topology: Optional[MeshTopology] = None, dataloader=None):
        check_ported(config)
        self.device = resolve_device(device)
        self.model = model
        self.ds_config = config
        self.config = config.cfg
        self.topology = topology or build_topology(config)
        self._init_groups()
        self.ep = self.topology.axis_size("expert")
        self.training_dataloader = dataloader
        self.global_steps = 0
        self.skipped_steps = 0
        self._batches_seen = 0
        self.compute_dtype = DTYPES[config.precision_dtype]
        self.fp16_enabled = self.config.fp16.enabled
        self.bf16_enabled = self.config.bf16.enabled
        self.zero_stage = config.zero_stage
        self.gas = config.gradient_accumulation_steps
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size

        opt_cfg = self.config.optimizer
        if opt_cfg is None:
            opt_cfg = OptimizerConfig(type="adamw", params={"lr": 1e-3})
        self.config.optimizer = opt_cfg
        # the 1-bit optimizers own their communication (JAX :199-201)
        from .fp16.onebit import is_onebit_optimizer
        self.onebit_mode = is_onebit_optimizer(opt_cfg.type)
        self._onebit = None
        if self.onebit_mode:
            self.optimizer = None
            base_lr = opt_cfg.params.get("lr", 1e-3)
        else:
            self.optimizer: TpuOptimizer = build_optimizer(opt_cfg.type,
                                                           opt_cfg.params)
            base_lr = opt_cfg.params.get("lr", getattr(self.optimizer, "lr",
                                                       1e-3))
        self._lr_fn = build_lr_schedule(self.config.scheduler, base_lr)
        self.lr_scheduler = lr_scheduler or LRScheduler(self._lr_fn)
        self._check_world()
        self.scale_cfg: Optional[LossScaleConfig] = (
            from_fp16_config(self.config.fp16) if self.fp16_enabled else None)
        # ZeRO-Offload (JAX :215-228): pin_memory selects the tiered path,
        # else the host C++ optimizer
        off = self.config.zero_optimization.offload_optimizer
        self.offload_device = off.device if off.device != "none" else None
        self.offload_tiered = bool(self.offload_device == "cpu"
                                   and off.pin_memory)
        self.host_opt = None
        self._check_pipeline(model)
        self._init_param_offload(model)
        self._init_experts(model)
        self._pending_saves: List[threading.Thread] = []
        self._async_save_errors: List[BaseException] = []
        # the quantized rings' error-feedback residuals (JAX :163-170; not
        # checkpointed, as in JAX) and their settings
        self.quant_reduce_state = None
        self._qr = None
        ds_ckpt.configure(deepspeed_config=self.config)
        if self.config.zero_optimization.quantized_reduce != "off" and \
                self.onebit_mode:
            # (JAX :328) its own step never consults the knob
            raise ConfigError(
                "zero_optimization.quantized_reduce requires the standard "
                "jitted step: ZeRO-Offload, ZeRO-Infinity and 1-bit "
                "optimizers keep their own gradient transports")
        if self.param_offload_nvme:
            self._init_infinity_state(params, seed)
        else:
            self._init_state(params, seed)
            self._init_grad_reduction()
        self._init_frozen(model)
        if self.onebit_mode:
            from .fp16.onebit import build_train_step_for
            self._onebit = build_train_step_for(self)
        self._last_metrics: Dict[str, float] = {}
        self.last_step_s = None
        self._step_events = None
        # the forward/backward/step shims' state (JAX :1828-1960)
        self._cached_losses: List[Any] = []
        self._shim_grads = False
        self.micro_steps = 0

        # --- observability (JAX :363-383)
        self.tput_timer = ThroughputTimer(self.train_batch_size)
        self.monitor = None
        try:
            from ..monitor.monitor import MonitorMaster
            self.monitor = MonitorMaster(self.config)
        except Exception as e:  # monitor must never break training
            logger.warning(f"monitor disabled: {e}")
        self._init_telemetry()
        logger.info(
            f"engine ready: zero_stage={self.zero_stage} "
            f"dtype={config.precision_dtype} device={self.device} "
            f"dp={self.dp_world_size} (rank {self.dp_rank}, backend "
            f"{comm.get_backend()}) grad_reduce={self.grad_overlap_mode} "
            f"batch={self.train_batch_size} (micro={self.micro_batch_size} "
            f"gas={self.gas})")
        self.memory_breakdown = None
        if self.config.memory_breakdown:
            from ..utils.memory import see_memory_usage
            self.memory_breakdown = see_memory_usage(
                "after engine init (params + optimizer state)", force=True,
                device=self.device)

    # ------------------------------------------------------------------
    # Telemetry and diagnostics (JAX :385-534)
    # ------------------------------------------------------------------
    def _init_telemetry(self):
        """Wire the metrics registry into this engine: the training-step
        series, and the TelemetryBridge that flushes registry scalars
        through MonitorMaster every ``telemetry.flush_interval`` steps.

        Of the JAX series, two are read from XLA there and have no
        compiled program to read here: ``training_comm_exposed_fraction``
        (measured from the HLO schedule only when the JAX step is
        AOT-lowered) keeps its registered default, as on a JAX engine
        that never lowers its step. Under ``quantized_reduce``,
        ``training_reduce_quantized_bytes`` is the plan's quantized ring
        bytes a rank ships a step (``ring_wire_bytes``) and
        ``training_quant_error_feedback_norm`` the global norm of the
        carried error-feedback residuals after each step (JAX :424-444);
        both stay 0 otherwise. ``telemetry.xla_annotations``
        mirrors the spans into ``torch.profiler.record_function`` ranges
        (``telemetry/trace.enable_profiler_annotations``)."""
        from ..telemetry import get_registry
        tcfg = self.config.telemetry
        self.telemetry_enabled = bool(tcfg.enabled)
        self.telemetry = get_registry()
        self.telemetry_bridge = None
        if not self.telemetry_enabled:
            self._init_diagnostics()   # attributes must exist either way
            return
        if tcfg.xla_annotations:
            trace.enable_profiler_annotations(True)
        reg = self.telemetry
        self._tm_loss = reg.gauge("training_loss", "last train_batch loss")
        self._tm_gnorm = reg.gauge("training_grad_norm",
                                   "global gradient norm (pre-clip)")
        self._tm_lr = reg.gauge("training_lr", "learning rate")
        self._tm_scale = reg.gauge("training_loss_scale",
                                   "fp16 dynamic loss scale")
        self._tm_steps = reg.counter("training_steps_total",
                                     "optimizer steps applied")
        self._tm_skipped = reg.counter("training_skipped_steps_total",
                                       "steps skipped on fp16 overflow")
        self._tm_samples = reg.counter("training_samples_total",
                                       "samples consumed")
        self._tm_step_time = reg.histogram(
            "training_step_seconds", "train_batch wall time", unit="s")
        self._tm_comm_exposed = reg.gauge(
            "training_comm_exposed_fraction",
            "fraction of grad-reduce collectives in the compiled train "
            "step with no overlap window (from HLO scheduling analysis)")
        self._tm_bucket_bytes = reg.gauge(
            "training_reduce_bucket_bytes",
            "largest gradient-reduction bucket", unit="bytes")
        self._tm_quant_bytes = reg.gauge(
            "training_reduce_quantized_bytes",
            "per-device wire bytes per step of the quantized ring "
            "gradient reduction (0 when quantized_reduce is off)",
            unit="bytes")
        self._tm_quant_err = reg.gauge(
            "training_quant_error_feedback_norm",
            "global norm of the carried quantized-reduce error-feedback "
            "residuals after the last step")
        if self.grad_bucket_plan is not None:
            self._tm_bucket_bytes.set(self.grad_bucket_plan.max_bucket_bytes)
            if self.quant_reduce_state is not None:
                self._tm_quant_bytes.set(ring_wire_bytes(
                    self.grad_bucket_plan, self._qr["world"], quantized=True,
                    quant_block=self._qr["block"]))
        if self.monitor is not None and self.monitor.enabled:
            self.telemetry_bridge = self.monitor.attach_telemetry(
                reg, flush_interval=tcfg.flush_interval)
        self._init_diagnostics()

    def _init_diagnostics(self):
        """Active observability (telemetry/anomaly.py): the flight
        recorder budget, the loss/grad anomaly detector fed by
        train_batch, the crash post-mortem hook and (lazily, on the first
        batch) the host-sync stall watchdog. All gated by the
        ``diagnostics`` block, under ``telemetry.enabled``."""
        from ..telemetry import recorder as flight
        from ..telemetry.anomaly import LossAnomalyDetector
        dcfg = self.config.diagnostics
        self.diagnostics_enabled = (self.telemetry_enabled
                                    and bool(dcfg.enabled))
        self._grad_attribution = (self.diagnostics_enabled
                                  and bool(dcfg.grad_attribution))
        self._anomaly_detector = None
        self._stall_watchdog = None
        # the watchdog's clock (tests drive a manual one)
        self._watchdog_clock = time.monotonic
        if not self.diagnostics_enabled:
            return
        flight.get_recorder().set_budget(dcfg.recorder_max_bytes)
        self._anomaly_detector = LossAnomalyDetector(
            dcfg, leaf_names=self._grad_leaf_names())
        if dcfg.postmortem_on_crash:
            from ..telemetry import postmortem
            postmortem.install_crash_handler(dcfg)

    def _grad_leaf_names(self) -> List[str]:
        """The gradient leaves' names: the "parameter bucket" labels
        anomaly attribution reports, in the order the step stacks the
        per-leaf squared norms (the JAX ``keystr`` paths, ``/``-joined)."""
        return list(self._leaf_names)

    def _ensure_stall_watchdog(self):
        """Start the train host-sync stall watchdog on first use (no
        thread for engines that never train)."""
        if not self.diagnostics_enabled:
            return None
        dcfg = self.config.diagnostics
        if not dcfg.stall_enabled:
            return None
        if self._stall_watchdog is None:
            from ..telemetry.anomaly import StallWatchdog
            self._stall_watchdog = StallWatchdog(
                dcfg, clock=self._watchdog_clock).start()
            self._stall_watchdog.register("train_step")
        return self._stall_watchdog

    def _record_train_telemetry(self, metrics, skipped: int):
        """Registry updates for one completed train_batch (+ the bridge's
        cadence-gated flush into the monitor backends)."""
        if not self.telemetry_enabled:
            return
        self._tm_loss.set(float(metrics["loss"]))
        self._tm_gnorm.set(float(metrics["grad_norm"]))
        self._tm_lr.set(float(metrics["lr"]))
        if "loss_scale" in metrics:
            self._tm_scale.set(float(metrics["loss_scale"]))
        if "quant_error_norm" in metrics:
            self._tm_quant_err.set(float(metrics["quant_error_norm"]))
        if skipped:
            self._tm_skipped.inc()
        else:
            self._tm_steps.inc()
            self._tm_samples.inc(self.train_batch_size)
        dur = self.tput_timer.last_duration
        if dur:
            self._tm_step_time.observe(dur)
        if self.telemetry_bridge is not None:
            self.telemetry_bridge.step(self.global_steps)

    def _record_flight_and_anomaly(self, metrics, loss: float,
                                   skipped: int, leaf_sqnorms) -> None:
        """One flight-recorder event per completed batch plus the online
        loss/grad anomaly check. Best-effort: diagnostics must never fail
        a training step."""
        if not self.diagnostics_enabled:
            return
        try:
            from ..telemetry import postmortem
            from ..telemetry import recorder as flight
            gnorm = float(metrics["grad_norm"])
            fields = {"step": self.global_steps, "loss": loss,
                      "grad_norm": gnorm, "skipped": bool(skipped),
                      "lr": float(metrics["lr"])}
            if "loss_scale" in metrics:
                fields["loss_scale"] = float(metrics["loss_scale"])
            dur = self.tput_timer.last_duration
            if dur:
                fields["dur_s"] = round(dur, 4)
            flight.record("train_step", **fields)
            verdict = self._anomaly_detector.update(
                self.global_steps, loss, gnorm, leaf_sqnorms=leaf_sqnorms,
                skipped=bool(skipped))
            if (verdict is not None
                    and self.config.diagnostics.postmortem_on_anomaly):
                postmortem.maybe_write_bundle(
                    verdict["kind"], config=self.config.diagnostics)
        except Exception as e:  # pragma: no cover - diagnostics only
            logger.debug(f"train-step diagnostics skipped: {e}")

    def _init_frozen(self, model):
        """``model.frozen_mask`` (a tree of bools like the params, or a
        callable returning one): the leaves that never move (reference
        requires_grad=False). As in JAX (:341, :778), the offloaded
        optimizers and ZeRO-Infinity refuse it."""
        fm = getattr(model, "frozen_mask", None)
        mask = fm() if callable(fm) else fm
        self._frozen_idx: List[int] = []
        if mask is None:
            return
        if self.offload_device or self.param_offload_nvme or \
                self.onebit_mode:
            raise NotImplementedError(
                "frozen_mask is not supported with ZeRO-Offload, "
                "offload_param nvme or 1-bit optimizers; use the resident "
                "optimizer")
        flags = dict(_flatten(mask))
        self._frozen_idx = [i for i, n in enumerate(self._leaf_names)
                            if flags.get(n)]

    def _init_groups(self):
        """The process groups of the step (JAX ``_init_state`` :606-627).

        * ``dp_world_size`` / ``dp_rank``: the data-parallel ranks the
          global batch is split over (``batch_axes``); the tensor- and
          seq-parallel ranks of one data index read the same rows.
        * ``group`` / ``zero_world`` / ``zero_rank``: the ZeRO group. A
          rank's ZeRO shard and its gradient reduction span the data axes
          and, under sequence parallelism, the seq axis (the JAX
          ``include_seq``: the seq ranks are data ranks to ZeRO); under
          MiCS the shard axis alone, the gradients then all-reduced over
          the replica groups (``_replica``: data, with seq under Ulysses
          and, for a dense leaf, expert) too.
        * ``_expert_zero``: an expert leaf's ZeRO group, the ZeRO axes
          less the expert axis (the ranks holding the same experts; the
          ZeRO group itself at ep 1).
        * the model group: the tensor-parallel ranks, over which a split
          leaf's squared norm is summed; likewise the pipe group (the
          pipeline's stages, each holding its slice of the layer stack)
          and, for a model whose layers own the seq axis
          (``pp_manual_axes``), the seq group.
        * ``_cuts``: each leaf's dimension per model-parallel axis it is
          cut over (``model.tp_shard_dims``, ``pipe_shard_dims``,
          ``seq_shard_dims``); a rank holds its slices.

        Under the pipeline (and a model that owns the seq axis) the ZeRO
        group is the data axes alone, as JAX leaves ``include_seq`` off
        there."""
        topo = self.topology
        model = self.model
        self.tp = topo.axis_size("model")
        self.sp = topo.axis_size("seq")
        self.pp = topo.axis_size("pipe")
        manual = set(getattr(model, "pp_manual_axes", ()))
        if getattr(model, "supports_pp_tp", False):
            manual.add("model")
        self._manual_axes = manual
        # the layers own the seq axis (a PipelineModule's seq-cut layers):
        # no Ulysses loss split, the seq ranks hold the same rows
        self._seq_manual = self.sp > 1 and "seq" in manual
        self.dp_world_size = topo.dp_world_size
        self.dp_rank = topo.dp_rank
        self._batch_group = topo.group(topo.batch_axes)
        self.mics = topo.mics_enabled
        ep = topo.axis_size("expert")
        axes = (topo.dp_axes if self.mics or self.pp > 1 or self._seq_manual
                else topo.zero_shard_axes)
        self.group = topo.group(axes)
        self.zero_world = topo.group_size(axes)
        self.zero_rank = topo.group_rank(axes)
        # an expert leaf's ZeRO group: the ranks of the ZeRO axes holding
        # the same experts (the whole ZeRO group at ep 1)
        eaxes = topo.expert_axes(axes) if ep > 1 else axes
        self._expert_zero = (topo.group(eaxes), topo.group_size(eaxes),
                             topo.group_rank(eaxes))
        # MiCS: the replica groups, over which the gradients reduced within
        # the shard group are averaged: the data axis, and the expert axis
        # for a dense leaf and the seq axis under Ulysses (their ranks hold
        # the same shards, as JAX leaves include_seq off under MiCS)
        self._replica = {}
        if self.mics:
            seq = ("seq",) if self.sp > 1 and not self._seq_manual else ()
            for key, extra in ((False, ("expert",) if ep > 1 else ()),
                               (True, ())):
                raxes = ("data",) + extra + seq
                self._replica[key] = (topo.group(raxes),
                                      topo.group_size(raxes))
        self._model_group = topo.group("model") if self.tp > 1 else None
        if hasattr(model, "set_topology"):
            model.set_topology(topo if self.tp > 1 or self.sp > 1
                               or self.pp > 1 else None)
        self._cuts: Dict[str, Dict[str, int]] = {}
        for axis, attr, on in (("model", "tp_shard_dims", self.tp > 1),
                               ("seq", "seq_shard_dims", self._seq_manual),
                               ("pipe", "pipe_shard_dims", self.pp > 1)):
            if not on:
                continue
            dims = getattr(model, attr, None)
            if dims is None:
                raise NotImplementedError(
                    f"a {axis} axis > 1 needs a model that declares which "
                    f"dimension of each leaf it cuts ({attr}; "
                    f"TransformerLM and PipelineModule do)")
            for k, d in dims.items():
                if d is not None:
                    self._cuts.setdefault(k, {})[axis] = d

    def _check_world(self):
        world = self.topology.dp_world_size
        if world != self.ds_config.dp_world_size:
            raise ConfigError(
                f"the config's data-parallel world is "
                f"{self.ds_config.dp_world_size} but the process group has "
                f"{world} ranks: build the config with world_size="
                f"comm.get_world_size() (initialize() does)")
        backend = comm.get_backend()
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if backend is not None and backend != want:
            raise RuntimeError(
                f"a {self.device.type} engine needs the {want!r} process "
                f"group, not {backend!r}")

    def _check_pipeline(self, model):
        """Pipeline mode (JAX :993-1048, :253-280): the compositions it
        runs and its refusals, before any state is built, with JAX's
        exception types (``AssertionError`` for the compositions). With
        fp16 the 1F1B schedule (which computes unscaled gradients) gives
        way to autograd through the pipelined forward, with a warning."""
        self._pipe_own_grads = False
        if self.pp <= 1:
            return
        manual = self._manual_axes
        refusals = [
            # PP composes with DP / ZeRO-1 only (the reference
            # PipelineEngine asserts no ZeRO-2/3)
            (self.zero_stage <= 1,
             "pipeline parallelism requires ZeRO stage <= 1"),
            (self.tp == 1 or "model" in manual,
             "pipeline + tensor parallel requires a model with manual TP "
             "layers (PipelineModule); this model does not declare "
             "'model' in pp_manual_axes"),
            (self.sp == 1 or "seq" in manual,
             "pipeline + sequence parallel requires a model declaring "
             "'seq' in pp_manual_axes (manual seq-axis layers)"),
            (self.topology.axis_size("expert") == 1
             or getattr(model, "supports_pp_ep", False),
             "pipeline + expert-parallel (ep>1) requires a model with a "
             "manual expert-dispatch path (supports_pp_ep); this model "
             "does not declare one")]
        for ok, msg in refusals:
            if not ok:
                raise AssertionError(msg)
        zc = self.config.zero_optimization
        if zc.offload_param.device not in ("none", None, ""):
            raise NotImplementedError(
                "offload_param x pipeline parallelism is not supported "
                "(the 1F1B program owns its own layer storage)")
        own = hasattr(model, "loss_and_grads")
        if self.offload_device:
            if self.fp16_enabled:
                # before the host optimizer is built: it has no loss-scale
                # unwind for the autograd fallback
                raise ConfigError(
                    "offload_optimizer x pipeline parallelism requires bf16 "
                    "(fp16 loss scaling disables the 1F1B schedule)")
            if not own:
                raise AssertionError(
                    "offload_optimizer + pipeline requires a 1F1B-capable "
                    "model (loss_and_grads) and bf16")
        if self.fp16_enabled and own:
            logger.warning(
                "fp16 + pipeline parallelism: loss scaling disables the "
                "1F1B schedule; this run uses whole-graph autograd through "
                "the pipelined forward with UNBOUNDED activation memory "
                "across all microbatches. Prefer bf16 (no scaling needed) "
                "to keep the pipeline's memory bound.")
        self._pipe_own_grads = own and not self.fp16_enabled

    def _init_param_offload(self, model):
        """``offload_param``: the device check and its refusals (JAX
        :229-270)."""
        self.param_offload = False
        self.param_offload_nvme = False
        self._infinity = None
        self.host_stream: Optional[HostLayerStream] = None
        self._param_pins: Optional[PinnedHost] = None
        self._streamed: Dict[str, str] = {}     # leaf path -> layer key
        po = self.config.zero_optimization.offload_param.device
        if po not in ("none", None, ""):
            if po not in ("cpu", "nvme"):
                raise ConfigError(
                    "zero_optimization.offload_param.device must be "
                    f"'cpu' or 'nvme' (got {po!r})")
            if self.zero_stage != 3:
                raise ConfigError(
                    "offload_param requires ZeRO stage 3 (param offload "
                    f"is a stage-3 feature); got stage {self.zero_stage}")
            if not getattr(model, "supports_param_offload", False):
                raise NotImplementedError(
                    "offload_param requires a model that streams its layer "
                    "stack from host memory (supports_param_offload; "
                    "TransformerLM with remat=True does). This model does "
                    "not declare it.")
            if po == "nvme":
                self._check_infinity_supported()
                self.param_offload_nvme = True
            else:
                self.param_offload = True
        # assigned on every build, so a model object reused by a second
        # engine cannot keep a stale stream
        model.stream_params_from_host = self.param_offload
        model.host_stream = None

    def _init_experts(self, model):
        """Expert parallelism (JAX: the expert mesh axis, the model's
        ``param_partition_specs``): which leaves hold experts, the refusals
        at ep > 1, and the MoE layers' process groups."""
        self._expert_dims: Dict[str, int] = dict(
            getattr(model, "expert_leaves", None) or {})
        ep = self.ep
        if ep > 1:
            cfg = getattr(model, "cfg", None)
            E = getattr(cfg, "moe_num_experts", 0)
            if not self._expert_dims or E % ep:
                raise ValueError(
                    f"expert_parallel_size {ep} needs an MoE model whose "
                    f"expert count divides by it (got {E} experts)")
        if hasattr(model, "moe_groups"):
            from ..moe.sharded_moe import MoEGroups
            model.moe_groups = None
            if self.pp > 1:
                # inside the pipeline the gating is local to this rank's
                # tokens, as in JAX's manual program
                if ep > 1:
                    model.moe_groups = MoEGroups(
                        None, 1, 0, self.topology.expert_group(), ep,
                        self.topology.ep_rank)
            else:
                # the gating is global over the tokens of the data ranks
                # and, under Ulysses, of the seq ranks (their chunks)
                topo = self.topology
                sp = self.sp if not self._seq_manual else 1
                axes = topo.batch_axes + (("seq",) if sp > 1 else ())
                if topo.group_size(axes) > 1:
                    model.moe_groups = MoEGroups(
                        topo.group(axes), topo.group_size(axes),
                        topo.group_rank(axes), topo.expert_group(), ep,
                        topo.ep_rank, sp=sp)

    def _expert_cut(self, name: str, v: torch.Tensor) -> torch.Tensor:
        """This rank's experts of a whole expert leaf (identity at ep 1 and
        for other leaves)."""
        d = self._expert_dims.get(name)
        if self.ep == 1 or d is None:
            return v
        return shard_of(v, d, self.topology.ep_rank, self.ep)

    def _manual_cut(self, name: str, v: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole leaf over the model-parallel axes
        that cut it (tensor, seq, pipe; identity for a replicated leaf)."""
        cuts = self._cuts.get(name)
        if not cuts:
            return v
        topo = self.topology
        for axis, d in cuts.items():
            v = shard_of(v, d, topo.axis_index(axis), topo.axis_size(axis))
        return v.contiguous()

    def _norm_splits(self):
        """(group, flags) of each model-parallel axis of more than one
        rank: the leaves cut over it, whose squared norms sum over it.
        Under MiCS at ep > 1 the expert axis is one (the shard group
        holds one rank's experts)."""
        topo = self.topology
        out = [(topo.group(a), [a in self._cuts.get(n, {})
                                for n in self._leaf_names])
               for a in ("model", "seq", "pipe") if topo.axis_size(a) > 1]
        if self.mics and self.ep > 1:
            out.append((topo.expert_group(),
                        [n in self._expert_dims for n in self._leaf_names]))
        return out

    def _ckpt_shape(self, name: str) -> Tuple[int, ...]:
        """A leaf's whole shape (what a checkpoint holds)."""
        shape = list(self._full_shapes[name])
        d = self._expert_dims.get(name)
        if self.ep > 1 and d is not None:
            shape[d] *= self.ep
        for axis, d in self._cuts.get(name, {}).items():
            shape[d] *= self.topology.axis_size(axis)
        return tuple(shape)

    def _check_infinity_supported(self):
        """The refusals of ``offload_param.device='nvme'`` (JAX
        ``_check_infinity_supported`` :544)."""
        po = self.config.zero_optimization.offload_param
        if not po.nvme_path:
            raise ConfigError(
                "offload_param.device='nvme' requires "
                "offload_param.nvme_path")
        if self.fp16_enabled:
            raise NotImplementedError(
                "offload_param nvme requires bf16/fp32 compute (fp16 loss "
                "scaling is not threaded through the per-layer executor)")
        if self.onebit_mode:
            raise NotImplementedError(
                "offload_param nvme x 1-bit optimizers is not supported")
        cfg = getattr(self.model, "cfg", None)
        if cfg is None or not cfg.is_causal or cfg.norm_scheme != "pre":
            raise NotImplementedError(
                "offload_param nvme supports causal-LM pre-LN models "
                "(the same surface as the 1F1B pipeline)")
        if getattr(cfg, "moe_num_experts", 0) > 0:
            raise NotImplementedError(
                "offload_param nvme x MoE is not supported (capacity "
                "routing needs the full layer stack resident)")
        for ax in ("seq", "expert"):
            if self.topology.axis_size(ax) > 1:
                raise NotImplementedError(
                    f"offload_param nvme does not compose with the "
                    f"'{ax}' mesh axis (dp x tp only)")
        zc = self.config.zero_optimization
        if (zc.zero_quantized_weights or zc.zero_quantized_gradients
                or zc.zero_hpz_partition_size > 1 or zc.mics_shard_size > 1):
            raise NotImplementedError(
                "offload_param nvme composes with plain ZeRO-3 only "
                "(no ZeRO++ / MiCS)")

    def _init_infinity_state(self, params, seed: int):
        """ZeRO-Infinity's parameter tier (JAX ``_init_infinity_state``
        :768): the per-layer executor owns params and optimizer state;
        the engine keeps none."""
        from .zero.infinity import InfinityParamEngine

        items = self._initial_items(params, seed)
        self._leaf_names = [k for k, _ in items]
        self._full_shapes = {k: tuple(v.shape) for k, v in items}
        opt_cfg, aio = self.config.optimizer, self.config.aio
        po = self.config.zero_optimization.offload_param
        oo = self.config.zero_optimization.offload_optimizer
        # each rank's pieces over the ZeRO (data) group of its
        # tensor-parallel slices
        self._infinity = InfinityParamEngine(
            self.model, items, self.device,
            opt_name=opt_cfg.type, opt_params=opt_cfg.params,
            param_nvme_path=po.nvme_path,
            optim_device="nvme" if self.offload_device == "nvme" else "cpu",
            optim_nvme_path=(oo.nvme_path if self.offload_device == "nvme"
                             else None),
            aio_block_size=aio.block_size, aio_threads=aio.thread_count,
            gas=self.gas, clip=self.config.gradient_clipping,
            compute_dtype=self.compute_dtype, group=self.group,
            model_group=self._model_group,
            tp_dims={k: c["model"] for k, c in self._cuts.items()
                     if "model" in c})
        self.has_master = True
        self._pdims = self._gdims = self._odims = [None] * len(items)
        self._zero, self._expert_idx = [], []
        self.zero_plan = None
        self.grad_overlap_mode = "off"
        self.grad_bucket_plan = None
        self._reducer = None
        self._param_leaves, self._master_leaves = [], None
        self.params = self.master_params = self.opt_state = None
        self.scale_state = None
        self.param_count = int(sum(torch.Size(self._ckpt_shape(k)).numel()
                                   for k in self._full_shapes))
        self._step = 0
        self._grad_acc = self._grad_shards = None

    def _initial_items(self, params, seed: int):
        """(path, leaf) of the initial weights: ``params``, or the seeded
        draw on the device in the compute dtype."""
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            # drawn on the device in the compute dtype; the fp32 master
            # is cast up from it (a 7B tree never exists in f32 on host)
            items = _flatten(self.model.init_params(
                gen, dtype=self.compute_dtype))
        else:
            items = [(k, torch.as_tensor(np.asarray(v)) if not
                      isinstance(v, torch.Tensor) else v)
                     for k, v in _flatten(params)]
        # ep > 1: this rank keeps its experts; tp / pp > 1: its slices
        return [(k, self._manual_cut(k, self._expert_cut(k, v)))
                for k, v in items]

    # ------------------------------------------------------------------
    def _init_state(self, params, seed: int):
        # as in JAX (:643): ZeRO 1/2/3 keep a master even in fp32
        self.has_master = (self.compute_dtype != torch.float32
                           or self.zero_stage >= 1)
        items = self._initial_items(params, seed)
        self._leaf_names = [k for k, _ in items]
        self._full_shapes = {k: tuple(v.shape) for k, v in items}
        zc = self.config.zero_optimization
        # an offloaded engine at one rank runs on the identity plan (its
        # host tier holds whole leaves); at more than one, on the stage's
        # plan, each rank's host tier holding its master shards
        plan_stage = (0 if self.offload_device and self.zero_world == 1
                      else self.zero_stage)
        # ZeRO++ hpZ: stage-3 compute params cut within the hpZ groups
        topo = self.topology
        self._hpz = self.zero_stage == 3 and topo.hpz_enabled
        sec = topo.secondary_axes
        secondary = ((topo.group(sec), topo.group_size(sec),
                      topo.group_rank(sec)) if self._hpz else None)
        self.zero_plan: ZeroPlan = build_zero_plan(
            self.zero_world, plan_stage, self._full_shapes,
            persistence_threshold=zc.stage3_param_persistence_threshold,
            expert_dims=self._expert_dims if self.ep > 1 else None,
            model_dims={k: tuple(c.values()) for k, c in self._cuts.items()},
            expert_world=self._expert_zero[1],
            secondary_world=secondary[1] if secondary else None)
        names = self._leaf_names
        # each leaf's ZeRO (group, world, rank): an expert leaf's is the
        # ranks holding its experts, every other leaf's the ZeRO group
        dense = (self.group, self.zero_world, self.zero_rank)
        self._expert_idx = [i for i, k in enumerate(names)
                            if k in self._expert_dims]
        self._zero = [self._expert_zero if k in self._expert_dims else dense
                      for k in names]
        # the compute params' ZeRO (group, world, rank): the hpZ group's
        # under hpZ, else the leaf's own
        self._pzero = ([secondary if k not in self._expert_dims else z
                        for k, z in zip(names, self._zero)]
                       if secondary else self._zero)
        self._pdims = [self.zero_plan.param_dims[k] for k in names]
        self._gdims = [self.zero_plan.grad_dims[k] for k in names]
        self._odims = [self.zero_plan.master_dims[k] for k in names]
        self._init_storage(plan_stage)

        def local(i, v, dim, zero=None):
            _, world, rank = (zero or self._zero)[i]
            return v if dim is None else shard_of(v, dim, rank, world)

        def plocal(i, v):
            return local(i, v, self._pdims[i], self._pzero)

        with torch.no_grad():
            if self.offload_device:
                # the master is the f32 value of the same weights, on the
                # host (built by the offload tier from this rank's master
                # shards); the card keeps the compute params only
                master = None
                compute = [plocal(i, v).to(self.device, self.compute_dtype,
                                           copy=params is not None)
                           for i, (_, v) in enumerate(items)]
                self._init_offload([(k, local(i, v, sd, self._szero))
                                    for i, ((k, v), sd)
                                    in enumerate(zip(items, self._sdims))])
            elif self.has_master:
                master = [local(i, v, d).to(self.device, torch.float32,
                                            copy=True)
                          for i, ((_, v), d) in enumerate(zip(items,
                                                              self._odims))]
                # a compute leaf sharded like its master is the master's
                # cast (the same tensor in fp32, as at stage 0)
                compute = [m.to(self.compute_dtype) if self._like_master(i)
                           else plocal(i, v).to(self.device,
                                                self.compute_dtype, copy=True)
                           for i, (m, (_, v)) in enumerate(zip(master,
                                                               items))]
            else:
                master = None
                compute = [v.to(self.device, torch.float32, copy=True)
                           for _, v in items]
        del items
        for p in compute:
            p.requires_grad_(True)
        if self.param_offload:
            compute = self._offload_layers(compute)
        self._param_leaves = compute
        self._master_leaves = master
        self.params = _unflatten(list(zip(self._leaf_names, compute)))
        self.master_params = (_unflatten(list(zip(self._leaf_names, master)))
                              if master is not None else None)
        # a 1-bit optimizer's state is its step's (fp16/onebit)
        self.opt_state = (None if self.offload_device or self.onebit_mode
                          else self.optimizer.init_state(
                              master if master is not None else compute))
        self.scale_state = (init_scale_state(self.scale_cfg, self.device)
                            if self.fp16_enabled else None)
        self.param_count = int(sum(torch.Size(self._ckpt_shape(k)).numel()
                                   for k in self._full_shapes))
        self._step = 0          # optimizer steps applied (JAX _step_arr)
        self._grad_acc: Optional[List[torch.Tensor]] = None
        self._grad_shards: Optional[List[Optional[torch.Tensor]]] = None
        # an offloaded engine at more than one rank: the compute-dtype
        # shard a leaf's host update writes where the compute leaf is not
        # cut as the host tier's master (a replicated one), then gathered
        self._update_bufs = [
            torch.empty(self._local_shape(i, sd, self._szero),
                        dtype=self.compute_dtype, device=self.device)
            if self.offload_device and not self._stored_like_param(i)
            else None
            for i, sd in enumerate(self._sdims)]

    def _init_storage(self, plan_stage: int):
        """The host tiers' storage geometry, ``_szero`` (each leaf's
        (group, world, rank)) and ``_sdims``: the master's own
        (``_zero``, ``_odims``) but under sequence parallelism, where JAX
        keeps the optimizer offload's ZeRO shard on the data axes (its
        ``include_seq`` is off there, :608-619). The gradients still
        reduce over data x seq as the resident step's do, and the norm
        and clipping read them so; :meth:`_to_storage` re-cuts them for
        the tier."""
        self._szero, self._sdims = self._zero, self._odims
        if not (self.offload_device and self.sp > 1 and not self.mics
                and not self._seq_manual):
            return
        topo = self.topology
        axes = topo.dp_axes
        dense = (topo.group(axes), topo.group_size(axes),
                 topo.group_rank(axes))
        eaxes = topo.expert_axes(axes) if self.ep > 1 else axes
        expert = (topo.group(eaxes), topo.group_size(eaxes),
                  topo.group_rank(eaxes))
        plan = build_zero_plan(
            dense[1], 0 if dense[1] == 1 else plan_stage, self._full_shapes,
            expert_dims=self._expert_dims if self.ep > 1 else None,
            model_dims={k: tuple(c.values()) for k, c in self._cuts.items()},
            expert_world=expert[1])
        self._szero = [expert if k in self._expert_dims else dense
                       for k in self._leaf_names]
        self._sdims = [plan.master_dims[k] for k in self._leaf_names]

    def _stored_like_param(self, i: int) -> bool:
        """Whether the host tier's master of leaf ``i`` is cut as its
        compute leaf is (then the tier's update writes that leaf)."""
        sd, pd = self._sdims[i], self._pdims[i]
        return sd == pd and (sd is None or self._szero[i] is self._pzero[i])

    def _to_storage(self, grads) -> List[torch.Tensor]:
        """The reduced, clipped gradients (cut like the master, ``_odims``
        over ``_zero``) re-cut as the host tier stores its master."""
        if self._szero is self._zero:
            return grads
        out = []
        for i, g in enumerate(grads):
            od, sd = self._odims[i], self._sdims[i]
            full = g if od is None else all_gather_leaf(g, od,
                                                        self._zero[i][0])
            _, world, rank = self._szero[i]
            out.append((full if sd is None else
                        shard_of(full, sd, rank, world)).contiguous())
        return out

    @torch.no_grad()
    def _params_from_tier(self):
        """The compute params as the cast of the host tier's master, as
        in JAX: gathered over the tier's group where the compute leaf is
        cut otherwise."""
        master, _ = self.host_opt.get_all_leaves()
        for i, (p, m) in enumerate(zip(self._param_leaves, master)):
            if self._stored_like_param(i):
                copy_rows(p.detach(), m)
            else:
                self._param_from_shard(i, m.to(self.device,
                                                self.compute_dtype))

    def _param_from_shard(self, i: int, shard: torch.Tensor):
        """Compute leaf ``i`` from every rank's piece ``shard`` of it (cut
        as the host tier stores it)."""
        sd, pd = self._sdims[i], self._pdims[i]
        full = shard if sd is None else all_gather_leaf(shard, sd,
                                                        self._szero[i][0])
        if pd is not None:
            _, world, rank = self._pzero[i]
            full = shard_of(full, pd, rank, world)
        self._param_leaves[i].copy_(full)

    def _like_master(self, i: int) -> bool:
        """Whether compute leaf ``i`` is cut as its master is (then it is
        the master's cast): sharded on the same group, or neither sharded.
        Not so under hpZ, nor for a replicated leaf with a sharded
        master."""
        pd, od = self._pdims[i], self._odims[i]
        if pd is None:
            return od is None
        return pd == od and self._pzero[i] is self._zero[i]

    def _local_shape(self, i: int, dim: Optional[int],
                     zero=None) -> Tuple[int, ...]:
        """The shape of this rank's shard of leaf ``i`` along ``dim`` over
        its ZeRO group (``zero``'s, by default :attr:`_zero`)."""
        shape = list(self._full_shapes[self._leaf_names[i]])
        if dim is not None:
            shape[dim] //= (zero or self._zero)[i][1]
        return tuple(shape)

    def _offload_layers(self, compute):
        """``offload_param {device: cpu}``: the stacked layer leaves
        (``param_offload_keys``) move to host memory, page-locked on the
        card (JAX ``_host_param_sharding`` :582); the model streams them
        back one layer at a time."""
        keys = tuple(getattr(self.model, "param_offload_keys", ("layers",)))
        self._param_pins = PinnedHost(self.device.type == "cuda")
        host = {}
        out = []
        for name, p in zip(self._leaf_names, compute):
            if any(name.startswith(k + "/") for k in keys):
                h = torch.empty(p.shape, dtype=p.dtype)
                copy_rows(h, p)
                p = self._param_pins.pin(h)
                self._streamed[name] = name.split("/", 1)[1]
                host[self._streamed[name]] = p
            out.append(p)
        del compute
        self.host_stream = HostLayerStream(host, self.device)
        self.model.host_stream = self.host_stream
        return out

    def _grad_inputs(self) -> List[torch.Tensor]:
        """What ``autograd.grad`` differentiates: the leaves, with each
        host-resident layer leaf replaced by its device anchor."""
        if self.host_stream is None:
            return self._param_leaves
        anchors = self.host_stream.anchors
        return [anchors[self._streamed[n]] if n in self._streamed else p
                for n, p in zip(self._leaf_names, self._param_leaves)]

    def _init_grad_reduction(self):
        """The leaves' reduction kinds, the stage-3 gathers and the bucket
        plan (JAX ``make_overlapped_grad_fn``'s planning, :648-758), with
        ZeRO++ and ``quantized_reduce`` (JAX :913-991): qwZ at stage 3 and
        qgZ at stages 2-3 where the gather's group has more than one rank,
        the quantized rings at a data-parallel world > 1 (inert at 1, with
        JAX's log line), and their refusals."""
        names = self._leaf_names
        zc = self.config.zero_optimization
        topo = self.topology
        gather_world = (topo.group_size(topo.secondary_axes) if self._hpz
                        else self.zero_world)
        # the optimizer offload keeps its own gradient transport, as JAX's
        # offload step does (:340-355): ZeRO++ quantizes nothing there
        zpp = not self.offload_device
        zpp_w = bool(zpp and zc.zero_quantized_weights
                     and self.zero_stage == 3 and gather_world > 1)
        zpp_g = bool(zpp and zc.zero_quantized_gradients
                     and self.zero_stage >= 2 and self.zero_world > 1)
        qr_on = zc.quantized_reduce != "off"
        if qr_on and self.ds_config.dp_world_size <= 1:
            from ..utils.logging import log_dist
            log_dist(
                "quantized_reduce is inert without data parallelism "
                "(dp world 1): no ring transport to quantize — running "
                "unquantized", ranks=[0])
            qr_on = False
        use_zeropp = zpp_w or zpp_g or qr_on
        if use_zeropp:
            if self.param_offload:
                raise ConfigError(
                    "the manual (bucketed/ZeRO++) gradient program does not "
                    "compose with offload_param (host-streamed layer "
                    "storage)")
            for ax in ("expert", "pipe"):
                if qr_on and topo.axis_size(ax) != 1:
                    raise ConfigError(
                        f"zero_optimization.quantized_reduce does not "
                        f"compose with {ax} parallelism: the quantized "
                        f"ring rides the manual data-parallel program")
                if topo.axis_size(ax) != 1:
                    raise AssertionError(
                        f"the manual gradient program composes with "
                        f"dp/tp/sp only (got {ax} size "
                        f"{topo.axis_size(ax)})")
        self._cross = (topo.group("data"), topo.axis_size("data"))
        self._kinds = leaf_kinds(names, self.zero_plan, hpz_cross=self._hpz)
        stack = tuple(getattr(self.model, "param_offload_keys", ()) or ())
        stacked = [any(n.startswith(k + "/") for k in stack) for n in names]

        def tp_of(n, shift=0):
            d = self._cuts.get(n, {}).get("model")
            if d is None or not (zpp_w or zpp_g):
                return None
            return (topo.group("model"), d - shift)

        def gather(d, i, shift=0):
            return make_zero3_gather(d, self._pzero[i][0],
                                     fwd_quantized=zpp_w,
                                     bwd_quantized=zpp_g,
                                     tp=tp_of(names[i], shift))

        # stage 3: a stacked leaf cut along a layer's own dimension is
        # gathered layer by layer in the model's loop; any other sharded
        # leaf once before the forward. Quantized gathers take whole
        # leaves, as JAX's do: a quantization block spans the layers of a
        # stacked shard
        self._whole_gathers: Dict[int, Any] = {}
        layer_gathers: Dict[str, Any] = {}
        per_layer = hasattr(self.model, "layer_gather") and not (zpp_w
                                                                  or zpp_g)
        for i, (n, d) in enumerate(zip(names, self._pdims)):
            if d is None:
                continue
            if stacked[i] and d > 0 and per_layer:
                layer_gathers[n.split("/", 1)[1]] = gather(d - 1, i, 1)
            elif n in self._streamed:
                raise NotImplementedError(
                    f"offload_param: {n} is cut along its layer axis at "
                    f"{self.zero_world} ranks, so no rank holds whole "
                    f"layers to stream")
            else:
                self._whole_gathers[i] = gather(d, i)
        self._layer_gather = None
        if layer_gathers:
            def layer_gather(lp):
                return {k: layer_gathers[k](v) if k in layer_gathers else v
                        for k, v in lp.items()}

            self._layer_gather = layer_gather
        self.grad_overlap_mode = resolve_overlap_mode(self, use_zeropp)
        self.grad_bucket_plan = None
        self._reducer = None
        # quantized transports and hpZ reduce after the backward on JAX's
        # bucket layout; the plain buckets reduce in the backward's hooks
        self._post_reduce = (self.grad_overlap_mode == "bucketed"
                             and (use_zeropp or self._hpz))
        if self.grad_overlap_mode == "bucketed":
            shapes = [self._full_shapes[n] for n in names]
            unroll = None
            if self._post_reduce:
                cfg = getattr(self.model, "cfg", None)
                hint = 2 if (self.zero_stage == 3 and zc.overlap_comm
                             and gather_world > 1) else 1
                unroll = max(int(getattr(cfg, "scan_unroll", 1) or 1), hint)
            self.grad_bucket_plan = plan_grad_buckets(
                names, shapes, self.zero_plan,
                zc.reduce_bucket_size, zc.allgather_bucket_size,
                stack_keys=stack, unroll=unroll, hpz_cross=self._hpz,
                gather_world=gather_world)
            if not self._post_reduce:
                self._reducer = BucketedReducer(self.grad_bucket_plan,
                                                self._gdims, self.device,
                                                self.group)
            logger.info(f"grad overlap: bucketed reduction "
                        f"({self.grad_bucket_plan.num_buckets} buckets, "
                        f"{len(self.grad_bucket_plan.vjp_leaves)} vjp-reduced "
                        f"leaves, quantized={zpp_g}, "
                        f"quantized_reduce={zc.quantized_reduce}, "
                        f"hierarchy={zc.quantized_reduce_hierarchy})")
        self._zpp_g = zpp_g
        if qr_on:
            self._init_quant_reduce(zpp_g)

    def _init_quant_reduce(self, zpp_g: bool):
        """The quantized rings' settings and zero error-feedback residuals
        (JAX ``make_overlapped_grad_fn`` :892-928, engine :966-984)."""
        zc = self.config.zero_optimization
        topo = self.topology
        if self.tp > 1 or self.sp > 1:
            raise ConfigError(
                "zero_optimization.quantized_reduce does not compose with "
                "tensor/sequence parallelism: the quantized ring needs the "
                "fully-manual data-parallel program")
        axes = topo.dp_axes
        live = [a for a in axes if topo.sizes[a] > 1]
        if len(live) > 1:
            raise ConfigError(
                "zero_optimization.quantized_reduce needs a single live "
                f"data-parallel mesh axis for the ring transport (got "
                f"{live})")
        world = topo.group_size(axes)
        groups = int(zc.quantized_reduce_hierarchy or 0)
        if groups > 1 and world % groups != 0:
            raise ConfigError(
                f"zero_optimization.quantized_reduce_hierarchy="
                f"{groups} must divide the data-parallel world "
                f"({world}): the two-level ring lays the ring out as "
                f"hosts x devices-per-host")
        layout = quant_reduce_layout(self.grad_bucket_plan, axes, world,
                                     topo.sizes, ring=True,
                                     a2a_quantized=zpp_g)
        self._qr = {"mode": zc.quantized_reduce, "block": int(zc.quant_block),
                    "groups": groups, "world": world, "layout": layout}
        self.quant_reduce_state = {
            k: {kk: torch.zeros(shape, dtype=torch.float32,
                                device=self.device)
                for kk, shape in v.items()}
            for k, v in layout.items()}

    def _init_offload(self, items):
        """The host tier (JAX ``_init_offload_state`` :797 /
        ``_init_tiered_offload_state`` :825) from the same weights the
        resident engine starts from. Stacked layer leaves may be cut
        between layers into segments of at most
        ``stage3_prefetch_bucket_size`` elements."""
        from .offload import TieredOptimizerOffload
        from .zero.offload import HostOffloadOptimizer

        zc = self.config.zero_optimization
        names = [k for k, _ in items]
        leaves = [v for _, v in items]
        stacked = [k.startswith("layers/") for k in names]
        if self.offload_tiered:
            self.host_opt = TieredOptimizerOffload(
                self.optimizer, leaves,
                bucket_elems=zc.stage3_prefetch_bucket_size,
                buffer_count=zc.offload_optimizer.buffer_count,
                device=self.device, splittable=stacked)
            return
        opt_cfg, aio = self.config.optimizer, self.config.aio
        self.host_opt = HostOffloadOptimizer(
            opt_cfg.type, opt_cfg.params, leaves, names,
            device=self.offload_device,
            nvme_path=zc.offload_optimizer.nvme_path,
            aio_block_size=aio.block_size, aio_threads=aio.thread_count,
            compute_dtype=self.compute_dtype,
            segment_elems=zc.stage3_prefetch_bucket_size,
            buffer_count=zc.offload_optimizer.buffer_count,
            splittable=stacked, transfer_device=self.device)

    # ------------------------------------------------------------------
    def _shard_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host batch [gas * global_micro, ...] or [gas, global_micro, ...]
        -> this rank's rows [gas, micro, ...] on the device (rows
        ``[rank * micro, (rank + 1) * micro)`` of each global
        micro-batch)."""
        def prep(x):
            x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            gm = self.micro_batch_size * self.ds_config.dp_world_size
            if x.ndim >= 2 and x.shape[0] == self.gas and x.shape[1] == gm:
                pass
            elif x.shape[0] == self.gas * gm:
                x = x.reshape((self.gas, gm) + tuple(x.shape[1:]))
            else:
                raise ValueError(
                    f"batch dim {tuple(x.shape[:2])} incompatible with "
                    f"gas={self.gas}, global_micro={gm}")
            if self.dp_world_size > 1:
                m = self.micro_batch_size
                x = x[:, self.dp_rank * m:(self.dp_rank + 1) * m]
            return x.to(self.device)

        return {k: prep(v) for k, v in batch.items()}

    def _next_batch(self, data_iter):
        """Stack ``gas`` global micro-batches (dicts of arrays) from an
        iterator, or from the engine's dataloader."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch/eval_batch need a data_iter, "
                                 "a batch or a training dataloader")
            data_iter = self.training_dataloader
        micro = [next(data_iter) for _ in range(self.gas)]
        return {k: np.stack([np.asarray(m[k]) for m in micro])
                for k in micro[0]}

    def _micro_batches(self, dev_batch):
        for g in range(self.gas):
            yield {k: v[g] for k, v in dev_batch.items()}

    def _model_params(self, reducer=None, acc=None):
        """The tree ``model.apply`` reads: stage-3 shards gathered (the
        whole-leaf gathers here, the per-layer ones left to the model's
        loop through ``layer_gather``); under ``reducer``, each bucketed
        unit's tensor — the leaf, or the per-layer views of a stacked leaf
        — carries the hook that hands its gradient to its bucket."""
        if hasattr(self.model, "layer_gather"):
            self.model.layer_gather = self._layer_gather
        views = self.host_stream.begin() if self.host_stream else {}
        units: Dict[int, List[Tuple[int, Any]]] = {}
        if reducer is not None:
            for u, unit in enumerate(reducer.plan.units):
                if unit.kind != VJP:
                    units.setdefault(unit.leaf, []).append((u, unit))
        items = []
        for i, (name, p) in enumerate(zip(self._leaf_names,
                                          self._param_leaves)):
            if i in self._whole_gathers:
                v = self._whole_gathers[i](p)
            elif i in units:
                if units[i][0][1].layer >= 0:
                    # a streamed leaf's layers reach autograd through its
                    # anchor's views (the model gets the host tensor)
                    v = views.get(self._streamed.get(name)) or \
                        torch.unbind(p)
                    for u, unit in units[i]:
                        v[unit.layer].register_hook(
                            reducer.hook_for(u, acc[i][unit.layer]))
                    if name in self._streamed:
                        v = p
                else:
                    v = p.view_as(p)
                    v.register_hook(reducer.hook_for(units[i][0][0], acc[i]))
            else:
                v = p
            items.append((name, v))
        return _unflatten(items)

    def _optimizer_grads(self, acc, shards) -> List[torch.Tensor]:
        """Each leaf's reduced gradient, cut like its master."""
        out = []
        for i, kind in enumerate(self._kinds):
            if kind == REDUCE_SCATTER:
                out.append(shards[i])
            elif kind == CROSS_GROUP:
                # hpZ: the group shard of the mean, re-cut like the master
                full = all_gather_leaf(acc[i], self._pdims[i],
                                       self._pzero[i][0])
                _, world, rank = self._zero[i]
                od = self._odims[i]
                out.append(full if od is None else
                           shard_of(full, od, rank, world))
            elif kind == VJP or self._odims[i] is None:
                out.append(acc[i])
            else:
                _, world, rank = self._zero[i]
                g = shard_of(acc[i], self._odims[i], rank, world)
                # the host tiers read flat, contiguous gradients
                out.append(g.contiguous() if self.host_opt is not None
                           else g)
        return out

    @torch.no_grad()
    def _publish_params(self):
        """The compute params from the updated master (JAX :1132-1136): a
        leaf sharded like its master is the master's cast; a replicated
        leaf with a sharded master gathers the cast shards."""
        for i, (p, m, pd, od, z) in enumerate(zip(
                self._param_leaves, self._master_leaves, self._pdims,
                self._odims, self._zero)):
            if p.device != m.device:
                # a streamed layer leaf in host memory: cast on the card
                # (a cast across devices would run on the host), one layer
                # at a time
                for r in range(p.shape[0]):
                    p[r].copy_(m[r].to(p.dtype))
            elif self._like_master(i):
                p.copy_(m)
            else:
                full = (m.to(self.compute_dtype) if od is None else
                        all_gather_leaf(m.to(self.compute_dtype), od, z[0]))
                if pd is not None:
                    # hpZ: this rank's slice within its group
                    _, pworld, prank = self._pzero[i]
                    full = shard_of(full, pd, prank, pworld)
                p.copy_(full)

    def _update_targets(self) -> List[torch.Tensor]:
        """Where the host tier writes the updated compute params: the
        compute leaf, or (more than one rank, replicated compute leaf,
        sharded master) this rank's shard buffer."""
        return [p if b is None else b
                for p, b in zip(self._param_leaves, self._update_bufs)]

    @torch.no_grad()
    def _gather_updated(self):
        """After a host-tier update at more than one rank: each compute
        leaf not cut as the tier's master from every rank's updated
        shard."""
        for i, b in enumerate(self._update_bufs):
            if b is not None:
                self._param_from_shard(i, b)

    def _mean_over_group(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data-parallel ranks (the tensor- and
        seq-parallel ranks already hold the same loss)."""
        if self.dp_world_size > 1:
            x = x.reshape(1).clone()
            comm.all_reduce(x, group=self._batch_group)
            x = x[0] / self.dp_world_size
        return x

    def _root(self, loss, scale):
        """What a micro-batch's backward starts from: the (fp16-scaled)
        loss, times sp under sequence parallelism, whose ranks each
        differentiate their own part of the loss while the reduction takes
        the mean over data x seq ranks (not where the layers own the seq
        axis: each seq rank then holds the whole loss)."""
        if scale is not None:
            loss = loss * scale
        if self.sp > 1 and not self._seq_manual:
            return loss * self.sp
        return loss

    # ------------------------------------------------------------------
    def train_batch(self, data_iter=None, batch=None) -> float:
        """Run one full (global micro * gas) training batch; returns the
        mean micro-batch loss over the data-parallel group.

        The step's spans (JAX :1693-1730): ``train_data`` (the batch to
        the device), ``train_step`` holding ``train_device_dispatch`` (the
        forward, backward and update, enqueued on the card) and
        ``train_host_sync`` (the fetch of the loss and norms, where the
        host waits for the card). The stall watchdog is armed only while
        a step is in flight."""
        if batch is None:
            batch = self._next_batch(data_iter)
        t0 = time.perf_counter()
        with trace.span("train_data", step=self.global_steps):
            dev_batch = self._shard_batch(batch)
        stall = self._ensure_stall_watchdog()
        if stall is not None:
            stall.beat("train_step")
            stall.set_active("train_step", True)
        self.tput_timer.start()
        self._shim_grads = False    # the step reuses the shims' buffers
        with trace.span("train_step", step=self.global_steps):
            with trace.span("train_device_dispatch"):
                if self._infinity is not None:
                    out = self._run_infinity(dev_batch)
                elif self._onebit is not None:
                    out = self._onebit.step(dev_batch)
                else:
                    out = self._run_step(dev_batch)
            with trace.span("train_host_sync"):
                metrics, leaf_sq = self._fetch_metrics(out)
        if stall is not None:
            stall.beat("train_step")
            stall.set_active("train_step", False)
        # the host counters mirror the applied steps: an fp16 step that
        # overflowed moves neither global_steps nor the schedule
        skipped = metrics["skipped"]
        self.skipped_steps += skipped
        self._batches_seen += 1
        if not skipped:
            self.global_steps += 1
            self.lr_scheduler.step()
        self.tput_timer.stop(global_step=True)
        return self._finish_step(metrics, t0, leaf_sq)

    def _grad_buffers(self):
        """The f32 gradient accumulators (one per leaf) and the
        reduce-scatter shards, allocated at first use."""
        if self._grad_acc is None:
            self._grad_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                          device=self.device)
                              for p in self._grad_inputs()]
            self._grad_shards = [
                torch.zeros(self._local_shape(i, d), dtype=torch.float32,
                            device=self.device)
                if k == REDUCE_SCATTER else None
                for i, (k, d) in enumerate(zip(self._kinds, self._gdims))]
        return self._grad_acc, self._grad_shards

    def _run_step(self, dev_batch) -> Dict[str, Any]:
        """The step on the card: the GAS loop (under the pipeline,
        :meth:`_pipeline_grads`), the reduction, then :meth:`_apply_grads`.
        Returns the loss, the norms and the skip flag, the loss and the
        norms still on the device."""
        leaves = self._grad_inputs()
        acc, shards = self._grad_buffers()
        scale = (self.scale_state["loss_scale"] if self.fp16_enabled
                 else None)
        lr = self._lr_fn(self._step)
        events = None
        if self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
        if self.offload_tiered:
            # the state fetches ride under the forward and backward
            self.host_opt.prefetch()
        inv = None
        if self.pp > 1:
            loss, inv = self._pipeline_grads(dev_batch, acc, scale)
        else:
            for a in acc:
                a.zero_()
            losses = []
            for g, micro in enumerate(self._micro_batches(dev_batch)):
                reducer = self._reducer if g == self.gas - 1 else None
                params = self._model_params(reducer, acc)
                loss = self.model.apply(params, micro, train=True).float()
                grads = torch.autograd.grad(self._root(loss, scale), leaves,
                                            allow_unused=True)
                del params
                with torch.no_grad():
                    for a, gr, kind in zip(acc, grads, self._kinds):
                        # a bucketed leaf's last gradient went to its bucket
                        if gr is not None and (reducer is None
                                               or kind == VJP):
                            a.add_(gr)
                # a bf16 grad tree of 7B is 14.5 GB: the next micro-batch's
                # backward must not find this one alive
                del grads
                losses.append(loss.detach())
            loss = torch.stack(losses).mean()
        new_q = None
        with torch.no_grad():
            if self._reducer is not None:
                self._reducer.finish(acc, shards)
            elif self._post_reduce:
                new_q = self._reduce_buckets(acc, shards, scale)
            else:
                self._reduce(acc, shards)
            loss = self._mean_over_group(loss)
            ok, gnorm, leaf_sq = self._apply_grads(acc, shards, scale, lr,
                                                   events, inv=inv)
        self._step_events = events
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr,
               "skipped": 0 if ok else 1, "leaf_sqnorms": leaf_sq}
        if self.fp16_enabled:
            out["loss_scale"] = scale
        if self.quant_reduce_state is not None:
            # an overflowed step's transport errors are garbage: the
            # residuals keep their pre-step values (JAX :1120-1126)
            if ok:
                self.quant_reduce_state = new_q
            out["quant_error_norm"] = self._quant_error_norm()
        return out

    def _reduce_buckets(self, acc, shards, scale):
        """The bucket plan's collectives after the backward, on JAX's
        layout (``apply_bucketed_reduction``): ZeRO++ qgZ, the quantized
        rings with their residuals, hpZ's cross-group means; then MiCS's
        replica means and the expert division. Returns the new
        residuals."""
        qr = self._qr or {}
        new_q = apply_bucketed_reduction(
            acc, self.grad_bucket_plan, self._gdims, shards,
            group=self.group, world=self.zero_world,
            cross_group=self._cross[0], cross_world=self._cross[1],
            quantized=self._zpp_g, quant_reduce=qr.get("mode"),
            quant_reduce_block=qr.get("block", 2048),
            quant_reduce_groups=qr.get("groups", 0),
            qstate=self.quant_reduce_state, qlayout=qr.get("layout"),
            loss_scale=scale)
        self._reduce_replicas(acc, shards)
        self._reduce_experts(acc, shards)
        return new_q

    def _quant_error_norm(self) -> torch.Tensor:
        """The global norm of the carried residuals, every rank's."""
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for v in self.quant_reduce_state.values():
            for x in v.values():
                sq += x.square().sum()
        sq = sq.reshape(1)
        comm.all_reduce(sq, group=self.group)
        return sq[0].sqrt()

    def _pipeline_grads(self, dev_batch, acc, scale):
        """Pipeline mode's gradients into ``acc`` (JAX ``train_step``,
        :1055-1079): the whole ``[M, micro, ...]`` batch (M = gas)
        through ``model.loss_and_grads``, the 1F1B schedule, which
        accumulates into ``acc`` the mean over the micro-batches, summed
        over the pipe group where a leaf is replicated over it. Under fp16
        (or for a model without it) autograd of the loss scale times
        ``model.apply``'s pipelined loss instead, whose gradients the
        model makes whole over the pipe group. Returns the loss (the mean
        over the micro-batches, on the device) and the unscale factor."""
        params = self._model_params()
        if self._pipe_own_grads:
            loss, _ = self.model.loss_and_grads(params, dev_batch,
                                                grad_acc=acc)
            return loss.detach(), 1.0
        loss = self.model.apply(params, dev_batch, train=True).float()
        grads = torch.autograd.grad(
            loss * scale if scale is not None else loss, self._grad_inputs(),
            allow_unused=True)
        with torch.no_grad():
            for a, g in zip(acc, grads):
                if g is None:
                    a.zero_()
                else:
                    a.copy_(g)
        return loss.detach(), (1.0 / scale if scale is not None else 1.0)

    def _reduce(self, acc, shards):
        """``overlap_grad_reduce`` off: every leaf's reduction after the
        backward, each over its ZeRO group (:attr:`_zero`), then
        :meth:`_reduce_experts`."""
        reduce_leaves(acc, self._kinds, self._gdims, shards,
                      [z[0] for z in self._zero], cross_group=self._cross[0])
        self._reduce_replicas(acc, shards)
        self._reduce_experts(acc, shards)

    def _reduce_replicas(self, acc, shards):
        """MiCS: each gradient reduced within the shard group (its shard,
        or the whole leaf) is averaged over the replica groups too (JAX
        ``dp_axes``: reduce-scatter within, all-reduce across)."""
        if not self._replica:
            return
        experts = set(self._expert_idx)
        for i, (a, s, kind) in enumerate(zip(acc, shards, self._kinds)):
            group, n = self._replica[i in experts]
            if n > 1:
                t = s if kind == REDUCE_SCATTER else a
                comm.all_reduce(t, group=group)
                t.div_(n)

    def _reduce_experts(self, acc, shards):
        """An expert leaf (ep > 1) already holds its expert group's sum
        (the all-to-all backward): its mean over the ranks holding the
        same experts, divided by ep, is the mean loss's gradient (the
        world's sum over the world, as JAX's)."""
        if self.ep <= 1:
            return
        for i in self._expert_idx:
            t = shards[i] if self._kinds[i] == REDUCE_SCATTER else acc[i]
            t.div_(self.ep)

    def _apply_grads(self, acc, shards, scale, lr, events=None, inv=None):
        """Unscale, clip and check the reduced gradients, then the update
        (resident, tiered or host optimizer) unless the step overflowed,
        and the fp16 scale update. Returns (ok, grad norm on the device,
        stacked per-leaf squared norms or None). Reads ``finite`` on the
        host once per fp16 step (other precisions never skip). ``inv``:
        the unscale factor, 1 / (gas * loss_scale) unless given."""
        if inv is None:
            inv = 1.0 / (self.gas * scale) if scale is not None \
                else 1.0 / self.gas
        sharded = [k not in (ALL_REDUCE, CROSS_GROUP) or d is not None
                   for k, d in zip(self._kinds, self._odims)]
        replicas = {}
        if self.ep > 1:
            # an expert leaf's part differs along the expert axis: summed
            # over the ZeRO group, once for each of the ranks that hold
            # the same part (its expert ZeRO group when not sharded)
            for i in self._expert_idx:
                sharded[i] = True
                if self._odims[i] is None:
                    replicas[i] = self._expert_zero[1]
        grads, finite, gnorm, *leaf_sq = unscale_clip_check(
            self._optimizer_grads(acc, shards), inv,
            self.config.gradient_clipping, self.fp16_enabled,
            sharded=sharded, group=self.group, frozen=self._frozen_idx,
            splits=self._norm_splits(),
            with_leaf_sqnorms=self._grad_attribution, replicas=replicas)
        if events is not None:
            events[1].record()
        ok = True if finite is None else bool(finite.item())
        if self.host_opt is None:
            target = (self._master_leaves if self.has_master
                      else self._param_leaves)
            self._step = apply_update_with_skip(
                self.optimizer, target, grads, self.opt_state,
                self._step, lr, ok, frozen=self._frozen_idx,
                **self._whole_leaf_kw())
            if ok and self.has_master:
                self._publish_params()
        elif ok:
            # an overflowed step leaves the host state untouched
            grads = self._to_storage(grads)
            if self.offload_tiered:
                self.host_opt.stream_update(grads, self._update_targets(),
                                            self._step, lr,
                                            **self._whole_leaf_kw())
            else:
                self.host_opt.step(grads, self._update_targets(),
                                   self._step + 1, lr)
            self._gather_updated()
            self._step += 1
        if self.fp16_enabled:
            self.scale_state = update_scale(
                self.scale_state, torch.tensor(ok, device=self.device),
                self.scale_cfg)
        if events is not None:
            events[2].record()
        return ok, gnorm, (leaf_sq[0] if leaf_sq else None)

    def _whole_leaf_kw(self):
        """An optimizer that reads whole leaves (LAMB's trust ratio) on a
        master cut over ranks: ``norm_reduce(i, t)`` sums leaf ``i``'s
        partial squares ``t`` over its ZeRO group, for a tensor-parallel
        leaf its model group, and for an expert leaf its expert group."""
        if self.optimizer.elementwise or (self.zero_world == 1
                                          and not self._cuts):
            return {}
        # the master: the host tier's, or the card's (the params without
        # one)
        dims, zeros = ((self._sdims, self._szero) if self.host_opt is not None
                       else (self._odims if self.has_master else self._pdims,
                             self._zero))
        zero = [d is not None and z[1] > 1 for d, z in zip(dims, zeros)]
        axes = [[self.topology.group(a) for a in self._cuts.get(n, {})]
                for n in self._leaf_names]
        if self.ep > 1:
            # an expert leaf is whole over its expert group too
            for i in self._expert_idx:
                axes[i].append(self.topology.expert_group())

        def norm_reduce(i, t):
            if zero[i]:
                comm.all_reduce(t, group=zeros[i][0])
            for g in axes[i]:
                comm.all_reduce(t, group=g)

        return {"norm_reduce": norm_reduce}

    def _fetch_metrics(self, out):
        """The step's numbers on the host: the loss and the grad norm,
        and the stacked per-leaf squared norms (one small fetch) when
        anomaly attribution is on."""
        leaf_sq = out.pop("leaf_sqnorms", None)
        metrics = {k: (float(v) if k != "skipped" else int(v))
                   for k, v in out.items()}
        if leaf_sq is not None:
            leaf_sq = leaf_sq.cpu().numpy().astype(np.float64)
        return metrics, leaf_sq

    def _run_infinity(self, dev_batch) -> Dict[str, Any]:
        """The ZeRO-Infinity batch (JAX ``_train_batch_infinity`` :1468):
        the per-layer executor streams the layers from their files,
        accumulates host gradients and runs the host optimizer."""
        lr = self._lr_fn(self._step)
        metrics = dict(self._infinity.train_batch(dev_batch, self._step + 1,
                                                  lr))
        self._step += 1
        metrics["lr"] = lr
        metrics["loss"] = self._mean_over_group(
            torch.tensor(metrics["loss"], device=self.device))
        return metrics

    def _finish_step(self, metrics, t0, leaf_sq=None) -> float:
        loss_f, lr, skipped = (metrics["loss"], metrics["lr"],
                               metrics["skipped"])
        self.last_step_s = time.perf_counter() - t0
        if self.config.wall_clock_breakdown and \
                self._batches_seen % self.config.steps_per_print == 0:
            logger.info(f"time: train_batch={self.last_step_s * 1e3:.1f}ms "
                        f"samples/s={self.train_batch_size / self.last_step_s:.1f}")
        if skipped or self._batches_seen % self.config.steps_per_print == 0:
            logger.info(
                f"step={self.global_steps} loss={loss_f:.5f} lr={lr:.3e} "
                f"grad_norm={metrics['grad_norm']:.4f}"
                + (f" loss_scale={metrics['loss_scale']:.0f}"
                   if self.fp16_enabled else "")
                + (" SKIPPED(overflow)" if skipped else ""))
        if self.monitor is not None and self.monitor.enabled and \
                not skipped:
            self.monitor.write_events([
                ("Train/loss", loss_f, self.global_steps),
                ("Train/lr", float(lr), self.global_steps)])
        self._record_train_telemetry(metrics, skipped)
        self._record_flight_and_anomaly(metrics, loss_f, skipped, leaf_sq)
        self._last_metrics = metrics
        return loss_f

    # ------------------------------------------------------------------
    # torch-style forward / backward / step (JAX :1828-1960)
    # ------------------------------------------------------------------
    def _check_shims(self):
        if self.onebit_mode:
            raise RuntimeError(
                "forward/backward/step are not supported with the 1-bit "
                "optimizers (their step owns its communication); use "
                "train_batch/eval_batch")
        if self.pp > 1:
            raise RuntimeError(
                "forward/backward/step are not supported in pipeline mode; "
                "use train_batch/eval_batch (same restriction as the "
                "reference PipelineEngine)")
        if self._infinity is not None:
            raise RuntimeError(
                "forward/backward/step are not supported with "
                "offload_param nvme; use train_batch/eval_batch")
        if self.host_stream is not None:
            raise RuntimeError(
                "forward/backward/step are not supported with "
                "offload_param cpu (the layer stream follows train_batch's "
                "forward and backward sweeps); use train_batch/eval_batch")

    def _shard_micro(self, batch) -> Dict[str, torch.Tensor]:
        """One global micro-batch [micro * dp_world, ...] -> this rank's
        rows on the device."""
        def prep(x):
            x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            gm = self.micro_batch_size * self.ds_config.dp_world_size
            if x.shape[0] != gm:
                raise ValueError(f"micro-batch dim {x.shape[0]} != "
                                 f"micro * dp_world = {gm}")
            if self.dp_world_size > 1:
                m = self.micro_batch_size
                x = x[self.dp_rank * m:(self.dp_rank + 1) * m]
            return x.to(self.device)

        return {k: prep(v) for k, v in batch.items()}

    def forward(self, batch):
        """Compat: ``engine(batch)`` -> the micro-batch's loss (f32, on
        the device). The autograd graph (or, under ``torch.no_grad``, the
        batch) is kept for :meth:`backward`."""
        self._check_shims()
        micro = self._shard_micro(batch)
        loss = self.model.apply(self._model_params(), micro,
                                train=True).float()
        self._cached_losses.append(loss if loss.requires_grad else micro)
        return loss.detach()

    __call__ = forward

    def backward(self, loss=None):
        """Compat: accumulate the gradients of the oldest forward's
        micro-batch (``loss`` is accepted and not read, as in JAX). Under
        fp16 they are the gradients of the SCALED loss (reference
        FP16_Optimizer scales inside backward); :meth:`step` unscales and
        checks for overflow."""
        if self.pp > 1:
            self._check_shims()
        if not self._cached_losses:
            raise RuntimeError("backward() without forward()")
        loss = self._cached_losses.pop(0)
        if isinstance(loss, dict):       # a forward run without a graph
            loss = self.model.apply(self._model_params(), loss,
                                    train=True).float()
        leaves = self._grad_inputs()
        acc, _ = self._grad_buffers()
        if not self._shim_grads:
            for a in acc:
                a.zero_()
            self._shim_grads = True
        scale = (self.scale_state["loss_scale"] if self.fp16_enabled
                 else None)
        grads = torch.autograd.grad(self._root(loss, scale), leaves,
                                    allow_unused=True)
        with torch.no_grad():
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g)
        self.micro_steps += 1

    def step(self):
        """Compat: apply the accumulated gradients as train_batch applies
        its own: the reduction over the group, the unscale by gas *
        loss_scale, the global inf/nan check, the skip on overflow, the
        scale update, and the host bookkeeping (global_steps / the lr
        schedule) gated on the skip (reference stage3.py:2018)."""
        if self.pp > 1:
            self._check_shims()
        if not self._shim_grads:
            raise RuntimeError("step() without backward()")
        acc, shards = self._grad_buffers()
        scale = (self.scale_state["loss_scale"] if self.fp16_enabled
                 else None)
        lr = self._lr_fn(self._step)
        with torch.no_grad():
            self._reduce(acc, shards)
            ok, _, _ = self._apply_grads(acc, shards, scale, lr)
        self._shim_grads = False
        if not ok:
            self.skipped_steps += 1
            return
        self.global_steps += 1
        self.lr_scheduler.step()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gas == 0

    def zero_grad(self):
        self._shim_grads = False

    @torch.no_grad()
    def eval_batch(self, data_iter=None, batch=None) -> float:
        """Mean loss over the batch's micro-batches and the data-parallel
        group, no update."""
        if batch is None:
            batch = self._next_batch(data_iter)
        dev_batch = self._shard_batch(batch)
        if self._infinity is not None:
            return float(self._mean_over_group(torch.tensor(
                self._infinity.eval_batch(dev_batch), device=self.device)))
        params = self._model_params()
        if self.pp > 1:
            # the pipelined apply takes the whole [M, micro, ...] batch
            return float(self._mean_over_group(
                self.model.apply(params, dev_batch, train=False).float()))
        losses = [self.model.apply(params, m, train=False).float()
                  for m in self._micro_batches(dev_batch)]
        return float(self._mean_over_group(torch.stack(losses).mean()))

    def step_timings(self) -> Dict[str, float]:
        """The last ``train_batch`` on the card's clock (CUDA events on its
        stream; waits for the step): ``grads_ms`` from the first forward
        to the clipped gradients, ``update_ms`` the optimizer step after
        them (for the offloaded engines the stream waits there for the
        host tier). Empty on the CPU."""
        ev = self._step_events
        if not ev:
            return {}
        ev[2].synchronize()
        return {"grads_ms": ev[0].elapsed_time(ev[1]),
                "update_ms": ev[1].elapsed_time(ev[2])}

    def get_lr(self):
        return self.lr_scheduler.get_lr()

    def get_global_grad_norm(self):
        return self._last_metrics.get("grad_norm")

    @property
    def loss_scale(self) -> float:
        if self.scale_state is None:
            return 1.0
        return float(self.scale_state["loss_scale"])

    # ------------------------------------------------------------------
    # Checkpointing (JAX :1968-2180; reference engine.py:2982 / :2653)
    # ------------------------------------------------------------------
    def _tree(self, leaves) -> Dict[str, Any]:
        return _unflatten(list(zip(self._leaf_names, leaves)))

    def _shards(self, whole, dims, zero=None) -> List[torch.Tensor]:
        """This rank's ZeRO shards (views) of whole leaves, each cut over
        its own ZeRO group (:attr:`_zero`; the compute params' are
        :attr:`_pzero`)."""
        zero = zero or self._zero
        return [v if d is None else
                shard_of(v, d, zero[i][2], zero[i][1])
                for i, (v, d) in enumerate(zip(whole, dims))]

    def _gathered(self, leaves, dims, zero=None) -> List[torch.Tensor]:
        """Whole leaves: the ZeRO shards joined over the ZeRO group (the
        compute params' over ``zero``, :attr:`_pzero`), the slices over
        the model-parallel groups that cut them (model, seq, pipe) and the
        experts over the expert group (every rank takes part)."""
        zero = zero or self._zero
        return [self._gather_leaf(i, v, d, zero)
                for i, (v, d) in enumerate(zip(leaves, dims))]

    def _gather_leaf(self, i: int, v: torch.Tensor, d: Optional[int],
                     zero) -> torch.Tensor:
        """Leaf ``i`` whole (:meth:`_gathered`'s work for one leaf: every
        rank calls it for the same leaves in the same order)."""
        if self.zero_world > 1 or self._cuts:  # collectives on the device
            v = v.to(self.device)
        if d is not None and zero[i][1] > 1:
            v = all_gather_leaf(v.detach(), d, zero[i][0])
        n = self._leaf_names[i]
        for axis, cd in self._cuts.get(n, {}).items():
            v = all_gather_leaf(v.detach().contiguous(), cd,
                                self.topology.group(axis))
        if self.ep > 1 and n in self._expert_dims:
            # whole expert leaves: every expert rank's experts joined
            v = all_gather_leaf(v.detach().contiguous(),
                                self._expert_dims[n],
                                self.topology.expert_group())
        return v

    def consolidated_param_buckets(self, bucket_bytes: int = 16 << 20):
        """Yield the live compute params as ``{path: fp32 ndarray}`` groups
        (the paths of ``serve/weights.flatten_params``), gathered leaf by
        leaf and capped at ``bucket_bytes`` of host fp32 (JAX :2139): the
        :class:`~.hybrid_engine.WeightPublisher` feed. The ZeRO shards,
        the model-parallel slices and the experts held over the expert
        ranks are joined as for a checkpoint; every rank must iterate it.
        Read-only: the train state and the addresses of its leaves do not
        change."""
        if self.param_offload_nvme:
            raise NotImplementedError(
                "weight publication over the NVMe parameter tier is not "
                "supported; use save_16bit_model")
        if not self._param_leaves:
            raise RuntimeError("engine holds no live compute params")
        bucket_bytes = max(int(bucket_bytes), 1)
        group: Dict[str, np.ndarray] = {}
        group_bytes = 0
        with torch.no_grad():
            for i, key in enumerate(self._leaf_names):
                nbytes = int(np.prod(self._ckpt_shape(key) or (1,))) * 4
                if group and group_bytes + nbytes > bucket_bytes:
                    yield group
                    group, group_bytes = {}, 0
                whole = self._gather_leaf(i, self._param_leaves[i],
                                          self._pdims[i], self._pzero)
                group[key] = whole.detach().to(
                    "cpu", torch.float32).numpy()
                group_bytes += nbytes
        if group:
            yield group

    def _storage_geometry(self):
        """(dims, ZeRO groups) of the host tier's master and moments
        (ZeRO-Infinity's are whole over the ZeRO group, to the engine)."""
        if self._infinity is not None:
            return self._odims, self._zero
        return self._sdims, self._szero

    @property
    def _state_tier(self):
        """The host tier holding master and moments, if any: the
        optimizer offload's or ZeRO-Infinity's (the same checkpoint
        surface)."""
        return self.host_opt if self.host_opt is not None else \
            self._infinity

    def _full_params(self) -> List[torch.Tensor]:
        """The whole compute params (ZeRO-Infinity: the master's cast, as
        JAX :1992 writes them)."""
        if self._infinity is not None:
            master, _ = self._infinity.get_all_leaves()
            return self._gathered([m.to(self.compute_dtype) for m in master],
                                  self._odims)
        return self._gathered(self._param_leaves, self._pdims, self._pzero)

    def _train_state(self):
        """The state a checkpoint holds, as the JAX engine lays it out,
        with whole (gathered) leaves."""
        tier = self._state_tier
        if tier is not None:
            master, moments = tier.get_all_leaves()
            sdims, szero = self._storage_geometry()
            master_tree = self._tree(self._gathered(master, sdims, szero))
            moments = {k: self._gathered(v, sdims, szero)
                       for k, v in moments.items()}
        else:
            master_tree = (None if self._master_leaves is None else
                           self._tree(self._gathered(self._master_leaves,
                                                     self._odims)))
            moments = {k: self._gathered(v, self._odims if self.has_master
                                         else self._pdims)
                       for k, v in self.opt_state.items()}
        return {
            "params": self._tree(self._full_params()),
            "master_params": master_tree,
            "opt_state": {k: self._tree(v) for k, v in moments.items()},
            "scale_state": self.scale_state,
            "step": torch.tensor(self._step, dtype=torch.int32),
        }

    def _join_pending_saves(self):
        """Commit barrier for ``async_save`` writes: the next save, load or
        close waits for them, and a failed write raises here instead of
        vanishing on its thread."""
        for t in self._pending_saves:
            t.join()
        self._pending_saves = []
        if self._async_save_errors:
            err = self._async_save_errors[0]
            self._async_save_errors = []
            raise RuntimeError(f"async checkpoint write failed: {err!r}") \
                from err

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Every rank takes part (the shards are gathered); rank 0
        writes."""
        self._check_checkpointable()
        self._join_pending_saves()
        tag = tag or f"global_step{self.global_steps}"
        state = self._train_state()
        meta = {
            "global_steps": self.global_steps,
            "skipped_steps": self.skipped_steps,
            "batches_seen": self._batches_seen,
            "lr_scheduler": self.lr_scheduler.state_dict(),
            "client_state": client_state or {},
            "zero_stage": self.zero_stage,
            "dp_world_size": self.ds_config.dp_world_size,
        }
        if not self.config.checkpoint.async_save:
            ckpt.save_state(save_dir, tag, state, meta,
                            save_latest=save_latest)
            comm.barrier()
            logger.info(f"saved checkpoint {save_dir}/{tag}")
        elif comm.get_rank() == 0:
            self._save_in_background(save_dir, tag, state, meta, save_latest)
        return True

    def _save_in_background(self, save_dir, tag, state, meta, save_latest):
        # snapshot to the host now: the next step updates the params, and
        # the offloaded leaves are views of the live host buffers
        host_state = {
            name: None if sub is None else ckpt.tree_from_paths(
                (k, v.detach().to("cpu", copy=True))
                for k, v in ckpt.leaf_paths(sub))
            for name, sub in state.items()}
        errors = self._async_save_errors

        def write():
            try:
                ckpt.save_state(save_dir, tag, host_state, meta,
                                save_latest=save_latest)
            except Exception as exc:  # surfaced at the commit barrier
                errors.append(exc)

        # non-daemon: a normal interpreter exit waits for the write
        t = threading.Thread(target=write, daemon=False)
        t.start()
        self._pending_saves.append(t)
        logger.info(f"async checkpoint started -> {save_dir}/{tag}")

    def _check_checkpointable(self):
        if self.onebit_mode:
            raise NotImplementedError(
                "checkpoints of an engine with a 1-bit optimizer (per-rank "
                "momentum and error-feedback state) are not supported by "
                "deepspeed_tpu_torch")

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, **_kw):
        """Restore a checkpoint of either package into this engine's
        tensors, in place: each rank reads the whole leaves and keeps its
        shards, so a checkpoint saved at any data-parallel world loads at
        any other. Returns ``(load_dir, client_state)``, or ``(None, {})``
        when ``load_dir`` names no checkpoint."""
        self._check_checkpointable()
        self._join_pending_saves()
        comm.barrier()   # rank 0's write is complete
        tag = tag or ckpt.read_latest(load_dir)
        if tag is None:
            return None, {}

        def meta_like(leaves):
            return None if leaves is None else self._tree([
                torch.empty(self._ckpt_shape(k), dtype=v.dtype,
                            device="meta")
                for k, v in zip(self._leaf_names, leaves)])

        tier = self._state_tier
        if tier is not None:
            master, moments = tier.template_leaves()
        else:
            master, moments = self._master_leaves, self.opt_state
        template = {
            "params": self._tree([
                torch.empty(self._ckpt_shape(k), dtype=self.compute_dtype
                            if self._infinity is not None else v.dtype,
                            device="meta")
                for k, v in zip(self._leaf_names,
                                self._param_leaves or master)]),
            "master_params": meta_like(master),
            "opt_state": ({k: meta_like(v) for k, v in moments.items()}
                          if load_optimizer_states else None),
            "scale_state": (None if self.scale_state is None else
                            ckpt.tree_from_paths(
                                (k, torch.empty_like(v, device="meta"))
                                for k, v in ckpt.leaf_paths(
                                    self.scale_state))),
            "step": torch.empty((), dtype=torch.int32, device="meta"),
        }
        state, meta = ckpt.load_state(load_dir, tag, template)
        if state["master_params"] is None and master is not None:
            # a checkpoint without a master (fp32 at ZeRO 0): the master is
            # its params' f32 value (the JAX engine keeps its old master)
            state["master_params"] = ckpt.load_state(
                load_dir, tag, {"params": template["master_params"]}
            )[0]["params"]

        def leaves(name, sub=None, dims=None, zero=None):
            whole = [self._manual_cut(k, self._expert_cut(k, v))
                     for k, v in ckpt.leaf_paths(
                         state[name] if sub is None else sub)]
            return self._shards(whole, dims or [None] * len(whole), zero)

        if tier is not None:
            sdims, szero = self._storage_geometry()
            moments = None
            if state["opt_state"] is not None:
                moments = {k: leaves(None, sub, sdims, szero)
                           for k, sub in state["opt_state"].items()}
            # ZeRO-Infinity rewrites its layer files and persistents too
            tier.load_leaves(leaves("master_params", dims=sdims, zero=szero),
                             moments)
            if self.host_opt is not None:
                self._params_from_tier()
        else:
            mdims = self._odims if self.has_master else self._pdims
            for p, v in zip(self._param_leaves,
                            leaves("params", dims=self._pdims,
                                   zero=self._pzero)):
                copy_rows(p.detach(), v)
            if master is not None:
                for m, v in zip(master, leaves("master_params",
                                               dims=self._odims)):
                    copy_rows(m, v)
            if state["opt_state"] is not None:
                for k, sub in state["opt_state"].items():
                    for m, v in zip(self.opt_state[k],
                                    leaves(None, sub, mdims)):
                        copy_rows(m, v)
        if state["scale_state"] is not None:
            self.scale_state = {k: v.to(self.device) for k, v in
                                state["scale_state"].items()}
        self._step = int(state["step"])
        self.global_steps = meta["global_steps"]
        self.skipped_steps = meta.get("skipped_steps", 0)
        self._batches_seen = meta.get("batches_seen", self.global_steps)
        if load_lr_scheduler_states and "lr_scheduler" in meta:
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        logger.info(f"loaded checkpoint {load_dir}/{tag}")
        return load_dir, meta.get("client_state", {})

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.npz"):
        """The consolidated compute-dtype weights as one ``.npz`` keyed by
        parameter path (JAX :2172; 16-bit leaves written as float32, as
        the JAX package writes them). Every rank gathers; rank 0 writes."""
        params = self._tree(self._full_params())
        path = os.path.join(save_dir, save_filename)
        if comm.get_rank() == 0:
            os.makedirs(save_dir, exist_ok=True)
            np.savez(path, **{k: ckpt.to_numpy(v)
                              for k, v in ckpt.leaf_paths(params)})
            logger.info(f"saved 16-bit model -> {path}")
        comm.barrier()
        return path

    @torch.no_grad()
    def load_universal_checkpoint(self, universal_dir):
        """Load a universal-checkpoint directory (``checkpoint/universal``;
        reference engine flag load_universal_checkpoint, engine.py:794;
        JAX :2183): the fragments by tree path, each rank keeping its
        shards, so a directory converted from any stage and world loads
        at this one. The fp16 scale state restores with the weights. The
        optimizer moments restore when the directory holds them and they
        match this optimizer, and then the step counter, global_steps and
        the lr schedule travel with them (Adam's bias correction); a
        mismatch restores the weights only, the step restarting at 0,
        and is validated before anything changes. Serves the resident
        engine at ZeRO 0-3 and both optimizer offloads."""
        self._check_checkpointable()
        from ..checkpoint.universal import (has_universal_opt_state,
                                            load_universal_extras,
                                            load_universal_into_tree)
        self._join_pending_saves()
        if self._infinity is not None:
            # the JAX loader has no ZeRO-Infinity branch: it maps the
            # weights over the engine's master tree, which is None there,
            # and fails with a ValueError
            raise NotImplementedError(
                "load_universal_checkpoint is not supported under "
                "offload_param nvme (nor by the JAX package's loader); "
                "load a native checkpoint with load_checkpoint")

        def template(dtype_of):
            return self._tree([
                torch.empty(self._ckpt_shape(k), dtype=dtype_of(i),
                            device="meta")
                for i, k in enumerate(self._leaf_names)])

        def leaves_of(tree):
            out = [v for _, v in ckpt.leaf_paths(tree)]
            for k, v in zip(self._leaf_names, out):
                if tuple(v.shape) != self._ckpt_shape(k):
                    raise KeyError(f"shape mismatch for {k}: "
                                   f"{tuple(v.shape)} vs "
                                   f"{self._ckpt_shape(k)}")
            # this rank's experts and tensor-parallel slices
            return [self._manual_cut(k, self._expert_cut(k, v))
                    for k, v in zip(self._leaf_names, out)]

        try:
            host = leaves_of(load_universal_into_tree(
                universal_dir, template(lambda i: torch.float32)))
        except KeyError as exc:
            raise ValueError(f"universal checkpoint {universal_dir} does "
                             f"not match this model: {exc}") from None
        extras = load_universal_extras(universal_dir)
        tier = self.host_opt
        if tier is not None:
            _, moments = tier.template_leaves()
        else:
            moments = self.opt_state or {}
        mdims, mzero = (self._storage_geometry() if tier is not None else
                        (self._odims if self.has_master else self._pdims,
                         self._zero))
        opt = None
        if moments and has_universal_opt_state(universal_dir):
            try:
                tree = load_universal_into_tree(
                    universal_dir,
                    {k: template(lambda i, v=v: v[i].dtype)
                     for k, v in moments.items()}, section="opt_state")
                opt = {k: self._shards(leaves_of(tree[k]), mdims, mzero)
                       for k in moments}
            except KeyError as exc:
                logger.warning(
                    f"universal checkpoint optimizer state does not match "
                    f"this optimizer ({exc}); restored weights only — the "
                    f"step counter and LR schedule restart at 0")
        if tier is not None:
            tier.load_leaves(self._shards(host, mdims, mzero), opt)
            self._params_from_tier()
        else:
            if self.has_master:
                for m, v in zip(self._master_leaves,
                                self._shards(host, self._odims)):
                    copy_rows(m, v)
                self._publish_params()
            else:
                for p, v in zip(self._param_leaves,
                                self._shards(host, self._pdims)):
                    copy_rows(p.detach(), v)
            if opt is not None:
                for k, vals in opt.items():
                    for m, v in zip(self.opt_state[k], vals):
                        copy_rows(m, v)
        if self.scale_state is not None and extras.get("scale_state"):
            # the loss scale belongs to the weights' magnitude: it
            # restores whenever they do (merged over the current state)
            self.scale_state = {**self.scale_state, **{
                k: torch.tensor(v, dtype=self.scale_state[k].dtype,
                                device=self.device)
                for k, v in extras["scale_state"].items()
                if k in self.scale_state}}
        if opt is not None:
            meta = extras.get("meta", {})
            if extras.get("step") is not None:
                self._step = int(extras["step"])
            if "global_steps" in meta:
                self.global_steps = meta["global_steps"]
                self.skipped_steps = meta.get("skipped_steps", 0)
                self._batches_seen = meta.get("batches_seen",
                                              self.global_steps)
                if extras.get("step") is None:
                    self._step = self.global_steps
            if "lr_scheduler" in meta:
                try:
                    self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
                except Exception as exc:
                    logger.warning(f"lr scheduler state not restored: "
                                   f"{exc}")
        logger.info(f"loaded universal checkpoint from {universal_dir}")

    def destroy(self):
        """JAX ``destroy`` (reference engine.py destroy): :meth:`close`."""
        self.close()

    def close(self):
        """Stop the stall watchdog, flush the telemetry bridge (metrics
        since the last cadence boundary would otherwise never reach the
        monitor backends), wait for pending saves, then release the host
        tier (pinned memory, swap files, the C++ optimizer) and the
        training state."""
        if getattr(self, "_stall_watchdog", None) is not None:
            self._stall_watchdog.stop()
            self._stall_watchdog = None
        if getattr(self, "telemetry_bridge", None) is not None:
            try:
                self.telemetry_bridge.close(self.global_steps)
            except Exception as e:  # a backend failure must not block
                logger.warning(f"final telemetry flush failed: {e}")
        self._cached_losses = []
        self._join_pending_saves()
        if self.host_opt is not None:
            self.host_opt.close()
            self.host_opt = None
        if self._infinity is not None:
            self._infinity.close()
            self._infinity = None
        if self._param_pins is not None:
            if self.device.type == "cuda":  # no copy may touch a page
                torch.cuda.synchronize(self.device)   # once unregistered
            self._param_pins.close()
            self._param_pins = None
            self.host_stream = self.model.host_stream = None
        self.params = self.master_params = self.opt_state = None
        self._param_leaves = self._master_leaves = []
        self._grad_acc = self._grad_shards = None
        self._reducer = None

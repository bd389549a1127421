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

At one rank the optimizer state
may leave the card (``zero_optimization.offload_optimizer``, the selection
of JAX :215-228; the ZeRO plan is then the identity):

* ``{device: cpu, pin_memory: true}`` (stages 1/2): the tiered offload
  (``runtime/offload.py``): master and moments in page-locked host memory,
  the update streamed bucket by bucket through the same
  ``apply_update_with_skip`` on the card, bit-identical to the resident
  step; the first fetches are issued before the forward;
* ``{device: cpu}`` or ``{device: nvme, nvme_path}``: the host C++
  optimizer (``runtime/zero/offload.py``): the gradients cross to the
  host in the transfer dtype, the host updates master and moments (in
  RAM, or swapped from files) and writes the compute params back.

An fp16 step that overflows leaves either host state untouched.
``save_checkpoint`` / ``load_checkpoint`` (JAX :1983 / :2061) write and
read the JAX package's fragment format (``checkpoint/state_checkpoint.py``)
for the resident and both offloaded engines, in the background under
``checkpoint.async_save``; ``save_16bit_model`` (:2172) writes the
consolidated weights.

Not ported (``runtime/config.check_ported`` raises, naming the ROADMAP
item): optimizer offload at more than one rank, ``offload_param`` and
``cpu_checkpointing`` (A9), MiCS (A4), ZeRO++ (A10), universal
checkpoints (A5), pipeline, tensor, sequence and expert parallelism (A8), telemetry and diagnostics (A7),
compression, curriculum and the profilers (A12), the hybrid engine (A11).
The ``forward``/``backward``/``step`` compatibility shims are not here
yet.
"""

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import state_checkpoint as ckpt
from ..comm import comm
from ..comm.quantized import (all_gather_leaf, make_zero3_gather,
                              shard_of)
from ..ops.optimizers import TpuOptimizer, build_optimizer
from ..parallel.topology import MeshTopology, build_topology
from ..utils.device import resolve_device
from .activation_checkpointing import checkpointing as ds_ckpt
from .config import ConfigError, DeepSpeedConfig, OptimizerConfig, check_ported
from .fp16.loss_scaler import (LossScaleConfig, from_fp16_config,
                               grads_finite, init_scale_state, update_scale)
from .grad_overlap import (ALL_REDUCE, REDUCE_SCATTER, VJP, BucketedReducer,
                           leaf_kinds, plan_grad_buckets, reduce_leaves,
                           resolve_overlap_mode)
from .lr_schedules import LRScheduler, build_lr_schedule
from .offload import copy_rows
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
                       group=None):
    """In place: unscale by ``inv`` (1 / (gas * loss_scale)), global
    inf/nan check under fp16 (on the unclipped grads: clipping an inf
    makes a nan), global norm, norm clipping. Returns (grads, finite,
    gnorm); ``finite`` is None when the precision cannot overflow.

    Across a data-parallel group of more than one rank, ``sharded[i]``
    marks a gradient each rank holds a shard of: its partial sum of
    squares is summed over the group (one all-reduce for all of them) and
    the leaves' squares are then added in leaf order, as at one rank; the
    overflow check is agreed over the group."""
    for g in grads:
        g.mul_(inv)
    world = comm.get_world_size(group)
    finite = grads_finite(grads) if fp16 else None
    if finite is not None and world > 1:
        flag = finite.to(torch.float32).reshape(1)
        comm.all_reduce(flag, op=comm.ReduceOp.MIN, group=group)
        finite = flag[0] > 0
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    idx = [i for i, s in enumerate(sharded or []) if s]
    if idx and world > 1:
        part = torch.stack([sq[i] for i in idx])
        comm.all_reduce(part, group=group)
        for j, i in enumerate(idx):
            sq[i] = part[j]
    gnorm = torch.sqrt(sum(sq))
    if clip and clip > 0:
        factor = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(factor)
    return grads, finite, gnorm


def apply_update_with_skip(optimizer: TpuOptimizer, target, grads,
                           opt_state, step: int, lr: float,
                           finite: bool) -> int:
    """The optimizer update unless the step overflowed (reference
    stage3.py:2018): a skipped step leaves target, moments and step
    untouched. Returns the new (1-based count of applied) step."""
    if not finite:
        return step
    optimizer.apply(target, grads, opt_state, step + 1, lr=lr)
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
        self.group = self.topology.group()
        self.dp_world_size = self.topology.dp_world_size
        self.dp_rank = self.topology.dp_rank
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
        self.optimizer: TpuOptimizer = build_optimizer(opt_cfg.type,
                                                       opt_cfg.params)
        base_lr = opt_cfg.params.get("lr", getattr(self.optimizer, "lr", 1e-3))
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
        self._pending_saves: List[threading.Thread] = []
        self._async_save_errors: List[BaseException] = []
        ds_ckpt.configure(deepspeed_config=self.config)
        self._init_state(params, seed)
        self._init_grad_reduction()
        self._last_metrics: Dict[str, float] = {}
        self.last_step_s = None
        self._step_events = None
        logger.info(
            f"engine ready: zero_stage={self.zero_stage} "
            f"dtype={config.precision_dtype} device={self.device} "
            f"dp={self.dp_world_size} (rank {self.dp_rank}, backend "
            f"{comm.get_backend()}) grad_reduce={self.grad_overlap_mode} "
            f"batch={self.train_batch_size} (micro={self.micro_batch_size} "
            f"gas={self.gas})")

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
        if world > 1 and self.zero_stage >= 1 and \
                not self.optimizer.elementwise:
            raise NotImplementedError(
                f"optimizer {self.config.optimizer.type!r} reads whole "
                f"leaves (a trust ratio), which a sharded master does not "
                f"hold at {world} ranks; not ported to deepspeed_tpu_torch "
                f"yet (ROADMAP A4)")

    # ------------------------------------------------------------------
    def _init_state(self, params, seed: int):
        # as in JAX (:643): ZeRO 1/2/3 keep a master even in fp32
        self.has_master = (self.compute_dtype != torch.float32
                           or self.zero_stage >= 1)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            # drawn on the device in the compute dtype; the fp32 master
            # is cast up from it (a 7B tree never exists in f32 on host)
            tree = self.model.init_params(gen, dtype=self.compute_dtype)
            items = _flatten(tree)
        else:
            items = [(k, torch.as_tensor(np.asarray(v)) if not
                      isinstance(v, torch.Tensor) else v)
                     for k, v in _flatten(params)]
        self._leaf_names = [k for k, _ in items]
        self._full_shapes = {k: tuple(v.shape) for k, v in items}
        zc = self.config.zero_optimization
        # the offloaded engines run at one rank on the identity plan
        self.zero_plan: ZeroPlan = build_zero_plan(
            self.dp_world_size, 0 if self.offload_device else self.zero_stage,
            self._full_shapes,
            persistence_threshold=zc.stage3_param_persistence_threshold)
        names = self._leaf_names
        self._pdims = [self.zero_plan.param_dims[k] for k in names]
        self._gdims = [self.zero_plan.grad_dims[k] for k in names]
        self._odims = [self.zero_plan.master_dims[k] for k in names]
        world, rank = self.dp_world_size, self.dp_rank

        def local(v, dim):
            return v if dim is None else shard_of(v, dim, rank, world)

        with torch.no_grad():
            if self.offload_device:
                # the master is the f32 value of the same weights, on the
                # host (built by the offload tier); the card keeps the
                # compute params only
                master = None
                compute = [v.to(self.device, self.compute_dtype,
                                copy=params is not None) for _, v in items]
                self._init_offload(items)
            elif self.has_master:
                master = [local(v, d).to(self.device, torch.float32,
                                         copy=True)
                          for (_, v), d in zip(items, self._odims)]
                # a compute leaf sharded like its master is the master's
                # cast (the same tensor in fp32, as at stage 0)
                compute = [m.to(self.compute_dtype) if pd is not None
                           or od is None else
                           local(v, pd).to(self.device, self.compute_dtype,
                                           copy=True)
                           for m, (_, v), pd, od in zip(master, items,
                                                        self._pdims,
                                                        self._odims)]
            else:
                master = None
                compute = [v.to(self.device, torch.float32, copy=True)
                           for _, v in items]
        del items
        for p in compute:
            p.requires_grad_(True)
        self._param_leaves = compute
        self._master_leaves = master
        self.params = _unflatten(list(zip(self._leaf_names, compute)))
        self.master_params = (_unflatten(list(zip(self._leaf_names, master)))
                              if master is not None else None)
        self.opt_state = (None if self.offload_device else
                          self.optimizer.init_state(
                              master if master is not None else compute))
        self.scale_state = (init_scale_state(self.scale_cfg, self.device)
                            if self.fp16_enabled else None)
        self.param_count = int(sum(torch.Size(s).numel()
                                   for s in self._full_shapes.values()))
        self._step = 0          # optimizer steps applied (JAX _step_arr)
        self._grad_acc: Optional[List[torch.Tensor]] = None
        self._grad_shards: Optional[List[Optional[torch.Tensor]]] = None

    def _init_grad_reduction(self):
        """The leaves' reduction kinds, the stage-3 gathers and the bucket
        plan (JAX ``make_overlapped_grad_fn``'s planning, :648-758)."""
        names = self._leaf_names
        self._kinds = leaf_kinds(names, self.zero_plan)
        stack = tuple(getattr(self.model, "param_offload_keys", ()) or ())
        stacked = [any(n.startswith(k + "/") for k in stack) for n in names]
        # stage 3: a stacked leaf cut along a layer's own dimension is
        # gathered layer by layer in the model's loop; any other sharded
        # leaf once before the forward
        self._whole_gathers: Dict[int, Any] = {}
        layer_dims: Dict[str, int] = {}
        for i, (n, d) in enumerate(zip(names, self._pdims)):
            if d is None:
                continue
            if stacked[i] and d > 0 and hasattr(self.model,
                                                      "layer_gather"):
                layer_dims[n.split("/", 1)[1]] = d - 1
            else:
                self._whole_gathers[i] = make_zero3_gather(d, self.group)
        self._layer_gather = None
        if layer_dims:
            gathers = {k: make_zero3_gather(d, self.group)
                       for k, d in layer_dims.items()}

            def layer_gather(lp):
                return {k: gathers[k](v) if k in gathers else v
                        for k, v in lp.items()}

            self._layer_gather = layer_gather
        self.grad_overlap_mode = resolve_overlap_mode(self)
        self.grad_bucket_plan = None
        self._reducer = None
        if self.grad_overlap_mode == "bucketed":
            zc = self.config.zero_optimization
            self.grad_bucket_plan = plan_grad_buckets(
                names, [self._full_shapes[n] for n in names], self.zero_plan,
                zc.reduce_bucket_size, zc.allgather_bucket_size,
                stack_keys=stack)
            self._reducer = BucketedReducer(self.grad_bucket_plan,
                                            self._gdims, self.device,
                                            self.group)
            logger.info(f"grad overlap: bucketed reduction "
                        f"({self.grad_bucket_plan.num_buckets} buckets, "
                        f"{len(self.grad_bucket_plan.vjp_leaves)} vjp-reduced "
                        f"leaves)")

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
                    v = torch.unbind(p)
                    for u, unit in units[i]:
                        v[unit.layer].register_hook(
                            reducer.hook_for(u, acc[i][unit.layer]))
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
            elif kind == VJP or self._odims[i] is None:
                out.append(acc[i])
            else:
                out.append(shard_of(acc[i], self._odims[i], self.dp_rank,
                                    self.dp_world_size))
        return out

    @torch.no_grad()
    def _publish_params(self):
        """The compute params from the updated master (JAX :1132-1136): a
        leaf sharded like its master is the master's cast; a replicated
        leaf with a sharded master gathers the cast shards."""
        for p, m, pd, od in zip(self._param_leaves, self._master_leaves,
                                self._pdims, self._odims):
            if pd is not None or od is None:
                p.copy_(m)
            else:
                p.copy_(all_gather_leaf(m.to(self.compute_dtype), od,
                                        self.group))

    def _mean_over_group(self, x: torch.Tensor) -> torch.Tensor:
        if self.dp_world_size > 1:
            x = x.reshape(1).clone()
            comm.all_reduce(x, group=self.group)
            x = x[0] / self.dp_world_size
        return x

    # ------------------------------------------------------------------
    def train_batch(self, data_iter=None, batch=None) -> float:
        """Run one full (global micro * gas) training batch; returns the
        mean micro-batch loss over the data-parallel group."""
        if batch is None:
            batch = self._next_batch(data_iter)
        t0 = time.perf_counter()
        dev_batch = self._shard_batch(batch)
        leaves = self._param_leaves
        if self._grad_acc is None:
            self._grad_acc = [torch.zeros_like(p, dtype=torch.float32)
                              for p in leaves]
            self._grad_shards = [
                torch.zeros(m.shape, dtype=torch.float32, device=self.device)
                if k == REDUCE_SCATTER else None
                for k, m in zip(self._kinds, self._master_leaves
                                or leaves)]
        acc, shards = self._grad_acc, self._grad_shards
        for a in acc:
            a.zero_()
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
        losses = []
        for g, micro in enumerate(self._micro_batches(dev_batch)):
            reducer = self._reducer if g == self.gas - 1 else None
            params = self._model_params(reducer, acc)
            loss = self.model.apply(params, micro, train=True).float()
            grads = torch.autograd.grad(
                loss * scale if scale is not None else loss, leaves,
                allow_unused=True)
            del params
            with torch.no_grad():
                for a, gr, kind in zip(acc, grads, self._kinds):
                    # a bucketed leaf's last gradient went to its bucket
                    if gr is not None and (reducer is None or kind == VJP):
                        a.add_(gr)
            # a bf16 grad tree of 7B is 14.5 GB: the next micro-batch's
            # backward must not find this one alive
            del grads
            losses.append(loss.detach())
        with torch.no_grad():
            if self._reducer is not None:
                self._reducer.finish(acc, shards)
            else:
                reduce_leaves(acc, self._kinds, self._gdims, shards,
                              self.group)
            loss = self._mean_over_group(torch.stack(losses).mean())
            inv = 1.0 / (self.gas * scale) if scale is not None \
                else 1.0 / self.gas
            grads, finite, gnorm = unscale_clip_check(
                self._optimizer_grads(acc, shards), inv,
                self.config.gradient_clipping, self.fp16_enabled,
                sharded=[k != ALL_REDUCE or d is not None
                         for k, d in zip(self._kinds, self._odims)],
                group=self.group)
            if events is not None:
                events[1].record()
            ok = True if finite is None else bool(finite.item())
            if self.host_opt is None:
                target = (self._master_leaves if self.has_master
                          else self._param_leaves)
                self._step = apply_update_with_skip(
                    self.optimizer, target, grads, self.opt_state,
                    self._step, lr, ok)
                if ok and self.has_master:
                    self._publish_params()
            elif ok:
                # an overflowed step leaves the host state untouched
                if self.offload_tiered:
                    self.host_opt.stream_update(grads, self._param_leaves,
                                                self._step, lr)
                else:
                    self.host_opt.step(grads, self._param_leaves,
                                       self._step + 1, lr)
                self._step += 1
            if self.fp16_enabled:
                self.scale_state = update_scale(
                    self.scale_state, torch.tensor(ok, device=self.device),
                    self.scale_cfg)
            if events is not None:
                events[2].record()
        self._step_events = events
        loss_f = float(loss)
        skipped = 0 if ok else 1
        self.skipped_steps += skipped
        self._batches_seen += 1
        if not skipped:
            self.global_steps += 1
            self.lr_scheduler.step()
        self.last_step_s = time.perf_counter() - t0
        metrics = {"loss": loss_f, "grad_norm": float(gnorm), "lr": lr,
                   "skipped": skipped}
        if self.fp16_enabled:
            metrics["loss_scale"] = float(scale)
        self._last_metrics = metrics
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
        return loss_f

    @torch.no_grad()
    def eval_batch(self, data_iter=None, batch=None) -> float:
        """Mean loss over the batch's micro-batches and the data-parallel
        group, no update."""
        if batch is None:
            batch = self._next_batch(data_iter)
        dev_batch = self._shard_batch(batch)
        params = self._model_params()
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

    def _gathered(self, leaves, dims) -> List[torch.Tensor]:
        return ckpt.gather_shards(leaves, dims, self.group)

    def _train_state(self):
        """The state a checkpoint holds, as the JAX engine lays it out,
        with whole (gathered) leaves."""
        if self.host_opt is not None:
            master, moments = self.host_opt.get_all_leaves()
            master_tree = self._tree(master)
        else:
            master_tree = (None if self._master_leaves is None else
                           self._tree(self._gathered(self._master_leaves,
                                                     self._odims)))
            moments = {k: self._gathered(v, self._odims if self.has_master
                                         else self._pdims)
                       for k, v in self.opt_state.items()}
        return {
            "params": self._tree(self._gathered(self._param_leaves,
                                                self._pdims)),
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
            comm.barrier(self.group)
            logger.info(f"saved checkpoint {save_dir}/{tag}")
        elif self.dp_rank == 0:
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

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, **_kw):
        """Restore a checkpoint of either package into this engine's
        tensors, in place: each rank reads the whole leaves and keeps its
        shards, so a checkpoint saved at any data-parallel world loads at
        any other. Returns ``(load_dir, client_state)``, or ``(None, {})``
        when ``load_dir`` names no checkpoint."""
        self._join_pending_saves()
        comm.barrier(self.group)   # rank 0's write is complete
        tag = tag or ckpt.read_latest(load_dir)
        if tag is None:
            return None, {}

        def meta_like(leaves):
            return None if leaves is None else self._tree([
                torch.empty(self._full_shapes[k], dtype=v.dtype,
                            device="meta")
                for k, v in zip(self._leaf_names, leaves)])

        if self.host_opt is not None:
            master, moments = self.host_opt.template_leaves()
        else:
            master, moments = self._master_leaves, self.opt_state
        template = {
            "params": meta_like(self._param_leaves),
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

        def leaves(name, sub=None, dims=None):
            whole = [v for _, v in ckpt.leaf_paths(
                state[name] if sub is None else sub)]
            return ckpt.take_shards(whole, dims or [None] * len(whole),
                                    self.dp_rank, self.dp_world_size)

        if self.host_opt is not None:
            moments = None
            if state["opt_state"] is not None:
                moments = {k: leaves(None, sub)
                           for k, sub in state["opt_state"].items()}
            self.host_opt.load_leaves(leaves("master_params"), moments)
            # the compute params are the master's cast, as in JAX
            master, _ = self.host_opt.get_all_leaves()
            for p, m in zip(self._param_leaves, master):
                copy_rows(p.detach(), m)
        else:
            mdims = self._odims if self.has_master else self._pdims
            for p, v in zip(self._param_leaves,
                            leaves("params", dims=self._pdims)):
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
        params = self._tree(self._gathered(self._param_leaves, self._pdims))
        path = os.path.join(save_dir, save_filename)
        if self.dp_rank == 0:
            os.makedirs(save_dir, exist_ok=True)
            np.savez(path, **{k: ckpt.to_numpy(v)
                              for k, v in ckpt.leaf_paths(params)})
            logger.info(f"saved 16-bit model -> {path}")
        comm.barrier(self.group)
        return path

    def close(self):
        """Wait for pending saves, then release the host tier (pinned
        memory, swap files, the C++ optimizer) and the training state."""
        self._join_pending_saves()
        if self.host_opt is not None:
            self.host_opt.close()
            self.host_opt = None
        self.params = self.master_params = self.opt_state = None
        self._param_leaves = self._master_leaves = []
        self._grad_acc = self._grad_shards = None
        self._reducer = None

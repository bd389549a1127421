"""Training engine, one GPU, ZeRO stage 0.

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

Not ported (``runtime/config.check_ported`` raises, naming the ROADMAP
item): ZeRO stages 1-3 and data parallelism (A4), offload (A9), pipeline,
tensor, sequence and expert parallelism (A8), telemetry and diagnostics
(A7), compression, curriculum and the profilers (A12), the hybrid engine
(A11). Checkpoints (``save_checkpoint``/``load_checkpoint``, A5) and the
``forward``/``backward``/``step`` compatibility shims are not here yet.
"""

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.optimizers import TpuOptimizer, build_optimizer
from ..utils.device import resolve_device
from .activation_checkpointing import checkpointing as ds_ckpt
from .config import DeepSpeedConfig, OptimizerConfig, check_ported
from .fp16.loss_scaler import (LossScaleConfig, from_fp16_config,
                               grads_finite, init_scale_state, update_scale)
from .lr_schedules import LRScheduler, build_lr_schedule

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


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def unscale_clip_check(grads: List[torch.Tensor], inv, clip: float,
                       fp16: bool):
    """In place: unscale by ``inv`` (1 / (gas * loss_scale)), global
    inf/nan check under fp16 (on the unclipped grads: clipping an inf
    makes a nan), global norm, norm clipping. Returns (grads, finite,
    gnorm); ``finite`` is None when the precision cannot overflow."""
    for g in grads:
        g.mul_(inv)
    finite = grads_finite(grads) if fp16 else None
    gnorm = global_norm(grads)
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
    """Training engine on one device.

    ``model`` follows the JAX package's protocol: ``init_params(generator,
    dtype)`` and ``apply(params, batch, train=...) -> loss``. ``params``
    (a tree of tensors or numpy arrays in the JAX layout, e.g. from
    ``checkpoint/interop.params_from_numpy``) replaces the seeded init.
    ``device=None`` means the GPU and raises without one.
    """

    def __init__(self, model, config: DeepSpeedConfig, params=None,
                 device=None, seed: int = 0, lr_scheduler=None):
        check_ported(config)
        self.device = resolve_device(device)
        self.model = model
        self.ds_config = config
        self.config = config.cfg
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
        self.scale_cfg: Optional[LossScaleConfig] = (
            from_fp16_config(self.config.fp16) if self.fp16_enabled else None)
        ds_ckpt.configure(deepspeed_config=self.config)
        self._init_state(params, seed)
        self._last_metrics: Dict[str, float] = {}
        self.last_step_s = None
        logger.info(
            f"engine ready: zero_stage={self.zero_stage} "
            f"dtype={config.precision_dtype} device={self.device} "
            f"batch={self.train_batch_size} (micro={self.micro_batch_size} "
            f"gas={self.gas})")

    # ------------------------------------------------------------------
    def _init_state(self, params, seed: int):
        self.has_master = self.compute_dtype != torch.float32
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
        with torch.no_grad():
            if self.has_master:
                master = [v.to(self.device, torch.float32, copy=True)
                          for _, v in items]
                compute = [m.to(self.compute_dtype) for m in master]
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
        target = master if master is not None else compute
        self.opt_state = self.optimizer.init_state(target)
        self.scale_state = (init_scale_state(self.scale_cfg, self.device)
                            if self.fp16_enabled else None)
        self.param_count = int(sum(p.numel() for p in compute))
        self._step = 0          # optimizer steps applied (JAX _step_arr)
        self._grad_acc: Optional[List[torch.Tensor]] = None

    # ------------------------------------------------------------------
    def _shard_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host batch [gas * micro, ...] or [gas, micro, ...] -> tensors
        [gas, micro, ...] on the device."""
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
            return x.to(self.device)

        return {k: prep(v) for k, v in batch.items()}

    def _next_batch(self, data_iter):
        """Stack ``gas`` micro-batches (dicts of arrays) from an iterator."""
        if data_iter is None:
            raise ValueError("train_batch/eval_batch need a data_iter or a "
                             "batch (the dataloader is not ported yet, "
                             "ROADMAP A12)")
        micro = [next(data_iter) for _ in range(self.gas)]
        return {k: np.stack([np.asarray(m[k]) for m in micro])
                for k in micro[0]}

    def _micro_batches(self, dev_batch):
        for g in range(self.gas):
            yield {k: v[g] for k, v in dev_batch.items()}

    # ------------------------------------------------------------------
    def train_batch(self, data_iter=None, batch=None) -> float:
        """Run one full (micro * gas) training batch; returns the mean
        micro-batch loss."""
        if batch is None:
            batch = self._next_batch(data_iter)
        t0 = time.perf_counter()
        dev_batch = self._shard_batch(batch)
        leaves = self._param_leaves
        if self._grad_acc is None:
            self._grad_acc = [torch.zeros_like(p, dtype=torch.float32)
                              for p in leaves]
        acc = self._grad_acc
        for a in acc:
            a.zero_()
        scale = (self.scale_state["loss_scale"] if self.fp16_enabled
                 else None)
        lr = self._lr_fn(self._step)
        losses = []
        for micro in self._micro_batches(dev_batch):
            loss = self.model.apply(self.params, micro, train=True).float()
            grads = torch.autograd.grad(
                loss * scale if scale is not None else loss, leaves,
                allow_unused=True)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    if g is not None:
                        a.add_(g)
            losses.append(loss.detach())
        with torch.no_grad():
            loss = torch.stack(losses).mean()
            inv = 1.0 / (self.gas * scale) if scale is not None \
                else 1.0 / self.gas
            grads, finite, gnorm = unscale_clip_check(
                acc, inv, self.config.gradient_clipping, self.fp16_enabled)
            ok = True if finite is None else bool(finite.item())
            target = (self._master_leaves if self.has_master
                      else self._param_leaves)
            self._step = apply_update_with_skip(
                self.optimizer, target, grads, self.opt_state, self._step,
                lr, ok)
            if ok and self.has_master:
                for p, m in zip(self._param_leaves, self._master_leaves):
                    p.copy_(m)
            if self.fp16_enabled:
                self.scale_state = update_scale(
                    self.scale_state, torch.tensor(ok, device=self.device),
                    self.scale_cfg)
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
        """Mean loss over the batch's micro-batches, no update."""
        if batch is None:
            batch = self._next_batch(data_iter)
        dev_batch = self._shard_batch(batch)
        losses = [self.model.apply(self.params, m, train=False).float()
                  for m in self._micro_batches(dev_batch)]
        return float(torch.stack(losses).mean())

    def get_lr(self):
        return self.lr_scheduler.get_lr()

    def get_global_grad_norm(self):
        return self._last_metrics.get("grad_norm")

    @property
    def loss_scale(self) -> float:
        if self.scale_state is None:
            return 1.0
        return float(self.scale_state["loss_scale"])

"""Training engine, one GPU: ZeRO stages 0-2, optimizer offload, checkpoints.

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

ZeRO stages 1 and 2 run at one rank, where their partition plan is the
identity (as the JAX engine's on a one-device mesh). The optimizer state
may leave the card (``zero_optimization.offload_optimizer``, the selection
of JAX :215-228):

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
item): ZeRO stage 3 and data parallelism (A4), ``offload_param`` and
``cpu_checkpointing`` (A9), universal checkpoints (A5), pipeline, tensor,
sequence and expert parallelism (A8), telemetry and diagnostics (A7),
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
from ..ops.optimizers import TpuOptimizer, build_optimizer
from ..utils.device import resolve_device
from .activation_checkpointing import checkpointing as ds_ckpt
from .config import DeepSpeedConfig, OptimizerConfig, check_ported
from .fp16.loss_scaler import (LossScaleConfig, from_fp16_config,
                               grads_finite, init_scale_state, update_scale)
from .lr_schedules import LRScheduler, build_lr_schedule
from .offload import copy_rows

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
        self._last_metrics: Dict[str, float] = {}
        self.last_step_s = None
        self._step_events = None
        logger.info(
            f"engine ready: zero_stage={self.zero_stage} "
            f"dtype={config.precision_dtype} device={self.device} "
            f"batch={self.train_batch_size} (micro={self.micro_batch_size} "
            f"gas={self.gas})")

    # ------------------------------------------------------------------
    def _init_state(self, params, seed: int):
        # as in JAX (:643): ZeRO 1/2 keep a master even in fp32 (there it
        # is the f32 params themselves, ``Tensor.to`` returns the tensor)
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
        self.opt_state = (None if self.offload_device else
                          self.optimizer.init_state(
                              master if master is not None else compute))
        self.scale_state = (init_scale_state(self.scale_cfg, self.device)
                            if self.fp16_enabled else None)
        self.param_count = int(sum(p.numel() for p in compute))
        self._step = 0          # optimizer steps applied (JAX _step_arr)
        self._grad_acc: Optional[List[torch.Tensor]] = None

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
        events = None
        if self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
        if self.offload_tiered:
            # the state fetches ride under the forward and backward
            self.host_opt.prefetch()
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
            # a bf16 grad tree of 7B is 14.5 GB: the next micro-batch's
            # backward must not find this one alive
            del grads
            losses.append(loss.detach())
        with torch.no_grad():
            loss = torch.stack(losses).mean()
            inv = 1.0 / (self.gas * scale) if scale is not None \
                else 1.0 / self.gas
            grads, finite, gnorm = unscale_clip_check(
                acc, inv, self.config.gradient_clipping, self.fp16_enabled)
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
                    for p, m in zip(self._param_leaves, self._master_leaves):
                        p.copy_(m)
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
        """Mean loss over the batch's micro-batches, no update."""
        if batch is None:
            batch = self._next_batch(data_iter)
        dev_batch = self._shard_batch(batch)
        losses = [self.model.apply(self.params, m, train=False).float()
                  for m in self._micro_batches(dev_batch)]
        return float(torch.stack(losses).mean())

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

    def _train_state(self):
        """The state a checkpoint holds, as the JAX engine lays it out."""
        if self.host_opt is not None:
            master, moments = self.host_opt.get_all_leaves()
            master_tree = self._tree(master)
        else:
            master_tree, moments = self.master_params, self.opt_state
        return {
            "params": self.params,
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
            logger.info(f"saved checkpoint {save_dir}/{tag}")
            return True
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
        return True

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, **_kw):
        """Restore a checkpoint of either package into this engine's
        tensors, in place. Returns ``(load_dir, client_state)``, or
        ``(None, {})`` when ``load_dir`` names no checkpoint."""
        self._join_pending_saves()
        tag = tag or ckpt.read_latest(load_dir)
        if tag is None:
            return None, {}

        def meta_like(tree):
            return None if tree is None else ckpt.tree_from_paths(
                (k, torch.empty_like(v, device="meta"))
                for k, v in ckpt.leaf_paths(tree))

        if self.host_opt is not None:
            master, moments = self.host_opt.template_leaves()
        else:
            master, moments = self._master_leaves, self.opt_state
        template = {
            "params": meta_like(self.params),
            "master_params": (None if master is None else
                              meta_like(self._tree(master))),
            "opt_state": ({k: meta_like(self._tree(v))
                           for k, v in moments.items()}
                          if load_optimizer_states else None),
            "scale_state": meta_like(self.scale_state),
            "step": torch.empty((), dtype=torch.int32, device="meta"),
        }
        state, meta = ckpt.load_state(load_dir, tag, template)
        if state["master_params"] is None and master is not None:
            # a checkpoint without a master (fp32 at ZeRO 0): the master is
            # its params' f32 value (the JAX engine keeps its old master)
            state["master_params"] = ckpt.load_state(
                load_dir, tag, {"params": template["master_params"]}
            )[0]["params"]

        def leaves(name):
            return [v for _, v in ckpt.leaf_paths(state[name])]

        if self.host_opt is not None:
            moments = None
            if state["opt_state"] is not None:
                moments = {k: [v for _, v in ckpt.leaf_paths(sub)]
                           for k, sub in state["opt_state"].items()}
            self.host_opt.load_leaves(leaves("master_params"), moments)
            # the compute params are the master's cast, as in JAX
            master, _ = self.host_opt.get_all_leaves()
            for p, m in zip(self._param_leaves, master):
                copy_rows(p.detach(), m)
        else:
            for p, v in zip(self._param_leaves, leaves("params")):
                copy_rows(p.detach(), v)
            if master is not None:
                for m, v in zip(master, leaves("master_params")):
                    copy_rows(m, v)
            if state["opt_state"] is not None:
                for k, sub in state["opt_state"].items():
                    for m, (_, v) in zip(self.opt_state[k],
                                         ckpt.leaf_paths(sub)):
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
        the JAX package writes them)."""
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, save_filename)
        np.savez(path, **{k: ckpt.to_numpy(v)
                          for k, v in ckpt.leaf_paths(self.params)})
        logger.info(f"saved 16-bit model -> {path}")
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
        self._grad_acc = None

"""ZeRO-Infinity NVMe parameter tier: per-layer streamed execution.

Port of ``deepspeed_tpu/runtime/zero/infinity.py`` (``_LayerFileStream``
:64, ``InfinityParamEngine`` :134). The reference's parameter swapper
(``swap_tensor/partitioned_param_swapper.py:36``) keeps the layer params
on NVMe and reads each into a page-locked buffer right before its module
runs. Here, as in the JAX package, an explicit per-layer executor walks
the stack:

* the forward sweep runs the stem (embedding), each layer, and keeps only
  the layers' boundary activations; layer ``i + 1``'s file read overlaps
  layer ``i``'s compute (two page-locked buffers, :class:`_LayerFileStream`
  on ``ops/aio.py``);
* the crown (final norm and the chunked cross-entropy) is differentiated
  by autograd; the reverse sweep reads each layer again and recomputes it
  under ``torch.enable_grad()``, differentiating it with
  ``torch.autograd.grad`` (the JAX ``jax.vjp``, :361-413), so the device
  never holds more than one layer's params plus the boundary activations;
* gradients accumulate in fp32 host buffers over the micro-batches
  (:415-425), then the 1/gas scale, the global norm and clipping;
* the optimizer sweep updates layer by layer with the host C++ optimizer
  (``ops/cpu_optimizers.py``), reading ``layer_{i}.optim`` ahead and
  writing it back behind when the optimizer state is on NVMe too, and
  rewrites ``layer_{i}.params`` (:427-471).

Files under ``offload_param.nvme_path/ds_tpu_param_swap/pid<p>_<n>/``
(the JAX layout, byte for byte):

* ``layer_{i:05d}.params``: the layer's compute-dtype leaves, in sorted
  leaf order, concatenated;
* ``layer_{i:05d}.optim``: fp32 ``[master | moment0 | moment1 ...]`` per
  leaf, concatenated (in host RAM instead unless ``offload_optimizer`` is
  ``nvme``).

The persistent leaves (embedding, final norm, head) stay on the device in
the compute dtype, with fp32 master and moments in host RAM. A slot of the
read buffers is reused only once its read has completed and the
host-to-device copies sourced from it have finished (a CUDA event, where
JAX waits with ``block_until_ready``).

Measured per step (``timings``): each sweep's seconds and the seconds it
waited on a file read, the bytes read from and written to the layer
files.
"""

import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...ops.cpu_optimizers import build_host_optimizer
from ..offload import PinnedHost

logger = logging.getLogger(__name__)


class _LayerFileStream:
    """Double-buffered reader over per-layer files of equal size.

    A slot's buffer is rewritten only after (a) its read completed and (b)
    the host-to-device copies sourced from it finished (``note_transfer``
    records an event after them; a claim waits on it)."""

    def __init__(self, aio, paths: List[str], numel: int, dtype,
                 pinned: PinnedHost):
        self.aio = aio
        self.paths = paths
        self.bufs = [pinned.pin(torch.zeros(numel, dtype=dtype))
                     for _ in range(2)]
        self._pending: Dict[int, int] = {}   # layer -> aio request id
        self._slot_of: Dict[int, int] = {}   # layer -> buffer slot
        self._transfer: Dict[int, Any] = {}  # slot -> event after its H2D
        self.wait_s = 0.0
        self.read_bytes = 0

    def note_transfer(self, i: int, event) -> None:
        if event is not None:
            self._transfer[self._slot_of[i]] = event

    def _claim_slot(self, i: int, keep: Optional[int]) -> Optional[int]:
        used = set(self._slot_of.values())
        free = [s for s in (0, 1) if s not in used]
        if free:
            slot = free[0]
        else:  # evict a layer that is not the caller's pinned one
            victim = next((k for k in self._slot_of
                           if k != keep and k not in self._pending), None)
            if victim is None:
                victim = next((k for k in self._pending if k != keep), None)
                if victim is None:
                    return None
                self.aio.wait(self._pending.pop(victim))
            slot = self._slot_of.pop(victim)
        ev = self._transfer.pop(slot, None)
        if ev is not None:
            ev.synchronize()   # the buffer may still feed a copy
        self._slot_of[i] = slot
        return slot

    def prefetch(self, i: int, keep: Optional[int] = None) -> None:
        if i < 0 or i >= len(self.paths) or i in self._pending \
                or i in self._slot_of:
            return
        slot = self._claim_slot(i, keep)
        if slot is not None:
            self._pending[i] = self.aio.pread(self.paths[i], self.bufs[slot])
            self.read_bytes += self.bufs[slot].numel() * \
                self.bufs[slot].element_size()

    def get(self, i: int, prefetch_next: Optional[int] = None):
        t0 = time.perf_counter()
        if i in self._pending:
            self.aio.wait(self._pending.pop(i))
        elif i not in self._slot_of:
            slot = self._claim_slot(i, keep=None)
            assert slot is not None, "layer stream: no free buffer slot"
            self.aio.sync_pread(self.paths[i], self.bufs[slot])
            self.read_bytes += self.bufs[slot].numel() * \
                self.bufs[slot].element_size()
        self.wait_s += time.perf_counter() - t0
        buf = self.bufs[self._slot_of[i]]
        if prefetch_next is not None:
            self.prefetch(prefetch_next, keep=i)
        return buf

    def invalidate(self) -> None:
        """Drop every buffered layer (the files were rewritten)."""
        for req in list(self._pending.values()):
            self.aio.wait(req)
        self._pending.clear()
        self._slot_of.clear()
        for ev in self._transfer.values():
            ev.synchronize()
        self._transfer.clear()


class InfinityParamEngine:
    """Owns the NVMe parameter files, the optimizer state and the
    per-layer step. Built by the training engine when
    ``offload_param.device == "nvme"``.

    ``items`` are the initial weights, ``(path, tensor)`` in the engine's
    leaf order (any device and dtype: the master is their f32 value).
    The checkpoint surface is the host optimizers' (leaf lists in that
    order): ``get_all_leaves``, ``template_leaves``, ``load_leaves``."""

    _instance_counter = 0

    def __init__(self, model, items: Sequence[Tuple[str, torch.Tensor]],
                 device, *, opt_name: str, opt_params: Dict[str, Any],
                 param_nvme_path: str, optim_device: str,
                 optim_nvme_path: Optional[str], aio_block_size: int,
                 aio_threads: int, gas: int, clip: float,
                 compute_dtype=torch.bfloat16):
        from ...ops.aio import AsyncIOHandle

        self.model = model
        self.cfg = model.cfg
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.gas = gas
        self.clip = clip
        self.compute_dtype = compute_dtype
        self.L = self.cfg.num_layers
        self.opt = build_host_optimizer(opt_name, opt_params)
        self.state_keys = self.opt.state_keys()
        self._n_fields = 1 + len(self.state_keys)
        self.optim_on_nvme = optim_device == "nvme"
        self.names = [k for k, _ in items]

        InfinityParamEngine._instance_counter += 1
        n = InfinityParamEngine._instance_counter
        self.param_dir = os.path.join(param_nvme_path, "ds_tpu_param_swap",
                                      f"pid{os.getpid()}_{n}")
        os.makedirs(self.param_dir, exist_ok=True)
        self.optim_dir = self.param_dir if not optim_nvme_path else \
            os.path.join(optim_nvme_path, "ds_tpu_param_swap",
                         f"pid{os.getpid()}_{n}_optim")
        if self.optim_on_nvme:
            os.makedirs(self.optim_dir, exist_ok=True)
        self.aio = AsyncIOHandle(aio_block_size, aio_threads)
        self.pinned = PinnedHost(self.cuda)

        # ---- the split: persistent leaves and the layer stack ----
        t0 = time.perf_counter()
        self.persist_names = [k for k in self.names
                              if not k.startswith("layers/")]
        self.layer_keys = [k.split("/", 1)[1] for k in self.names
                           if k.startswith("layers/")]
        tensors = dict(items)
        self.persist_leaves = [
            tensors[k].detach().to("cpu", torch.float32, copy=True)
            for k in self.persist_names]
        self.persist_state = [[torch.zeros(m.shape)
                               for _ in self.state_keys]
                              for m in self.persist_leaves]
        layer_leaves = [tensors["layers/" + k] for k in self.layer_keys]
        self.layer_shapes = [tuple(l.shape[1:]) for l in layer_leaves]
        self.layer_sizes = [int(torch.Size(s).numel())
                            for s in self.layer_shapes]
        self.layer_elems = int(sum(self.layer_sizes))
        self.param_files = [os.path.join(self.param_dir,
                                         f"layer_{i:05d}.params")
                            for i in range(self.L)]
        self.optim_files = [os.path.join(self.optim_dir,
                                         f"layer_{i:05d}.optim")
                            for i in range(self.L)]
        # one layer at a time, so host memory holds one layer's staging
        pbuf = torch.zeros(self.layer_elems, dtype=compute_dtype)
        obuf = torch.zeros(self.layer_elems * self._n_fields)
        self._optim_ram: List[Optional[torch.Tensor]] = [None] * self.L
        self.bytes_written = 0
        for i in range(self.L):
            off = ooff = 0
            obuf.zero_()
            for leaf, sz in zip(layer_leaves, self.layer_sizes):
                flat = leaf[i].detach().to("cpu", torch.float32).reshape(-1)
                pbuf[off:off + sz].copy_(flat)
                obuf[ooff:ooff + sz].copy_(flat)
                off += sz
                ooff += sz * self._n_fields
            self.aio.sync_pwrite(self.param_files[i], pbuf)
            self.bytes_written += pbuf.numel() * pbuf.element_size()
            if self.optim_on_nvme:
                self.aio.sync_pwrite(self.optim_files[i], obuf)
                self.bytes_written += obuf.numel() * 4
            else:
                self._optim_ram[i] = obuf.clone()
        del tensors, layer_leaves, items
        self.init_s = time.perf_counter() - t0
        logger.info(
            f"ZeRO-Infinity: {self.L} layer param files at {self.param_dir} "
            f"({self.layer_elems * self.L * pbuf.element_size() / 1e9:.2f} "
            f"GB); optimizer state "
            f"{'on NVMe' if self.optim_on_nvme else 'in host RAM'}")

        # ---- working buffers ----
        self._pstream = _LayerFileStream(self.aio, self.param_files,
                                         self.layer_elems, compute_dtype,
                                         self.pinned)
        self.grad_acc = [torch.zeros(self.layer_elems)
                         for _ in range(self.L)]
        # a layer's gradients arrive here in f32 (cast on the device: a
        # cast across devices, or a mixed-dtype add, runs slowly on the
        # host), then one f32 add into the accumulator
        self._gstage = self.pinned.pin(torch.empty(self.layer_elems))
        self.persist_grad_acc = [torch.zeros(m.shape)
                                 for m in self.persist_leaves]
        self._obufs = ([torch.zeros(self.layer_elems * self._n_fields)
                        for _ in range(2)] if self.optim_on_nvme else [])
        self._pbuf = torch.zeros(self.layer_elems, dtype=compute_dtype)
        self._push_persist()
        self._rope_cache: Dict[int, Any] = {}
        self.timings: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _push_persist(self) -> None:
        self.pp_dev = {k: m.to(self.device, self.compute_dtype)
                       for k, m in zip(self.persist_names,
                                       self.persist_leaves)}

    def _fetch_layer(self, i: int, prefetch: Optional[int]):
        """Layer ``i``'s leaves on the device (fresh tensors)."""
        buf = self._pstream.get(i, prefetch)
        views, off = {}, 0
        for k, shape, sz in zip(self.layer_keys, self.layer_shapes,
                                self.layer_sizes):
            views[k] = buf[off:off + sz].view(shape)
            off += sz
        if not self.cuda:
            return {k: v.clone() for k, v in views.items()}
        dev = {k: v.to(self.device, non_blocking=True)
               for k, v in views.items()}
        done = torch.cuda.Event()
        done.record()
        # the buffer is not rewritten before these copies have read it
        self._pstream.note_transfer(i, done)
        return dev

    # -- the stem, the crown (the model's own pieces) --------------------
    def _stem(self, pp, ids):
        cfg = self.cfg
        x = F.embedding(ids, pp["embed"])
        if cfg.embed_scale != 1.0:
            x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
        if cfg.positional == "learned":
            x = x + pp["pos_embed"][:ids.shape[1]][None]
        return x

    def _crown(self, pp, x, ids, mask):
        from ...models.transformer import _chunked_ce_loss

        cfg = self.cfg
        x = self.model._norm(x, pp["final_norm"], pp.get("final_norm_b"))
        head = pp["embed"].T if cfg.tie_embeddings else pp["lm_head"]
        m = (mask[:, 1:].float() if mask is not None
             else torch.ones(ids[:, 1:].shape, dtype=torch.float32,
                             device=ids.device))
        total, count = _chunked_ce_loss(x[:, :-1], ids[:, 1:], m, head,
                                        cfg.loss_chunk)
        return total / torch.clamp(count, min=1.0)

    def _rope(self, S: int):
        if S not in self._rope_cache:
            from ...models.transformer import _rope_tables

            if self.cfg.positional == "rope":
                cos, sin = _rope_tables(self.cfg, S, device=self.device)
            else:   # unused by _layer, as in forward_hidden
                cos = sin = torch.zeros((S, 1), device=self.device)
            self._rope_cache[S] = (cos.to(self.compute_dtype),
                                   sin.to(self.compute_dtype))
        return self._rope_cache[S]

    # ------------------------------------------------------------------
    # one train batch: gas micro-batches, then the optimizer sweep
    # ------------------------------------------------------------------
    def train_batch(self, dev_batch, step: int, lr: float) -> Dict[str, Any]:
        """``dev_batch``: ``[gas, micro, ...]`` tensors on the device;
        ``step`` is 1-based."""
        L = self.L

        def layer(*args):
            # ZeRO-Infinity refuses MoE: a layer's aux output is None
            return self.model._layer(*args)[0]

        self.model._check_trainable()
        t_start = time.perf_counter()
        r0 = self._pstream.read_bytes
        fwd_s = bwd_s = fwd_wait = bwd_wait = 0.0
        losses = []
        for g in self.grad_acc:
            g.zero_()
        for g in self.persist_grad_acc:
            g.zero_()
        for m in range(self.gas):
            ids = dev_batch["input_ids"][m]
            mask = dev_batch["loss_mask"][m] if "loss_mask" in dev_batch \
                else None
            cos, sin = self._rope(ids.shape[1])
            # ---- forward sweep (the read of i + 1 under layer i) ----
            t0, wt = time.perf_counter(), self._pstream.wait_s
            with torch.no_grad():
                h = self._stem(self.pp_dev, ids)
                acts = [h]
                for i in range(L):
                    lp = self._fetch_layer(i, i + 1 if i + 1 < L else None)
                    h = layer(h, lp, cos, sin)
                    acts.append(h)
            fwd_s += time.perf_counter() - t0
            fwd_wait += self._pstream.wait_s - wt
            # ---- the crown's gradients ----
            t0, wt = time.perf_counter(), self._pstream.wait_s
            pp = {k: v.detach().requires_grad_()
                  for k, v in self.pp_dev.items()}
            x = acts.pop().detach().requires_grad_()
            with torch.enable_grad():
                loss = self._crown(pp, x, ids, mask)
                grads = torch.autograd.grad(loss, list(pp.values()) + [x],
                                            allow_unused=True)
            losses.append(loss.detach())
            self._acc_persist(grads[:-1])
            dh = grads[-1]
            del grads, x
            # ---- reverse sweep: each layer read again and recomputed ----
            for i in range(L - 1, -1, -1):
                lp = self._fetch_layer(i, i - 1 if i > 0 else None)
                for v in lp.values():
                    v.requires_grad_(True)
                h_in = acts.pop().detach().requires_grad_()
                with torch.enable_grad():
                    out = layer(h_in, lp, cos, sin)
                    g = torch.autograd.grad(out, [h_in] + list(lp.values()),
                                            grad_outputs=dh)
                dh = g[0]
                self._acc_layer_grads(i, g[1:])
                del out, g, lp, h_in
            with torch.enable_grad():
                pp = {k: v.detach().requires_grad_()
                      for k, v in self.pp_dev.items()}
                e = self._stem(pp, ids)
                grads = torch.autograd.grad(e, list(pp.values()),
                                            grad_outputs=dh,
                                            allow_unused=True)
            self._acc_persist(grads)
            del grads, dh
            bwd_s += time.perf_counter() - t0
            bwd_wait += self._pstream.wait_s - wt

        # ---- 1 / gas, the global norm, the clip factor ----
        inv = 1.0 / self.gas
        sq = 0.0
        for g in self.grad_acc + self.persist_grad_acc:
            g.mul_(inv)
            flat = g.reshape(-1)
            sq += float(torch.dot(flat, flat))
        gnorm = sq ** 0.5
        if self.clip and self.clip > 0 and gnorm > self.clip:
            factor = self.clip / (gnorm + 1e-6)
            for g in self.grad_acc + self.persist_grad_acc:
                g.mul_(factor)
        t0 = time.perf_counter()
        opt_wait = self._optimizer_sweep(step, lr)
        opt_s = time.perf_counter() - t0
        loss_mean = float(torch.stack(losses).float().mean())
        self.timings = {
            "forward_s": fwd_s, "forward_read_wait_s": fwd_wait,
            "backward_s": bwd_s, "backward_read_wait_s": bwd_wait,
            "optimizer_s": opt_s, "optimizer_read_wait_s": opt_wait,
            "read_bytes": self._pstream.read_bytes - r0,
            "step_s": time.perf_counter() - t_start}
        return {"loss": loss_mean, "grad_norm": gnorm, "skipped": 0}

    def _acc_layer_grads(self, i: int, grads) -> None:
        off = 0
        for g, sz in zip(grads, self.layer_sizes):
            self._gstage[off:off + sz].copy_(g.detach().float().reshape(-1))
            off += sz
        self.grad_acc[i].add_(self._gstage)

    def _acc_persist(self, grads) -> None:
        for acc, g in zip(self.persist_grad_acc, grads):
            if g is not None:
                acc.add_(g.detach().float().to("cpu").reshape(acc.shape))

    # ------------------------------------------------------------------
    def _optimizer_sweep(self, step: int, lr: float) -> float:
        """Per-layer update; with the state on NVMe, layer ``i + 1``'s
        read and layer ``i - 1``'s write-back ride the AIO threads while
        layer ``i`` runs the C++ kernel. Returns the seconds waited on a
        state read."""
        L = self.L
        pbuf = self._pbuf
        reads = [None, None]
        pending_write = None
        wait = 0.0
        if self.optim_on_nvme:
            reads[0] = self.aio.pread(self.optim_files[0], self._obufs[0])
        for i in range(L):
            if self.optim_on_nvme:
                cur = self._obufs[i % 2]
                if i + 1 < L:
                    if pending_write is not None:
                        self.aio.wait(pending_write)
                        pending_write = None
                    reads[(i + 1) % 2] = self.aio.pread(
                        self.optim_files[i + 1], self._obufs[(i + 1) % 2])
                t0 = time.perf_counter()
                self.aio.wait(reads[i % 2])
                wait += time.perf_counter() - t0
            else:
                cur = self._optim_ram[i]
            grads, ooff, poff = self.grad_acc[i], 0, 0
            for sz in self.layer_sizes:
                master = cur[ooff:ooff + sz]
                moments = [cur[ooff + (1 + k) * sz:ooff + (2 + k) * sz]
                           for k in range(len(self.state_keys))]
                self.opt.step(step, master, grads[poff:poff + sz],
                              *moments, lr=lr)
                pbuf[poff:poff + sz].copy_(master)
                ooff += sz * self._n_fields
                poff += sz
            if self.optim_on_nvme:
                pending_write = self.aio.pwrite(self.optim_files[i], cur)
            self.aio.sync_pwrite(self.param_files[i], pbuf)
        if pending_write is not None:
            self.aio.wait(pending_write)
        # any buffered layer predates the rewrite
        self._pstream.invalidate()
        # the persistent (device-resident) params: a plain host update
        for j, m in enumerate(self.persist_leaves):
            self.opt.step(step, m.view(-1),
                          self.persist_grad_acc[j].view(-1),
                          *[s.view(-1) for s in self.persist_state[j]],
                          lr=lr)
        self._push_persist()
        return wait

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_batch(self, dev_batch) -> float:
        losses = []
        for m in range(self.gas):
            ids = dev_batch["input_ids"][m]
            mask = dev_batch["loss_mask"][m] if "loss_mask" in dev_batch \
                else None
            cos, sin = self._rope(ids.shape[1])
            h = self._stem(self.pp_dev, ids)
            for i in range(self.L):
                lp = self._fetch_layer(i, i + 1 if i + 1 < self.L else None)
                h = self.model._layer(h, lp, cos, sin)[0]
            losses.append(float(self._crown(self.pp_dev, h, ids, mask)))
        return float(sum(losses) / len(losses))

    # ------------------------------------------------------------------
    # checkpoint surface: whole leaves in the engine's leaf order
    # ------------------------------------------------------------------
    def _read_optim(self, i: int) -> torch.Tensor:
        if self.optim_on_nvme:
            buf = torch.empty(self.layer_elems * self._n_fields)
            self.aio.sync_pread(self.optim_files[i], buf)
            return buf
        return self._optim_ram[i]

    def _assemble(self, persist, stacked) -> List[torch.Tensor]:
        by_name = dict(zip(self.persist_names, persist))
        by_name.update(("layers/" + k, v)
                       for k, v in zip(self.layer_keys, stacked))
        return [by_name[k] for k in self.names]

    def get_all_leaves(self):
        """(master leaves, {state key: leaves}), fp32 host copies with the
        layers re-stacked: one sweep over the optimizer state."""
        stacked_m = [torch.empty((self.L,) + s) for s in self.layer_shapes]
        stacked_s = {k: [torch.empty((self.L,) + s)
                         for s in self.layer_shapes]
                     for k in self.state_keys}
        for i in range(self.L):
            buf = self._read_optim(i)
            ooff = 0
            for j, (shape, sz) in enumerate(zip(self.layer_shapes,
                                                self.layer_sizes)):
                stacked_m[j][i] = buf[ooff:ooff + sz].view(shape)
                for k_idx, key in enumerate(self.state_keys):
                    stacked_s[key][j][i] = buf[
                        ooff + (1 + k_idx) * sz:
                        ooff + (2 + k_idx) * sz].view(shape)
                ooff += sz * self._n_fields
        master = self._assemble([m.clone() for m in self.persist_leaves],
                                stacked_m)
        state = {key: self._assemble([s[k_idx].clone()
                                      for s in self.persist_state],
                                     stacked_s[key])
                 for k_idx, key in enumerate(self.state_keys)}
        return master, state

    def template_leaves(self):
        """Shape templates (``meta`` tensors) for checkpoint loading."""
        def meta():
            return self._assemble(
                [torch.empty(m.shape, device="meta")
                 for m in self.persist_leaves],
                [torch.empty((self.L,) + s, device="meta")
                 for s in self.layer_shapes])

        return meta(), {k: meta() for k in self.state_keys}

    def load_leaves(self, master: Sequence[torch.Tensor],
                    state: Optional[Dict[str, Sequence[torch.Tensor]]] = None):
        """Restore the master (and the moments, if given; ``None`` keeps
        them) into the files or RAM, and rebuild the param files and the
        device persistents from it."""
        by_name = dict(zip(self.names, master))
        s_by_name = ({k: dict(zip(self.names, v)) for k, v in state.items()}
                     if state is not None else None)
        for j, name in enumerate(self.persist_names):
            self.persist_leaves[j].copy_(by_name[name].reshape(
                self.persist_leaves[j].shape))
            if s_by_name is not None:
                for k_idx, key in enumerate(self.state_keys):
                    self.persist_state[j][k_idx].copy_(
                        s_by_name[key][name].reshape(
                            self.persist_state[j][k_idx].shape))
        pbuf = self._pbuf
        for i in range(self.L):
            buf = self._read_optim(i) if state is None else \
                torch.zeros(self.layer_elems * self._n_fields)
            ooff = poff = 0
            for key, sz in zip(self.layer_keys, self.layer_sizes):
                flat = by_name["layers/" + key][i].to(
                    "cpu", torch.float32).reshape(-1)
                buf[ooff:ooff + sz].copy_(flat)
                pbuf[poff:poff + sz].copy_(flat)
                if s_by_name is not None:
                    for k_idx, skey in enumerate(self.state_keys):
                        buf[ooff + (1 + k_idx) * sz:
                            ooff + (2 + k_idx) * sz].copy_(
                            s_by_name[skey]["layers/" + key][i].reshape(-1))
                ooff += sz * self._n_fields
                poff += sz
            if self.optim_on_nvme:
                self.aio.sync_pwrite(self.optim_files[i], buf)
            else:
                self._optim_ram[i] = buf
            self.aio.sync_pwrite(self.param_files[i], pbuf)
        self._pstream.invalidate()
        self._push_persist()

    # ------------------------------------------------------------------
    def device_param_bytes(self) -> int:
        """Bytes of parameters resident on the device: the persistent
        leaves only (the layer stack lives in its files)."""
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        return int(sum(m.numel() * itemsize for m in self.persist_leaves))

    def close(self) -> None:
        if self.aio is not None:
            self._pstream.invalidate()
            self.aio.close()
            self.aio = None
            shutil.rmtree(self.param_dir, ignore_errors=True)
            if self.optim_on_nvme:
                shutil.rmtree(self.optim_dir, ignore_errors=True)
        if self.cuda:       # no copy may touch a page once unregistered
            torch.cuda.synchronize(self.device)
        self.pinned.close()
        self.opt.destroy()

"""ZeRO-Infinity NVMe parameter tier: per-layer streamed execution.

Port of ``deepspeed_tpu/runtime/zero/infinity.py`` (``_LayerFileStream``
:64, ``InfinityParamEngine`` :134). The reference's parameter swapper
(``swap_tensor/partitioned_param_swapper.py:36``) keeps each rank's
partition of the layer params on NVMe and reads it into a page-locked
buffer right before its module runs. Here, as in the JAX package, an
explicit per-layer executor walks the stack:

* the forward sweep runs the stem (embedding), each layer, and keeps only
  the layers' boundary activations; layer ``i + 1``'s file read overlaps
  layer ``i``'s gather and compute (two page-locked buffers,
  :class:`_LayerFileStream` on ``ops/aio.py``);
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

At more than one rank each rank runs this executor on its own rows of the
batch (the JAX engine is one controller over the mesh; the reference's
partitioned swapper is the model here). A rank holds its tensor-parallel
slice of every leaf (the model's TP plan, as the resident engine cuts
them), and of that slice its ZeRO-3 piece over the data-parallel group
``group``: each layer leaf flattened, zero-padded to a multiple of the
group's size and cut into equal contiguous pieces, piece ``r`` on rank
``r``. Before layer ``i`` runs (forward and recompute) the ranks
all-gather its pieces, while layer ``i + 1``'s file read proceeds; its
gradients reduce-scatter (the mean over the group) into the rank's host
f32 accumulators. The persistent leaves (embedding, final norm, head)
follow the resident stage-3 plan: master and moments cut along the
largest dimension the group's size divides (``runtime/zero/partition``),
gathered to the device after each update, their gradients
reduce-scattered. The clip norm sums each piece's squares over the ranks
holding distinct pieces (the data group; a tensor-parallel slice over the
model group too), never over replicas. At one rank every piece is the
whole leaf and every collective a copy.

Files under ``offload_param.nvme_path/ds_tpu_param_swap/pid<p>_<n>/``
(the JAX layout, byte for byte, at one rank):

* ``layer_{i:05d}.params``: the rank's pieces of the layer's leaves in
  the compute dtype, in sorted leaf order, concatenated;
* ``layer_{i:05d}.optim``: fp32 ``[master | moment0 | moment1 ...]`` per
  piece, concatenated (in host RAM instead unless ``offload_optimizer`` is
  ``nvme``).

The persistent leaves stay on the device in the compute dtype, with their
fp32 master and moments pieces in host RAM. A slot of the read buffers is
reused only once its read has completed and the host-to-device copy
sourced from it has finished (a CUDA event, where JAX waits with
``block_until_ready``).

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

from ...comm import comm
from ...comm.quantized import all_gather_leaf, reduce_scatter_leaf, shard_of
from ...ops.cpu_optimizers import build_host_optimizer
from ..offload import PinnedHost
from .partition import zero_dim

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
    leaf order, each this rank's tensor-parallel slice (any device and
    dtype: the master is their f32 value). ``group`` is the data-parallel
    group the pieces are cut over; ``model_group`` the tensor-parallel
    group and ``tp_dims`` the leaves cut over it, with the dimension (their
    squares sum over it in the clip norm). The checkpoint surface is the
    host optimizers' (leaf lists in that order, whole over ``group``):
    ``get_all_leaves``, ``template_leaves``, ``load_leaves``."""

    _instance_counter = 0

    def __init__(self, model, items: Sequence[Tuple[str, torch.Tensor]],
                 device, *, opt_name: str, opt_params: Dict[str, Any],
                 param_nvme_path: str, optim_device: str,
                 optim_nvme_path: Optional[str], aio_block_size: int,
                 aio_threads: int, gas: int, clip: float,
                 compute_dtype=torch.bfloat16, group=None, model_group=None,
                 tp_dims: Optional[Dict[str, int]] = None):
        from ...ops.aio import AsyncIOHandle

        self.model = model
        self.cfg = model.cfg
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.gas = gas
        self.clip = clip
        self.compute_dtype = compute_dtype
        self.L = self.cfg.num_layers
        self.group = group
        self.world = comm.get_world_size(group)
        self.rank = comm.get_rank(group)
        self.model_group = model_group
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
        tp_dims = tp_dims or {}
        # a persistent leaf's piece: the resident stage-3 plan's dimension
        # (never the tensor-parallel one), or the whole leaf (replicated)
        self.persist_shapes = [tuple(tensors[k].shape)
                               for k in self.persist_names]
        self.persist_dims = [
            zero_dim(s, self.world,
                     free=[d for d in range(len(s)) if d != tp_dims.get(k)])
            for k, s in zip(self.persist_names, self.persist_shapes)]
        self.persist_leaves = [
            self._cut(tensors[k].detach().to("cpu", torch.float32), d)
            for k, d in zip(self.persist_names, self.persist_dims)]
        self.persist_state = [[torch.zeros(m.shape)
                               for _ in self.state_keys]
                              for m in self.persist_leaves]
        layer_leaves = [tensors["layers/" + k] for k in self.layer_keys]
        self.layer_shapes = [tuple(l.shape[1:]) for l in layer_leaves]
        self.layer_sizes = [int(torch.Size(s).numel())
                            for s in self.layer_shapes]
        # each leaf's piece of a layer: its flat elements padded to a
        # multiple of the group's size, cut in ``world`` equal parts
        self.piece_sizes = [-(-sz // self.world) for sz in self.layer_sizes]
        self.layer_elems = int(sum(self.piece_sizes))
        self._cut_layer = ["layers/" + k in tp_dims for k in self.layer_keys]
        self._cut_persist = [k in tp_dims for k in self.persist_names]
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
            for leaf, c in zip(layer_leaves, self.piece_sizes):
                flat = leaf[i].detach().to("cpu", torch.float32).reshape(-1)
                self._piece(flat, obuf[ooff:ooff + c])
                pbuf[off:off + c].copy_(obuf[ooff:ooff + c])
                off += c
                ooff += c * self._n_fields
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
            f"GB, piece {self.rank} of {self.world}); optimizer state "
            f"{'on NVMe' if self.optim_on_nvme else 'in host RAM'}")

        # ---- working buffers ----
        self._pstream = _LayerFileStream(self.aio, self.param_files,
                                         self.layer_elems, compute_dtype,
                                         self.pinned)
        self.grad_acc = [torch.zeros(self.layer_elems)
                         for _ in range(self.L)]
        # a layer's gradients are cast to f32 on the device into the
        # reduce-scatter's input (its padding stays 0), reduced into this
        # rank's pieces, then cross in one copy: a cast across devices,
        # or a mixed-dtype add, runs slowly on the host
        self._gstage = self.pinned.pin(torch.empty(self.layer_elems))
        self._gbufs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.persist_grad_acc = [torch.zeros(m.shape)
                                 for m in self.persist_leaves]
        self._obufs = ([torch.zeros(self.layer_elems * self._n_fields)
                        for _ in range(2)] if self.optim_on_nvme else [])
        self._pbuf = torch.zeros(self.layer_elems, dtype=compute_dtype)
        self._push_persist()
        self._rope_cache: Dict[int, Any] = {}
        self.timings: Dict[str, float] = {}

    # ------------------------------------------------------------------
    # pieces over the data-parallel group
    # ------------------------------------------------------------------
    def _cut(self, full: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's piece of a persistent leaf (a contiguous copy)."""
        if dim is None:
            return full.clone()
        return shard_of(full, dim, self.rank, self.world).clone()

    def _piece(self, flat: torch.Tensor, out: torch.Tensor) -> None:
        """This rank's piece of a flat layer leaf into ``out`` (zeros past
        the leaf's end)."""
        c = out.numel()
        a = min(self.rank * c, flat.numel())
        b = min(a + c, flat.numel())
        out[:b - a].copy_(flat[a:b])
        out[b - a:].zero_()

    def _whole(self, rows: torch.Tensor, off: int, c: int, n: int,
               shape) -> torch.Tensor:
        """A leaf from every rank's pieces: ``rows`` [world, ...] holds
        each rank's concatenated pieces; this leaf's are ``[off, off +
        c)`` of each row (a view at one rank, else a copy)."""
        return rows[:, off:off + c].reshape(-1)[:n].view(shape)

    def _gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """[world, numel]: every rank's ``local`` (on this engine's
        device), rank-major."""
        out = torch.empty(self.world * local.numel(), dtype=local.dtype,
                          device=local.device)
        comm.all_gather_into_tensor(out, local, group=self.group)
        return out.view(self.world, -1)

    def _gather_host(self, local: torch.Tensor) -> torch.Tensor:
        """:meth:`_gather_rows` of a host tensor, back on the host (the
        collective runs where the group's backend does: on the card)."""
        return self._gather_rows(local.to(self.device)).cpu()

    def _push_persist(self) -> None:
        self.pp_dev = {
            k: (m.to(self.device, self.compute_dtype) if d is None else
                all_gather_leaf(m.to(self.device, self.compute_dtype), d,
                                self.group))
            for k, m, d in zip(self.persist_names, self.persist_leaves,
                               self.persist_dims)}

    def _fetch_layer(self, i: int, prefetch: Optional[int]):
        """Layer ``i``'s leaves on the device (fresh tensors): this rank's
        pieces from its file, gathered over the group while the read of
        ``prefetch`` proceeds."""
        buf = self._pstream.get(i, prefetch)
        if self.cuda:
            local = buf.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            # the buffer is not rewritten before this copy has read it
            self._pstream.note_transfer(i, done)
        else:
            local = buf
        rows = self._gather_rows(local)
        views, off = {}, 0
        for k, shape, n, c in zip(self.layer_keys, self.layer_shapes,
                                  self.layer_sizes, self.piece_sizes):
            views[k] = self._whole(rows, off, c, n, shape)
            off += c
        return views

    # -- the stem, the crown (the model's own pieces) --------------------
    def _stem(self, pp, ids):
        # under tensor parallelism a masked lookup of this rank's vocab
        # rows, summed over the model group
        return self.model._embed_tokens(pp, ids)

    def _crown(self, pp, x, ids, mask):
        from ...models.transformer import (_chunked_ce_loss,
                                           _vocab_parallel_ce_loss)

        cfg = self.cfg
        x = self.model._norm(x, pp["final_norm"], pp.get("final_norm_b"))
        head = pp["embed"].T if cfg.tie_embeddings else pp["lm_head"]
        m = (mask[:, 1:].float() if mask is not None
             else torch.ones(ids[:, 1:].shape, dtype=torch.float32,
                             device=ids.device))
        tp, tr, tg = self.model._tp
        if tp > 1:      # this rank's vocab columns, as the model's apply
            total, count = _vocab_parallel_ce_loss(
                self.model._col(x[:, :-1]), ids[:, 1:], m, head,
                cfg.loss_chunk, tr * head.shape[-1], tg)
        else:
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
        for g in self.grad_acc + self.persist_grad_acc:
            g.mul_(inv)
        gnorm = self._global_norm()
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
        """Layer ``i``'s gradients (this rank's rows) reduce-scattered
        into the rank's pieces (the mean over the group), added to its
        host accumulator."""
        if self._gbufs is None:
            self._gbufs = (
                torch.zeros(self.world * self.layer_elems,
                            device=self.device),
                torch.empty(self.layer_elems, device=self.device))
        send, recv = self._gbufs
        rows = send.view(self.world, self.layer_elems)
        off = 0
        for g, n, c in zip(grads, self.layer_sizes, self.piece_sizes):
            flat = g.detach().reshape(-1)
            if n < self.world * c:      # zeros past the leaf's end
                flat = torch.cat([flat, flat.new_zeros(self.world * c - n)])
            # piece r of the leaf into row r
            rows[:, off:off + c].copy_(flat.view(self.world, c))
            off += c
        comm.reduce_scatter_tensor(recv, send, group=self.group)
        if self.world > 1:
            recv.div_(self.world)
        self._gstage.copy_(recv)
        self.grad_acc[i].add_(self._gstage)

    def _acc_persist(self, grads) -> None:
        for acc, g, d in zip(self.persist_grad_acc, grads, self.persist_dims):
            if g is None:
                continue
            g = g.detach().float()
            if d is not None:
                g = reduce_scatter_leaf(g, d, self.group)
            else:
                g = g.clone()
                comm.all_reduce(g, group=self.group)
                g.div_(self.world)
            acc.add_(g.to("cpu").reshape(acc.shape))

    def _global_norm(self) -> float:
        """The norm of the whole gradient: each piece's squares, summed
        over the data group (distinct pieces; a persistent leaf this rank
        holds whole counts on rank 0 only) and, for a tensor-parallel
        slice, over the model group."""
        sq = [0.0, 0.0]         # [cut over the model group, replicated]
        for g in self.grad_acc:
            if self.model_group is None:    # nothing cut: one sum a layer
                sq[1] += float(torch.dot(g, g))
                continue
            off = 0
            for c, cut in zip(self.piece_sizes, self._cut_layer):
                part = g[off:off + c]
                sq[0 if cut else 1] += float(torch.dot(part, part))
                off += c
        for g, d, cut in zip(self.persist_grad_acc, self.persist_dims,
                             self._cut_persist):
            if d is not None or self.rank == 0:
                flat = g.reshape(-1)
                sq[0 if cut else 1] += float(torch.dot(flat, flat))
        t = torch.tensor(sq, dtype=torch.float64, device=self.device)
        comm.all_reduce(t, group=self.group)
        if self.model_group is not None:
            cut = t[:1].clone()
            comm.all_reduce(cut, group=self.model_group)
            t[0] = cut[0]
        return float(t.sum()) ** 0.5

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
            for c in self.piece_sizes:
                master = cur[ooff:ooff + c]
                moments = [cur[ooff + (1 + k) * c:ooff + (2 + k) * c]
                           for k in range(len(self.state_keys))]
                self.opt.step(step, master, grads[poff:poff + c],
                              *moments, lr=lr)
                pbuf[poff:poff + c].copy_(master)
                ooff += c * self._n_fields
                poff += c
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

    def _whole_persist(self, pieces) -> List[torch.Tensor]:
        """Persistent leaves from every rank's pieces (host f32)."""
        return [p.clone() if d is None else
                all_gather_leaf(p.to(self.device), d, self.group).cpu()
                for p, d in zip(pieces, self.persist_dims)]

    def get_all_leaves(self):
        """(master leaves, {state key: leaves}), fp32 host copies, whole
        over the group, with the layers re-stacked: one sweep over the
        optimizer state (every rank takes part)."""
        stacked = [[torch.empty((self.L,) + s) for s in self.layer_shapes]
                   for _ in range(self._n_fields)]
        for i in range(self.L):
            rows = self._gather_host(self._read_optim(i))
            ooff = 0
            for j, (shape, n, c) in enumerate(zip(
                    self.layer_shapes, self.layer_sizes, self.piece_sizes)):
                for f in range(self._n_fields):
                    stacked[f][j][i] = self._whole(rows, ooff + f * c, c, n,
                                                   shape)
                ooff += c * self._n_fields
        master = self._assemble(self._whole_persist(self.persist_leaves),
                                stacked[0])
        state = {key: self._assemble(
            self._whole_persist([s[k_idx] for s in self.persist_state]),
            stacked[1 + k_idx])
            for k_idx, key in enumerate(self.state_keys)}
        return master, state

    def template_leaves(self):
        """Shape templates (``meta`` tensors, whole over the group) for
        checkpoint loading."""
        def meta():
            return self._assemble(
                [torch.empty(s, device="meta") for s in self.persist_shapes],
                [torch.empty((self.L,) + s, device="meta")
                 for s in self.layer_shapes])

        return meta(), {k: meta() for k in self.state_keys}

    def load_leaves(self, master: Sequence[torch.Tensor],
                    state: Optional[Dict[str, Sequence[torch.Tensor]]] = None):
        """Restore the master (and the moments, if given; ``None`` keeps
        them) from whole leaves into this rank's pieces in the files or
        RAM, and rebuild the param files and the device persistents from
        it."""
        by_name = dict(zip(self.names, master))
        s_by_name = ({k: dict(zip(self.names, v)) for k, v in state.items()}
                     if state is not None else None)
        for j, (name, d) in enumerate(zip(self.persist_names,
                                          self.persist_dims)):
            shape = self.persist_shapes[j]

            def piece(v):
                return self._cut(v.to("cpu", torch.float32).reshape(shape),
                                 d)

            self.persist_leaves[j].copy_(piece(by_name[name]))
            if s_by_name is not None:
                for k_idx, key in enumerate(self.state_keys):
                    self.persist_state[j][k_idx].copy_(
                        piece(s_by_name[key][name]))
        pbuf = self._pbuf
        for i in range(self.L):
            buf = self._read_optim(i) if state is None else \
                torch.zeros(self.layer_elems * self._n_fields)
            ooff = poff = 0
            for key, n, c in zip(self.layer_keys, self.layer_sizes,
                                 self.piece_sizes):
                def flat(v):
                    return v[i].to("cpu", torch.float32).reshape(-1)

                self._piece(flat(by_name["layers/" + key]),
                            buf[ooff:ooff + c])
                pbuf[poff:poff + c].copy_(buf[ooff:ooff + c])
                if s_by_name is not None:
                    for k_idx, skey in enumerate(self.state_keys):
                        self._piece(
                            flat(s_by_name[skey]["layers/" + key]),
                            buf[ooff + (1 + k_idx) * c:
                                ooff + (2 + k_idx) * c])
                ooff += c * self._n_fields
                poff += c
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
        return int(sum(torch.Size(s).numel() * itemsize
                       for s in self.persist_shapes))

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

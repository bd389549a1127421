"""ZeRO-Offload / ZeRO-Infinity host-side optimizer state management.

Port of ``deepspeed_tpu/runtime/zero/offload.py`` (``HostOffloadOptimizer``
:47, ``step`` :124, ``_step_nvme`` :152, the checkpoint surface
:186-254). The card only computes gradients; this module owns the fp32
master weights and the moments as flat host tensors, runs the native
OpenMP/SIMD update (``ops/cpu_optimizers.py``) and writes the updated
compute params back to the card:

* the gradients cross in the transfer dtype (bf16 when the compute dtype
  is bf16, else f32, as the JAX ``_build_offload_step`` ships them), one
  leaf segment at a time (:func:`..offload.leaf_segments`: stacked layer
  leaves cut between layers), through a ring of ``buffer_count`` host
  slots; so host memory holds the state plus the ring, never a whole
  gradient or parameter tree;
* on the card the device-to-host copies run on one side stream and the
  host-to-device copies of the updated params on another, so segment
  ``s + 1`` crosses while the host updates segment ``s`` (the ring slots
  are page-locked; the master and moments never cross the bus and stay
  pageable);
* under bf16 grads and a bf16 compute dtype ``ds_adam_update_bf16``
  writes the bf16 params in the same pass; otherwise the f32 update is
  followed by a cast.

With ``device="nvme"`` each leaf's state lives in one file (master |
moment0 | moment1 ...) under ``<nvme_path>/ds_tpu_swap/`` and streams
through two leaf buffers: leaf ``i + 1``'s read and leaf ``i - 1``'s
write-back overlap leaf ``i``'s update (``ops/aio.py``).
"""

import logging
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence

import torch

from ...ops.cpu_optimizers import build_host_optimizer
from ..offload import PinnedHost, copy_rows, leaf_segments

logger = logging.getLogger(__name__)


def _file_name(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name).strip("_") \
        or "leaf"


class HostOffloadOptimizer:
    """Owns flat fp32 master + moments on the host; steps via the native
    C++ kernels.

    ``master_leaves`` are the initial weights (any device and dtype: the
    master is their f32 value), ``compute_dtype`` the card's params,
    ``splittable`` the stacked layer leaves, ``segment_elems`` the most
    elements a cut segment holds, ``device`` the storage ("cpu" or
    "nvme") and ``transfer_device`` where the gradients and params live.
    """

    _instance_counter = 0

    def __init__(self, opt_name: str, opt_params, master_leaves,
                 leaf_names: Sequence[str], device: str = "cpu",
                 nvme_path: Optional[str] = None,
                 aio_block_size: int = 1 << 20, aio_threads: int = 8,
                 compute_dtype=torch.bfloat16, segment_elems: int = 1 << 26,
                 buffer_count: int = 4, splittable=None,
                 transfer_device=None):
        self.opt = build_host_optimizer(opt_name, opt_params)
        self.state_keys = self.opt.state_keys()
        self.device = device
        self.names = list(leaf_names)
        self.shapes = [tuple(m.shape) for m in master_leaves]
        self.sizes = [int(m.numel()) for m in master_leaves]
        self.out_dtype = compute_dtype
        self.transfer_dtype = (torch.bfloat16 if compute_dtype ==
                               torch.bfloat16 else torch.float32)
        self.xfer = torch.device("cpu" if transfer_device is None
                                 else transfer_device)
        self.cuda = self.xfer.type == "cuda"
        splittable = splittable or [False] * len(self.sizes)
        self.segments = leaf_segments(self.shapes, splittable, segment_elems)
        self.depth = max(1, int(buffer_count))
        seg_max = max(e - s for _, s, e in self.segments)
        # the ring: gradients in, compute params out (page-locked on the
        # card so the copies run asynchronously)
        self.pinned = PinnedHost(self.cuda)
        nslot = min(self.depth, len(self.segments))
        self._gslots = [self.pinned.empty(seg_max, self.transfer_dtype)
                        for _ in range(nslot)]
        self._oslots = [self.pinned.empty(seg_max, self.out_dtype)
                        for _ in range(nslot)]
        if self.cuda:
            self._d2h = torch.cuda.Stream(self.xfer)
            self._h2d = torch.cuda.Stream(self.xfer)
        self.timings: Dict[str, float] = {}
        self.swap_bytes = 0
        self.swap_seconds = 0.0

        n_fields = 1 + len(self.state_keys)
        if device == "cpu":
            self.master = []
            for m, n in zip(master_leaves, self.sizes):
                host = torch.empty(n)
                copy_rows(host.view(m.shape), m)
                self.master.append(host)
            self.state = [[torch.zeros(n) for _ in self.state_keys]
                          for n in self.sizes]
            self._aio = None
        elif device == "nvme":
            from ...ops.aio import AsyncIOHandle

            if not nvme_path:
                raise ValueError("offload_optimizer.nvme_path is required "
                                 "for device 'nvme'")
            HostOffloadOptimizer._instance_counter += 1
            self.swap_dir = os.path.join(
                nvme_path, "ds_tpu_swap",
                f"pid{os.getpid()}_{HostOffloadOptimizer._instance_counter}")
            os.makedirs(self.swap_dir, exist_ok=True)
            self._aio = AsyncIOHandle(aio_block_size, aio_threads)
            self._n_fields = n_fields
            # two leaf buffers (current / prefetch), sized to the largest
            # leaf; initial files: master followed by zero moments
            self._bufs = [torch.zeros(max(self.sizes) * n_fields)
                          for _ in range(2)]
            t0 = time.perf_counter()
            for i, m in enumerate(master_leaves):
                flat = self._view(self._bufs[0], i)
                flat.zero_()
                copy_rows(flat[:self.sizes[i]].view(m.shape), m)
                self._aio.sync_pwrite(self._file(i), flat)
                self.swap_bytes += flat.numel() * 4
            self.swap_seconds += time.perf_counter() - t0
            logger.info(
                f"ZeRO-Infinity: optimizer state on NVMe at {self.swap_dir} "
                f"({sum(self.sizes) * 4 * n_fields / 1e9:.2f} GB)")
        else:
            raise ValueError(f"unknown offload device '{device}'")

    def _file(self, i: int) -> str:
        return os.path.join(self.swap_dir,
                            f"{i:05d}_{_file_name(self.names[i])}.bin")

    def _view(self, buf: torch.Tensor, i: int) -> torch.Tensor:
        return buf[:self.sizes[i] * self._n_fields]

    # ------------------------------------------------------------------
    def _leaf_state(self, i: int, cur: Optional[torch.Tensor]):
        """(flat master, [flat moments]) of leaf ``i``: the resident
        tensors, or the parts of its loaded NVMe buffer."""
        if self.device == "cpu":
            return self.master[i], self.state[i]
        n = self.sizes[i]
        return cur[:n], [cur[(1 + k) * n:(2 + k) * n]
                         for k in range(len(self.state_keys))]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             params: Sequence[torch.Tensor], step: int,
             lr: Optional[float] = None) -> None:
        """One optimizer step: ``grads`` (f32 leaves on the card, or on the
        CPU) update the host state, and the updated params are written into
        ``params`` (compute dtype, same device) in place. ``step`` is
        1-based."""
        segs, K = self.segments, len(self._gslots)
        n = len(segs)
        main = torch.cuda.current_stream(self.xfer) if self.cuda else None
        shipped: List[Optional[torch.cuda.Event]] = [None] * n
        written: List[Optional[torch.cuda.Event]] = [None] * n
        d2h_ev, h2d_ev = [], []
        host_s = 0.0

        def ship(s):
            i, a, b = segs[s]
            g = grads[i].detach().view(-1)[a:b]
            slot = self._gslots[s % K][:b - a]
            if not self.cuda:
                slot.copy_(g)
                return
            tmp = g.to(self.transfer_dtype)
            cast = torch.cuda.Event()
            cast.record(main)
            with torch.cuda.stream(self._d2h):
                self._d2h.wait_event(cast)
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                slot.copy_(tmp, non_blocking=True)
                tmp.record_stream(self._d2h)
                done = torch.cuda.Event(enable_timing=True)
                done.record()
            d2h_ev.append((start, done))
            shipped[s] = done

        # NVMe: leaf buffers in turn, reads ahead and write-backs behind
        reads: Dict[int, int] = {}
        pending_write: Dict[int, int] = {}
        t_swap = 0.0
        if self.device == "nvme":
            reads[0] = self._aio.pread(self._file(0),
                                       self._view(self._bufs[0], 0))
        cur_leaf, cur = -1, None
        for s in range(min(K, n)):
            ship(s)
        for s in range(n):
            i, a, b = segs[s]
            if i != cur_leaf and self.device == "nvme":
                t0 = time.perf_counter()
                if cur_leaf >= 0:
                    pending_write[cur_leaf % 2] = self._aio.pwrite(
                        self._file(cur_leaf), cur)
                nxt = i + 1
                if nxt < len(self.sizes):
                    if nxt % 2 in pending_write:      # buffer reuse
                        self._aio.wait(pending_write.pop(nxt % 2))
                    reads[nxt] = self._aio.pread(
                        self._file(nxt), self._view(self._bufs[nxt % 2], nxt))
                self._aio.wait(reads.pop(i))
                t_swap += time.perf_counter() - t0
                cur = self._view(self._bufs[i % 2], i)
            cur_leaf = i
            master, moments = self._leaf_state(i, cur)
            if self.cuda:
                shipped[s].synchronize()
                if s >= K:
                    written[s - K].synchronize()    # out slot is free
            out = self._oslots[s % K][:b - a]
            t0 = time.perf_counter()
            self.opt.step(step, master[a:b], self._gslots[s % K][:b - a],
                          *[m[a:b] for m in moments], lr=lr,
                          params_out_bf16=out)
            host_s += time.perf_counter() - t0
            dst = params[i].detach().view(-1)[a:b]
            if self.cuda:
                with torch.cuda.stream(self._h2d):
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                    dst.copy_(out, non_blocking=True)
                    done = torch.cuda.Event(enable_timing=True)
                    done.record()
                h2d_ev.append((start, done))
                written[s] = done
            else:
                dst.copy_(out)
            if s + K < n:
                ship(s + K)
        if self.device == "nvme":
            t0 = time.perf_counter()
            pending_write[cur_leaf % 2] = self._aio.pwrite(
                self._file(cur_leaf), cur)
            self._aio.wait_all()
            t_swap += time.perf_counter() - t0
            self.swap_seconds += t_swap
            self.swap_bytes += 2 * sum(self.sizes) * 4 * self._n_fields
        self.timings = {"host_opt_ms": host_s * 1e3, "swap_wait_ms":
                        t_swap * 1e3}
        if self.cuda:
            main.wait_stream(self._h2d)     # the next forward sees them
            self._h2d.synchronize()
            self.timings["d2h_ms"] = sum(a.elapsed_time(z)
                                         for a, z in d2h_ev)
            self.timings["h2d_ms"] = sum(a.elapsed_time(z)
                                         for a, z in h2d_ev)

    # ------------------------------------------------------------------
    # Checkpoint interop: the full fp32 state as leaf lists
    # ------------------------------------------------------------------
    def get_all_leaves(self):
        """(master leaves, {state key: leaves}) in one sweep over storage:
        views of the host tensors, or copies read from NVMe."""
        if self.device == "cpu":
            master = [m.view(s) for m, s in zip(self.master, self.shapes)]
            state = {k: [st[j].view(s)
                         for st, s in zip(self.state, self.shapes)]
                     for j, k in enumerate(self.state_keys)}
            return master, state
        master: List[torch.Tensor] = []
        state: Dict[str, List[torch.Tensor]] = {k: [] for k in
                                                self.state_keys}
        for i, shape in enumerate(self.shapes):
            flat = torch.empty(self.sizes[i] * self._n_fields)
            self._aio.sync_pread(self._file(i), flat)
            m, moments = self._leaf_state(i, flat)
            master.append(m.view(shape))
            for k, t in zip(self.state_keys, moments):
                state[k].append(t.view(shape))
        return master, state

    def template_leaves(self):
        """Shape / dtype templates (``meta`` tensors: no IO, no memory)
        for checkpoint loading."""
        master = [torch.empty(s, device="meta") for s in self.shapes]
        state = {k: [torch.empty(s, device="meta") for s in self.shapes]
                 for k in self.state_keys}
        return master, state

    def load_leaves(self, master: Sequence[torch.Tensor],
                    state: Optional[Dict[str, Sequence[torch.Tensor]]] = None):
        """Restore master (and, if given, moments) from checkpoint leaves;
        ``state=None`` keeps the existing moments
        (``load_optimizer_states=False``, reference engine.py:2653)."""
        for i, shape in enumerate(self.shapes):
            if self.device == "cpu":
                flat = None
            else:
                flat = torch.empty(self.sizes[i] * self._n_fields)
                if state is None:   # keep the current moments
                    self._aio.sync_pread(self._file(i), flat)
            m, moments = self._leaf_state(i, flat)
            copy_rows(m.view(shape), master[i])
            if state is not None:
                for k, t in zip(self.state_keys, moments):
                    copy_rows(t.view(shape), state[k][i])
            if flat is not None:
                self._aio.sync_pwrite(self._file(i), flat)

    def close(self):
        if self.cuda:       # no copy may touch a page once unregistered
            torch.cuda.synchronize(self.xfer)
        if self._aio is not None:
            self._aio.close()
            self._aio = None
            shutil.rmtree(self.swap_dir, ignore_errors=True)
        self.opt.destroy()
        self._gslots, self._oslots = [], []
        self.master, self.state = [], []
        self.pinned.close()

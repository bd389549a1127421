"""Tiered host-offloaded optimizer state with bucket-streamed prefetch.

Port of ``deepspeed_tpu/runtime/offload.py`` (``plan_prefetch_buckets``
:83, ``TieredOptimizerOffload`` :106, ``prefetch`` :278,
``stream_update`` :291). The fp32 master weights and the optimizer moments
live in host memory, page-locked when the engine runs on the card
(:class:`PinnedHost`); the update itself stays on the card, with the same
``apply_update_with_skip`` math as the resident step, bucket by bucket:

* a bucket is a run of consecutive leaf segments of at most
  ``zero_optimization.stage3_prefetch_bucket_size`` elements. Under an
  element-wise optimizer (Adam / AdamW / Lion / Adagrad / SGD) a stacked
  ``[L, ...]`` layer leaf larger than that is cut between layers
  (:func:`leaf_segments`): at full Mistral-7B depth one ``w_gate`` is
  1.88 B elements, 22.5 GB of f32 state, more than a few buckets in flight
  may take of the card. LAMB (a trust ratio per leaf) keeps whole leaves;
* ``buffer_count`` bucket fetches are in flight on a side stream; the
  engine issues the first ones before the forward (:meth:`prefetch`), so
  their host-to-device copies run under the backward;
* bucket ``b``'s update waits on its fetch's event, writes the updated
  compute params in place, and its write-back is a device-to-host copy on
  a second side stream, fenced by an event after the update; the buffer
  is released to the allocator only after both streams are done with it.

Every element is computed by the same kernels as in the resident step, so
tiered training is bit-identical to resident training (pinned by
``tests/test_torch_offload.py``, the layer split included).

Overlap is measured, not assumed (attributes here; the JAX package also
publishes them as registry families, ``optimizer_offload_bytes``,
``offload_prefetch_*`` and ``offload_*_bytes_total``, which this module
does not register): ``prefetch_hit_fraction`` counts fetches
already issued when their bucket needed them, and
``prefetch_exposed_fraction`` is the share of the streamed update the
card's stream spent waiting on a fetch (CUDA events around each wait);
``offload_bytes`` is the state held off the card, ``h2d_bytes`` /
``d2h_bytes`` what the update moved, ``timings`` the last step's split.
"""

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)

Segment = Tuple[int, int, int]      # (leaf, first element, end element)


class PinnedHost:
    """Host tensors page-locked with ``cudaHostRegister`` (exact sizes, no
    allocator rounding) when ``enabled``; plain host tensors otherwise.
    :meth:`close` unregisters them; the object holds each tensor until
    then, so no registered page is freed while registered. A failed
    registration raises."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._held: List[torch.Tensor] = []
        self.bytes = 0

    def pin(self, t: torch.Tensor) -> torch.Tensor:
        """Page-lock ``t`` (already filled: registering touched pages is
        cheaper than faulting them in) and hold it until :meth:`close`."""
        if self.enabled and t.numel():
            nbytes = t.numel() * t.element_size()
            err = torch.cuda.cudart().cudaHostRegister(t.data_ptr(), nbytes,
                                                       0)
            if int(err) != 0:
                raise RuntimeError(
                    f"cudaHostRegister of {nbytes} host bytes failed "
                    f"({err}); {self.bytes} bytes were pinned before it")
            self._held.append(t)
            self.bytes += nbytes
        return t

    def empty(self, n: int, dtype=torch.float32) -> torch.Tensor:
        return self.pin(torch.empty(n, dtype=dtype))

    def zeros(self, n: int, dtype=torch.float32) -> torch.Tensor:
        return self.pin(torch.zeros(n, dtype=dtype))

    def close(self):
        cudart = torch.cuda.cudart() if self._held else None
        for t in self._held:
            cudart.cudaHostUnregister(t.data_ptr())
        self._held.clear()
        self.bytes = 0


def copy_rows(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` one leading-axis row at a time for a stacked
    leaf, so a cast across devices never stages a whole leaf."""
    src = src.detach().reshape(dst.shape)
    if dst.dim() >= 2 and dst.shape[0] > 1:
        for r in range(dst.shape[0]):
            dst[r].copy_(src[r])
    else:
        dst.copy_(src)


def plan_prefetch_buckets(numels: Sequence[int],
                          bucket_elems: int) -> List[List[int]]:
    """Group indices into prefetch buckets: consecutive entries packed
    until the bucket would exceed ``bucket_elems``; one larger than the
    cap forms its own bucket (JAX ``plan_prefetch_buckets``)."""
    if bucket_elems <= 0:
        raise ValueError(f"bucket_elems must be > 0, got {bucket_elems}")
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_elems = 0
    for i, n in enumerate(numels):
        if cur and cur_elems + n > bucket_elems:
            buckets.append(cur)
            cur, cur_elems = [], 0
        cur.append(i)
        cur_elems += n
    if cur:
        buckets.append(cur)
    return buckets


def leaf_segments(shapes: Sequence[Tuple[int, ...]],
                  splittable: Sequence[bool],
                  max_elems: int) -> List[Segment]:
    """Flat element ranges ``(leaf, start, end)`` over the leaves, in leaf
    order. A splittable leaf larger than ``max_elems`` is cut between rows
    of its leading (layer) axis into runs of whole rows, each at most
    ``max_elems`` elements or one row; every other leaf is one segment."""
    segs: List[Segment] = []
    for i, (shape, split) in enumerate(zip(shapes, splittable)):
        n = 1
        for d in shape:
            n *= d
        if not (split and len(shape) >= 2 and n > max_elems):
            segs.append((i, 0, n))
            continue
        row = n // shape[0]
        per = max(1, max_elems // row) * row
        segs.extend((i, a, min(a + per, n)) for a in range(0, n, per))
    return segs


class TieredOptimizerOffload:
    """Host tier for optimizer state; device tier for the update.

    ``optimizer`` is the registry instance the resident step applies;
    ``master_leaves`` are the initial weights (any device and dtype: the
    master is their f32 value); ``splittable`` marks the stacked layer
    leaves. Exposes the checkpoint surface of
    ``runtime/zero/offload.HostOffloadOptimizer``: ``state_keys``,
    ``get_all_leaves``, ``template_leaves``, ``load_leaves``, ``close``.
    """

    def __init__(self, optimizer, master_leaves: Sequence[torch.Tensor],
                 bucket_elems: int, buffer_count: int = 4, device=None,
                 splittable: Optional[Sequence[bool]] = None):
        from .engine import apply_update_with_skip

        self._apply = apply_update_with_skip
        self.opt = optimizer
        self.shapes = [tuple(m.shape) for m in master_leaves]
        self.sizes = [int(m.numel()) for m in master_leaves]
        self.depth = max(1, int(buffer_count))
        self.device = torch.device("cpu" if device is None else device)
        self.cuda = self.device.type == "cuda"
        if splittable is None or not getattr(optimizer, "elementwise", False):
            splittable = [False] * len(self.sizes)
        segs = leaf_segments(self.shapes, splittable, bucket_elems)
        self.buckets: List[List[Segment]] = [
            [segs[j] for j in b] for b in
            plan_prefetch_buckets([e - s for _, s, e in segs], bucket_elems)]
        self.state_keys = sorted(optimizer.init_state(
            [torch.zeros(1)]).keys())

        self.pinned = PinnedHost(self.cuda)
        self.master = []
        for m, n in zip(master_leaves, self.sizes):
            host = torch.empty(n)
            copy_rows(host.view(m.shape), m)
            self.master.append(self.pinned.pin(host))
        self.state = {k: [self.pinned.zeros(n) for n in self.sizes]
                      for k in self.state_keys}

        if self.cuda:
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        self._inflight: Dict[int, tuple] = {}
        self._fetch_hits = 0
        self._fetch_total = 0
        self._wait_ms = 0.0
        self._stream_ms = 0.0
        self.offload_bytes = sum(self.sizes) * 4 * (1 + len(self.state_keys))
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.timings: Dict[str, float] = {}
        logger.info(
            f"tiered optimizer offload: {len(self.buckets)} buckets over "
            f"{len(self.sizes)} leaves ({self.offload_bytes / 1e6:.1f} MB "
            f"host state, prefetch depth {self.depth}, pinned "
            f"{self.pinned.enabled})")

    @property
    def prefetch_hit_fraction(self) -> float:
        return self._fetch_hits / max(1, self._fetch_total)

    @property
    def prefetch_exposed_fraction(self) -> float:
        return min(1.0, self._wait_ms / self._stream_ms) \
            if self._stream_ms > 0 else 0.0

    def _fields(self):
        return [self.master] + [self.state[k] for k in self.state_keys]

    def _event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    # -- streaming update ----------------------------------------------
    def _issue_fetch(self, b: int) -> None:
        if b in self._inflight or b >= len(self.buckets):
            return
        segs = self.buckets[b]
        n = sum(e - s for _, s, e in segs)
        fields = self._fields()

        def copy_in(buf, non_blocking):
            off = 0
            for field in fields:
                for i, s, e in segs:
                    buf[off:off + e - s].copy_(field[i][s:e],
                                               non_blocking=non_blocking)
                    off += e - s

        if self.cuda:
            with torch.cuda.stream(self._h2d):
                buf = torch.empty(len(fields) * n, device=self.device)
                start = self._event()
                copy_in(buf, True)
                self._inflight[b] = (buf, start, self._event())
        else:
            buf = torch.empty(len(fields) * n)
            copy_in(buf, False)
            self._inflight[b] = (buf, None, None)
        self.h2d_bytes += len(fields) * n * 4

    def prefetch(self) -> None:
        """Issue the first ``buffer_count`` buckets' fetches; the engine
        calls this before the forward, so they run under the backward."""
        for b in range(min(self.depth, len(self.buckets))):
            self._issue_fetch(b)

    @torch.no_grad()
    def stream_update(self, grads: Sequence[torch.Tensor],
                      params: Sequence[torch.Tensor], step: int,
                      lr: float, norm_reduce=None) -> None:
        """One optimizer step, bucket by bucket: ``grads`` (f32, on the
        device, in leaf order) update the host state and the compute
        ``params`` in place. ``step`` is the count of applied steps before
        this one (the resident step's ``_step``). ``norm_reduce(i, t)``
        (LAMB over leaves cut over ranks, the resident step's) sums leaf
        ``i``'s partial squares over the ranks holding its pieces; the
        buckets hold whole leaves then, so each trust ratio is the whole
        leaf's (JAX :89-97)."""
        if len(grads) != len(self.sizes):
            raise ValueError(f"{len(grads)} grads vs {len(self.sizes)} "
                             f"leaves")
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device) if self.cuda else None
        first = self._event(main) if self.cuda else None
        waits, copies_out = [], []
        fields = self._fields()
        for b, segs in enumerate(self.buckets):
            self._fetch_total += 1
            if b in self._inflight:
                self._fetch_hits += 1
            else:
                self._issue_fetch(b)
            buf, fstart, fdone = self._inflight.pop(b)
            if self.cuda:
                w0 = self._event(main)
                main.wait_event(fdone)
                waits.append((w0, self._event(main), fstart, fdone))
                buf.record_stream(main)
            n = sum(e - s for _, s, e in segs)
            views, off = [], 0
            for _ in fields:
                field_views = []
                for _, s, e in segs:
                    field_views.append(buf[off:off + e - s])
                    off += e - s
                views.append(field_views)
            g = [grads[i].view(-1)[s:e] for i, s, e in segs]
            states = dict(zip(self.state_keys, views[1:]))
            kw = {} if norm_reduce is None else {
                "norm_reduce": lambda j, t, segs=segs: norm_reduce(
                    segs[j][0], t)}
            self._apply(self.opt, views[0], g, states, step, lr, True, **kw)
            for (i, s, e), m in zip(segs, views[0]):
                params[i].detach().view(-1)[s:e].copy_(m)
            self._issue_fetch(b + self.depth)
            if self.cuda:
                updated = self._event(main)
                with torch.cuda.stream(self._d2h):
                    self._d2h.wait_event(updated)
                    w_start = self._event()
                    for field, fv in zip(fields, views):
                        for (i, s, e), v in zip(segs, fv):
                            field[i][s:e].copy_(v, non_blocking=True)
                    copies_out.append((w_start, self._event()))
                buf.record_stream(self._d2h)
            else:
                for field, fv in zip(fields, views):
                    for (i, s, e), v in zip(segs, fv):
                        field[i][s:e].copy_(v)
            self.d2h_bytes += len(fields) * n * 4
        if self.cuda:
            self._d2h.synchronize()     # host state whole before returning
            last = self._event(main)
            last.synchronize()
            wait = sum(a.elapsed_time(z) for a, z, _, _ in waits)
            span = first.elapsed_time(last)
            self.timings = {
                "stream_ms": span, "wait_ms": wait,
                "h2d_ms": sum(s.elapsed_time(e) for _, _, s, e in waits),
                "d2h_ms": sum(s.elapsed_time(e) for s, e in copies_out)}
        else:
            span = (time.perf_counter() - t0) * 1e3
            wait = 0.0
            self.timings = {"stream_ms": span, "wait_ms": 0.0}
        self._wait_ms += wait
        self._stream_ms += span

    # -- checkpoint surface (HostOffloadOptimizer-compatible) -----------
    def get_all_leaves(self):
        """(master leaves, {state key: leaves}): shaped views of the host
        storage."""
        master = [m.view(s) for m, s in zip(self.master, self.shapes)]
        state = {k: [t.view(s) for t, s in zip(self.state[k], self.shapes)]
                 for k in self.state_keys}
        return master, state

    def template_leaves(self):
        """Shape / dtype templates (``meta`` tensors) for checkpoint
        loading."""
        master = [torch.empty(s, device="meta") for s in self.shapes]
        state = {k: [torch.empty(s, device="meta") for s in self.shapes]
                 for k in self.state_keys}
        return master, state

    def load_leaves(self, master: Sequence[torch.Tensor],
                    state: Optional[Dict[str, Sequence[torch.Tensor]]] = None):
        """Restore the master (and, if given, the moments; ``None`` keeps
        them, ``load_optimizer_states=False``)."""
        self._inflight.clear()     # a stale prefetch would resurrect the
        for i, m in enumerate(master):          # pre-restore state
            copy_rows(self.master[i].view(self.shapes[i]), m)
            if state is not None:
                for k in self.state_keys:
                    copy_rows(self.state[k][i].view(self.shapes[i]),
                              state[k][i])

    def close(self):
        if self.cuda:       # no copy may touch a page once unregistered
            torch.cuda.synchronize(self.device)
        self._inflight.clear()
        self.master, self.state = [], {}
        self.pinned.close()


class _Fetch(torch.autograd.Function):
    """A layer leaf fetched from host memory, as seen by autograd: its
    gradient goes, unchanged and on the device, to ``anchor`` (a stride-0
    device tensor of the leaf's shape that holds no memory), since autograd
    refuses a device gradient for a host tensor."""

    @staticmethod
    def forward(ctx, anchor, fetched):
        return fetched

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class HostLayerStream:
    """The stacked ``[L, ...]`` layer leaves of ``offload_param {device:
    cpu}``: stored in host memory (page-locked on the card) and brought to
    the device one layer at a time by the model's layer loop (``fetch``,
    inside the layer's activation checkpoint), the port of JAX's
    ``stream_params_from_host`` (``models/transformer.py:729``), where
    XLA's host offloader does the double buffering.

    Here a fetch of layer ``l`` issues the host-to-device copy of the next
    layer the loop will ask for on a side stream: ``l + 1`` in the
    forward, ``l - 1`` in the backward's recompute (after the last layer's
    forward, that layer again for the first recompute). The model's layer
    loop says which pass a fetch belongs to (:meth:`forward_sweep` around
    the loop; a fetch outside it is the recompute). The consumer's stream
    waits on the copy's event. Gradients reach the engine through ``anchors`` (one per leaf,
    cut into layers by :meth:`begin`), so they stay on the device and are
    reduced exactly as the resident leaves' are.

    ``h2d_bytes`` counts the bytes copied; on the card, :meth:`timings`
    sums the copies' time on the side stream and the time the compute
    stream waited for them (the exposed share)."""

    def __init__(self, host: Dict[str, torch.Tensor], device):
        self.host = host
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.L = next(iter(host.values())).shape[0]
        self.anchors = {
            k: torch.zeros((), dtype=v.dtype, device=self.device)
            .expand(v.shape).detach().requires_grad_()
            for k, v in host.items()}
        self._side = torch.cuda.Stream(self.device) if self.cuda else None
        self._views: Dict[str, Tuple[torch.Tensor, ...]] = {}
        self._ready: Dict[int, tuple] = {}
        self._forward = False
        self._events: List[tuple] = []
        self.h2d_bytes = 0

    def begin(self) -> Dict[str, Tuple[torch.Tensor, ...]]:
        """Start a forward: returns the anchors' per-layer views (where
        the engine may hook each layer's gradient)."""
        for _, ev, _ in self._ready.values():
            if ev is not None:
                ev.synchronize()
        self._ready.clear()
        self._views = {k: torch.unbind(a) for k, a in self.anchors.items()}
        return self._views

    def forward_sweep(self, active: bool) -> None:
        """Called by the model's layer loop: ``True`` before its first
        layer, ``False`` after its last. Fetches in between are the
        forward's; later ones, the backward's recompute."""
        self._forward = active

    def _issue(self, l: int) -> None:
        if l in self._ready or not 0 <= l < self.L:
            return
        if not self.cuda:
            self._ready[l] = ({k: v[l].clone() for k, v in
                               self.host.items()}, None, None)
        else:
            with torch.cuda.stream(self._side):
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                dev = {k: v[l].to(self.device, non_blocking=True)
                       for k, v in self.host.items()}
                done = torch.cuda.Event(enable_timing=True)
                done.record()
            self._ready[l] = (dev, done, start)
        self.h2d_bytes += sum(v[l].numel() * v.element_size()
                              for v in self.host.values())

    def fetch(self, l: int) -> Dict[str, torch.Tensor]:
        """Layer ``l``'s leaves on the device, tied to the anchors."""
        self._issue(l)
        dev, done, start = self._ready.pop(l)
        if done is not None:
            main = torch.cuda.current_stream(self.device)
            w0 = torch.cuda.Event(enable_timing=True)
            w0.record(main)
            main.wait_event(done)
            w1 = torch.cuda.Event(enable_timing=True)
            w1.record(main)
            self._events.append((start, done, w0, w1))
            for t in dev.values():
                t.record_stream(main)
        if self._forward:       # up the stack, then the top layer again
            nxt = l + 1 if l + 1 < self.L else (
                l if torch.is_grad_enabled() else -1)
        else:                   # the backward's recompute walks down
            nxt = l - 1
        self._issue(nxt)
        return {k: _Fetch.apply(self._views[k][l], v)
                for k, v in dev.items()}

    def timings(self) -> Dict[str, float]:
        """Copies' ms on the side stream and the ms the compute stream
        waited on them, since the last call (waits for the events)."""
        ev, self._events = self._events, []
        if not ev:
            return {"h2d_ms": 0.0, "wait_ms": 0.0}
        ev[-1][3].synchronize()
        return {"h2d_ms": sum(s.elapsed_time(d) for s, d, _, _ in ev),
                "wait_ms": sum(a.elapsed_time(b) for _, _, a, b in ev)}

"""Continuous-batching background runner over the SplitFuse scheduler.

One dedicated thread owns the scheduler (and through it the engine —
neither is thread-safe): it applies queued commands (request
registration, cancellation, drain), expires deadlines, admits pending
requests from the :class:`AdmissionController` into the scheduler, and
runs composed engine steps. New requests join IN-FLIGHT batches between
steps — FastGen's continuous batching — rather than waiting for the
current batch to finish.

All cross-thread traffic goes one way: the asyncio side posts callables
onto the command deque and wakes the loop; the loop pushes tokens back
through each entry's (thread-safe) callbacks. Every scheduler/engine
touch happens on the loop thread.

Port note: a copy of ``deepspeed_tpu/inference/v2/serve/loop.py``. The
loop thread selects the engine's CUDA device before its first step (a
thread starts on device 0). The engine's ``put()`` returns host logits and
a decode window one host token block, so each step synchronizes once;
nothing else on this thread reads the device (the telemetry hooks read
host counters). The fleet's state is JAX's: the chunked KV restores in
flight (``begin_restore`` / ``apply_restore`` / ``commit_restore``, each
chunk applied between scheduler steps), whole handoffs (``resume``), the
weight updates staging (``weight_staging``), and their metric families
(``handoff_chunk_*``, ``weight_update_overlap_steps_total``), and the
online adapter (``autotuning/online.py``), ticked right after the SLO
monitor. The drain closes the engine's KV spill tier
(``ragged/spill.py``), as in JAX.

Over an SPMD engine (tensor or expert parallel: ``engine.topology`` set)
the runtime runs on the engine group's rank 0 (the leader): its loop
drives a :class:`LeaderEngine`, which broadcasts each engine call that
changes what a rank holds (``MIRRORED``: the step's uids, token ids and
finished sequences) over the group before making it, and every other
rank runs :class:`FollowerLoop`, which makes the same calls in the same
order. The leader samples on the host; the followers never read a token.
After each mirrored call the group agrees, in one small all-reduce,
whether the call raised everywhere or nowhere: a call that raised on
some ranks only (an out-of-memory, say) leaves their KV state out of
step, so the followers log it and end, and the leader's loop fails every
request and ends (:class:`GroupDiverged`). A failure between the
collectives of one call cannot reach that agreement; the process
group's timeout ends it. An engine call that is neither mirrored nor
known to run no collective (``LOCAL``) raises on the leader rather than
leave the followers behind. When the leader's loop exits (drain or stop)
it sends a final message, and the followers' loops end: a follower never
waits on a step the leader will not take. The JAX package is one
controller over all devices, so this layer has no JAX counterpart. A KV
handoff into an SPMD engine is refused (``NotImplementedError``, ROADMAP
A15): each rank's pool holds its own heads, and the restore would have to
be mirrored.
"""

import asyncio
import heapq
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

# the engine calls that change what a rank of an SPMD engine holds (its KV
# pool and sequences, its dispatch): mirrored on every rank in order
MIRRORED = ("put", "flush", "_decode_batch_greedy", "_decode_window_greedy",
            "set_ragged_mode", "set_decode_window")
# the engine calls the runtime makes on the leader alone: they read host
# state and run no collective
LOCAL = ("can_schedule", "_window_steps_left", "bind_trace",
         "warmed_decode_windows")


def select_device(device) -> None:
    """Make ``device`` the calling thread's CUDA device (a thread starts on
    device 0). A device without an index (``torch.device("cuda")``, what
    an engine built with ``device=None`` holds) means the current one."""
    if device is not None and device.type == "cuda" \
            and device.index is not None:
        import torch
        torch.cuda.set_device(device)


class GroupDiverged(RuntimeError):
    """A mirrored engine call raised on some ranks of the group and not on
    others: their engine states no longer match."""


class ModelGroup:
    """The ranks of one SPMD engine (its model and expert axes) and the
    channel its leader (group rank 0) sends each mirrored call on: one
    pickled ``(name, args, kwargs)`` object broadcast a call, None at the
    end."""

    def __init__(self, engine):
        import torch.distributed as dist

        from ....comm import comm

        topo = engine.topology
        axes = ("expert", "model")
        self.group = topo.group(axes)
        self.size = topo.group_size(axes)
        self.rank = topo.group_rank(axes)
        self.src = (dist.get_global_rank(self.group, 0)
                    if self.group is not None else 0)
        # an object broadcast over NCCL stages through the device
        self.device = (engine.device if comm.get_backend(self.group)
                       == "nccl" else None)

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def send(self, msg) -> None:
        import torch.distributed as dist
        dist.broadcast_object_list([msg], src=self.src, group=self.group,
                                   device=self.device)

    def recv(self):
        import torch.distributed as dist
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group,
                                   device=self.device)
        return box[0]

    def agree(self, raised: bool) -> bool:
        """Whether every rank's last mirrored call raised, or none did."""
        import torch
        import torch.distributed as dist
        flag = torch.tensor([int(raised), -int(raised)],
                            device=self.device or "cpu")
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        any_raised, none_clean = flag.tolist()
        return any_raised == -none_clean


class LeaderEngine:
    """The leader's view of an SPMD engine: every ``MIRRORED`` call is
    broadcast to the followers, made here, and agreed on (it raised on
    every rank or on none, else :class:`GroupDiverged`, then and on every
    later call); a ``LOCAL`` call or an attribute that is no call is the
    engine's own, and any other call raises. :meth:`release_followers`
    sends the final message (once)."""

    def __init__(self, engine, group: ModelGroup):
        self._engine = engine
        self._group = group
        self._released = False
        self._diverged: Optional[GroupDiverged] = None

    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if name in LOCAL or not callable(attr):
            return attr
        if name not in MIRRORED:
            raise TypeError(
                f"engine call {name!r} is neither mirrored on the engine "
                f"group's followers nor known to run no collective "
                f"(serve/loop.py MIRRORED, LOCAL)")

        def mirrored(*args, **kwargs):
            if self._diverged is not None:
                raise self._diverged
            self._group.send((name, args, kwargs))
            err = None
            try:
                out = attr(*args, **kwargs)
            except Exception as e:
                err = e
            if not self._group.agree(err is not None):
                # the followers have left their loop: nothing more to send
                self._released = True
                self._diverged = GroupDiverged(
                    f"engine call {name!r} raised on some ranks of the "
                    f"engine group and not on others"
                    + (f" (here: {type(err).__name__}: {err})" if err
                       else " (not here)"))
                raise self._diverged from err
            if err is not None:
                raise err
            return out

        return mirrored

    def release_followers(self) -> None:
        if not self._released:
            self._released = True
            self._group.send(None)


class FollowerLoop:
    """A follower rank's runtime: a thread that makes the leader's
    mirrored engine calls in the leader's order, until its final message
    (then it closes the engine's spill tier, as the leader's drain does).
    A call that raises is logged; if it raised on every rank (a request
    the engine refuses) the loop goes on, as the leader's does, else it
    ends, with the :class:`GroupDiverged` in :attr:`error`."""

    def __init__(self, engine, group: ModelGroup):
        self.engine = engine
        self.group = group
        self.calls = 0
        self.error: Optional[GroupDiverged] = None
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        select_device(getattr(self.engine, "device", None))
        while True:
            msg = self.group.recv()
            if msg is None:
                break
            name, args, kwargs = msg
            self.calls += 1
            err = None
            try:
                getattr(self.engine, name)(*args, **kwargs)
            except Exception as e:
                err = e
                logger.warning("serving follower (engine group rank %d): "
                               "engine call %r raised %s: %s", self.group.rank,
                               name, type(e).__name__, e)
            if not self.group.agree(err is not None):
                self.error = GroupDiverged(
                    f"engine call {name!r} raised on some ranks of the "
                    f"engine group and not on others")
                logger.error("serving follower (engine group rank %d): %s; "
                             "the follower loop ends", self.group.rank,
                             self.error)
                break
        spill = getattr(self.engine, "spill", None)
        if spill is not None:
            spill.close()

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="ds-tpu-serving-follower",
                                            daemon=True)
            self._thread.start()

    def request_drain(self) -> None:
        """The leader's final message ends the loop."""

    request_stop = request_drain

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


class ServingLoop:
    """Drains ``scheduler`` continuously; admits from ``admission``.

    Entries are the frontend's request records (duck-typed): they carry
    the scheduler submit() parameters plus ``deadline_t`` (absolute clock
    time or None), ``state`` ('pending' | 'inflight' | 'done'), and the
    thread-safe callbacks ``on_token(token, finished)`` and
    ``on_end(status, reason)``."""

    def __init__(self, scheduler, admission, *,
                 max_inflight: Optional[int] = None,
                 idle_wait_s: float = 0.002, clock=time.perf_counter,
                 bridge=None, diagnostics=None,
                 lane: Optional[str] = None, adapter=None):
        self.scheduler = scheduler
        self.admission = admission
        # fleet lane name (telemetry/trace.py set_lane): the loop thread
        # names its spans' lane once at start, so N in-process replica
        # loops sharing one trace ring stay distinguishable and the
        # stitched fleet timeline gives each its own process row
        self.lane = lane
        # optional TelemetryBridge: final-flushed (close()) when the loop
        # exits, so a drain's last partial flush interval isn't dropped
        self.bridge = bridge
        # optional ServingDiagnostics (frontend.py): the loop beats the
        # stall watchdog around every scheduler step, ticks the SLO
        # burn-rate monitor at ~1 Hz, and runs the KV-leak check when it
        # drains — the loop thread is the only place that sees all three
        # moments
        self.diagnostics = diagnostics
        # optional SLO-driven online adapter (autotuning/online.py):
        # ticked right after the SLO monitor so it reads a fresh burn
        # verdict, on this thread (the only one that touches the engine)
        self.adapter = adapter
        self._last_slo_tick = 0.0
        sm = scheduler.engine.state_manager.config
        # cap on requests inside the scheduler at once; the admission
        # queue (bounded) holds the rest
        self.max_inflight = max_inflight or sm.max_tracked_sequences
        self.idle_wait_s = idle_wait_s
        self.clock = clock
        self._cmds: deque = deque()      # callables run on the loop thread
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._draining = False
        # set just before the loop's FINAL command drain: commands
        # posted after it may never run (run_on_loop fails fast on it)
        self._cmds_closed = False
        self._entries: Dict[int, object] = {}   # uid -> entry (not done)
        self._deadlines: List = []              # heap of (deadline_t, uid)
        self._just_finished: List = []          # entries finished in step()
        self._dead: List[int] = []              # uids whose on_token raised
        # chunked streaming KV handoffs in flight (handoff.ChunkedRestore,
        # keyed by destination uid): each chunk applies between scheduler
        # steps, so the transfer overlaps the running batch; drain waits
        # for them and a hard stop aborts them
        self._restores: Dict[int, object] = {}
        # scheduler steps completed since start: the overlap evidence
        self.steps_done = 0
        # weight updates currently STAGING host-side (frontend.py
        # WeightUpdate): staging never blocks the loop, and steps taken
        # while >= 1 update stages are the publish / decode overlap
        self.weight_staging = 0
        from ....telemetry import get_registry
        reg = get_registry()
        self._m_expired = reg.counter(
            "serving_deadline_expired_total",
            "requests cancelled because their deadline passed")
        self._m_chunks = reg.counter(
            "handoff_chunks_total",
            "chunked-handoff KV chunks applied to this runtime's pool")
        self._m_chunk_bytes = reg.counter(
            "handoff_chunk_bytes_total",
            "serialized chunked-handoff bytes applied")
        self._m_chunk_apply = reg.histogram(
            "handoff_chunk_apply_seconds",
            "per-chunk integrity check + scatter time on the loop "
            "thread", unit="s",
            buckets=(1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0))
        self._m_chunk_aborts = reg.counter(
            "handoff_chunk_aborts_total",
            "chunked handoffs aborted mid-transfer (client hangup, "
            "integrity failure, drain)")
        self._m_chunk_inflight = reg.gauge(
            "handoff_chunk_inflight",
            "chunked handoffs currently streaming into this runtime")
        self._m_overlap_steps = reg.counter(
            "handoff_chunk_overlap_steps_total",
            "scheduler steps completed while >=1 chunked handoff was "
            "in flight (the transfer/compute overlap the protocol "
            "buys)")
        self._m_weight_overlap_steps = reg.counter(
            "weight_update_overlap_steps_total",
            "scheduler steps completed while >=1 weight update was "
            "staging (publication overlaps decode; only the final "
            "atomic swap lands between steps)")

    # -- cross-thread surface (any thread) ------------------------------
    def post(self, fn: Callable[[], None]) -> None:
        self._cmds.append(fn)
        self.wake()

    def wake(self) -> None:
        self._wake.set()

    def register(self, entry) -> None:
        """Track an admitted entry (deadline enforcement starts here)."""
        self.post(lambda: self._register(entry))

    def request_cancel(self, uid: int, status: str = "cancelled") -> None:
        self.post(lambda: self._cancel(uid, status))

    def resume(self, entry, pack, *, generated, rng_state=None) -> None:
        """Adopt a handed-off request (serve/handoff.py): restore the KV
        pack into the engine and insert the entry directly into the
        scheduler's running set, both on the loop thread."""
        self.post(lambda: self._resume(entry, pack, generated, rng_state))

    def run_on_loop(self, fn: Callable[[], object]) -> "asyncio.Future":
        """Run ``fn`` on the loop thread and resolve an asyncio future
        with its result (or exception): the chunked-handoff surface's ack
        channel. Must be called from a running event loop."""
        aio = asyncio.get_running_loop()
        fut: asyncio.Future = aio.create_future()

        def done(result, exc) -> None:
            if fut.done():
                return
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)

        def wrapped() -> None:
            try:
                result = fn()
            except BaseException as e:   # noqa: BLE001 — forwarded
                result, exc = None, e
            else:
                exc = None
            try:
                aio.call_soon_threadsafe(done, result, exc)
            except RuntimeError:
                # the client's event loop is gone (closed between post
                # and execution): drop the ack, it must not kill the
                # serving-loop thread mid-drain
                pass

        self.post(wrapped)
        if self._cmds_closed or not self.running:
            # a dead (or exiting: _cmds_closed set before the final drain)
            # loop never processes this command: fail fast instead of
            # awaiting forever (wrapped() may still run via the final
            # drain; done() is idempotent either way)
            done(None, RuntimeError("serving loop is not running"))
        return fut

    def request_drain(self) -> None:
        """Graceful drain: admission closes immediately (new submits get
        an explicit rejection); everything already admitted finishes,
        then the thread exits."""
        self.admission.close()
        self.post(self._mark_draining)

    def request_stop(self) -> None:
        """Hard stop: in-flight and pending requests are cancelled (KV
        released) and their streams ended, then the thread exits."""
        self.admission.close()

        def _halt():
            self._stop = True
        self.post(_halt)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run,
                                        name="ds-tpu-serving-loop",
                                        daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def draining(self) -> bool:
        return self._draining

    # -- loop thread ----------------------------------------------------
    def _mark_draining(self) -> None:
        self._draining = True

    def _register(self, entry) -> None:
        if entry.state == "done":
            # the entry was popped from admission and ran to completion
            # before this command arrived (register is posted after
            # try_admit); inserting it now would strand a permanently
            # done entry in _entries and wedge graceful drain
            return
        self._entries[entry.uid] = entry
        if entry.deadline_t is not None:
            heapq.heappush(self._deadlines, (entry.deadline_t, entry.uid))

    def _end(self, entry, status: str, reason: Optional[str] = None) -> None:
        entry.state = "done"
        self._entries.pop(entry.uid, None)
        try:
            entry.on_end(status, reason)
        except Exception:
            # a dead client (e.g. its asyncio loop is gone) must not
            # take the serving loop down; the entry is done either way
            pass

    def _check_restorable(self) -> None:
        if getattr(self.scheduler.engine, "release_followers", None) \
                is not None:
            raise NotImplementedError(
                "a KV handoff into an SPMD engine (tensor or expert "
                "parallel) is not ported to deepspeed_tpu_torch yet: each "
                "rank's pool holds its own heads and the restore would "
                "have to be mirrored (ROADMAP A15)")

    def _resume(self, entry, pack, generated, rng_state) -> None:
        from . import handoff
        try:
            self._check_restorable()
            handoff.restore_sequence(self.scheduler.engine, pack,
                                     uid=entry.uid)
        except Exception as e:
            self._end(entry, "error",
                      f"handoff restore failed: {type(e).__name__}: {e}")
            return
        self._adopt(entry, generated, rng_state)

    def _adopt(self, entry, generated, rng_state) -> None:
        """Insert an entry whose KV is already in the pool into the
        scheduler's running set (the blocking and chunked handoff paths
        share it)."""
        try:
            self.scheduler.resume(
                entry.uid, entry.prompt, generated,
                entry.max_new_tokens, eos_token_id=entry.eos_token_id,
                temperature=entry.temperature, top_p=entry.top_p,
                top_k=entry.top_k, rng_state=rng_state,
                on_token=self._make_on_token(entry),
                trace_ctx=getattr(entry, "trace_ctx", None))
        except Exception as e:
            self.scheduler.engine.flush(entry.uid)
            self._end(entry, "error", f"{type(e).__name__}: {e}")
            return
        entry.state = "inflight"
        self._entries[entry.uid] = entry
        if entry.deadline_t is not None:
            heapq.heappush(self._deadlines, (entry.deadline_t, entry.uid))

    # -- chunked streaming handoff (loop thread; serve/handoff.py) ------
    def begin_restore(self, uid: int, header) -> None:
        """Adopt the destination blocks for a streaming handoff (raises
        through run_on_loop's future on a layout mismatch or an exhausted
        pool)."""
        from . import handoff
        if self._stop or self._draining:
            raise RuntimeError("serving loop is draining")
        self._check_restorable()
        restore = handoff.ChunkedRestore(self.scheduler.engine, uid,
                                         header)
        restore.begin()
        self._restores[uid] = restore
        self._m_chunk_inflight.set(len(self._restores))

    def apply_restore(self, uid: int, chunk, nbytes: int) -> None:
        restore = self._restores.get(uid)
        if restore is None:
            raise ValueError(f"no chunked handoff in flight for uid {uid}")
        t0 = time.perf_counter()
        try:
            restore.apply(chunk)
        except Exception:
            # integrity / protocol failure: free the partial blocks now;
            # the client learns from the raised ack either way
            self._abort_restore(uid)
            raise
        self._m_chunks.inc()
        self._m_chunk_bytes.inc(nbytes)
        self._m_chunk_apply.observe(time.perf_counter() - t0)

    def commit_restore(self, entry, generated, rng_state) -> None:
        restore = self._restores.get(entry.uid)
        if restore is None:
            raise ValueError(f"no chunked handoff in flight for uid "
                             f"{entry.uid}")
        try:
            restore.commit_check()
        except Exception:
            self._abort_restore(entry.uid)
            raise
        del self._restores[entry.uid]
        self._m_chunk_inflight.set(len(self._restores))
        self._adopt(entry, generated, rng_state)

    def _abort_restore(self, uid: int) -> None:
        restore = self._restores.pop(uid, None)
        if restore is not None:
            restore.abort()
            self._m_chunk_aborts.inc()
            self._m_chunk_inflight.set(len(self._restores))

    def _cancel(self, uid: int, status: str) -> None:
        entry = self._entries.get(uid)
        if entry is None or entry.state == "done":
            return
        if entry.state == "pending":
            self.admission.remove(uid)
        else:
            self.scheduler.cancel(uid)     # releases the KV blocks
            self.scheduler.release(uid)
        if status == "expired":
            self._m_expired.inc()
        self._end(entry, status)

    def _run_cmds(self) -> None:
        while self._cmds:
            self._cmds.popleft()()

    def _expire_deadlines(self) -> None:
        now = self.clock()
        while self._deadlines and self._deadlines[0][0] <= now:
            _, uid = heapq.heappop(self._deadlines)
            entry = self._entries.get(uid)
            if entry is not None and entry.state != "done":
                self._cancel(uid, "expired")

    def _make_on_token(self, entry):
        def cb(uid, tok, finished):
            try:
                entry.on_token(tok, finished)
            except Exception:
                # this fires INSIDE scheduler.step(): letting one
                # client's dead callback propagate would reach
                # _step_error and fail EVERY in-flight request. Mark
                # just this entry for cancellation after the step.
                if not finished and entry.uid not in self._dead:
                    self._dead.append(entry.uid)
            if finished:
                self._just_finished.append(entry)
        return cb

    def _cancel_dead(self) -> None:
        for uid in self._dead:
            self._cancel(uid, "error")
        self._dead.clear()

    def _admit_ready(self) -> None:
        while self.scheduler.inflight() < self.max_inflight:
            entry = self.admission.pop()
            if entry is None:
                return
            if entry.state == "done":     # raced a cancel; already ended
                continue
            try:
                self.scheduler.submit(
                    entry.uid, entry.prompt, entry.max_new_tokens,
                    eos_token_id=entry.eos_token_id,
                    temperature=entry.temperature, top_p=entry.top_p,
                    top_k=entry.top_k, seed=entry.seed,
                    on_token=self._make_on_token(entry),
                    trace_ctx=getattr(entry, "trace_ctx", None),
                    adapter=getattr(entry, "adapter", None))
            except Exception as e:   # e.g. prompt exceeds max_seq_len
                self._end(entry, "error", f"{type(e).__name__}: {e}")
                continue
            entry.state = "inflight"

    def _flush_finished(self) -> None:
        for entry in self._just_finished:
            self.scheduler.release(entry.uid)
            if entry.state != "done":
                self._end(entry, "completed")
        self._just_finished.clear()

    def _step_error(self, e: BaseException) -> None:
        # a step-time failure cannot be attributed to one request here;
        # fail every in-flight request loudly rather than wedging the loop
        failed = [en for en in self._entries.values()
                  if en.state == "inflight"]
        for entry in failed:
            self.scheduler.cancel(entry.uid)
            self.scheduler.release(entry.uid)
            self._end(entry, "error", f"{type(e).__name__}: {e}")
        if self.diagnostics is not None and failed:
            from ....telemetry import anomaly, postmortem
            anomaly.report(
                "serving_step_error",
                f"scheduler.step() raised {type(e).__name__}: {e}; "
                f"{len(failed)} in-flight request(s) failed",
                error=f"{type(e).__name__}: {e}",
                failed_uids=[en.uid for en in failed])
            if self.diagnostics.config.postmortem_on_anomaly:
                postmortem.maybe_write_bundle(
                    "serving_step_error", config=self.diagnostics.config)

    # -- diagnostics hooks (loop thread) --------------------------------
    def _diag_step(self, fn):
        """Run one scheduler step inside the stall-watchdog heartbeat
        window and tick the SLO monitor at most once a second."""
        diag = self.diagnostics
        if diag is None:
            return fn()
        if diag.stall is not None:
            diag.stall.set_active("serving_loop", True)
        try:
            return fn()
        finally:
            if diag.stall is not None:
                diag.stall.beat("serving_loop")
            self._diag_tick()

    def _diag_tick(self) -> None:
        diag = self.diagnostics
        if diag is not None and diag.slo is not None:
            now = time.monotonic()
            if now - self._last_slo_tick >= 1.0:
                self._last_slo_tick = now
                try:
                    diag.slo.tick()
                except Exception:   # monitoring must never stall serving
                    pass
        if self.adapter is not None:
            try:
                self.adapter.tick()
            except Exception:       # adaptation must never stall serving
                logger.exception("online adapter tick failed")

    def _diag_drain(self) -> None:
        """KV-pool reconciliation at drain: every allocated block must be
        owned by a still-inflight request or the prefix cache."""
        diag = self.diagnostics
        if diag is None or diag.leak is None:
            return
        try:
            if diag.stall is not None:
                diag.stall.set_active("serving_loop", False)
            diag.leak.check_at_drain(
                self.scheduler.engine.state_manager,
                inflight_uids=self.scheduler.known_uids())
        except Exception:
            pass

    def _abort_remaining(self) -> None:
        for uid in list(self._restores):
            self._abort_restore(uid)     # free partially-streamed KV
        for entry in list(self._entries.values()):
            self._cancel(entry.uid, "cancelled")
        while (entry := self.admission.pop()) is not None:
            if entry.state != "done":
                self._end(entry, "cancelled")

    def _run(self) -> None:
        try:
            self._serve()
        except GroupDiverged as e:
            self._fail_all(e)
        finally:
            # an SPMD engine's followers end with this loop
            release = getattr(self.scheduler.engine, "release_followers",
                              None)
            if release is not None:
                release()

    def _fail_all(self, e: GroupDiverged) -> None:
        """The engine group's states diverged: fail every request, make
        no more engine calls, and end the loop."""
        logger.error("serving loop: %s; every request fails and the loop "
                     "ends", e)
        self.admission.close()
        reason = f"{type(e).__name__}: {e}"
        for entry in list(self._entries.values()):
            self._end(entry, "error", reason)
        while (entry := self.admission.pop()) is not None:
            if entry.state != "done":
                self._end(entry, "error", reason)
        spill = getattr(self.scheduler.engine, "spill", None)
        if spill is not None:
            spill.close()
        if self.bridge is not None:
            try:
                self.bridge.close()
            except Exception:
                pass

    def _serve(self) -> None:
        select_device(getattr(self.scheduler.engine, "device", None))
        if self.lane is not None:
            from ....telemetry import trace
            trace.set_lane(self.lane)
        while not self._stop:
            self._run_cmds()
            if self._stop:
                break
            self._expire_deadlines()
            self._admit_ready()
            if self.scheduler.pending():
                try:
                    self._diag_step(self.scheduler.step)
                except GroupDiverged:
                    raise
                except Exception as e:
                    self._step_error(e)
                self.steps_done += 1
                if self._restores:
                    # a chunked handoff is streaming in AND the batch
                    # kept stepping: the overlap the protocol buys
                    self._m_overlap_steps.inc()
                if self.weight_staging:
                    self._m_weight_overlap_steps.inc()
                self._cancel_dead()
                self._flush_finished()
                continue
            if (self.diagnostics is not None
                    and self.diagnostics.stall is not None):
                # idle is silence, not a stall
                self.diagnostics.stall.set_active("serving_loop", False)
            # an idle loop must still tick the SLO monitor, or the burn
            # gauges (and a latched slo_burn alert) freeze at their
            # last busy-time values after traffic stops
            self._diag_tick()
            if (self._draining and not self._entries
                    and not self._restores
                    and self.admission.empty() and not self._cmds):
                break
            # idle: block until woken (every external command calls
            # wake()), or until the nearest registered deadline so
            # queued requests still expire. With the SLO monitor
            # attached the wait is additionally capped at its ~1 Hz
            # tick cadence (burn windows must keep decaying after
            # traffic stops); otherwise never a fixed-rate poll
            if self._deadlines:
                timeout = max(self._deadlines[0][0] - self.clock(),
                              self.idle_wait_s)
            else:
                timeout = None
            if (self.diagnostics is not None
                    and self.diagnostics.slo is not None):
                timeout = 1.0 if timeout is None else min(timeout, 1.0)
            self._wake.wait(timeout)
            self._wake.clear()
        self._cmds_closed = True
        self._run_cmds()
        self._abort_remaining()
        self._diag_drain()
        spill = getattr(self.scheduler.engine, "spill", None)
        if spill is not None:
            # a stopped replica leaks no host RAM or disk scratch: its
            # spilled conversations recompute wherever they land next
            spill.close()
        if self.bridge is not None:
            try:  # drain/stop must end cleanly even if a backend throws
                self.bridge.close()
            except Exception:
                pass

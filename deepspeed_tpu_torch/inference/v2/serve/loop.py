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
host counters). The KV handoff entry points (``resume``,
``begin_restore``) raise ``NotImplementedError`` (ROADMAP A7); the loop
keeps none of the fleet's state (chunked restores, weight staging, the
online adapter), which comes with those modules (ROADMAP A7, A12). A KV
spill tier is refused when the engine is configured (ROADMAP A9).
"""

import heapq
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional


def _handoff_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "KV handoff between replicas (serve/handoff.py) is not ported to "
        "deepspeed_tpu_torch yet (ROADMAP A7)")


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
                 lane: Optional[str] = None):
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
        self._entries: Dict[int, object] = {}   # uid -> entry (not done)
        self._deadlines: List = []              # heap of (deadline_t, uid)
        self._just_finished: List = []          # entries finished in step()
        self._dead: List[int] = []              # uids whose on_token raised
        from ....telemetry import get_registry
        reg = get_registry()
        self._m_expired = reg.counter(
            "serving_deadline_expired_total",
            "requests cancelled because their deadline passed")

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
        """Adopt a handed-off request (serve/handoff.py): not ported."""
        raise _handoff_not_ported()

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

    def begin_restore(self, uid: int, header) -> None:
        """Start a chunked streaming KV handoff: not ported."""
        raise _handoff_not_ported()

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
        for entry in list(self._entries.values()):
            self._cancel(entry.uid, "cancelled")
        while (entry := self.admission.pop()) is not None:
            if entry.state != "done":
                self._end(entry, "cancelled")

    def _run(self) -> None:
        device = getattr(self.scheduler.engine, "device", None)
        if device is not None and device.type == "cuda":
            import torch
            torch.cuda.set_device(device)
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
                except Exception as e:
                    self._step_error(e)
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
        self._run_cmds()
        self._abort_remaining()
        self._diag_drain()
        if self.bridge is not None:
            try:  # drain/stop must end cleanly even if a backend throws
                self.bridge.close()
            except Exception:
                pass

"""Flight recorder: an always-on, bounded, structured event black box.

The passive observability spine (registry gauges, trace spans) answers
"what is the system doing NOW"; the flight recorder answers "what
happened in the seconds BEFORE it went wrong". It is a ring buffer of
typed events — plain dicts with a ``kind``, a monotonic timestamp, a
process-wide sequence number, and free-form correlation fields
(``uid``, ``step``, ...) — capped by a BYTE budget rather than an event
count, so one chatty producer (e.g. per-window decode events) cannot
silently change how much history a quiet producer (e.g. anomaly
verdicts) keeps.

Producers (docs/TELEMETRY.md § Flight recorder):

  * training (``runtime/engine.py``): one ``train_step`` event per
    batch (loss, grad norm, loss scale, skip flag, duration),
  * serving: ``request_submit`` / ``request_finish`` /
    ``request_cancel`` (scheduler), ``admit`` / ``shed`` (admission),
    ``prefill`` / ``decode_window`` (engine), ``kv_alloc`` /
    ``kv_free`` (state manager),
  * the recompile watchdog mirrors every compile as ``xla_compile``,
  * anomaly detectors append their verdicts as ``anomaly`` events.

Cost: one dict build, one approximate size estimate, one locked deque
append — single-digit microseconds. ``scripts/perf_gate.py`` gates
``recorder_ns_per_event`` so the black box can never become the hot
path. Post-mortem bundles (:mod:`.postmortem`) snapshot the last-N
events; ``events()`` serves them live.

Like the metrics registry, there is one process default
(:func:`get_recorder`), swappable for test isolation
(:func:`set_recorder`).

Port note: a copy of ``deepspeed_tpu/telemetry/recorder.py`` (which imports no
jax); the metric names and documents are the same in both packages.
"""

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .registry import get_registry

DEFAULT_MAX_BYTES = 2 << 20          # ~2 MiB of history by default

# wall time is derived from one process-lifetime anchor instead of a
# time.time() syscall per event; sub-ms anchor drift is irrelevant for
# forensics timestamps
_WALL_ANCHOR = time.time() - time.perf_counter()

# fixed per-event overhead estimate (dict + bookkeeping fields), plus a
# per-field estimate below. Approximate by design: the budget bounds
# memory to the right order, it is not an allocator.
_EVENT_BASE_BYTES = 96
_FIELD_BYTES = 24


def _event_bytes(fields: Dict) -> int:
    n = _EVENT_BASE_BYTES + _FIELD_BYTES * len(fields)
    for v in fields.values():
        t = type(v)
        if t is str:
            n += len(v)
        elif t is list or t is tuple:
            n += 8 * len(v)
        elif t is dict:
            n += 48 * len(v)
    return n


class FlightRecorder:
    """Byte-bounded ring of typed events; see module docstring."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._bytes = 0
        self._seq = itertools.count(1)
        self._dropped = 0
        self._recorded = 0
        self.enabled = True
        # registry series are resolved lazily and cached against the
        # registry object's identity (plus a per-kind series cache), so
        # a test's set_registry() swap is picked up without paying a
        # family lookup per record()
        self._reg = None
        self._m_events = None
        self._m_dropped = None
        self._m_bytes = None
        self._kind_series: Dict[str, object] = {}

    # -- metrics -------------------------------------------------------
    def _metrics(self, kind: str):
        reg = get_registry()
        if reg is not self._reg:
            # assign _reg LAST: a concurrent record() that observes
            # `reg is self._reg` must find every series attribute
            # already in place (re-running this branch on a race is
            # idempotent — registration is — but a half-initialized
            # fast path is an AttributeError inside admit()/submit())
            self._kind_series = {}
            self._m_events = reg.counter(
                "recorder_events_total",
                "flight-recorder events recorded", labelnames=("kind",))
            self._m_dropped = reg.counter(
                "recorder_dropped_events_total",
                "flight-recorder events evicted to hold the byte budget")
            self._m_bytes = reg.gauge(
                "recorder_buffer_bytes",
                "approximate bytes of retained flight-recorder history",
                unit="bytes")
            self._reg = reg
        series = self._kind_series.get(kind)
        if series is None:
            series = self._kind_series[kind] = \
                self._m_events.labels(kind=kind)
        return series, self._m_dropped, self._m_bytes

    # -- recording -----------------------------------------------------
    def record(self, kind: str, **fields) -> Optional[Dict]:
        """Append one event; returns the event dict (None when the
        recorder is disabled). ``fields`` must be JSON-serializable —
        they land verbatim in post-mortem bundles."""
        if not self.enabled:
            return None
        t = time.perf_counter()
        ev = {"kind": kind, "t": t, "wall": _WALL_ANCHOR + t,
              "seq": next(self._seq)}
        ev.update(fields)
        size = _event_bytes(ev)
        kind_total, m_dropped, m_bytes = self._metrics(kind)
        with self._lock:
            self._events.append((size, ev))
            self._bytes += size
            self._recorded += 1
            dropped = 0
            while self._bytes > self.max_bytes and len(self._events) > 1:
                s, _ = self._events.popleft()
                self._bytes -= s
                dropped += 1
            self._dropped += dropped
            buf_bytes = self._bytes
        kind_total.inc()
        if dropped:
            m_dropped.inc(dropped)
        m_bytes.set(buf_bytes)
        return ev

    # -- reading -------------------------------------------------------
    def events(self, kind: Optional[str] = None,
               last: Optional[int] = None) -> List[Dict]:
        """Copy of retained events (oldest first); ``kind`` filters,
        ``last`` keeps only the most recent N after filtering."""
        with self._lock:
            evs = [e for _, e in self._events]
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if last is not None:
            evs = evs[-int(last):]
        return evs

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"retained": len(self._events), "bytes": self._bytes,
                    "recorded": self._recorded, "dropped": self._dropped,
                    "max_bytes": self.max_bytes}

    # -- management ----------------------------------------------------
    def set_budget(self, max_bytes: int) -> None:
        """Resize the byte budget (evicts oldest events immediately)."""
        with self._lock:
            self.max_bytes = int(max_bytes)
            while self._bytes > self.max_bytes and len(self._events) > 1:
                s, _ = self._events.popleft()
                self._bytes -= s
                self._dropped += 1

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._bytes = 0


_default_recorder = FlightRecorder()
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    """The process-local default recorder every subsystem feeds."""
    return _default_recorder


def set_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process default (tests isolate with a fresh recorder);
    returns the previous one."""
    global _default_recorder
    with _recorder_lock:
        prev = _default_recorder
        _default_recorder = recorder
    return prev


def record(kind: str, **fields) -> Optional[Dict]:
    """Record into the process-default recorder (the instrumentation
    call sites' one-liner)."""
    return _default_recorder.record(kind, **fields)

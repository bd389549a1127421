"""Lightweight span tracing with a ring-buffer exporter.

``with trace.span("decode_step"):`` records (name, start, duration,
depth) into a bounded deque — overhead is two ``perf_counter`` calls and
one locked append, so the serving hot path can stay instrumented in
production.
``export()`` drains a copy for offline analysis; ``durations(name)``
feeds assertions and benchmarks.

Every span also carries a process-unique ``id``, the ``parent`` id of
the enclosing span (None at top level), and a ``track`` — by default the
recording thread's name, overridable with :func:`set_track` — so the
ring buffer reconstructs into per-thread timelines
(:mod:`deepspeed_tpu.telemetry.timeline` exports them as Chrome trace
events). :func:`record` appends a RETROACTIVE span from saved
timestamps (e.g. a request's queue wait, measured between two scheduler
events rather than around a ``with`` block).

Fleet serving adds a second grouping axis: the ``lane`` — which serving
REPLICA (or the router) recorded the span. In-process replicas share
this one ring buffer, so each replica's loop thread names its lane once
(:func:`set_lane`; the router passes ``lane=`` explicitly) and the
fleet timeline export groups lanes into per-replica process rows —
exactly the shape N remote rings would stitch into. Spans without a
lane belong to no replica (single-engine serving, training).

``enable_profiler_annotations(True)`` mirrors every span into a
``torch.profiler.record_function`` range, so spans line up with the
card's kernels in a ``torch.profiler`` trace (the hook is optional: a
failed ``record_function`` leaves the span host-only).

Port note: ``deepspeed_tpu/telemetry/trace.py`` mirrors spans into
``jax.profiler.TraceAnnotation``; this copy mirrors them into
``torch.profiler.record_function``. The span records are the same.
"""

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

_DEFAULT_CAPACITY = 4096

_lock = threading.Lock()
_buffer: deque = deque(maxlen=_DEFAULT_CAPACITY)
_profiler_annotations = False
_local = threading.local()
_ids = itertools.count(1)


def enable_profiler_annotations(on: bool = True) -> None:
    """Mirror spans into torch.profiler ranges (see module docstring)."""
    global _profiler_annotations
    _profiler_annotations = on


def set_capacity(capacity: int) -> None:
    """Resize the ring buffer (drops recorded spans)."""
    global _buffer
    with _lock:
        _buffer = deque(maxlen=int(capacity))


def set_track(name: Optional[str]) -> None:
    """Name this thread's timeline track (None restores the default —
    the thread's own name). Tracks map to rows in the Chrome trace
    export."""
    _local.track = name


def current_track() -> str:
    track = getattr(_local, "track", None)
    return track if track is not None else threading.current_thread().name


def set_lane(name: Optional[str]) -> None:
    """Name this thread's fleet lane (the replica whose spans it
    records; None clears it). Lanes map to process rows in the stitched
    fleet timeline (:func:`timeline.stitch_fleet`)."""
    _local.lane = name


def current_lane() -> Optional[str]:
    return getattr(_local, "lane", None)


@contextmanager
def span(name: str, lane: Optional[str] = None, **attrs):
    """Record a wall-clock span; nests (depth reflects enclosing spans).
    ``lane`` overrides the thread's fleet lane for this span."""
    depth = getattr(_local, "depth", 0)
    parent = getattr(_local, "span_id", None)
    span_id = next(_ids)
    _local.depth = depth + 1
    _local.span_id = span_id
    annotation = None
    if _profiler_annotations:
        try:
            import torch
            annotation = torch.profiler.record_function(name)
            annotation.__enter__()
        except Exception:
            annotation = None
    start = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - start
        if annotation is not None:
            annotation.__exit__(None, None, None)
        _local.depth = depth
        _local.span_id = parent
        rec = {"name": name, "start": start, "duration_s": dur,
               "depth": depth, "id": span_id, "parent": parent,
               "track": current_track()}
        ln = lane if lane is not None else current_lane()
        if ln is not None:
            rec["lane"] = ln
        if attrs:
            rec["attrs"] = attrs
        # under _lock: export() snapshots the deque while other threads
        # record, and set_capacity() swaps the buffer out entirely
        with _lock:
            _buffer.append(rec)


def record(name: str, start: float, duration_s: float,
           track: Optional[str] = None, lane: Optional[str] = None,
           **attrs) -> None:
    """Append a retroactive span from saved ``perf_counter`` timestamps.

    For phases whose boundaries are events rather than a ``with`` block
    (a request's queue wait between submit and first prefill chunk, its
    decode phase between first token and finish). Retroactive spans are
    top-level (no parent) on ``track`` (default: the calling thread's
    track) in fleet lane ``lane`` (default: the thread's lane)."""
    rec = {"name": name, "start": float(start),
           "duration_s": float(duration_s), "depth": 0, "id": next(_ids),
           "parent": None,
           "track": track if track is not None else current_track()}
    ln = lane if lane is not None else current_lane()
    if ln is not None:
        rec["lane"] = ln
    if attrs:
        rec["attrs"] = attrs
    with _lock:
        _buffer.append(rec)


def export(name: Optional[str] = None) -> List[Dict]:
    """Copy of the recorded spans (oldest first), optionally filtered."""
    with _lock:
        spans = list(_buffer)
    if name is not None:
        spans = [s for s in spans if s["name"] == name]
    return spans


def durations(name: str) -> List[float]:
    return [s["duration_s"] for s in export(name)]


def clear() -> None:
    with _lock:
        _buffer.clear()

"""Timeline export: telemetry spans -> Chrome trace events.

Converts the :mod:`~deepspeed_tpu_torch.telemetry.trace` ring buffer into the
Chrome trace-event JSON format (the ``{"traceEvents": [...]}`` shape
``chrome://tracing`` and https://ui.perfetto.dev load directly), so a
serving incident or a slow training step can be inspected as a timeline
without a TensorBoard/XProf capture.

Each span becomes one complete ("X") event; span ``track``s (one per
recording thread by default) become trace threads, named via metadata
events. Request-correlated spans carry the request ``uid`` in their
``args``, so one request's lifeline — admission, queue wait, prefill,
decode windows, finish — filters out of the mixed serving timeline with
:func:`request_spans` / :func:`request_lifeline`.

Fleet stitching: a routed deployment records spans in N replica rings
plus the router's (in-process replicas share one ring, distinguished by
per-span ``lane``; remote replicas each own a ring). :func:`stitch_fleet`
merges them into ONE Chrome trace with a process row per lane, and
``trace_id``-filtered views (:func:`trace_spans`) follow a single
request across router dispatch, prefill, KV handoff and decode — the
distributed-tracing surface (docs/PROFILING.md § Distributed tracing).

Surfaces: ``bench.py --trace-out`` and ``serving_bench --trace-out``
write the file after a run (``--router`` writes the stitched fleet
form); the serving API exposes ``GET /debug/timeline[?uid=N][&trace=ID]``
live (docs/PROFILING.md).

Port note: a copy of ``deepspeed_tpu/telemetry/timeline.py`` (which imports no
jax); the metric names and documents are the same in both packages.
"""

import json
import os
from typing import Dict, Iterable, List, Mapping, Optional

from . import trace

# phases of one serving request, in lifeline order (scheduler.py emits
# them; the names are the contract the timeline tests pin)
REQUEST_PHASES = ("request_queue", "request_prefill", "request_decode",
                  "request")


def to_chrome_trace(spans: Optional[Iterable[Dict]] = None) -> Dict:
    """Chrome-trace-event JSON dict for ``spans`` (default: the current
    ring buffer). Timestamps are microseconds relative to the earliest
    span; tracks map to tids with thread_name metadata."""
    spans = trace.export() if spans is None else list(spans)
    pid = os.getpid()
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(s["start"] for s in spans)
    tracks: Dict[str, int] = {}
    events: List[Dict] = []
    for s in spans:
        track = s.get("track") or "main"
        tid = tracks.setdefault(track, len(tracks) + 1)
        ev = {"name": s["name"], "ph": "X", "cat": "span", "pid": pid,
              "tid": tid, "ts": round((s["start"] - t0) * 1e6, 3),
              "dur": round(s["duration_s"] * 1e6, 3)}
        args = dict(s.get("attrs") or {})
        if s.get("id") is not None:
            args["span_id"] = s["id"]
        if s.get("parent") is not None:
            args["parent_id"] = s["parent"]
        if args:
            ev["args"] = args
        events.append(ev)
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": track}} for track, tid in tracks.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       spans: Optional[Iterable[Dict]] = None) -> str:
    """Write :func:`to_chrome_trace` JSON to ``path``; returns the path."""
    obj = to_chrome_trace(spans)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return path


def stitch_fleet(rings: Optional[Mapping[str, Iterable[Dict]]] = None,
                 trace_id: Optional[str] = None) -> Dict:
    """Merge N span rings into ONE Chrome trace with a process row per
    fleet lane.

    ``rings`` maps a source name to its exported spans — one entry per
    remote replica ring, or the default ``None`` for the in-process
    case (one shared ring, every span already lane-tagged). A span's
    own ``lane`` wins over its ring's name (the router and its
    in-process replicas share a ring), spans with neither group under
    the ring name, and a lane-less default ring groups under ``host``.
    ``trace_id`` filters every ring to one request's trace first.

    All timestamps must share a clock (in-process: ``perf_counter``;
    remote rings need their exporter to rebase) — events are offset
    from the earliest span across ALL rings, so causal order is
    preserved fleet-wide."""
    if rings is None:
        rings = {"host": trace.export()}
    lanes: Dict[str, List[Dict]] = {}
    for ring_name, spans in rings.items():
        spans = list(spans)
        if trace_id is not None:
            spans = trace_spans(trace_id, spans)
        for s in spans:
            lanes.setdefault(s.get("lane") or ring_name, []).append(s)
    if not any(lanes.values()):
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(s["start"] for spans in lanes.values() for s in spans)
    events: List[Dict] = []
    meta: List[Dict] = []
    for pid, lane in enumerate(sorted(lanes), start=1):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": lane}})
        tracks: Dict[str, int] = {}
        for s in lanes[lane]:
            track = s.get("track") or "main"
            tid = tracks.setdefault(track, len(tracks) + 1)
            ev = {"name": s["name"], "ph": "X", "cat": "span",
                  "pid": pid, "tid": tid,
                  "ts": round((s["start"] - t0) * 1e6, 3),
                  "dur": round(s["duration_s"] * 1e6, 3)}
            args = dict(s.get("attrs") or {})
            if s.get("id") is not None:
                args["span_id"] = s["id"]
            if args:
                ev["args"] = args
            events.append(ev)
        meta.extend({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": track}}
                    for track, tid in tracks.items())
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_fleet_trace(path: str,
                      rings: Optional[Mapping[str, Iterable[Dict]]] = None,
                      trace_id: Optional[str] = None) -> str:
    """Write :func:`stitch_fleet` JSON to ``path``; returns the path."""
    obj = stitch_fleet(rings, trace_id=trace_id)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return path


def _touches_uid(s: Dict, uid: int) -> bool:
    attrs = s.get("attrs") or {}
    if attrs.get("uid") == uid:
        return True
    uids = attrs.get("uids")
    return bool(uids) and uid in uids


def _touches_trace(s: Dict, trace_id: str) -> bool:
    attrs = s.get("attrs") or {}
    if attrs.get("trace_id") == trace_id:
        return True
    tids = attrs.get("trace_ids")
    return bool(tids) and trace_id in tids


def trace_spans(trace_id: str,
                spans: Optional[Iterable[Dict]] = None) -> List[Dict]:
    """Every span correlated with distributed trace ``trace_id`` —
    spans whose attrs carry ``trace_id`` or include it in a batch
    ``trace_ids`` list (engine steps serve many traces at once)."""
    spans = trace.export() if spans is None else list(spans)
    return [s for s in spans if _touches_trace(s, str(trace_id))]


def request_spans(uid: int,
                  spans: Optional[Iterable[Dict]] = None) -> List[Dict]:
    """Every span correlated with request ``uid`` — spans whose attrs
    carry ``uid=<uid>`` or include it in a batch ``uids`` list (decode
    steps/windows serve many requests at once)."""
    spans = trace.export() if spans is None else list(spans)
    return [s for s in spans if _touches_uid(s, int(uid))]


def request_lifeline(uid: int,
                     spans: Optional[Iterable[Dict]] = None) -> Dict:
    """The request's phase spans keyed by name (queue -> prefill ->
    decode -> total; missing phases are absent). ``decode_batches``
    collects the shared decode-step/window spans the uid rode in."""
    mine = request_spans(uid, spans)
    out: Dict = {"uid": int(uid)}
    for s in mine:
        if s["name"] in REQUEST_PHASES:
            out[s["name"]] = s
    out["decode_batches"] = [s for s in mine
                             if s["name"] in ("decode_step",
                                              "decode_window")]
    return out

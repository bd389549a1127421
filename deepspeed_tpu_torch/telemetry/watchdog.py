"""Recompile watchdog: every compile point, counted and attributed.

Port of ``deepspeed_tpu/telemetry/watchdog.py``. On the TPU a silent XLA
recompile is a multi-second stall that looks like a latency spike; the
bucketing layers (engine_v2's power-of-two decode buckets, the
scheduler's chunk-aligned prefill sizes) exist so steady-state serving
never retraces. Eager PyTorch has no jit cache, so this port counts the
two events that play the part of a compile here:

  * a kernel build: ``ops/op_builder/cuda.py`` (nvcc over ``csrc/*.cu``)
    and ``ops/op_builder/builder.py`` (g++ host ops) call
    :func:`record_build` with the build's wall time, under the program
    name ``build:<library>``;
  * the first call of a :func:`watch`-wrapped function at a new shape
    signature (:func:`_signature` over its tensor arguments), with that
    call's wall time as an upper bound — the first launch at a new shape
    is where CUDA loads modules and the caching allocator grows.

:func:`mark_steady` flips the process into steady-state mode — from then
on ANY such event increments ``xla_steady_state_recompiles_total`` and
logs a warning naming the program and the shapes that triggered it.
:func:`record_compile` covers explicit compile points.

Registry series (the JAX package's names, so dashboards read both):
``xla_compile_events_total``, ``xla_compile_seconds_total``,
``xla_steady_state_recompiles_total`` (all labeled by ``program``) and
the ``xla_compiled_programs`` gauge (distinct signatures per program).
"""

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.logging import logger
from .registry import get_registry

_EVENT_CAPACITY = 256

_lock = threading.Lock()
_events: deque = deque(maxlen=_EVENT_CAPACITY)
_steady = False


def _metrics():
    reg = get_registry()
    return (
        reg.counter("xla_compile_events_total",
                    "XLA program compiles observed by the watchdog",
                    labelnames=("program",)),
        reg.counter("xla_compile_seconds_total",
                    "wall time spent compiling, per program", unit="s",
                    labelnames=("program",)),
        reg.counter("xla_steady_state_recompiles_total",
                    "compiles AFTER mark_steady() — a supposedly-bucketed "
                    "path retraced at steady state",
                    labelnames=("program",)),
        reg.gauge("xla_compiled_programs",
                  "live jit-cache entries per watched program",
                  labelnames=("program",)),
    )


def mark_steady(on: bool = True) -> None:
    """Enter (or leave) steady-state mode: further compiles are counted
    as recompile violations and logged."""
    global _steady
    _steady = on


def is_steady() -> bool:
    return _steady


def reset() -> None:
    """Drop the event log and leave steady-state mode (tests/benches)."""
    global _steady
    _steady = False
    with _lock:
        _events.clear()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _signature(args: tuple, kwargs: dict) -> Tuple:
    """Shape/dtype signature of the tensor arguments — the bucket key a
    first call at a new shape is keyed on (nested dicts / lists / tuples
    are walked)."""
    return tuple((tuple(x.shape), str(x.dtype))
                 for x in _leaves((args, kwargs))
                 if hasattr(x, "shape") and hasattr(x, "dtype"))


def record_compile(program: str, seconds: float,
                   signature: Optional[Tuple] = None,
                   cached_programs: Optional[int] = None,
                   analysis: bool = False) -> None:
    """Record one observed compile of ``program`` (counters + event log;
    warns when it happened at steady state). ``analysis=True`` marks a
    deliberate AOT analysis compile (``lower_train_step``,
    ``memory_report``): counted in the compile totals but never a
    steady-state violation — it is not a hot path retracing."""
    ev_total, sec_total, steady_total, progs = _metrics()
    ev_total.labels(program=program).inc()
    sec_total.labels(program=program).inc(max(float(seconds), 0.0))
    if cached_programs is not None:
        progs.labels(program=program).set(cached_programs)
    rec = {"program": program, "seconds": float(seconds),
           "signature": signature, "steady_state": _steady and not analysis,
           "time": time.time()}
    with _lock:
        _events.append(rec)
    # mirror into the flight recorder: a compile near an incident is a
    # prime suspect, and the black box should hold it without anyone
    # having to correlate the watchdog's own deque after the fact
    from . import recorder as ds_recorder
    ds_recorder.record(
        "xla_compile", program=program, seconds=round(float(seconds), 4),
        signature=repr(signature) if signature else None,
        steady_state=_steady and not analysis, analysis=analysis)
    if _steady and not analysis:
        steady_total.labels(program=program).inc()
        logger.warning(
            f"steady-state recompile: program={program!r} took "
            f"{seconds * 1e3:.1f}ms for shapes {signature} — a bucketed "
            f"path retraced after warmup (check bucket keys / weak types)")


def events() -> List[Dict[str, Any]]:
    """The recent compile events (oldest first, bounded)."""
    with _lock:
        return list(_events)


def summary() -> Dict[str, Dict[str, float]]:
    """Per-program rollup: {program: {compiles, seconds,
    steady_state_recompiles}}. Built from the registry counters — the
    authoritative totals — not the bounded event log, so a long-lived
    server's /statusz matches /metrics even after the deque wraps."""
    reg = get_registry()
    out: Dict[str, Dict[str, float]] = {}
    for metric, key in (
            ("xla_compile_events_total", "compiles"),
            ("xla_compile_seconds_total", "seconds"),
            ("xla_steady_state_recompiles_total",
             "steady_state_recompiles")):
        fam = reg.get(metric)
        if fam is None:
            continue
        for values, s in fam.series():
            prog = values[0] if values else ""
            out.setdefault(prog, {"compiles": 0, "seconds": 0.0,
                                  "steady_state_recompiles": 0})[key] = \
                s.value
    return out


def record_build(library: str, seconds: float) -> None:
    """Record one kernel build (nvcc or g++) of ``library`` as a compile
    of program ``build:<library>``."""
    record_compile(f"build:{library}", seconds)


class WatchedFunction:
    """Transparent proxy over a callable: forwards calls and attribute
    access, recording a compile event the first time it is called at a
    new shape signature."""

    def __init__(self, program: str, fn: Callable):
        self.program = program
        self._fn = fn
        self._seen: set = set()
        self._seen_lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        sig = _signature(args, kwargs)
        with self._seen_lock:
            new = sig not in self._seen
            if new:
                self._seen.add(sig)
                cached = len(self._seen)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        if new:
            record_compile(self.program, time.perf_counter() - t0,
                           signature=sig, cached_programs=cached)
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __repr__(self) -> str:
        return f"WatchedFunction({self.program!r}, {self._fn!r})"


def watch(program: str, fn: Callable) -> WatchedFunction:
    """Wrap ``fn`` so its first call at each new shape signature is
    counted under ``program``. Idempotent on already-watched functions."""
    if isinstance(fn, WatchedFunction):
        return fn
    return WatchedFunction(program, fn)

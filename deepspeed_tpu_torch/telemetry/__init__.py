"""Unified telemetry: metrics registry + span tracing.

Port of ``deepspeed_tpu/telemetry/``. One process-local
:class:`MetricsRegistry` (labeled counters, gauges, fixed-bucket
histograms) feeds every consumer from the same series:

  * ``render_prometheus()`` — Prometheus text exposition a serving
    deployment scrapes (the JAX package's metric names, labels and
    buckets),
  * ``snapshot()`` — machine-readable JSON snapshot (benchmarks,
    dashboards, tests),
  * :class:`TelemetryBridge` — periodic flush of registry scalars into
    monitor backends.

Span tracing (``with trace.span("decode_step"):``) records wall-clock
spans into a ring buffer and can mirror them into ``torch.profiler``
ranges (see :mod:`deepspeed_tpu_torch.telemetry.trace`). The flight
recorder, anomaly detectors, post-mortem bundles and W3C trace context
are copies of the JAX package's; ``memory`` and ``watchdog`` read the
CUDA caching allocator and count kernel builds and first calls at new
shapes in place of XLA's memory analysis and jit-cache growth.
"""

from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       get_registry, render_federated, scoped_registry,
                       set_registry)
from .bridge import TelemetryBridge
from . import anomaly, context, memory, postmortem, recorder, timeline, \
    trace, watchdog
from .anomaly import DiagnosticsConfig
from .context import TraceContext
from .recorder import FlightRecorder, get_recorder, set_recorder

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "set_registry", "scoped_registry",
    "render_federated", "TelemetryBridge", "trace", "timeline",
    "watchdog", "memory", "recorder", "anomaly", "postmortem", "context",
    "TraceContext", "DiagnosticsConfig", "FlightRecorder",
    "get_recorder", "set_recorder",
]

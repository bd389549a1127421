"""Registry -> monitor bridge.

:class:`TelemetryBridge` flushes every scalar the registry holds
(counters, gauges, histogram count/sum/mean) into a ``MonitorMaster``
(TensorBoard/W&B/CSV backends) at a configurable step cadence — the
training-loop path from the unified registry to the experiment trackers
the reference wires ad hoc per metric (engine.py:2141 monitor writes).

The bridge writes only series that CHANGED since the last flush, so an
idle subsystem (e.g. inference metrics during training) adds no event
spam to the backends.

``close()`` is the final flush: a run ending mid-interval (engine
``destroy()``, serving drain) would otherwise silently drop every
metric recorded since the last cadence boundary.

Port note: a copy of ``deepspeed_tpu/telemetry/bridge.py`` (which imports no
jax); the metric names and documents are the same in both packages.
"""

from typing import Dict, Optional

from .registry import MetricsRegistry, get_registry


class TelemetryBridge:
    def __init__(self, monitor, registry: Optional[MetricsRegistry] = None,
                 flush_interval: int = 1):
        """``monitor``: anything with ``write_events([(tag, value, step)])``
        and an ``enabled`` attribute (MonitorMaster). ``flush_interval``:
        flush every N ``step()`` calls (1 = every step)."""
        self.monitor = monitor
        self.registry = registry or get_registry()
        self.flush_interval = max(int(flush_interval), 1)
        self._calls = 0
        self._last: Dict[str, float] = {}
        self._last_step = 0
        self._closed = False

    @property
    def enabled(self) -> bool:
        return bool(getattr(self.monitor, "enabled", False))

    def step(self, step: int) -> bool:
        """Cadence-gated flush; returns True when a flush happened."""
        self._calls += 1
        self._last_step = int(step)
        if self._calls % self.flush_interval:
            return False
        return self.flush(step)

    def flush(self, step: int) -> bool:
        """Write every changed registry scalar as a (tag, value, step)
        event to the monitor backends."""
        self._last_step = int(step)
        if not self.enabled:
            return False
        events = []
        for tag, value in self.registry.scalar_items():
            if self._last.get(tag) != value:
                self._last[tag] = value
                events.append((tag, value, int(step)))
        if events:
            self.monitor.write_events(events)
        return bool(events)

    def close(self, step: Optional[int] = None) -> bool:
        """Final flush, ignoring the cadence: write whatever changed
        since the last flush interval (engine shutdown / serving drain
        would otherwise drop the tail). Idempotent — the first call
        flushes, later calls are no-ops. ``step`` defaults to the last
        step seen."""
        if self._closed:
            return False
        # mark closed only after a successful flush: a backend failure
        # (swallowed by the drain/destroy callers) must leave the final
        # flush retryable, or the tail metrics are permanently dropped
        out = self.flush(self._last_step if step is None else step)
        self._closed = True
        return out

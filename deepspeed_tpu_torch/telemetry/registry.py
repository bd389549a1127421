"""Process-local metrics registry.

Three metric kinds with Prometheus semantics:

  * :class:`Counter` — monotonically increasing float (``_total`` names),
  * :class:`Gauge` — a value that goes up and down,
  * :class:`Histogram` — fixed-bucket distribution; ``observe`` is a
    bisect over a precomputed bound tuple plus one list increment, so the
    hot path allocates nothing.

Label handling follows the client-library convention: a family is
registered once with its ``labelnames``; ``family.labels(op="x")``
resolves (and caches) the concrete series, so steady-state
instrumentation touches plain Python attributes. A family with no label
names IS its single series — ``inc``/``set``/``observe`` work directly
on it.

Exports: ``render_prometheus()`` (text exposition format 0.0.4) and
``snapshot()`` (JSON-serializable dict; round-trips through ``json``).
Registration is idempotent: re-registering a name returns the existing
family and raises only on a kind/labelnames mismatch.

Port note: a copy of ``deepspeed_tpu/telemetry/registry.py`` (which imports no
jax); the metric names and documents are the same in both packages.
"""

import threading
from bisect import bisect_left
from contextlib import contextmanager
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

# Prometheus default buckets suit request latencies in seconds; the
# sub-millisecond tail matters for per-step decode timings.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_INF = float("inf")


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # HELP text escapes ONLY backslash and newline (exposition format
    # 0.0.4); quotes are legal there, unlike in label values
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _label_str(names: Tuple[str, ...], values: Tuple[str, ...],
               extra: str = "") -> str:
    parts = [f'{n}="{_escape_label_value(v)}"'
             for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _CounterSeries:
    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only increase; use a gauge")
        self.value += amount


class _GaugeSeries:
    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class _HistogramSeries:
    __slots__ = ("bounds", "bucket_counts", "sum", "count")
    kind = "histogram"

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        # one slot per finite bound plus the +Inf overflow slot
        self.bucket_counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.bucket_counts[bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0 <= q <= 1) from the fixed buckets
        by linear interpolation inside the bucket holding the target
        rank — the same estimate PromQL's ``histogram_quantile`` makes
        server-side, available process-locally (the SLO monitor and
        /statusz p50/p95/p99 read it without raw-sample lists).

        Error is bounded by the width of the bucket the quantile lands
        in (observations are uniform-within-bucket by assumption). The
        first bucket interpolates from 0; a quantile landing in the
        +Inf overflow bucket returns the largest finite bound (there is
        no upper edge to interpolate toward). NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        if not self.count:
            return float("nan")
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.bucket_counts):
            if not c:
                continue
            if acc + c >= target:
                if i >= len(self.bounds):      # +Inf overflow bucket
                    return float(self.bounds[-1]) if self.bounds \
                        else float("nan")
                lo = float(self.bounds[i - 1]) if i else 0.0
                hi = float(self.bounds[i])
                frac = (target - acc) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            acc += c
        return float(self.bounds[-1]) if self.bounds else float("nan")


_SERIES_CLS = {"counter": _CounterSeries, "gauge": _GaugeSeries,
               "histogram": _HistogramSeries}


class _Family:
    """One named metric: a set of series keyed by label values."""

    def __init__(self, name: str, kind: str, help: str, unit: str,
                 labelnames: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.unit = unit
        self.labelnames = labelnames
        self.buckets = tuple(sorted(buckets)) if buckets else None
        self._series: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not labelnames:
            self._default = self._make()
            self._series[()] = self._default

    def _make(self):
        if self.kind == "histogram":
            return _HistogramSeries(self.buckets or DEFAULT_BUCKETS)
        return _SERIES_CLS[self.kind]()

    def labels(self, **kw):
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(kw)}, declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kw[n]) for n in self.labelnames)
        series = self._series.get(key)
        if series is None:
            with self._lock:
                series = self._series.setdefault(key, self._make())
        return series

    def series(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        return list(self._series.items())

    # -- no-label families proxy their single series -------------------
    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    def set(self, value: float) -> None:
        self._default.set(value)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    def quantile(self, q: float) -> float:
        return self._default.quantile(q)

    @property
    def value(self) -> float:
        return self._default.value

    @property
    def sum(self) -> float:
        return self._default.sum

    @property
    def count(self) -> int:
        return self._default.count

    @property
    def mean(self) -> float:
        return self._default.mean


Counter = Gauge = Histogram = _Family  # exported aliases for isinstance/docs


class MetricsRegistry:
    """Named metric families; see module docstring."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    # -- registration --------------------------------------------------
    def _register(self, name: str, kind: str, help: str, unit: str,
                  labelnames, buckets=None) -> _Family:
        labelnames = tuple(labelnames or ())
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, not "
                        f"{kind}{labelnames}")
                if (kind == "histogram" and buckets is not None
                        and tuple(sorted(buckets)) != fam.buckets):
                    # silently keeping the first buckets would bin the
                    # second caller's observations into bounds it never
                    # asked for — as loud as a kind mismatch
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam.buckets}, not "
                        f"{tuple(sorted(buckets))}")
                return fam
            fam = _Family(name, kind, help, unit, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", unit: str = "",
                labelnames=()) -> _Family:
        return self._register(name, "counter", help, unit, labelnames)

    def gauge(self, name: str, help: str = "", unit: str = "",
              labelnames=()) -> _Family:
        return self._register(name, "gauge", help, unit, labelnames)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  labelnames=(), buckets=DEFAULT_BUCKETS) -> _Family:
        return self._register(name, "histogram", help, unit, labelnames,
                              buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def family_total(self, name: str) -> float:
        """Sum of every series of a (possibly labeled) family; 0.0 when
        the family doesn't exist (benches/gates summing labeled
        counters like the watchdog's per-program series)."""
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        return sum(s.value for _, s in fam.series())

    def families(self) -> List[_Family]:
        return list(self._families.values())

    # -- exports -------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable view of every series (round-trips through
        ``json.dumps``/``loads`` unchanged: plain dicts/lists/str/num)."""
        out = {}
        for fam in self.families():
            series = []
            for values, s in fam.series():
                entry = {"labels": dict(zip(fam.labelnames, values))}
                if fam.kind == "histogram":
                    entry["count"] = s.count
                    entry["sum"] = s.sum
                    entry["buckets"] = {
                        _format_value(b): c for b, c in
                        zip(list(s.bounds) + [_INF], s.bucket_counts)}
                else:
                    entry["value"] = s.value
                series.append(entry)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "unit": fam.unit, "series": series}
        return {"metrics": out}

    def render_prometheus(self) -> str:
        """Text exposition format 0.0.4 (the format Prometheus scrapes).

        Correctness contract (pinned by the round-trip parse test in
        tests/unit/telemetry/test_registry.py): ``# HELP``/``# TYPE``
        appear exactly once per family, immediately before its samples;
        HELP text escapes backslash and newline; label values escape
        backslash, quote, and newline."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, s in fam.series():
                label_s = _label_str(fam.labelnames, values)
                if fam.kind == "histogram":
                    acc = 0
                    for b, c in zip(list(s.bounds) + [_INF],
                                    s.bucket_counts):
                        acc += c  # exposition buckets are cumulative
                        le = f'le="{_format_value(b)}"'
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_label_str(fam.labelnames, values, le)}"
                            f" {acc}")
                    lines.append(f"{fam.name}_sum{label_s} "
                                 f"{_format_value(s.sum)}")
                    lines.append(f"{fam.name}_count{label_s} {s.count}")
                else:
                    lines.append(f"{fam.name}{label_s} "
                                 f"{_format_value(s.value)}")
        return "\n".join(lines) + "\n"

    def scalar_items(self) -> List[Tuple[str, float]]:
        """Flatten every series to (tag, value) pairs for scalar backends
        (the TelemetryBridge's feed). Histograms flatten to their
        ``_count``/``_sum``/``_mean``; labeled series append
        ``/key.value`` segments to the tag."""
        out: List[Tuple[str, float]] = []
        for fam in self.families():
            for values, s in fam.series():
                tag = fam.name
                if values:
                    tag += "/" + "/".join(
                        f"{n}.{v}" for n, v in zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    if s.count:
                        out.append((tag + "_count", float(s.count)))
                        out.append((tag + "_sum", s.sum))
                        out.append((tag + "_mean", s.mean))
                else:
                    out.append((tag, float(s.value)))
        return out

    def reset(self) -> None:
        """Drop every family (tests / fresh serving epoch)."""
        with self._lock:
            self._families.clear()


_default_registry = MetricsRegistry()
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-local default registry every subsystem records into."""
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests isolate with a fresh registry);
    returns the previous one."""
    global _default_registry
    with _registry_lock:
        prev = _default_registry
        _default_registry = registry
    return prev


@contextmanager
def scoped_registry(registry: MetricsRegistry) -> Iterator[MetricsRegistry]:
    """Make ``registry`` the process default for the enclosed block.

    Construction-time scoping for per-replica registries: serving
    components resolve (and cache) their series via ``get_registry()``
    when they are BUILT, so building a replica's serving stack inside
    this scope lands its metrics in the replica's own registry — the
    unit the router's /metrics federation labels. The swap is process-
    global, so scope construction, not steady-state traffic."""
    prev = set_registry(registry)
    try:
        yield registry
    finally:
        set_registry(prev)


def render_federated(sources: Iterable[Tuple[str, MetricsRegistry]],
                     label: str = "replica") -> str:
    """One Prometheus exposition over N registries, each source's series
    labeled ``{label}="<name>"`` — the router's federated /metrics view
    of its replica fleet (same text format contract as
    :meth:`MetricsRegistry.render_prometheus`: TYPE/HELP exactly once
    per family even when several sources register it).

    Sources listing the SAME registry object are deduplicated (shared-
    registry replicas are already covered by the first source naming
    it); families whose kind/labels disagree across sources keep the
    first definition and skip the conflicting series."""
    sources = list(sources)
    seen_regs: Dict[int, str] = {}
    merged: "Dict[str, Tuple[_Family, List[Tuple[str, _Family]]]]" = {}
    order: List[str] = []
    for src_name, reg in sources:
        if id(reg) in seen_regs:
            continue
        seen_regs[id(reg)] = src_name
        for fam in reg.families():
            if fam.name not in merged:
                merged[fam.name] = (fam, [])
                order.append(fam.name)
            first, members = merged[fam.name]
            if (fam.kind == first.kind
                    and fam.labelnames == first.labelnames):
                members.append((src_name, fam))
    lines: List[str] = []
    for name in order:
        first, members = merged[name]
        if first.help:
            lines.append(f"# HELP {name} {_escape_help(first.help)}")
        lines.append(f"# TYPE {name} {first.kind}")
        for src_name, fam in members:
            names = (label,) + fam.labelnames
            for values, s in fam.series():
                vals = (src_name,) + values
                label_s = _label_str(names, vals)
                if fam.kind == "histogram":
                    acc = 0
                    for b, c in zip(list(s.bounds) + [_INF],
                                    s.bucket_counts):
                        acc += c
                        le = f'le="{_format_value(b)}"'
                        lines.append(f"{name}_bucket"
                                     f"{_label_str(names, vals, le)}"
                                     f" {acc}")
                    lines.append(f"{name}_sum{label_s} "
                                 f"{_format_value(s.sum)}")
                    lines.append(f"{name}_count{label_s} {s.count}")
                else:
                    lines.append(f"{name}{label_s} "
                                 f"{_format_value(s.value)}")
    return "\n".join(lines) + "\n"

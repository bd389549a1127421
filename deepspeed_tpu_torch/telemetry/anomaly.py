"""Online anomaly detection over the registry + flight-recorder signals.

The passive layer (metrics, spans, recorder events) only *stores*
evidence; this module watches it and raises typed verdicts while the
process is still alive — the difference between "the dashboard looked
odd yesterday" and an ``anomaly`` event with attribution written the
moment it happened. Four detectors (docs/TELEMETRY.md § Anomaly
detectors):

  * :class:`LossAnomalyDetector` — non-finite or z-score-spiking
    training loss/grad-norm, with per-parameter-bucket attribution: the
    train step exports each gradient leaf's squared norm, the detector
    keeps rolling per-bucket statistics and names the top offending
    buckets (non-finite first, then largest z-score).
  * :class:`SLOBurnRateMonitor` — multi-window (fast/slow) SLO
    burn-rate alerting over the serving TTFT/TPOT histograms, using the
    registry's bucket counts (quantile-style interpolation, no raw
    samples). Burn rate = (fraction of observations over the SLO bound)
    / (error budget); 1.0 means exactly consuming budget, >1 burning it.
  * :class:`StallWatchdog` — a daemon thread watching heartbeat
    channels (serving decode loop, training host sync). No beat within
    ``max(min_deadline, factor × rolling-median interval)`` while the
    channel is active ⇒ ``stall`` anomaly carrying a stack dump of
    every live thread (the wedged frame is in there).
  * :class:`KVLeakDetector` — at serving drain, reconciles the KV block
    pool against the scheduler's in-flight set: sequences still tracked
    with no owner, or allocated blocks no live sequence or prefix-cache
    entry accounts for, are leaks.

Every verdict goes through :func:`report`: the
``anomaly_events_total{kind=...}`` counter, an ``anomaly`` flight-
recorder event, a bounded recent-verdicts ledger (``/statusz`` and
post-mortem bundles read it), and a warning log.

Port note: a copy of ``deepspeed_tpu/telemetry/anomaly.py`` (which imports no
jax); the metric names and documents are the same in both packages.
"""

import math
import sys
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..utils.logging import logger
from . import recorder as ds_recorder
from .registry import get_registry


@dataclass
class DiagnosticsConfig:
    """The ``diagnostics`` config block (runtime JSON config and
    ``ServingConfig.diagnostics``): flight recorder + anomaly detector +
    post-mortem knobs. Everything is on by default — the point of a
    black box is that it was recording BEFORE the incident."""

    enabled: bool = True
    # flight recorder (telemetry/recorder.py)
    recorder_max_bytes: int = 2 << 20
    # loss/grad anomaly (LossAnomalyDetector)
    loss_window: int = 64          # rolling window for loss z-scores
    loss_zscore: float = 8.0       # spike threshold in sigmas
    grad_attribution: bool = True  # export per-leaf grad norms from jit
    attribution_top_k: int = 3     # buckets named per verdict
    # SLO burn rate (SLOBurnRateMonitor)
    ttft_slo_s: float = 1.0        # TTFT objective bound
    tpot_slo_s: float = 0.25       # per-output-token objective bound
    slo_target: float = 0.99       # attainment target (error budget 1%)
    burn_threshold: float = 2.0    # alert when BOTH windows exceed this
    slo_fast_window_s: float = 30.0
    slo_slow_window_s: float = 600.0
    # a window with fewer observations than this reads burn 0: one
    # compile-inflated first token out of a handful of samples is
    # noise, not a 14x burn (a 1% error budget needs >= ~100 samples
    # before a fraction means anything)
    slo_min_samples: int = 50
    # stall watchdog (StallWatchdog)
    stall_enabled: bool = True
    stall_factor: float = 8.0          # k x rolling-median interval
    # floor on the deadline. Generous by default: a channel with no
    # beat history yet (first serving step, first train batch) may be
    # sitting in a cold kernel build, which legitimately takes tens of
    # seconds — tune down once warm if faster detection matters
    stall_min_deadline_s: float = 60.0
    stall_check_interval_s: float = 0.25
    # post-mortem bundles (telemetry/postmortem.py)
    postmortem_dir: str = "postmortems"
    postmortem_on_anomaly: bool = False
    # install the process-wide unhandled-exception/atexit bundle hooks
    # (postmortem.install_crash_handler); off by default because the
    # hooks are global, not per-engine
    postmortem_on_crash: bool = False
    postmortem_min_interval_s: float = 60.0
    postmortem_last_events: int = 512

    def __post_init__(self):
        if not 0.0 < self.slo_target < 1.0:
            raise ValueError(
                f"diagnostics.slo_target must be in (0, 1), got "
                f"{self.slo_target}")
        if self.slo_fast_window_s > self.slo_slow_window_s:
            raise ValueError(
                "diagnostics.slo_fast_window_s must not exceed "
                "slo_slow_window_s")


# ---------------------------------------------------------------------------
# verdict ledger
# ---------------------------------------------------------------------------
_RECENT_CAP = 64
_recent: deque = deque(maxlen=_RECENT_CAP)
_recent_lock = threading.Lock()


def report(kind: str, summary: str, **details) -> Dict:
    """Raise one anomaly verdict: counter + recorder event + recent
    ledger + warning log. Returns the verdict dict."""
    get_registry().counter(
        "anomaly_events_total",
        "anomaly-detector verdicts raised (see docs/TELEMETRY.md)",
        labelnames=("kind",)).labels(kind=kind).inc()
    verdict = {"kind": kind, "summary": summary, "wall": time.time(),
               **details}
    ds_recorder.record("anomaly", anomaly=kind, summary=summary, **details)
    with _recent_lock:
        _recent.append(verdict)
    logger.warning(f"ANOMALY[{kind}]: {summary}")
    return verdict


def recent(n: int = _RECENT_CAP) -> List[Dict]:
    """Most recent verdicts, oldest first (bounded ledger)."""
    with _recent_lock:
        return list(_recent)[-int(n):]


def reset() -> None:
    """Drop the verdict ledger (test isolation)."""
    with _recent_lock:
        _recent.clear()


# ---------------------------------------------------------------------------
# training: loss / gradient anomalies with parameter-bucket attribution
# ---------------------------------------------------------------------------
class _Rolling:
    """Fixed-window mean/std (loss z-scores)."""

    __slots__ = ("values",)

    def __init__(self, window: int):
        self.values: deque = deque(maxlen=max(int(window), 4))

    def push(self, v: float) -> None:
        self.values.append(float(v))

    def zscore(self, v: float) -> Optional[float]:
        n = len(self.values)
        if n < 8:
            return None
        mean = sum(self.values) / n
        var = sum((x - mean) ** 2 for x in self.values) / n
        std = math.sqrt(var)
        if std <= 0:
            return None
        return (v - mean) / std


class LossAnomalyDetector:
    """Per-step training anomaly check; see module docstring.

    ``leaf_names`` are the gradient pytree's leaf paths (the
    "parameter buckets" attribution names); ``update`` takes the same
    step's per-leaf squared norms when the engine exports them
    (``diagnostics.grad_attribution``)."""

    def __init__(self, config: Optional[DiagnosticsConfig] = None,
                 leaf_names: Optional[Sequence[str]] = None):
        self.config = config or DiagnosticsConfig()
        self.leaf_names = list(leaf_names or ())
        self._loss = _Rolling(self.config.loss_window)
        self._gnorm = _Rolling(self.config.loss_window)
        # per-bucket EMA of mean/var — O(buckets) floats, no windows
        self._b_mean: Dict[int, float] = {}
        self._b_var: Dict[int, float] = {}
        self._decay = 0.98

    # -- attribution ---------------------------------------------------
    def _bucket_name(self, i: int) -> str:
        return (self.leaf_names[i] if i < len(self.leaf_names)
                else f"leaf[{i}]")

    def _attribute(self, leaf_sqnorms) -> List[Dict]:
        """Rank parameter buckets: non-finite norms first, then largest
        z-score against each bucket's own EMA statistics."""
        if leaf_sqnorms is None:
            return []
        scored: List[Tuple[float, Dict]] = []
        for i, sq in enumerate(leaf_sqnorms):
            sq = float(sq)
            norm = math.sqrt(sq) if (math.isfinite(sq) and sq >= 0) \
                else float("nan")
            if not math.isfinite(norm):
                scored.append((float("inf"),
                               {"bucket": self._bucket_name(i),
                                "grad_norm": None, "z": None,
                                "non_finite": True}))
                continue
            mean = self._b_mean.get(i, norm)
            var = self._b_var.get(i, 0.0)
            # std floored at 5% of the mean: a bucket whose norm never
            # moved (var 0) must still rank by deviation when it jumps
            std = max(math.sqrt(var), 0.05 * abs(mean), 1e-12)
            z = (norm - mean) / std
            scored.append((z, {"bucket": self._bucket_name(i),
                               "grad_norm": norm, "z": round(z, 2),
                               "non_finite": False}))
        scored.sort(key=lambda s: -s[0])
        return [rec for _, rec in scored[:self.config.attribution_top_k]]

    def _absorb_buckets(self, leaf_sqnorms) -> None:
        if leaf_sqnorms is None:
            return
        d = self._decay
        for i, sq in enumerate(leaf_sqnorms):
            sq = float(sq)
            if not (math.isfinite(sq) and sq >= 0):
                continue   # never poison the baseline with the anomaly
            norm = math.sqrt(sq)
            mean = self._b_mean.get(i)
            if mean is None:
                self._b_mean[i] = norm
                self._b_var[i] = 0.0
            else:
                delta = norm - mean
                self._b_mean[i] = mean + (1 - d) * delta
                self._b_var[i] = d * (self._b_var.get(i, 0.0)
                                      + (1 - d) * delta * delta)

    # -- the per-step check --------------------------------------------
    def update(self, step: int, loss: float, grad_norm: float,
               leaf_sqnorms=None, skipped: bool = False) -> Optional[Dict]:
        """Check one completed train step; returns the verdict (already
        reported) or None. Finite healthy steps feed the rolling
        baselines; anomalous values never do."""
        loss = float(loss)
        grad_norm = float(grad_norm)
        verdict = None
        if skipped and math.isfinite(loss):
            # fp16 dynamic loss scaling doing its job: an overflowed
            # grad with a finite loss is a skip-step, not an anomaly
            # (the engine records it as a train_step event with
            # skipped=true; training_skipped_steps_total counts it)
            return None
        if not math.isfinite(loss) or not math.isfinite(grad_norm):
            kind = "nan_loss" if not math.isfinite(loss) else "nan_grad"
            top = self._attribute(leaf_sqnorms)
            names = ", ".join(t["bucket"] for t in top) or "unattributed"
            verdict = report(
                kind,
                f"step {step}: non-finite "
                f"{'loss' if kind == 'nan_loss' else 'grad norm'} "
                f"(loss={loss}, grad_norm={grad_norm}); top buckets: "
                f"{names}",
                step=int(step), loss=loss, grad_norm=grad_norm,
                top_buckets=top, skipped=bool(skipped))
        else:
            z = self._loss.zscore(loss)
            gz = self._gnorm.zscore(grad_norm)
            if z is not None and z > self.config.loss_zscore:
                top = self._attribute(leaf_sqnorms)
                verdict = report(
                    "loss_spike",
                    f"step {step}: loss {loss:.5g} is {z:.1f} sigma over "
                    f"the rolling window; top buckets: "
                    f"{', '.join(t['bucket'] for t in top) or 'n/a'}",
                    step=int(step), loss=loss, grad_norm=grad_norm,
                    zscore=round(z, 2), top_buckets=top)
            elif gz is not None and gz > self.config.loss_zscore:
                top = self._attribute(leaf_sqnorms)
                verdict = report(
                    "grad_spike",
                    f"step {step}: grad norm {grad_norm:.5g} is "
                    f"{gz:.1f} sigma over the rolling window; top "
                    f"buckets: "
                    f"{', '.join(t['bucket'] for t in top) or 'n/a'}",
                    step=int(step), loss=loss, grad_norm=grad_norm,
                    zscore=round(gz, 2), top_buckets=top)
            else:
                self._loss.push(loss)
                self._gnorm.push(grad_norm)
                self._absorb_buckets(leaf_sqnorms)
        return verdict


# ---------------------------------------------------------------------------
# serving: SLO burn-rate monitoring from histogram bucket counts
# ---------------------------------------------------------------------------
def estimate_over(series, threshold: float) -> float:
    """Estimated number of a histogram series' observations exceeding
    ``threshold``, interpolating linearly inside the straddling bucket
    (±bucket-width error — the same estimate ``quantile`` makes in the
    other direction)."""
    bounds = series.bounds
    counts = series.bucket_counts
    under = 0.0
    for i, c in enumerate(counts[:len(bounds)]):
        hi = float(bounds[i])
        if hi <= threshold:
            under += c
            continue
        lo = float(bounds[i - 1]) if i else 0.0
        if lo < threshold < hi and c:
            under += c * (threshold - lo) / (hi - lo)
        break
    return max(float(series.count) - under, 0.0)


class SLOBurnRateMonitor:
    """Multi-window SLO burn-rate over registry latency histograms.

    ``tick()`` snapshots each watched histogram's (count, est. count
    over the SLO bound), computes the bad fraction over the fast and
    slow windows, publishes ``slo_burn_rate{signal=...,window=...}``
    gauges, and raises one ``slo_burn`` verdict per excursion when BOTH
    windows exceed ``burn_threshold`` (the classic fast+slow gate: fast
    for reaction time, slow so a blip cannot page). The alert re-arms
    when the fast window drops back under the threshold.

    Burn rate 1.0 = consuming error budget exactly at the sustainable
    rate; e.g. with ``slo_target=0.99``, 3% of requests over the bound
    is a burn rate of 3. No traffic in a window reads as burn 0.

    **Fleet mode**: pass ``registries`` (N per-replica registries) and
    the monitor burns over the AGGREGATED histograms — bucket counts
    summed across every replica's TTFT/TPOT series — so the alert fires
    on the fleet's attainment, not any one replica's. The router owns
    one (``fleet_slo_burn_rate`` gauges, ``fleet_slo_burn`` verdicts,
    distinct names so per-replica monitors sharing a registry never
    collide with it)."""

    def __init__(self, config: Optional[DiagnosticsConfig] = None,
                 registry=None, clock=time.monotonic,
                 signals: Optional[Iterable[Tuple[str, str, float]]]
                 = None, registries: Optional[Iterable] = None,
                 gauge_name: str = "slo_burn_rate",
                 verdict_kind: str = "slo_burn"):
        self.config = config or DiagnosticsConfig()
        self.registry = registry or get_registry()
        # the registries the latency histograms are READ from (fleet
        # mode: one per replica); gauges/verdicts always publish into
        # self.registry / the process ledger
        self.registries = (list(registries) if registries is not None
                           else [self.registry])
        self.verdict_kind = verdict_kind
        self.clock = clock
        cfg = self.config
        self.signals = list(signals) if signals is not None else [
            ("ttft", "serving_ttft_seconds", cfg.ttft_slo_s),
            ("tpot", "serving_tpot_seconds", cfg.tpot_slo_s),
        ]
        self._snaps: Dict[str, deque] = {s[0]: deque()
                                         for s in self.signals}
        self._alerting: Dict[str, bool] = {s[0]: False
                                           for s in self.signals}
        # tick() runs on the serving-loop thread AND on /statusz's
        # asyncio thread; the snapshot rings need one owner at a time
        self._lock = threading.Lock()
        # literal registrations for the two known names keep
        # scripts/check_telemetry_docs.py's literal scan honest (a
        # variable name would read as an unregistered catalog row)
        if gauge_name == "fleet_slo_burn_rate":
            self._gauge = self.registry.gauge(
                "fleet_slo_burn_rate",
                "SLO error-budget burn rate per signal and window, "
                "aggregated across the replica fleet's histograms "
                "(1.0 = consuming budget exactly at the sustainable "
                "rate)", labelnames=("signal", "window"))
        elif gauge_name == "slo_burn_rate":
            self._gauge = self.registry.gauge(
                "slo_burn_rate",
                "SLO error-budget burn rate per signal and window "
                "(1.0 = consuming budget exactly at the sustainable "
                "rate)", labelnames=("signal", "window"))
        else:
            self._gauge = self.registry.gauge(
                gauge_name,
                "SLO error-budget burn rate per signal and window "
                "(1.0 = consuming budget exactly at the sustainable "
                "rate)", labelnames=("signal", "window"))

    @staticmethod
    def _family_series(reg, metric: str):
        fam = reg.get(metric)
        if fam is None:
            return None
        return fam._series.get(()) or next(
            (s for _, s in fam.series()), None)

    def _series(self, metric: str):
        """The metric's histogram series — or, in fleet mode, a merged
        view with bucket counts summed across every source registry
        (sources whose bucket bounds disagree are skipped: summing
        misaligned bins would fabricate a distribution)."""
        found = []
        for reg in self.registries:
            s = self._family_series(reg, metric)
            if s is not None:
                found.append(s)
        if not found:
            return None
        if len(found) == 1:
            return found[0]
        from .registry import _HistogramSeries
        merged = _HistogramSeries(found[0].bounds)
        for s in found:
            if tuple(s.bounds) != tuple(merged.bounds):
                continue
            merged.bucket_counts = [
                a + b for a, b in zip(merged.bucket_counts,
                                      s.bucket_counts)]
            merged.sum += s.sum
            merged.count += s.count
        return merged

    def _window_burn(self, snaps: deque, now: float, window_s: float,
                     budget: float) -> float:
        """Burn over [now - window_s, now] from the snapshot ring.

        The base is the newest snapshot at-or-before the window edge,
        falling back to the OLDEST snapshot when the monitor is younger
        than the window — never 0: a fresh monitor attached to a
        long-lived shared registry must burn over what it OBSERVED, not
        over the registry's whole pre-history (a histogram full of
        earlier traffic would otherwise fire a phantom verdict on the
        very first tick)."""
        cur_t, cur_n, cur_over = snaps[-1]
        base_n, base_over = snaps[0][1], snaps[0][2]
        cutoff = now - window_s
        for t, n, over in reversed(snaps):
            if t <= cutoff:
                base_n, base_over = n, over
                break
        dn = cur_n - base_n
        if dn < max(self.config.slo_min_samples, 1):
            return 0.0    # too few observations for a fraction to mean
            # anything (and a cold monitor must not page on a blip)
        bad_frac = max(cur_over - base_over, 0.0) / dn
        return bad_frac / budget

    def tick(self) -> Dict[str, Dict[str, float]]:
        """One monitoring pass; returns {signal: {fast, slow}} burns."""
        with self._lock:
            return self._tick_locked()

    def _tick_locked(self) -> Dict[str, Dict[str, float]]:
        cfg = self.config
        now = self.clock()
        budget = 1.0 - cfg.slo_target
        out: Dict[str, Dict[str, float]] = {}
        for name, metric, slo in self.signals:
            series = self._series(metric)
            snaps = self._snaps[name]
            if series is None:
                continue
            snaps.append((now, float(series.count),
                          estimate_over(series, slo)))
            horizon = now - cfg.slo_slow_window_s - 1.0
            while len(snaps) > 2 and snaps[1][0] <= horizon:
                snaps.popleft()
            fast = self._window_burn(snaps, now, cfg.slo_fast_window_s,
                                     budget)
            slow = self._window_burn(snaps, now, cfg.slo_slow_window_s,
                                     budget)
            self._gauge.labels(signal=name, window="fast").set(fast)
            self._gauge.labels(signal=name, window="slow").set(slow)
            out[name] = {"fast": fast, "slow": slow}
            over = (fast > cfg.burn_threshold
                    and slow > cfg.burn_threshold)
            if over and not self._alerting[name]:
                self._alerting[name] = True
                report(self.verdict_kind,
                       f"{name} SLO burn rate {fast:.1f}x (fast) / "
                       f"{slow:.1f}x (slow) exceeds "
                       f"{cfg.burn_threshold}x of the "
                       f"{1 - cfg.slo_target:.1%} error budget "
                       f"(bound {slo}s)",
                       signal=name, slo_s=slo, burn_fast=round(fast, 2),
                       burn_slow=round(slow, 2),
                       threshold=cfg.burn_threshold)
            elif self._alerting[name] and fast <= cfg.burn_threshold:
                self._alerting[name] = False
                ds_recorder.record("slo_recovered", signal=name,
                                   burn_fast=round(fast, 2),
                                   burn_slow=round(slow, 2))
        return out

    def burning(self) -> bool:
        """True while ANY watched signal's fast+slow alert is latched
        (between the ``slo_burn`` verdict and its fast-window
        recovery) — the router autoscaler's scale-up signal."""
        return any(self._alerting.values())

    def quantiles(self) -> Dict[str, Dict[str, float]]:
        """p50/p95/p99 per watched signal from the histogram buckets
        (the /statusz SLO section — no raw-sample lists)."""
        out: Dict[str, Dict[str, float]] = {}
        for name, metric, slo in self.signals:
            series = self._series(metric)
            if series is None or not series.count:
                continue
            out[name] = {
                "p50": series.quantile(0.5),
                "p95": series.quantile(0.95),
                "p99": series.quantile(0.99),
                "slo_s": slo, "count": series.count,
            }
        return out


# ---------------------------------------------------------------------------
# stall / straggler watchdog
# ---------------------------------------------------------------------------
def thread_stacks(max_frames: int = 20) -> Dict[str, List[str]]:
    """Formatted stack of every live thread (the post-mortem evidence a
    stall verdict carries: the wedged frame is one of these). Duplicate
    thread names — N serving replicas each run a 'ds-tpu-serving-loop'
    thread — are disambiguated with the thread ident so no stack
    silently overwrites another."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        stack = traceback.format_stack(frame)[-max_frames:]
        name = names.get(ident, f"thread-{ident}")
        if name in out:
            name = f"{name}#{ident}"
        out[name] = [line.rstrip() for line in stack]
    return out


class _Channel:
    __slots__ = ("last_beat", "intervals", "active", "stalled",
                 "min_deadline", "factor")

    def __init__(self, min_deadline: float, factor: float):
        self.last_beat: Optional[float] = None
        self.intervals: deque = deque(maxlen=32)
        self.active = False
        self.stalled = False
        self.min_deadline = min_deadline
        self.factor = factor

    def deadline(self) -> float:
        if self.intervals:
            ordered = sorted(self.intervals)
            median = ordered[len(ordered) // 2]
            return max(self.min_deadline, self.factor * median)
        return self.min_deadline


class StallWatchdog:
    """Heartbeat-deadline watchdog; see module docstring.

    A channel only arms while ``set_active(channel, True)`` — an idle
    serving loop or a training engine between batches is silence, not a
    stall. The deadline adapts: ``factor ×`` the rolling median of the
    channel's own beat intervals, floored at ``min_deadline_s``, so a
    workload whose windows take 2s is judged on its own cadence."""

    def __init__(self, config: Optional[DiagnosticsConfig] = None,
                 clock=time.monotonic):
        self.config = config or DiagnosticsConfig()
        self.clock = clock
        self._channels: Dict[str, _Channel] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def register(self, channel: str,
                 min_deadline_s: Optional[float] = None,
                 factor: Optional[float] = None) -> None:
        with self._lock:
            if channel not in self._channels:
                self._channels[channel] = _Channel(
                    min_deadline_s if min_deadline_s is not None
                    else self.config.stall_min_deadline_s,
                    factor if factor is not None
                    else self.config.stall_factor)

    def beat(self, channel: str) -> None:
        now = self.clock()
        with self._lock:
            ch = self._channels.get(channel)
            if ch is None:
                ch = self._channels[channel] = _Channel(
                    self.config.stall_min_deadline_s,
                    self.config.stall_factor)
            if ch.last_beat is not None:
                ch.intervals.append(now - ch.last_beat)
            ch.last_beat = now
            recovered = ch.stalled
            ch.stalled = False
        if recovered:
            ds_recorder.record("stall_recovered", channel=channel)

    def set_active(self, channel: str, active: bool) -> None:
        with self._lock:
            ch = self._channels.get(channel)
            if ch is None:
                return
            if active and not ch.active:
                ch.last_beat = self.clock()   # arm from now, not history
            ch.active = active

    def heartbeat_age(self, channel: str) -> Optional[float]:
        """Seconds since the channel's last heartbeat while ARMED, or
        None when the channel is unknown, idle (idle is silence, not a
        stall) or has never beaten. The serving router reads this to
        declare a replica dead: a loop wedged mid-step stays active
        with a growing age, while an idle loop reads None."""
        now = self.clock()
        with self._lock:
            ch = self._channels.get(channel)
            if ch is None or ch.last_beat is None or not ch.active:
                return None
            return now - ch.last_beat

    # -- scanning ------------------------------------------------------
    def check_now(self) -> List[Dict]:
        """One scan (what the thread runs each interval); returns the
        verdicts raised. Exposed for deterministic tests."""
        now = self.clock()
        victims: List[Tuple[str, float, float]] = []
        with self._lock:
            for name, ch in self._channels.items():
                if not ch.active or ch.stalled or ch.last_beat is None:
                    continue
                waited = now - ch.last_beat
                deadline = ch.deadline()
                if waited > deadline:
                    ch.stalled = True
                    victims.append((name, waited, deadline))
        verdicts = []
        for name, waited, deadline in victims:
            verdicts.append(report(
                "stall",
                f"channel {name!r}: no heartbeat for {waited:.2f}s "
                f"(deadline {deadline:.2f}s = max(min_deadline, "
                f"factor x rolling-median interval)); thread stacks "
                f"attached",
                channel=name, waited_s=round(waited, 3),
                deadline_s=round(deadline, 3), stacks=thread_stacks()))
        return verdicts

    def _run(self) -> None:
        while not self._stop.wait(self.config.stall_check_interval_s):
            try:
                self.check_now()
            except Exception:   # the watchdog must never kill the host
                logger.exception("stall watchdog scan failed")

    def start(self) -> "StallWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="ds-tpu-stall-watchdog",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# ---------------------------------------------------------------------------
# KV-pool leak detection
# ---------------------------------------------------------------------------
class KVLeakDetector:
    """Reconcile the KV block pool against the scheduler at drain.

    At a clean drain nothing is in flight, so every tracked sequence is
    an orphan and every allocated block must be explained by a tracked
    sequence or a prefix-cache index entry. Anything else leaked — the
    free path was skipped somewhere (a cancel that didn't flush, an
    exception between allocate and release)."""

    def __init__(self, config: Optional[DiagnosticsConfig] = None):
        self.config = config or DiagnosticsConfig()

    def check_at_drain(self, state_manager,
                       inflight_uids: Iterable[int] = ()) -> Optional[Dict]:
        """Returns the reported ``kv_leak`` verdict, or None when the
        pool reconciles."""
        inflight = set(int(u) for u in inflight_uids)
        orphans = {int(uid): len(seq.blocks)
                   for uid, seq in state_manager.seqs.items()
                   if int(uid) not in inflight}
        usable = max(state_manager.config.num_blocks - 1, 0)
        allocated = usable - state_manager.free_blocks()
        accounted = set()
        for seq in state_manager.seqs.values():
            accounted.update(int(b) for b in seq.blocks)
        for blk in getattr(state_manager, "_prefix", {}).values():
            accounted.add(int(blk))
        unaccounted = allocated - len(accounted)
        if not orphans and unaccounted <= 0:
            ds_recorder.record("kv_drain_clean", allocated=int(allocated),
                               prefix_retained=len(
                                   getattr(state_manager, "_prefix", {})))
            return None
        detail = (f"{len(orphans)} orphaned sequence(s) holding "
                  f"{sum(orphans.values())} block(s)"
                  if orphans else "")
        if unaccounted > 0:
            detail += (" and " if detail else "") + \
                f"{unaccounted} allocated block(s) owned by nothing"
        return report(
            "kv_leak",
            f"KV pool failed to reconcile at drain: {detail} "
            f"(allocated={allocated}, inflight={len(inflight)})",
            orphan_uids=sorted(orphans),
            orphan_blocks=int(sum(orphans.values())),
            unaccounted_blocks=max(int(unaccounted), 0),
            allocated_blocks=int(allocated))

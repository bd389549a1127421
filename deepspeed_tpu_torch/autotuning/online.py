"""SLO-driven online adaptation.

Port of ``deepspeed_tpu/autotuning/online.py``, a copy. The offline tuner
picks good steady-state knobs; this adapter covers the gap between tuning
runs by nudging the two knobs the registry marks ``online=True`` — the
fused decode window K and the admission token-budget shed threshold —
from LIVE signals, between scheduler steps, on the serving-loop thread
(the only thread allowed to touch the engine).

Sense: ``SLOBurnRateMonitor.burning()`` (the latched fast+slow burn
alert) and the ``inference_ragged_pad_fraction`` gauge.
Decide: hysteresis-armed like the burn monitor itself — while burning,
step DOWN one rung per ``hold_ticks`` (smaller K returns tokens to
clients sooner and frees step capacity; a tighter admission budget
sheds load at the door instead of queueing it into the latency tail);
after ``restore_ticks`` consecutive clean ticks, restore one rung back
toward the configured baseline and re-arm when fully restored. A high
pad fraction reorders restoration (admission budget first — underfilled
steps mean the queue is starved, not the device).
Actuate: ``engine.set_decode_window`` / ``admission
.set_max_queued_tokens`` — both registry-bounded, both flight-recorded.

Once ``watchdog.is_steady()``, the adapter only moves K across
``engine.warmed_decode_windows()`` — windows that have already run on
live traffic (on the TPU a cold window is a compile; here the first
launches at a new shape, which the watchdog counts the same way). Cold
rungs are only reachable during warmup.
"""

import time
from dataclasses import dataclass
from typing import List, Optional

from ..runtime import tunables
from ..telemetry import recorder as flight
from ..telemetry import watchdog

_WINDOW_KNOB = "serving.decode_window"
_BUDGET_KNOB = "serving.max_queued_tokens"


@dataclass
class OnlineAdapterConfig:
    enabled: bool = True
    interval_s: float = 1.0       # decision cadence (matches SLO tick)
    hold_ticks: int = 2           # ticks between successive down-moves
    restore_ticks: int = 3        # clean ticks per restore step
    min_decode_window: int = 2    # adapter floor (1 = per-token path)
    budget_shrink: float = 0.5    # admission-budget cut per down-move
    min_queued_tokens: int = 64   # admission-budget floor
    pad_high: float = 0.6         # pad fraction that reorders restores

    def __post_init__(self):
        self.min_decode_window = tunables.check(
            _WINDOW_KNOB, self.min_decode_window,
            label="min_decode_window")
        self.min_queued_tokens = tunables.check(
            _BUDGET_KNOB, self.min_queued_tokens,
            label="min_queued_tokens")


class OnlineAdapter:
    """Duck-typed over the engine (``decode_window``,
    ``set_decode_window``, ``warmed_decode_windows``) and the admission
    controller (``config.max_queued_tokens``, ``set_max_queued_tokens``,
    ``queued_tokens``) so the decision logic tests device-free. ``slo``
    needs only ``burning() -> bool``."""

    def __init__(self, engine, admission=None, slo=None,
                 config: Optional[OnlineAdapterConfig] = None,
                 clock=time.monotonic):
        self.engine = engine
        self.admission = admission
        self.slo = slo
        self.config = config or OnlineAdapterConfig()
        self.clock = clock
        # the configured operating point restoration returns to
        self.base_window = int(engine.decode_window)
        self.base_budget = (None if admission is None
                           else admission.config.max_queued_tokens)
        self.armed = True
        self.adaptations = 0
        self._last_tick = None
        self._hold = 0
        self._clean = 0
        self._init_telemetry()

    def _init_telemetry(self):
        from ..telemetry import get_registry
        reg = get_registry()
        self._m_adapt = reg.counter(
            "autotune_online_adaptations_total",
            "online tunable nudges applied by the SLO-driven adapter",
            labelnames=("knob", "direction"))
        self._m_armed = reg.gauge(
            "autotune_online_armed",
            "1 while the online adapter is armed (hysteresis re-armed "
            "after a full restore), 0 while backed off")
        self._m_budget = reg.gauge(
            "autotune_admission_token_budget",
            "effective admission queued-token budget (0 = shedding "
            "disabled)")
        self._m_armed.set(1)
        self._m_budget.set(self.base_budget or 0)

    # -- signals -------------------------------------------------------
    def _burning(self) -> bool:
        try:
            return bool(self.slo is not None and self.slo.burning())
        except Exception:
            return False

    def _pad_fraction(self) -> float:
        from ..telemetry import get_registry
        fam = get_registry().get("inference_ragged_pad_fraction")
        try:
            return float(fam.value) if fam is not None else 0.0
        except Exception:
            return 0.0

    # -- decode-window ladder ------------------------------------------
    def _window_candidates(self) -> List[int]:
        """K values the adapter may occupy: at steady state only
        already-warmed windows (zero-recompile guarantee); during
        warmup also the power-of-two ladder inside the registry range,
        so the adapter can seed rungs the workload has not hit yet."""
        t = tunables.REGISTRY.get(_WINDOW_KNOB)
        lo = max(int(t.lo or 1), self.config.min_decode_window)
        hi = min(int(t.hi or self.base_window), self.base_window)
        warmed = [k for k in self.engine.warmed_decode_windows()
                  if lo <= k <= hi]
        if watchdog.is_steady():
            return sorted(set(warmed) | {self.engine.decode_window})
        ladder = {k for k in (1, 2, 4, 8, 16, 32, 64) if lo <= k <= hi}
        return sorted(ladder | set(warmed) | {self.engine.decode_window})

    # -- actuation -----------------------------------------------------
    def _move_window(self, target: int, direction: str,
                     reason: str) -> bool:
        old = self.engine.decode_window
        if target == old:
            return False
        self.engine.set_decode_window(target, source="online")
        self.adaptations += 1
        self._m_adapt.labels(knob="decode_window", direction=direction) \
            .inc()
        flight.record("autotune_adapt", knob="decode_window", old=old,
                      new=target, reason=reason)
        return True

    def _set_budget(self, budget, direction: str, reason: str) -> bool:
        if self.admission is None:
            return False
        old = self.admission.config.max_queued_tokens
        if budget == old:
            return False
        self.admission.set_max_queued_tokens(budget, source="online")
        self._m_budget.set(budget or 0)
        self.adaptations += 1
        self._m_adapt.labels(knob="max_queued_tokens",
                             direction=direction).inc()
        flight.record("autotune_adapt", knob="max_queued_tokens",
                      old=old, new=budget, reason=reason)
        return True

    def _shrink_budget(self) -> bool:
        if self.admission is None:
            return False
        cur = self.admission.config.max_queued_tokens
        if cur is None:
            # no configured cap: bound the burn at the currently-queued
            # work so the backlog stops growing while the SLO bleeds
            cur = max(int(self.admission.queued_tokens()),
                      self.config.min_queued_tokens * 2)
        new = max(int(cur * self.config.budget_shrink),
                  self.config.min_queued_tokens)
        new = tunables.clamp(_BUDGET_KNOB, new)
        if new >= cur and self.admission.config.max_queued_tokens \
                is not None:
            return False
        return self._set_budget(new, "down", "slo_burn")

    def _restore_budget(self) -> bool:
        if self.admission is None:
            return False
        cur = self.admission.config.max_queued_tokens
        if cur == self.base_budget or cur is None:
            return False
        if self.base_budget is None:
            # restore in doublings; past 4x the floor the cap stops
            # binding and the configured "no cap" returns
            new = cur * 2
            if new > self.config.min_queued_tokens * 16:
                return self._set_budget(None, "up", "recovered")
            return self._set_budget(tunables.clamp(_BUDGET_KNOB, new),
                                    "up", "recovered")
        new = min(cur * 2, self.base_budget)
        return self._set_budget(new, "up", "recovered")

    def _restored(self) -> bool:
        budget_ok = (self.admission is None
                     or self.admission.config.max_queued_tokens
                     == self.base_budget)
        return self.engine.decode_window >= self.base_window and budget_ok

    # -- the decision loop ---------------------------------------------
    def tick(self, now: Optional[float] = None) -> bool:
        """Called by the serving loop between scheduler steps (and on
        idle ticks). Rate-limited to ``interval_s``. Returns True when
        a knob moved."""
        if not self.config.enabled:
            return False
        now = self.clock() if now is None else now
        if (self._last_tick is not None
                and now - self._last_tick < self.config.interval_s):
            return False
        self._last_tick = now
        if self._burning():
            return self._on_burn()
        return self._on_clean()

    def _on_burn(self) -> bool:
        self._clean = 0
        self._m_armed.set(0)
        if self.armed:
            # first burn tick acts immediately; later ones pace on hold
            self.armed = False
            self._hold = 0
        if self._hold > 0:
            self._hold -= 1
            return False
        self._hold = self.config.hold_ticks
        moved = False
        cands = [k for k in self._window_candidates()
                 if k < self.engine.decode_window]
        if cands:
            moved = self._move_window(cands[-1], "down", "slo_burn")
        if self._shrink_budget():
            moved = True
        return moved

    def _on_clean(self) -> bool:
        if self.armed and self._restored():
            return False
        self._clean += 1
        if self._clean < self.config.restore_ticks:
            return False
        self._clean = 0
        moved = False
        restore_budget_first = self._pad_fraction() > self.config.pad_high
        order = ((self._restore_budget, self._restore_window)
                 if restore_budget_first
                 else (self._restore_window, self._restore_budget))
        for step in order:
            if step():
                moved = True
                break
        if self._restored() and not self.armed:
            self.armed = True
            self._m_armed.set(1)
            flight.record("autotune_adapt", knob="adapter", old=0, new=1,
                          reason="rearmed")
        return moved

    def _restore_window(self) -> bool:
        if self.engine.decode_window >= self.base_window:
            return False
        cands = [k for k in self._window_candidates()
                 if self.engine.decode_window < k <= self.base_window]
        if not cands:
            return False
        return self._move_window(cands[0], "up", "recovered")

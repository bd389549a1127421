"""Autoscaler loop over the replica router.

Scales the serving fleet off the signals the router already collects
(serve/router.py): sustained shed /
re-route pressure or a burning fleet SLO scales UP (a factory spawns a
new replica — in-process, or a worker subprocess wrapped in a
:class:`~.remote.RemoteReplica` — and the router's dynamic membership
adds it to the ring); a sustained idle fleet scales DOWN by
drain-then-stop (in-flight streams finish, new traffic diverts, then
the replica stops — a worker process exits); dead replicas (heartbeat
expiry, loop exit) are replaced up to ``min_replicas``.

The decision cadence is :meth:`Autoscaler.tick` — pure and
deterministic given the router state, so tests drive it directly; the
background :meth:`run` task just calls it on ``interval_s``. Every
action is counted (``router_autoscale_{up,down}_total``), the tick
cost is histogrammed (``router_autoscale_tick_seconds``), and each
action records a ``router_autoscale`` span in the router lane so fleet
timelines show scaling next to the traffic that caused it.

Port note: a copy of ``deepspeed_tpu/inference/v2/serve/autoscaler.py``,
which imports no jax.
"""

import asyncio
import itertools
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from ....telemetry import trace

_ROUTER_LANE = "router"


@dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    # consecutive pressure ticks (shed/re-route events, burning fleet
    # SLO, or mean up-replica load above load_high) before scaling up
    scale_up_after_ticks: int = 2
    # consecutive fully-idle ticks (zero load, zero shed) before
    # scaling down
    scale_down_after_ticks: int = 5
    # mean load per up replica that counts as pressure even without
    # sheds (queued tokens + in-flight requests, the router's load
    # signal)
    load_high: float = 64.0
    # minimum seconds between scale actions (replacing dead capacity
    # below min_replicas ignores the cooldown)
    cooldown_s: float = 2.0
    # background run() cadence
    interval_s: float = 0.5
    replace_dead: bool = True
    # spawn-failure quarantine: after a factory/spawn failure the
    # autoscaler backs off exponentially (base * 2^(failures-1), capped)
    # before trying to spawn again — even for dead-capacity
    # replacement, so a broken factory cannot hot-loop
    spawn_backoff_s: float = 1.0
    spawn_backoff_max_s: float = 30.0


class Autoscaler:
    """Spawn/drain replicas off the router's load, shed, SLO-burn and
    heartbeat signals.

    ``factory``: ``async (name) -> replica`` building a NOT-yet-added
    replica — an in-process :class:`~.replica.Replica` or a
    :class:`~.remote.RemoteReplica` over a freshly spawned worker
    process. The autoscaler adds it to the router (which starts it)."""

    def __init__(self, router,
                 factory: Callable[[str], Awaitable],
                 config: Optional[AutoscalerConfig] = None,
                 clock=time.monotonic, name_prefix: str = "auto"):
        self.router = router
        self.factory = factory
        self.config = config or AutoscalerConfig()
        if self.config.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.config.max_replicas < self.config.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.clock = clock
        self.name_prefix = name_prefix
        self._ids = itertools.count(len(router.replicas))
        self._pressure_ticks = 0
        self._idle_ticks = 0
        self._last_events = self._event_count()
        self._last_action_t: Optional[float] = None
        self._spawning = False
        self._spawn_failures = 0
        self._spawn_quarantine_until: Optional[float] = None
        self._last_spawn_error: Optional[str] = None
        self._task: Optional[asyncio.Task] = None
        from ....telemetry import get_registry
        reg = get_registry()
        self._m_up = reg.counter(
            "router_autoscale_up_total",
            "replicas spawned by the autoscaler",
            labelnames=("reason",))
        self._m_down = reg.counter(
            "router_autoscale_down_total",
            "replicas drained and stopped by the autoscaler")
        self._m_replicas = reg.gauge(
            "router_autoscale_replicas",
            "up replicas as last seen by the autoscaler")
        self._m_tick = reg.histogram(
            "router_autoscale_tick_seconds",
            "autoscaler decision-loop cost per tick (excl. spawn/drain "
            "awaits)", unit="s",
            buckets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1))
        self._m_spawn_fail = reg.counter(
            "router_autoscale_spawn_failures_total",
            "factory/spawn failures caught by the autoscaler (the "
            "failure is recorded in last_decision and the spawner "
            "quarantined; it never escapes tick())")

    # -- signals --------------------------------------------------------
    def _event_count(self) -> float:
        """Cumulative overload events at the router: sheds (every
        routable replica rejected) plus re-routes (one replica rejected,
        another absorbed) — the pressure signal."""
        from ....telemetry import get_registry
        reg = get_registry()
        total = 0.0
        for name in ("router_shed_total", "router_reroutes_total"):
            fam = reg.get(name)
            if fam is not None:
                total += sum(s.value for _, s in fam.series())
        return total

    def _slo_burning(self) -> bool:
        slo = getattr(self.router, "fleet_slo", None)
        return bool(slo is not None and slo.burning())

    # -- one decision round ---------------------------------------------
    async def tick(self) -> dict:
        """Observe, update streaks, take at most one scale action.
        Returns the decision record (/statusz + tests read it)."""
        t0 = time.perf_counter()
        await self.router.check_replicas()
        cfg = self.config
        # reap corpses: check_replicas already re-enqueued a dead
        # replica's requests, so keeping it in the member list would
        # only grow the hash ring / health rollups / metric series
        # forever under worker churn
        for r in [r for r in self.router.replicas
                  if r.state in ("dead", "drained")]:
            try:
                self.router.remove_replica(r.name)
            except (KeyError, RuntimeError):
                pass
        up = [r for r in self.router.replicas if r.state == "up"]
        loads = [r.load() for r in up]
        events = self._event_count()
        shed_delta = events - self._last_events
        self._last_events = events
        burning = self._slo_burning()
        mean_load = (sum(loads) / len(up)) if up else float("inf")
        pressure = (shed_delta > 0 or burning
                    or mean_load > cfg.load_high)
        idle = not pressure and sum(loads) == 0 and shed_delta == 0
        if pressure:
            self._pressure_ticks += 1
            self._idle_ticks = 0
        elif idle:
            self._idle_ticks += 1
            self._pressure_ticks = 0
        else:
            self._pressure_ticks = 0
            self._idle_ticks = 0
        self._m_replicas.set(len(up))
        decision = {
            "up_replicas": len(up), "mean_load": round(mean_load, 3)
            if up else None, "shed_delta": shed_delta,
            "slo_burning": burning,
            "pressure_ticks": self._pressure_ticks,
            "idle_ticks": self._idle_ticks, "action": "none",
        }
        self._m_tick.observe(time.perf_counter() - t0)

        now = self.clock()
        cooled = (self._last_action_t is None
                  or now - self._last_action_t >= cfg.cooldown_s)
        # spawn quarantine: a failed factory backs the SPAWNER off (not
        # just the cooldown), and dead-capacity replacement respects it
        # too — plus the breaker state: suspected replicas still count
        # as up capacity, so suspicion never triggers a replacement
        spawn_ok = (self._spawn_quarantine_until is None
                    or now >= self._spawn_quarantine_until)
        decision["spawn_quarantine_s"] = (
            round(max(self._spawn_quarantine_until - now, 0.0), 3)
            if self._spawn_quarantine_until is not None else 0.0)
        if (cfg.replace_dead and len(up) < cfg.min_replicas
                and spawn_ok and not self._spawning):
            decision["action"] = await self._scale_up("replace_dead")
        elif (self._pressure_ticks >= cfg.scale_up_after_ticks
                and len(up) < cfg.max_replicas and cooled and spawn_ok
                and not self._spawning):
            decision["action"] = await self._scale_up("pressure")
            self._pressure_ticks = 0
        elif (self._idle_ticks >= cfg.scale_down_after_ticks
                and len(up) > cfg.min_replicas and cooled):
            decision["action"] = await self._scale_down(up, loads)
            self._idle_ticks = 0
        if decision["action"].startswith("up_failed:"):
            decision["spawn_error"] = self._last_spawn_error
            decision["spawn_quarantine_s"] = round(
                max(self._spawn_quarantine_until - self.clock(), 0.0), 3)
        self.last_decision = decision
        return decision

    def _spawn_call(self, name: str):
        """Call the factory, passing the fleet's current target weight
        version when the factory accepts it — a scale-up after a push
        must join at the LIVE version, not the boot checkpoint (the
        router's ``sync_weights_on_add`` then verifies/pushes either
        way)."""
        import inspect
        target = getattr(self.router, "target_weight_version", None)
        try:
            sig = inspect.signature(self.factory)
            accepts = ("weight_version" in sig.parameters
                       or any(p.kind is inspect.Parameter.VAR_KEYWORD
                              for p in sig.parameters.values()))
        except (TypeError, ValueError):
            accepts = False
        if accepts:
            return self.factory(name, weight_version=target)
        return self.factory(name)

    async def _scale_up(self, reason: str) -> str:
        name = f"{self.name_prefix}{next(self._ids)}"
        t0 = time.perf_counter()
        self._spawning = True
        try:
            replica = await self._spawn_call(name)
            await self.router.add_replica(replica)
        except Exception as e:
            # a spawn failure must never escape tick(): count it,
            # record it, quarantine the spawner with exponential
            # backoff, and STILL advance the cooldown clock so the
            # decision cadence stays honest
            self._spawn_failures += 1
            self._m_spawn_fail.inc()
            backoff = min(
                self.config.spawn_backoff_s
                * 2 ** (self._spawn_failures - 1),
                self.config.spawn_backoff_max_s)
            self._spawn_quarantine_until = self.clock() + backoff
            self._last_action_t = self.clock()
            self._last_spawn_error = f"{type(e).__name__}: {e}"
            trace.record("router_autoscale", t0,
                         time.perf_counter() - t0, lane=_ROUTER_LANE,
                         action="up_failed", replica=name,
                         reason=reason, error=self._last_spawn_error,
                         backoff_s=round(backoff, 3))
            return f"up_failed:{name}"
        finally:
            self._spawning = False
        self._spawn_failures = 0
        self._spawn_quarantine_until = None
        self._last_action_t = self.clock()
        self._m_up.labels(reason=reason).inc()
        trace.record("router_autoscale", t0, time.perf_counter() - t0,
                     lane=_ROUTER_LANE, action="up", replica=name,
                     reason=reason)
        return f"up:{name}"

    async def _scale_down(self, up, loads) -> str:
        # drain the least-loaded up replica (ties: newest name last so
        # the original fixed fleet is preferred to stay)
        name = min(zip(loads, (r.name for r in up)))[1]
        replica = self.router._by_name[name]
        t0 = time.perf_counter()
        try:
            await self.router.drain_replica(name)
            await replica.stop()    # a worker process exits here
        except Exception:
            # the worker died mid-drain: a replica stuck in 'draining'
            # would never be declared dead NOR reaped — mark it dead so
            # membership cleanup still happens
            replica.state = "dead"
            try:
                replica.reap()
            except Exception:
                pass
        self.router.remove_replica(name)
        self._last_action_t = self.clock()
        self._m_down.inc()
        trace.record("router_autoscale", t0, time.perf_counter() - t0,
                     lane=_ROUTER_LANE, action="down", replica=name)
        return f"down:{name}"

    # -- background loop ------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._task is None:
            self._task = asyncio.ensure_future(self.run())
        return self

    async def run(self) -> None:
        while True:
            await asyncio.sleep(self.config.interval_s)
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:    # scaling must never kill the router
                pass

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

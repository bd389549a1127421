"""Retry/backoff and circuit-breaking for remote serving calls.

Two primitives the remote plane (serve/remote.py, serve/router.py)
builds its fault tolerance from:

  * :class:`RetryPolicy` — exponential backoff with jitter over a
    PER-CALL deadline budget shared across attempts: a call that times
    out has consumed its budget (no blind re-timeout stacking), while a
    fast transient failure (reset, refused dial) retries within the
    same budget. Applied only to IDEMPOTENT remote calls — health/load
    probes, metrics/span fetches, drain, and the chunked-handoff send
    (the chunk protocol is idempotent-retransmit by construction, so a
    whole-transfer retry rides it for free). ``submit`` is NOT retried
    here: the router re-routes a failed dispatch to another replica,
    which is the safe retry for non-idempotent work.
  * :class:`CircuitBreaker` — per-replica failure ledger with half-open
    probing: consecutive probe failures OPEN the breaker (the replica
    is *suspected*: routed around, streams kept), after ``open_s`` one
    half-open probe is allowed through; ``max_open_cycles`` failed
    half-open probes EXHAUST the breaker (the replica is *dead*:
    failover + re-enqueue). One success fully closes it. This is what
    lets the router distinguish a slow replica from a gone one instead
    of today's one-probe death verdict.

Both take injectable clocks (and the policy an injectable sleep), so
the chaos suite drives them deterministically without wall-clock
waits.

Port note: a copy of ``deepspeed_tpu/inference/v2/serve/resilience.py``, which
imports no jax.
"""

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Optional

# transient transport failures worth another attempt; typed server
# verdicts (OverloadedError, RequestFailed) are NEVER retryable
RETRYABLE = (OSError, ConnectionError, asyncio.TimeoutError,
             asyncio.IncompleteReadError, TimeoutError)


@dataclass
class RetryConfig:
    max_attempts: int = 3
    base_backoff_s: float = 0.02
    max_backoff_s: float = 1.0
    # fraction of each backoff randomly SHAVED off (decorrelates
    # thundering retries without ever exceeding the planned delay)
    jitter: float = 0.5
    # default per-call deadline budget shared across attempts
    deadline_s: float = 5.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")


class RetryPolicy:
    """``await policy.call(fn, call="healthz", deadline_s=...)`` runs
    ``fn(remaining_budget_s)`` up to ``max_attempts`` times, backing
    off between transient failures, never sleeping past the shared
    deadline. ``fn`` receives the remaining budget so each attempt can
    bound its own I/O (the HTTP helpers take it as their timeout)."""

    def __init__(self, config: Optional[RetryConfig] = None,
                 clock=time.monotonic, sleep=asyncio.sleep, rng=None):
        self.config = config or RetryConfig()
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random.Random()
        from ....telemetry import get_registry
        reg = get_registry()
        self._m_attempts = reg.counter(
            "remote_call_attempts_total",
            "attempts of idempotent remote calls (first tries + "
            "retries)", labelnames=("call",))
        self._m_retries = reg.counter(
            "remote_call_retries_total",
            "retries of idempotent remote calls after a transient "
            "transport failure", labelnames=("call",))

    async def call(self, fn, *, call: str = "remote",
                   deadline_s: Optional[float] = None):
        cfg = self.config
        budget = cfg.deadline_s if deadline_s is None else deadline_s
        deadline = self._clock() + budget
        attempt = 0
        while True:
            attempt += 1
            self._m_attempts.labels(call=call).inc()
            remaining = max(deadline - self._clock(), 0.001)
            try:
                return await fn(remaining)
            except RETRYABLE:
                if attempt >= cfg.max_attempts:
                    raise
                delay = min(cfg.base_backoff_s * 2 ** (attempt - 1),
                            cfg.max_backoff_s)
                delay *= 1.0 - cfg.jitter * self._rng.random()
                if deadline - self._clock() <= delay:
                    raise   # budget exhausted: surface the last failure
                self._m_retries.labels(call=call).inc()
                await self._sleep(delay)


@dataclass
class BreakerConfig:
    # consecutive failures (from closed) that OPEN the breaker
    failure_threshold: int = 2
    # open dwell before ONE half-open probe is allowed through
    open_s: float = 1.0
    # failed half-open probes (re-opens) before the breaker is
    # EXHAUSTED — the router's dead verdict
    max_open_cycles: int = 3

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if self.max_open_cycles < 1:
            raise ValueError("max_open_cycles must be >= 1")


class CircuitBreaker:
    """States: ``closed`` (healthy), ``open`` (suspected; probes held
    back for ``open_s``), ``half_open`` (one trial probe in flight).
    ``exhausted`` latches once ``max_open_cycles`` open cycles ran
    without an intervening success."""

    def __init__(self, config: Optional[BreakerConfig] = None,
                 clock=time.monotonic):
        self.config = config or BreakerConfig()
        self._clock = clock
        self.state = "closed"
        self._failures = 0
        self._opened_t: Optional[float] = None
        self._cycles = 0

    def record_success(self) -> None:
        self.state = "closed"
        self._failures = 0
        self._cycles = 0
        self._opened_t = None

    def record_failure(self) -> None:
        self._failures += 1
        if self.state == "half_open":
            self._cycles += 1
            self._open()
        elif (self.state == "closed"
              and self._failures >= self.config.failure_threshold):
            self._cycles += 1
            self._open()

    def _open(self) -> None:
        self.state = "open"
        self._opened_t = self._clock()

    def allow_probe(self) -> bool:
        """True when a probe should run now: always while closed or
        half-open; while open only once ``open_s`` elapsed (which flips
        to half-open — the trial probe)."""
        if self.state == "open" \
                and self._clock() - self._opened_t >= self.config.open_s:
            self.state = "half_open"
        return self.state != "open"

    @property
    def exhausted(self) -> bool:
        return self._cycles >= self.config.max_open_cycles

    def snapshot(self) -> dict:
        return {"state": self.state, "failures": self._failures,
                "open_cycles": self._cycles,
                "exhausted": self.exhausted}

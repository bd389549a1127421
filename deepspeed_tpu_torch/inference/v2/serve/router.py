"""Prefix-affinity replica router — the multi-host serving front tier.

One :class:`ReplicaRouter` spreads streaming requests across N engine
replicas (serve/replica.py):

  * **Prefix-affinity placement** — an incoming prompt is chain-hashed
    with the replicas' KV block size (`ragged_manager.prefix_digest`,
    the exact digests the per-replica prefix caches key on) and routed
    to the replica that last served the longest matching digest, so
    shared-prefix traffic (system prompts, few-shot preambles,
    multi-turn conversations) lands where its KV blocks already are.
    Affinity is recorded at DISPATCH time, so concurrent same-prefix
    requests converge on one replica before the first even finishes.
    No match falls back to a consistent-hash ring (stable under replica
    death: only the dead node's keys move).
  * **Backoff-aware rebalancing** — a replica that sheds
    (:class:`~.admission.OverloadedError`) is taken out of rotation for
    its ``retry_after_s`` hint and the request re-routes to the
    next-best (least-loaded) replica; only when EVERY routable replica
    is overloaded does the router itself shed, with the soonest
    retry hint attached.
  * **Lifecycle** — ``drain_replica()`` finishes a replica's in-flight
    streams while new traffic diverts to survivors;
    ``check_replicas()`` (run at submit time and by the background
    monitor) classifies every replica through a per-replica circuit
    breaker (serve/resilience.py): probe timeouts/resets make it
    SUSPECTED — out of rotation, mid-stream requests keep streaming —
    while a refused dial (process exit), an exhausted breaker, a dead
    loop thread or an expired stall-watchdog heartbeat make it DEAD:
    its queued (not-yet-prefilled) requests re-enqueue on survivors
    and a request that already streamed tokens fails explicitly (its
    KV lives only on the dead replica). One slow ``/healthz`` probe is
    never a death verdict.
  * **Disaggregation** (``RouterConfig.disaggregated``) — dedicated
    prefill replicas run whole-prompt prefill and hand the paged KV
    blocks off to a decode replica (serve/handoff.py); token streams
    stay bit-identical to colocated serving.

The router is asyncio-side only: it owns no engine and touches replicas
exclusively through their thread-safe serving frontends, so N
in-process replicas (N loop threads) serve concurrently under one
event loop — and the same surface maps onto subprocess or multi-host
replicas.
"""

import asyncio
import bisect
import hashlib
import itertools
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ....telemetry import context as trace_context
from ....telemetry import trace
from ....telemetry.anomaly import DiagnosticsConfig, SLOBurnRateMonitor
from ..ragged.ragged_manager import prefix_digest
from .admission import OverloadedError
from .frontend import DeadlineExceeded, RequestFailed
from .replica import PrefillReplica, Replica
from .resilience import BreakerConfig, CircuitBreaker

# transport-level dispatch failures the router re-routes (typed server
# verdicts — OverloadedError, RequestFailed — are handled separately)
_DISPATCH_CONN_ERRORS = (OSError, ConnectionError, asyncio.TimeoutError,
                         asyncio.IncompleteReadError, TimeoutError)

_ROUTER_LANE = "router"


def _relabel_exposition(text: str, label: str, value: str) -> str:
    """Inject ``label="value"`` into every sample line of a Prometheus
    text exposition fetched from a remote replica, so its series
    federate next to the local registries' (comment lines are dropped —
    the local render already emitted TYPE/HELP for shared families, and
    duplicating them would violate the exactly-once contract)."""
    esc = value.replace("\\", r"\\").replace('"', r'\"')
    out = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        brace, space = line.find("{"), line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            # labeled sample: label values may contain spaces, so split
            # on the braces (the value after '}' never contains one)
            close = line.rfind("}")
            out.append(f'{line[:brace]}{{{label}="{esc}",'
                       f'{line[brace + 1:close]}}}{line[close + 1:]}')
        else:
            name, _, rest = line.partition(" ")
            out.append(f'{name}{{{label}="{esc}"}} {rest}')
    return "\n".join(out) + ("\n" if out else "")


@dataclass
class RouterConfig:
    # 'affinity' — prefix-digest affinity with consistent-hash fallback
    # (the default); 'hash' — consistent hash only; 'round_robin' — the
    # random-placement baseline
    placement: str = "affinity"
    # digest -> replica map bound (LRU): memory ceiling for the
    # affinity index, NOT correctness — evicted digests just fall back
    # to the hash ring
    affinity_max_entries: int = 8192
    # spill-aware placement: when no replica holds a request's prefix
    # HOT (affinity miss at every depth), prefer a replica whose
    # advertised spill-tier bloom summary claims the prefix digests —
    # restoring spilled KV beats recomputing it. A bloom false positive
    # degrades silently to recompute on the chosen replica (counted,
    # never a typed failure). Only consulted under placement='affinity'.
    spill_placement: bool = True
    # session resurrection: when a replica dies, a least-loaded survivor
    # adopts the dead replica's disk spill namespace (shared
    # kv_spill_dir) BEFORE the reap sweeps it, so re-enqueued requests
    # whose prefixes were spilled restore on the failover target instead
    # of recomputing from token zero. No shared directory -> no-op.
    resurrection: bool = True
    # dead-replica detection: loop stuck mid-step longer than this (as
    # reported by the stall-watchdog heartbeat) or a dead loop thread
    heartbeat_timeout_s: float = 10.0
    # background monitor cadence (0 disables; check_replicas() also
    # runs inline on every submit)
    monitor_interval_s: float = 1.0
    # backoff for a shedding replica when its rejection carries no
    # retry_after_s hint
    default_backoff_s: float = 0.25
    # prefill/decode disaggregation: prompts prefill on dedicated
    # prefill replicas, KV hands off to a decode replica
    disaggregated: bool = False
    # KV blocks per chunk of the streaming handoff (serve/handoff.py
    # chunk protocol): each chunk applies between the decode replica's
    # scheduler steps, so the transfer overlaps its running batch.
    # 0 = the legacy blocking whole-sequence transport.
    handoff_chunk_blocks: int = 4
    # consistent-hash ring points per replica
    ring_points: int = 32
    # blue/green weight push (push_weights): how long a stale replica
    # may take to finish its in-flight routed streams before the push
    # fails typed (streams complete on their ORIGINAL version — the
    # swap waits for them, never flips a stream mid-decode)
    weight_push_drain_timeout_s: float = 30.0
    # a replica added after a push (autoscaler scale-up) receives the
    # cached target payload before taking traffic, so scale-ups join
    # the fleet at the LIVE version instead of their boot checkpoint
    sync_weights_on_add: bool = True
    # per-replica circuit breaker (serve/resilience.py): probe failures
    # OPEN it (the replica is SUSPECTED — routed around, mid-stream
    # requests keep streaming), half-open probes retest it, exhaustion
    # (max_open_cycles failed retests) or a refused dial (process exit)
    # is the DEAD verdict that triggers failover + re-enqueue
    breaker: BreakerConfig = field(default_factory=BreakerConfig)
    # fleet-level diagnostics (telemetry/anomaly.py): the router runs an
    # SLO burn monitor over the AGGREGATED replica histograms
    # (fleet_slo_burn_rate gauges / fleet_slo_burn verdicts) and — when
    # postmortem_on_anomaly — answers any replica's anomaly verdict
    # with ONE fleet post-mortem bundle (postmortem.write_fleet_bundle)
    diagnostics: DiagnosticsConfig = field(
        default_factory=DiagnosticsConfig)


class RoutedStream:
    """Async token stream over a routed request (the TokenStream
    surface: iterate, ``cancel()``, ``drain()``, ``.tokens`` /
    ``.status`` / ``.uid``), decoupled from any one replica so the
    router can re-dispatch a queued request when its replica dies.
    ``replica`` names where the request is (currently) running."""

    def __init__(self, router: "ReplicaRouter", uid: int):
        self._router = router
        self._q: asyncio.Queue = asyncio.Queue()
        self._ended = False
        self.uid = uid
        self.replica: Optional[str] = None
        self.status = "active"
        self.reason: Optional[str] = None
        self.tokens: List[int] = []
        # tokens PUSHED by the router (>= len(tokens), which counts only
        # what the client consumed): the failover safety check — a
        # request is only re-runnable elsewhere while nothing was
        # emitted, consumed or not
        self.pushed = 0

    # router-side (event loop)
    def _push_token(self, tok: int) -> None:
        self.pushed += 1
        self._q.put_nowait(("tok", int(tok)))

    def _push_end(self, status: str, reason: Optional[str]) -> None:
        if not self._ended:
            self._q.put_nowait(("end", status, reason))

    # -- async iterator -------------------------------------------------
    def __aiter__(self) -> "RoutedStream":
        return self

    async def __anext__(self) -> int:
        if self._ended:
            raise StopAsyncIteration
        item = await self._q.get()
        if item[0] == "tok":
            self.tokens.append(item[1])
            return item[1]
        self._ended = True
        self.status, self.reason = item[1], item[2]
        if self.status == "expired":
            raise DeadlineExceeded(
                f"request {self.uid}: deadline exceeded")
        if self.status == "error":
            raise RequestFailed(f"request {self.uid}: {self.reason}")
        raise StopAsyncIteration

    async def cancel(self) -> None:
        await self._router.cancel(self.uid)

    async def aclose(self) -> None:
        if not self._ended and self.status == "active":
            await self.cancel()

    async def drain(self) -> List[int]:
        async for _ in self:
            pass
        return self.tokens


class _RoutedRequest:
    """Router-side request record: everything needed to (re)dispatch."""

    def __init__(self, uid: int, prompt: List[int], max_new_tokens: int,
                 kw: dict, deadline_t: Optional[float],
                 stream: RoutedStream, ctx=None):
        self.uid = uid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.kw = kw                 # submit() keywords sans deadline_s
        self.deadline_t = deadline_t  # absolute, router clock
        self.stream = stream
        self.ctx = ctx               # distributed TraceContext
        self.replica: Optional[str] = None
        self.inner = None            # the replica-side TokenStream
        self.pump: Optional[asyncio.Task] = None
        self.handed_off = False      # disaggregated: KV moved already

    def trace_attr(self) -> dict:
        return ({"trace_id": self.ctx.trace_id}
                if self.ctx is not None else {})


class _HashRing:
    """Consistent hashing over replica names: each node owns K points on
    a ring; a key routes to the next point clockwise whose node is
    allowed. Node removal moves only the removed node's keys."""

    def __init__(self, names: Sequence[str], points: int):
        self._ring: List[tuple] = sorted(
            (self._h(f"{name}#{i}".encode()), name)
            for name in names for i in range(points))
        self._hashes = [h for h, _ in self._ring]

    @staticmethod
    def _h(key: bytes) -> int:
        return int.from_bytes(hashlib.sha1(key).digest()[:8], "big")

    def pick(self, key: bytes, allowed) -> Optional[str]:
        if not self._ring:
            return None
        start = bisect.bisect_left(self._hashes, self._h(key))
        for off in range(len(self._ring)):
            name = self._ring[(start + off) % len(self._ring)][1]
            if name in allowed:
                return name
        return None


class ReplicaRouter:
    """Front tier over N serving replicas (module docstring).

    Duck-compatible with :class:`~.frontend.ServingEngine` where the
    HTTP surface needs it (``submit`` / ``health``), so
    :class:`~.api.ServingAPI` serves routed traffic unchanged — the
    routed frontend mode."""

    def __init__(self, replicas: Sequence[Replica],
                 config: Optional[RouterConfig] = None,
                 prefill_replicas: Sequence[PrefillReplica] = (),
                 clock=time.monotonic):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if config is None:
            config = RouterConfig()
        if config.placement not in ("affinity", "hash", "round_robin"):
            raise ValueError(
                f"placement must be 'affinity', 'hash' or 'round_robin' "
                f"(got {config.placement!r})")
        if config.disaggregated and not prefill_replicas:
            raise ValueError(
                "disaggregated mode needs at least one prefill replica")
        self.config = config
        self.clock = clock
        self.replicas: List[Replica] = list(replicas)
        self.prefill_replicas: List[PrefillReplica] = list(prefill_replicas)
        self._by_name = {r.name: r for r in self.replicas}
        if len(self._by_name) != len(self.replicas):
            raise ValueError("replica names must be unique")
        # every replica must share the KV block geometry: prefix digests
        # (and disaggregated handoffs) are keyed on it. Remote replicas
        # report their block size only after start()'s first /healthz
        # probe (None here) — start() re-verifies them.
        sizes = {r.block_size for r in self.replicas
                 if r.block_size is not None}
        for p in self.prefill_replicas:
            sizes.add(p.engine.state_manager.block_size)
        if len(sizes) > 1:
            raise ValueError(
                f"replicas disagree on KV block size ({sorted(sizes)}); "
                f"prefix affinity and handoff require one layout")
        self.block_size = sizes.pop() if sizes else None
        self._ring = _HashRing([r.name for r in self.replicas],
                               config.ring_points)
        self._affinity: "OrderedDict[bytes, str]" = OrderedDict()
        self._backoff_until: Dict[str, float] = {}
        # resilience state (remote replicas): per-replica breaker, the
        # suspected set (out of rotation, streams kept), and the last
        # probe_seq consumed so each probe feeds the breaker ONCE
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._suspected: Dict[str, str] = {}     # name -> reason
        self._probe_seen: Dict[str, int] = {}
        self._rr = itertools.count()          # round-robin cursors
        self._rr_prefill = itertools.count()
        # blue/green weight state (push_weights): the fleet's target
        # version, the cached payload newcomers sync from, and the set
        # of replicas currently draining for their swap (out of
        # rotation, streams finishing on their original version)
        self.target_weight_version: Optional[int] = None
        self._weight_payloads: Optional[List[bytes]] = None
        # adapter payloads by name for scale-up sync: a newcomer holds
        # every live adapter before it takes adapter traffic
        self._adapter_payloads: Dict[str, List[bytes]] = {}
        self._updating: set = set()
        self._uids = itertools.count(1)
        self._requests: Dict[int, _RoutedRequest] = {}
        self._monitor: Optional[asyncio.Task] = None
        self._stopped = False
        self._init_telemetry()
        # fleet SLO burn monitor: burns over the replica registries'
        # aggregated TTFT/TPOT histograms (one registry per replica
        # when Replica(registry=...) is used; otherwise the shared
        # process registry already aggregates the fleet). Distinct
        # gauge/verdict names so per-replica monitors never collide.
        regs = [r.registry for r in self.replicas
                if getattr(r, "registry", None) is not None]
        self.fleet_slo: Optional[SLOBurnRateMonitor] = None
        if config.diagnostics.enabled:
            self.fleet_slo = SLOBurnRateMonitor(
                config.diagnostics, registries=regs or None,
                gauge_name="fleet_slo_burn_rate",
                verdict_kind="fleet_slo_burn")
        # fleet post-mortem trigger state: per KIND, the wall clock of
        # the newest anomaly verdict whose bundle attempt ran (a failed
        # write must leave its verdicts un-consumed for the next tick)
        self._fleet_pm_start = time.time()
        self._fleet_pm_seen: Dict[str, float] = {}
        self._last_fleet_bundle: Optional[str] = None
        self._fleet_bundle_paths: set = set()

    def _init_telemetry(self):
        from ....telemetry import get_registry
        reg = get_registry()
        self._m_replicas = reg.gauge(
            "router_replicas", "replicas registered with the router")
        self._m_requests = reg.counter(
            "router_requests_total",
            "requests dispatched to a replica", labelnames=("replica",))
        self._m_aff_hits = reg.counter(
            "router_affinity_hits_total",
            "requests placed by prefix-digest affinity")
        self._m_aff_miss = reg.counter(
            "router_affinity_fallback_total",
            "requests placed by the consistent-hash ring / round robin "
            "(no affinity match)")
        # spill-aware placement + session resurrection (ragged/spill.py
        # bloom summaries advertised over /healthz)
        self._m_spill_hits = reg.counter(
            "router_spill_placement_hits_total",
            "requests placed onto a replica whose spill-tier bloom "
            "summary claims the prompt's prefix digests (restore "
            "preferred over recompute)")
        self._m_spill_fp = reg.counter(
            "router_spill_placement_false_positives_total",
            "spill placements where none of the bloom-claimed digests "
            "actually existed in the tier (the replica silently "
            "recomputes; exact check, in-process replicas only)")
        self._m_spill_restored = reg.counter(
            "router_spill_placement_restored_blocks_total",
            "KV blocks a spill placement expects to restore instead of "
            "recompute (exact for in-process replicas, bloom-claimed "
            "for remote)")
        self._m_resurrections = reg.counter(
            "router_session_resurrections_total",
            "dead replicas whose disk spill namespace a survivor "
            "adopted (shared kv_spill_dir)")
        self._m_resurrected = reg.counter(
            "router_resurrected_requests_total",
            "re-enqueued requests whose prefix digests survived into "
            "the adopter's spill tier (restore instead of full "
            "recompute on the failover target)")
        self._m_reroutes = reg.counter(
            "router_reroutes_total",
            "requests re-routed off an overloaded replica",
            labelnames=("reason",))
        self._m_shed = reg.counter(
            "router_shed_total",
            "requests shed by the router (every routable replica "
            "overloaded)")
        self._m_requeued = reg.counter(
            "router_requeued_total",
            "queued requests re-enqueued onto survivors after their "
            "replica died")
        self._m_dead = reg.counter(
            "router_dead_replicas_total",
            "replicas declared dead (heartbeat expiry / loop exit)")
        self._m_drains = reg.counter(
            "router_drains_total", "replica drains initiated")
        self._m_state = reg.gauge(
            "router_replica_state",
            "per-replica lifecycle state (1 up, 0.5 draining, 0 "
            "drained, -1 dead)", labelnames=("replica",))
        self._m_dispatch = reg.histogram(
            "router_dispatch_seconds",
            "routing decision time (digest + placement, excl. the "
            "replica submit)", unit="s",
            buckets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1))
        self._m_handoffs = reg.counter(
            "router_handoffs_total",
            "prefill->decode KV handoffs completed")
        self._m_handoff_bytes = reg.counter(
            "router_handoff_bytes_total",
            "serialized KV handoff payload bytes moved")
        # ONE source for the per-replica heartbeat signal: /statusz,
        # check_replicas() and dashboards all read this gauge (fed by
        # StallWatchdog.heartbeat_age via replica_heartbeat_age())
        self._m_heartbeat = reg.gauge(
            "router_replica_heartbeat_age_seconds",
            "seconds each replica's serving loop has been stuck "
            "mid-step (0 when idle / healthy; the dead-replica "
            "detector fires past heartbeat_timeout_s)",
            labelnames=("replica",))
        # labeled series resolved once: replica_heartbeat_age() runs on
        # the per-request dispatch path (check_replicas -> _is_dead),
        # which must not pay a registry-lock labels() lookup per probe
        self._hb_series = {r.name: self._m_heartbeat.labels(replica=r.name)
                           for r in self.replicas}
        self._m_fleet_bundles = reg.counter(
            "router_fleet_postmortems_total",
            "fleet post-mortem bundles written in answer to a replica "
            "anomaly verdict")
        # resilience signals: suspected (out of rotation, streams kept)
        # is DISTINCT from dead (failover) — the breaker's whole point
        self._m_suspected = reg.gauge(
            "router_replica_suspected",
            "1 while the replica is suspected (probe timeouts / open "
            "breaker): routed around but NOT failed over",
            labelnames=("replica",))
        self._m_suspects = reg.counter(
            "router_suspects_total",
            "replicas taken out of rotation as suspected (probe "
            "timeout / reset / breaker open)")
        self._m_breaker_state = reg.gauge(
            "router_breaker_state",
            "per-replica circuit-breaker state (0 closed, 0.5 "
            "half-open, 1 open)", labelnames=("replica",))
        self._m_breaker_opens = reg.counter(
            "router_breaker_open_total",
            "circuit-breaker open transitions (a replica entered "
            "suspicion)")
        # blue/green weight push (serve/weights.py)
        self._m_weight_pushes = reg.counter(
            "router_weight_pushes_total",
            "per-replica weight pushes completed by the blue/green "
            "rollout", labelnames=("replica",))
        self._m_weight_push_bytes = reg.counter(
            "router_weight_push_bytes_total",
            "serialized weight-payload bytes pushed to replicas",
            unit="bytes")
        self._m_weight_push_time = reg.histogram(
            "router_weight_push_seconds",
            "whole-fleet push_weights wall time (drain stale streams + "
            "transfer + swap, per rollout)", unit="s",
            buckets=(1e-2, 0.1, 1.0, 10.0, 60.0, 600.0))
        self._m_weight_push_failures = reg.counter(
            "router_weight_push_failures_total",
            "per-replica weight pushes that failed (replica still "
            "stale; the rollout raises typed when it stays up)")
        self._m_target_version = reg.gauge(
            "router_target_weight_version",
            "the fleet's target weight version (0 until the first "
            "push)")
        # delta negotiation (serve/weights.py § delta payloads)
        self._m_delta_pushes = reg.counter(
            "router_weight_delta_pushes_total",
            "per-replica pushes that shipped the quantized DELTA "
            "payload (replica advertised the delta's base version)")
        self._m_delta_fallbacks = reg.counter(
            "router_weight_delta_fallbacks_total",
            "delta pushes that failed typed (stale base, no retained "
            "base, corrupt chunk) and fell back to the full payload")
        self._m_replica_version = reg.gauge(
            "router_replica_weight_version",
            "per-replica live weight version as last advertised "
            "(healthz/heartbeat) or installed by a push",
            labelnames=("replica",))
        self._wv_series: Dict[str, object] = {}
        self._m_replicas.set(len(self.replicas))
        for r in self.replicas:
            self._m_state.labels(replica=r.name).set(1)

    # -- lifecycle ------------------------------------------------------
    def _check_block_size(self, replica) -> None:
        bs = replica.block_size
        if bs is None:
            raise ValueError(
                f"replica {replica.name} reports no KV block size "
                f"(remote replica not started?)")
        if self.block_size is None:
            self.block_size = int(bs)
        elif int(bs) != self.block_size:
            raise ValueError(
                f"replica {replica.name} has KV block size {bs}, the "
                f"fleet uses {self.block_size}; prefix affinity and "
                f"handoff require one layout")
        # disaggregated mode pre-checks KV-slot need against the
        # PREFILL side's max_seq_len before burning prefill flops — a
        # decode replica with a smaller pool would defeat that check
        # after the work was already done, so require one geometry
        msl = getattr(replica, "max_seq_len", None)
        if self.prefill_replicas and msl is not None:
            want = self.prefill_replicas[0].engine.state_manager \
                .config.max_seq_len
            if int(msl) != int(want):
                raise ValueError(
                    f"replica {replica.name} has max_seq_len {msl}, "
                    f"the prefill replicas use {want}; disaggregated "
                    f"replicas must share the KV geometry")

    async def start(self) -> "ReplicaRouter":
        for r in self.replicas:
            await r.start()
            self._check_block_size(r)
        if self.config.monitor_interval_s > 0:
            self._monitor = asyncio.ensure_future(self._monitor_loop())
        return self

    # -- dynamic membership (the autoscaler's surface) ------------------
    def _rebuild_ring(self) -> None:
        """Rebuild the consistent-hash ring from the current member
        names. Point hashes are deterministic per name, so surviving
        replicas keep their ring positions — only keys owned by a
        removed (or claimed by an added) node remap."""
        self._ring = _HashRing([r.name for r in self.replicas],
                               self.config.ring_points)

    async def add_replica(self, replica, start: bool = True) -> None:
        """Grow the fleet: start the replica (unless already started),
        verify the shared KV layout, and rebuild the ring so it takes
        traffic immediately."""
        if self._stopped:
            raise RuntimeError("router is stopped")
        if replica.name in self._by_name:
            raise ValueError(f"replica name {replica.name!r} already "
                             f"registered")
        if start and not replica.started:
            await replica.start()
        self._check_block_size(replica)
        # scale-ups join at the LIVE version: push the cached target
        # payload BEFORE the replica enters the ring, so it never
        # serves a request from its boot checkpoint after a push
        if (self.config.sync_weights_on_add
                and self._weight_payloads is not None
                and self.target_weight_version is not None
                and self._replica_weight_version(replica)
                != self.target_weight_version):
            try:
                await self._push_to_replica(
                    replica, self._weight_payloads,
                    sum(len(p) for p in self._weight_payloads))
            except BaseException:
                # the replica was already STARTED above: stop it before
                # propagating, or a failed sync leaks a live worker the
                # autoscaler only counts as a spawn failure
                try:
                    await replica.stop()
                except Exception:
                    pass
                raise
        # newcomers also sync every live ADAPTER before taking traffic
        # (bank-slot installs; weight_version untouched)
        if self.config.sync_weights_on_add and self._adapter_payloads:
            try:
                for pl in self._adapter_payloads.values():
                    await self._push_to_replica(
                        replica, pl, sum(len(p) for p in pl))
            except BaseException:
                try:
                    await replica.stop()
                except Exception:
                    pass
                raise
        self.replicas.append(replica)
        self._by_name[replica.name] = replica
        self._rebuild_ring()
        self._m_replicas.set(len(self.replicas))
        self._m_state.labels(replica=replica.name).set(1)
        trace.record("router_membership", time.perf_counter(), 0.0,
                     lane=_ROUTER_LANE, action="add",
                     replica=replica.name)

    def remove_replica(self, name: str) -> None:
        """Shrink the fleet: pure membership removal — the replica must
        already be drained or dead (``drain_replica`` first; the
        autoscaler's drain-then-stop does). Ring and affinity entries
        remap; in-flight failover bookkeeping is untouched (a dead
        replica's requests were already re-enqueued by
        ``check_replicas``)."""
        replica = self._by_name.get(name)
        if replica is None:
            raise KeyError(f"no replica named {name!r}")
        if replica.state == "up":
            raise RuntimeError(
                f"replica {name} is still 'up': drain it (or let the "
                f"death check reap it) before removing")
        del self._by_name[name]
        self.replicas = [r for r in self.replicas if r.name != name]
        self._rebuild_ring()
        # affinity remap: purge the removed replica's digests so a
        # future same-name replica never inherits stale residency claims
        for digest in [d for d, n in self._affinity.items() if n == name]:
            del self._affinity[digest]
        self._backoff_until.pop(name, None)
        self._hb_series.pop(name, None)
        self._wv_series.pop(name, None)
        self._updating.discard(name)
        self._breakers.pop(name, None)
        self._probe_seen.pop(name, None)
        if name in self._suspected:
            del self._suspected[name]
            self._m_suspected.labels(replica=name).set(0)
        self._m_replicas.set(len(self.replicas))
        trace.record("router_membership", time.perf_counter(), 0.0,
                     lane=_ROUTER_LANE, action="remove", replica=name)

    async def stop(self, drain: bool = True) -> None:
        self._stopped = True
        if self._monitor is not None:
            self._monitor.cancel()
            try:
                await self._monitor
            except asyncio.CancelledError:
                pass
            self._monitor = None
        for r in self.replicas:
            if r.state in ("up", "draining") and r.started:
                try:
                    if drain:
                        await r.drain()
                    else:
                        await r.stop()
                except Exception:
                    pass
                r.state = "drained"
                self._m_state.labels(replica=r.name).set(0)
            elif r.state == "dead" and r.started:
                # best-effort: an unwedged dead loop exits on the halt
                # command; a truly stuck one stays a daemon thread
                try:
                    await r.kill()
                except Exception:
                    pass
        for rec in list(self._requests.values()):
            self._finish(rec, "cancelled", None)

    async def __aenter__(self) -> "ReplicaRouter":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=exc == (None, None, None))

    async def _monitor_loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.monitor_interval_s)
            try:
                await self.check_replicas()
            except Exception:       # monitoring must never kill routing
                pass
            try:
                if self.fleet_slo is not None:
                    self.fleet_slo.tick()
            except Exception:
                pass
            try:
                await self._maybe_fleet_postmortem()
            except Exception:
                pass

    async def _maybe_fleet_postmortem(self) -> None:
        """Answer any NEW anomaly verdict (raised by any replica's
        detectors — they share the process ledger — or the fleet SLO
        monitor) with one fleet bundle: every replica's evidence plus
        the router's routing state under a cross-replica manifest.
        Per-kind rate-limited like single-process bundles."""
        if not self.config.diagnostics.postmortem_on_anomaly:
            return
        from ....telemetry import anomaly as ds_anomaly
        from ....telemetry import postmortem as ds_postmortem
        # one bundle attempt per DISTINCT fresh kind: collapsing to the
        # newest verdict would let a chatty kind suppress the others at
        # the trigger level — the very failure the per-kind rate limit
        # exists to prevent. The watermark advances per kind and only
        # AFTER its attempt ran, so a failed write (disk full) leaves
        # the incident's verdicts fresh for the next monitor tick.
        by_kind: Dict[str, float] = {}
        for v in ds_anomaly.recent():
            kind, wall = v.get("kind"), v.get("wall", 0.0)
            if wall > self._fleet_pm_seen.get(kind, self._fleet_pm_start):
                by_kind[kind] = max(by_kind.get(kind, 0.0), wall)
        for kind, wall in by_kind.items():
            # bundle writing is disk I/O at exactly the wrong moment —
            # keep it off the event loop so live streams never stall
            # behind it
            path = await asyncio.to_thread(
                ds_postmortem.maybe_write_fleet_bundle, kind, self,
                self.config.diagnostics)
            self._fleet_pm_seen[kind] = wall
            if path is not None and path not in self._fleet_bundle_paths:
                # rate-limited calls return the previous bundle's path —
                # only a NEW directory counts as a bundle written
                self._fleet_bundle_paths.add(path)
                self._last_fleet_bundle = path
                self._m_fleet_bundles.inc()

    # -- placement ------------------------------------------------------
    @staticmethod
    def _replica_weight_version(replica) -> Optional[int]:
        v = getattr(replica, "weight_version", None)
        return int(v) if v is not None else None

    def _note_weight_version(self, replica) -> None:
        v = self._replica_weight_version(replica)
        if v is None:
            return
        series = self._wv_series.get(replica.name)
        if series is None:
            series = self._m_replica_version.labels(
                replica=replica.name)
            self._wv_series[replica.name] = series
        series.set(v)

    def _routable(self) -> List[Replica]:
        now = self.clock()
        base = [r for r in self.replicas
                if r.state == "up"
                and r.name not in self._suspected
                and r.name not in self._updating
                and self._backoff_until.get(r.name, 0.0) <= now]
        # blue/green invariant: once ANY routable replica serves the
        # target version, new dispatches land only on target-version
        # replicas — stale ones keep their in-flight streams (their
        # pumps are untouched) and drain toward their own swap
        if self.target_weight_version is not None:
            at_target = [r for r in base
                         if self._replica_weight_version(r)
                         == self.target_weight_version]
            if at_target:
                return at_target
        return base

    def _record_affinity(self, digests: List[bytes], name: str) -> None:
        for d in digests:
            self._affinity[d] = name
            self._affinity.move_to_end(d)
        while len(self._affinity) > self.config.affinity_max_entries:
            self._affinity.popitem(last=False)

    def pick_replica(self, prompt: Sequence[int],
                     adapter: Optional[str] = None) -> tuple:
        """Placement decision only (no dispatch): returns
        ``(replica_name, digests, via)`` where ``via`` is 'affinity' |
        'spill' | 'hash' | 'round_robin'. ``adapter`` scopes the
        placement key the same way it scopes the replica-side prefix
        cache (the digests ARE the replica's cache keys): the same
        prompt under different adapters lands wherever each adapter's
        KV actually lives. 'spill' means no replica holds the prefix
        HOT at that depth but one's advertised spill-tier bloom claims
        it — restoring spilled KV beats recomputing it (a bloom false
        positive silently recomputes)."""
        routable = self._routable()
        if not routable:
            return None, [], "none"
        names = {r.name for r in routable}
        digests: List[bytes] = []
        if self.config.placement == "affinity":
            digests = prefix_digest(np.asarray(list(prompt), np.int64),
                                    self.block_size, adapter=adapter)
            summaries = []
            if self.config.spill_placement and digests:
                for r in routable:
                    fn = getattr(r, "spill_summary", None)
                    s = fn() if fn is not None else None
                    if s is not None and s.entries:
                        summaries.append((r, s))
            # longest matching digest wins: the deepest shared prefix.
            # At equal depth hot KV (affinity) beats spilled KV (the
            # restore costs a host->device scatter the hot block
            # doesn't); a DEEPER spill claim beats a shallower affinity
            # entry because the walk is deepest-first over depths.
            for d in reversed(digests):
                name = self._affinity.get(d)
                if name is not None and name in names:
                    return name, digests, "affinity"
                if summaries:
                    claimants = [r for (r, s) in summaries if s.claims(d)]
                    if claimants:
                        best = min(claimants, key=lambda r: r.load())
                        return best.name, digests, "spill"
        if self.config.placement == "round_robin":
            name = routable[next(self._rr) % len(routable)].name
            return name, digests, "round_robin"
        key = np.asarray(list(prompt), np.int64).tobytes()
        if adapter:
            key = adapter.encode("utf-8") + b"\x00" + key
        return self._ring.pick(key, names), digests, "hash"

    def _candidates(self, first: str) -> List[Replica]:
        """The chosen replica, then every other routable one least-
        loaded first (the overload re-route order)."""
        rest = sorted((r for r in self._routable() if r.name != first),
                      key=lambda r: r.load())
        head = [self._by_name[first]] if first in {
            r.name for r in self._routable()} else []
        return head + rest

    # -- submission -----------------------------------------------------
    async def submit(self, prompt: Sequence[int], max_new_tokens: int,
                     **kw) -> RoutedStream:
        """Route and dispatch one streaming request (the ServingEngine
        submit surface). Raises :class:`OverloadedError` — with the
        soonest per-replica ``retry_after_s`` hint — only when every
        routable replica sheds."""
        if self._stopped:
            raise OverloadedError("draining", "router is stopped")
        await self.check_replicas()
        uid = next(self._uids)
        # one trace identity from router dispatch to the last decode
        # token: continue the HTTP layer's bound context (traceparent
        # header) or mint the root here — the router IS the fleet entry
        ctx = trace_context.get_or_new()
        stream = RoutedStream(self, uid)
        deadline_s = kw.pop("deadline_s", None)
        rec = _RoutedRequest(
            uid, list(map(int, prompt)), int(max_new_tokens), dict(kw),
            self.clock() + deadline_s if deadline_s is not None else None,
            stream, ctx=ctx)
        # register BEFORE dispatching: a request that finishes inside
        # dispatch (finished-at-prefill, handoff error) must find its
        # record to pop, or it would linger in _requests forever
        self._requests[uid] = rec
        try:
            if self.config.disaggregated:
                await self._dispatch_disaggregated(rec)
            else:
                await self._dispatch(rec)
        except BaseException:
            self._requests.pop(uid, None)
            raise
        return stream

    def _pick_for(self, rec: _RoutedRequest):
        t0 = time.perf_counter()
        name, digests, via = self.pick_replica(
            rec.prompt, adapter=rec.kw.get("adapter"))
        self._m_dispatch.observe(time.perf_counter() - t0)
        if name is None:
            self._m_shed.inc()
            raise OverloadedError(
                "no_replicas", "no routable replicas (all dead, "
                "draining or backing off)",
                retry_after_s=self._soonest_backoff())
        if via == "affinity":
            self._m_aff_hits.inc()
        elif via == "spill":
            self._m_aff_miss.inc()
            self._note_spill_placement(name, digests)
        else:
            self._m_aff_miss.inc()
        return name, digests

    def _note_spill_placement(self, name: str, digests) -> None:
        """Account a via='spill' placement: count the hit, the blocks
        it expects to restore, and — where an exact check is possible —
        a bloom false positive (placement gained nothing; the replica
        recomputes silently, which is the designed degradation)."""
        self._m_spill_hits.inc()
        replica = self._by_name.get(name)
        if replica is None:
            return
        summary = replica.spill_summary()
        claimed = ([d for d in digests if summary.claims(d)]
                   if summary is not None else [])
        if not claimed:
            return
        probe = replica.spill_probe(claimed)
        if probe is None:
            # remote replica: no exact digest check over the wire —
            # count the bloom-claimed blocks (documented-optimistic)
            self._m_spill_restored.inc(len(claimed))
        elif probe == 0:
            self._m_spill_fp.inc()
        else:
            self._m_spill_restored.inc(probe)

    def _soonest_backoff(self) -> Optional[float]:
        now = self.clock()
        waits = [t - now for r in self.replicas if r.state == "up"
                 for t in [self._backoff_until.get(r.name, 0.0)]
                 if t > now]
        return round(min(waits), 3) if waits else None

    def _remaining_deadline(self, rec: _RoutedRequest) -> Optional[float]:
        if rec.deadline_t is None:
            return None
        return max(rec.deadline_t - self.clock(), 0.001)

    async def _dispatch(self, rec: _RoutedRequest) -> None:
        """Pick a replica and submit; on shed, back the replica off for
        its retry hint and try the next-best until one admits."""
        t0 = time.perf_counter()
        name, digests = self._pick_for(rec)
        last_err: Optional[OverloadedError] = None
        conn_err: Optional[Exception] = None
        for replica in self._candidates(name):
            try:
                # bind the request's trace context around the replica
                # submit: the replica frontend CONTINUES it (get_or_new
                # reads the contextvar) instead of minting a new root —
                # one trace id from dispatch to the last decode token
                with trace_context.use(rec.ctx):
                    inner = await replica.submit(
                        rec.prompt, rec.max_new_tokens,
                        deadline_s=self._remaining_deadline(rec),
                        **rec.kw)
            except OverloadedError as e:
                last_err = e
                backoff = (e.retry_after_s if e.retry_after_s is not None
                           else self.config.default_backoff_s)
                self._backoff_until[replica.name] = self.clock() + backoff
                self._m_reroutes.labels(reason=e.reason).inc()
                trace.record("router_reroute", time.perf_counter(), 0.0,
                             lane=_ROUTER_LANE, uid=rec.uid,
                             replica=replica.name, reason=e.reason,
                             backoff_s=round(backoff, 3),
                             **rec.trace_attr())
                continue
            except _DISPATCH_CONN_ERRORS as e:
                # transport failure before any token: the prompt is
                # idempotent at zero tokens, so route around — feed the
                # breaker, suspect the replica, try the next candidate
                conn_err = e
                self._note_dispatch_failure(replica)
                self._m_reroutes.labels(reason="connect_error").inc()
                trace.record("router_reroute", time.perf_counter(), 0.0,
                             lane=_ROUTER_LANE, uid=rec.uid,
                             replica=replica.name,
                             reason="connect_error",
                             **rec.trace_attr())
                continue
            self._attach(rec, replica.name, inner, digests)
            trace.record("router_dispatch", t0,
                         time.perf_counter() - t0, lane=_ROUTER_LANE,
                         uid=rec.uid, replica=replica.name,
                         **rec.trace_attr())
            return
        self._m_shed.inc()
        trace.record("router_shed", t0, time.perf_counter() - t0,
                     lane=_ROUTER_LANE, uid=rec.uid,
                     reason=last_err.reason if last_err else
                     ("connect_error" if conn_err else "no_replicas"),
                     **rec.trace_attr())
        if last_err is None and conn_err is not None:
            # every candidate failed at the transport level: a typed
            # dispatch failure, not an overload signal
            raise RequestFailed(
                f"dispatch failed: no replica reachable "
                f"({type(conn_err).__name__}: {conn_err})")
        raise OverloadedError(
            last_err.reason if last_err else "no_replicas",
            f"all routable replicas overloaded: "
            f"{last_err if last_err else 'none routable'}",
            retry_after_s=(last_err.retry_after_s if last_err
                           and last_err.retry_after_s is not None
                           else self._soonest_backoff()))

    async def _dispatch_disaggregated(self, rec: _RoutedRequest) -> None:
        """Prefill on a dedicated prefill replica, then hand the KV off
        to a decode replica picked by the normal placement. The decode
        replica is chosen BEFORE prefill runs (shed-before-compute: an
        unroutable fleet never burns prefill flops)."""
        t0 = time.perf_counter()
        name, digests = self._pick_for(rec)
        # the decode-side KV-slot precheck, before any prefill flops are
        # burned (replicas share one layout — the prefill side's state
        # manager speaks for remote decode replicas too)
        max_seq = self.prefill_replicas[0].engine.state_manager.config \
            .max_seq_len
        need = len(rec.prompt) + max(rec.max_new_tokens - 1, 0)
        if need > max_seq:
            self._finish(
                rec, "error",
                f"RuntimeError: request needs {need} KV slots, over "
                f"max_seq_len={max_seq}; shorten the request")
            return
        pw = self.prefill_replicas[
            next(self._rr_prefill) % len(self.prefill_replicas)]
        # the dispatch span closes at the routing DECISION (decode
        # candidate + prefill worker chosen), before any prefill flops —
        # the first hop of the request's distributed trace
        trace.record("router_dispatch", t0, time.perf_counter() - t0,
                     lane=_ROUTER_LANE, uid=rec.uid, replica=name,
                     prefill_replica=pw.name, disaggregated=True,
                     **rec.trace_attr())
        chunk_blocks = max(int(self.config.handoff_chunk_blocks), 0)
        tok, payloads, rng_state, finished = await pw.prefill(
            rec.prompt, rec.max_new_tokens,
            eos_token_id=rec.kw.get("eos_token_id"),
            temperature=rec.kw.get("temperature", 0.0),
            top_p=rec.kw.get("top_p", 1.0),
            top_k=rec.kw.get("top_k", 0), seed=rec.kw.get("seed"),
            trace_ctx=rec.ctx, chunk_blocks=chunk_blocks)
        rec.stream._push_token(tok)
        if finished:
            # NO affinity recorded: the decode candidate never received
            # this KV (the prefill replica flushed it), and an affinity
            # entry would assert residency that does not exist
            rec.replica = pw.name
            self._finish(rec, "completed", None)
            return
        t_h = time.perf_counter()
        payload_bytes = sum(len(p) for p in payloads)
        last_err: Optional[OverloadedError] = None
        for replica in self._candidates(name):
            try:
                with trace_context.use(rec.ctx):
                    inner = await replica.resume_handoff(
                        payloads, chunked=chunk_blocks > 0,
                        prompt=rec.prompt, generated=[tok],
                        max_new_tokens=rec.max_new_tokens,
                        eos_token_id=rec.kw.get("eos_token_id"),
                        temperature=rec.kw.get("temperature", 0.0),
                        top_p=rec.kw.get("top_p", 1.0),
                        top_k=rec.kw.get("top_k", 0),
                        rng_state=rng_state,
                        deadline_s=self._remaining_deadline(rec))
            except OverloadedError as e:
                last_err = e
                self._backoff_until[replica.name] = self.clock() + (
                    e.retry_after_s if e.retry_after_s is not None
                    else self.config.default_backoff_s)
                self._m_reroutes.labels(reason=e.reason).inc()
                continue
            except _DISPATCH_CONN_ERRORS as e:
                # the chunked protocol is idempotent-retransmit (and
                # the worker aborts partial restores on disconnect), so
                # after the replica's own retries failed the handoff is
                # safe to offer to the next candidate
                self._note_dispatch_failure(replica)
                self._m_reroutes.labels(reason="connect_error").inc()
                trace.record("router_reroute", time.perf_counter(), 0.0,
                             lane=_ROUTER_LANE, uid=rec.uid,
                             replica=replica.name,
                             reason="connect_error",
                             **rec.trace_attr())
                continue
            rec.handed_off = True
            self._m_handoffs.inc()
            self._m_handoff_bytes.inc(payload_bytes)
            # the KV transfer hop: wire (de)serialize -> decode-side
            # restore/adopt, between the prefill span (prefill lane) and
            # the first decode span (decode lane)
            trace.record("router_handoff", t_h,
                         time.perf_counter() - t_h, lane=_ROUTER_LANE,
                         uid=rec.uid, src=pw.name, dst=replica.name,
                         payload_bytes=payload_bytes,
                         chunks=(len(payloads) - 1 if chunk_blocks
                                 else 0), **rec.trace_attr())
            self._attach(rec, replica.name, inner, digests)
            return
        self._m_shed.inc()
        self._finish(rec, "error",
                     f"no decode replica accepted the handoff: "
                     f"{last_err}")

    def _attach(self, rec: _RoutedRequest, name: str, inner,
                digests: List[bytes]) -> None:
        rec.replica = name
        rec.stream.replica = name
        rec.inner = inner
        self._record_affinity(digests, name)
        self._m_requests.labels(replica=name).inc()
        rec.pump = asyncio.ensure_future(self._pump(rec, inner))

    async def _pump(self, rec: _RoutedRequest, inner) -> None:
        """Forward one replica-side stream into the routed stream."""
        try:
            async for tok in inner:
                rec.stream._push_token(tok)
            self._finish(rec, inner.status, inner.reason)
        except DeadlineExceeded:
            self._finish(rec, "expired", "deadline exceeded")
        except RequestFailed as e:
            self._finish(rec, "error", str(e))
        except asyncio.CancelledError:   # failover/cancel detached us
            raise
        except Exception as e:           # never lose a stream silently
            self._finish(rec, "error", f"{type(e).__name__}: {e}")

    def _finish(self, rec: _RoutedRequest, status: str,
                reason: Optional[str]) -> None:
        rec.stream._push_end(status, reason)
        self._requests.pop(rec.uid, None)

    async def cancel(self, uid: int) -> None:
        rec = self._requests.get(uid)
        if rec is None:
            return
        if rec.pump is not None:
            rec.pump.cancel()
        if rec.inner is not None:
            try:
                await rec.inner.cancel()
            except Exception:
                pass
        self._finish(rec, "cancelled", None)

    # -- blue/green weight push (serve/weights.py) ----------------------
    async def push_weights(self, payloads: Sequence[bytes],
                           version: Optional[int] = None,
                           delta: Optional[Sequence[bytes]] = None
                           ) -> int:
        """Converge the fleet onto a new weight version, blue/green:

        1. the payload version becomes the fleet TARGET (``_routable``
           then prefers target-version replicas for every new
           dispatch);
        2. each stale up replica in turn is taken out of rotation, its
           in-flight routed streams finish ON THE OLD VERSION (the
           quiesce wait — a stream never spans a swap), the payload is
           pushed (``POST /weights`` for remote replicas, the staged
           in-process update otherwise) and the replica returns to
           rotation at the target version.

        Zero requests are dropped: new traffic always has the other
        replicas (rolling, one at a time), in-flight streams complete
        where they started, and a replica that cannot be pushed (still
        up, still stale) fails the rollout TYPED. The payload is cached
        so later ``add_replica`` scale-ups join at the live version.
        Returns the target version.

        ``delta`` enables per-replica DELTA NEGOTIATION: a replica whose
        advertised ``weight_version`` equals the delta's ``base_version``
        gets the quantized delta payload (~4x fewer wire bytes); anyone else —
        and any delta that fails typed (stale base, corrupt chunk) —
        gets the full payload. Only the FULL payload is cached for
        scale-up sync (newcomers hold no base). ``payloads`` may be a
        :class:`~....runtime.hybrid_engine.WeightPublication` (its full
        payload, and its delta unless ``delta`` is given), or an adapter
        payload, which goes to :meth:`push_adapter`."""
        from . import weights as serve_weights
        if hasattr(payloads, "full"):   # a WeightPublication
            if delta is None:
                delta = payloads.delta
            payloads = payloads.full
        if serve_weights.is_adapter_payload(payloads):
            # an ADAPTER rode the publish path: the same per-replica push,
            # installed in a bank slot, the fleet's version target left
            return await self.push_adapter(payloads)
        if self.config.disaggregated:
            raise NotImplementedError(
                "blue/green weight push over disaggregated fleets is "
                "not supported yet: prefill and decode replicas would "
                "need a coupled swap to keep handed-off streams on one "
                "version")
        if self._stopped:
            raise RuntimeError("router is stopped")
        if version is None:
            version = serve_weights.payload_version(payloads)
        version = int(version)
        t0 = time.perf_counter()
        payloads = list(payloads)
        delta_base: Optional[int] = None
        delta_nbytes = 0
        if delta is not None:
            delta = list(delta)
            if serve_weights.payload_version(delta) != version:
                raise ValueError(
                    f"delta payload version "
                    f"{serve_weights.payload_version(delta)} != full "
                    f"payload version {version}")
            delta_base = serve_weights.delta_base_version(delta)
            delta_nbytes = serve_weights.payload_bytes(delta)
        self.target_weight_version = version
        self._weight_payloads = payloads
        self._m_target_version.set(version)
        nbytes = serve_weights.payload_bytes(payloads)
        failures: List[str] = []
        for replica in list(self.replicas):
            if replica.state != "up":
                continue
            if self._replica_weight_version(replica) == version:
                continue
            if (delta is not None
                    and self._replica_weight_version(replica)
                    == delta_base):
                try:
                    await self._push_to_replica(replica, delta,
                                                delta_nbytes)
                    self._m_delta_pushes.inc()
                    continue
                except Exception as e:
                    # typed delta rejection (stale base, corrupt
                    # chunk, pre-delta worker): fall back to the full
                    # payload for this replica
                    self._m_delta_fallbacks.inc()
                    trace.record(
                        "router_weight_delta_fallback", t0,
                        time.perf_counter() - t0, lane=_ROUTER_LANE,
                        replica=replica.name,
                        error=f"{type(e).__name__}: {e}")
            try:
                await self._push_to_replica(replica, payloads, nbytes)
            except Exception as e:
                self._m_weight_push_failures.inc()
                failures.append(
                    f"{replica.name}: {type(e).__name__}: {e}")
        self._m_weight_push_time.observe(time.perf_counter() - t0)
        trace.record("router_weight_push", t0,
                     time.perf_counter() - t0, lane=_ROUTER_LANE,
                     version=version, payload_bytes=nbytes,
                     failures=len(failures))
        # a failed push only fails the rollout while the replica is
        # still UP and stale — a replica that died mid-push was already
        # failed over by check_replicas and no longer serves anything
        still_stale = [
            r.name for r in self.replicas
            if r.state == "up"
            and self._replica_weight_version(r) != version]
        if still_stale:
            detail = "; ".join(failures) if failures \
                else "no error recorded"
            raise RequestFailed(
                f"weight push to version {version} did not converge: "
                f"replicas {still_stale} still stale ({detail})")
        return version

    async def push_adapter(self, payloads: Sequence[bytes]) -> int:
        """Deploy a LoRA adapter fleet-wide over the per-replica push path
        of the blue/green weights (quiesce, ``POST /weights`` or the staged
        in-process update, ingest) without moving the fleet's weight
        version: each replica installs it in a bank slot
        (``engine.load_adapter``), so convergence is each push's success.
        The payload is cached by adapter name, so later ``add_replica``
        scale-ups join holding every live adapter. Returns the payload's
        version (JAX :1267)."""
        from . import weights as serve_weights
        if self._stopped:
            raise RuntimeError("router is stopped")
        header = serve_weights.parse_weights_header(payloads[0])
        if not serve_weights.is_adapter_header(header):
            raise ValueError(
                "push_adapter requires an adapter payload "
                "(payload_kind='adapter'); use push_weights for full/delta "
                "payloads")
        name = str(header["adapter_name"])
        version = int(header["version"])
        payloads = list(payloads)
        nbytes = serve_weights.payload_bytes(payloads)
        t0 = time.perf_counter()
        failures: List[str] = []
        for replica in list(self.replicas):
            if replica.state != "up":
                continue
            try:
                await self._push_to_replica(replica, payloads, nbytes)
            except Exception as e:
                self._m_weight_push_failures.inc()
                failures.append(f"{replica.name}: {type(e).__name__}: {e}")
        self._adapter_payloads[name] = payloads
        trace.record("router_adapter_push", t0, time.perf_counter() - t0,
                     lane=_ROUTER_LANE, adapter=name, version=version,
                     payload_bytes=nbytes, failures=len(failures))
        if failures:
            raise RequestFailed(
                f"adapter {name!r} push did not converge: "
                + "; ".join(failures))
        return version

    async def _push_to_replica(self, replica, payloads: List[bytes],
                               nbytes: int) -> None:
        name = replica.name
        self._updating.add(name)
        t0 = time.perf_counter()
        try:
            await self._quiesce_replica(replica)
            if hasattr(replica, "push_weights"):
                v = await replica.push_weights(payloads)
            else:
                v = await replica.apply_weights(payloads)
        finally:
            self._updating.discard(name)
        self._m_weight_pushes.labels(replica=name).inc()
        self._m_weight_push_bytes.inc(nbytes)
        self._note_weight_version(replica)
        trace.record("router_weight_push_replica", t0,
                     time.perf_counter() - t0, lane=_ROUTER_LANE,
                     replica=name, version=int(v))

    async def _quiesce_replica(self, replica) -> None:
        """Wait for the replica's routed in-flight streams to finish
        (they complete on the version they started on; new dispatches
        already divert — the replica is in ``_updating``)."""
        deadline = (time.monotonic()
                    + self.config.weight_push_drain_timeout_s)
        while True:
            live = [rec for rec in self._requests.values()
                    if rec.replica == replica.name]
            if not live:
                return
            if time.monotonic() > deadline:
                raise RequestFailed(
                    f"replica {replica.name} did not finish its "
                    f"{len(live)} in-flight streams within "
                    f"{self.config.weight_push_drain_timeout_s}s; "
                    f"weight push aborted for it")
            await asyncio.sleep(0.005)

    # -- lifecycle: drain & failover ------------------------------------
    async def drain_replica(self, name: str) -> None:
        """Take ``name`` out of rotation and finish its in-flight
        streams (new traffic diverts immediately; this returns when the
        replica has fully drained)."""
        replica = self._by_name[name]
        if replica.state != "up":
            return
        replica.state = "draining"
        self._m_state.labels(replica=name).set(0.5)
        self._m_drains.inc()
        await replica.drain()
        replica.state = "drained"
        self._m_state.labels(replica=name).set(0)

    def replica_heartbeat_age(self, replica: Replica) -> Optional[float]:
        """THE source for the per-replica heartbeat signal: reads the
        stall watchdog's ``heartbeat_age``, publishes it as the
        ``router_replica_heartbeat_age_seconds`` gauge (0 = idle or
        healthy) and returns it — ``check_replicas()``, ``/statusz``
        and dashboards all read this one probe instead of each asking
        the watchdog themselves."""
        age = replica.heartbeat_age()
        series = self._hb_series.get(replica.name)
        if series is None:       # replica added after _init_telemetry
            series = self._m_heartbeat.labels(replica=replica.name)
            self._hb_series[replica.name] = series
        series.set(age if age is not None else 0.0)
        return age

    def _breaker(self, name: str) -> CircuitBreaker:
        br = self._breakers.get(name)
        if br is None:
            br = CircuitBreaker(self.config.breaker, clock=self.clock)
            self._breakers[name] = br
        return br

    @staticmethod
    def _is_remote(replica) -> bool:
        # the probe-classification surface is the remote marker
        return hasattr(replica, "probe_seq")

    def _suspect(self, name: str, reason: str) -> None:
        if name not in self._suspected:
            self._suspected[name] = reason
            self._m_suspected.labels(replica=name).set(1)
            self._m_suspects.inc()
            trace.record("router_suspect", time.perf_counter(), 0.0,
                         lane=_ROUTER_LANE, replica=name, action="suspect",
                         reason=reason)
        else:
            self._suspected[name] = reason

    def _unsuspect(self, name: str) -> None:
        if name in self._suspected:
            del self._suspected[name]
            self._m_suspected.labels(replica=name).set(0)
            trace.record("router_suspect", time.perf_counter(), 0.0,
                         lane=_ROUTER_LANE, replica=name, action="clear")

    def _note_dispatch_failure(self, replica) -> None:
        """A submit/handoff attempt failed at the transport level:
        feed the breaker (one verdict) and suspect the replica so the
        very next candidate scan routes around it."""
        if not self._is_remote(replica):
            return
        br = self._breaker(replica.name)
        was = br.state
        br.record_failure()
        if br.state == "open" and was != "open":
            self._m_breaker_opens.inc()
        self._sync_breaker_gauge(replica.name)
        self._suspect(replica.name, "connect_error")

    def _sync_breaker_gauge(self, name: str) -> None:
        state = self._breaker(name).state
        self._m_breaker_state.labels(replica=name).set(
            {"closed": 0.0, "half_open": 0.5, "open": 1.0}[state])

    def _verdict(self, replica) -> tuple:
        """Classify one up replica: ``('ok'|'suspected'|'dead',
        reason)``. In-process replicas keep the direct local signals
        (loop exit / heartbeat expiry are reliable, not a network
        blip); remote replicas go through the probe classification +
        circuit breaker so one slow probe suspends routing instead of
        amplifying into a failover."""
        if not self._is_remote(replica):
            if not replica.alive():
                return "dead", "loop_exit"
            age = self.replica_heartbeat_age(replica)
            if age is not None and age > self.config.heartbeat_timeout_s:
                return "dead", "heartbeat_expired"
            return "ok", None
        br = self._breaker(replica.name)
        seq = replica.probe_seq
        fresh = seq != self._probe_seen.get(replica.name)
        self._probe_seen[replica.name] = seq
        status = replica.probe_status
        if not fresh and br.state != "closed":
            # no new probe, breaker not closed (opened by dispatch
            # failures or held open between half-open windows): a STALE
            # 'ok' must not re-admit the replica — only a fresh
            # successful probe closes the breaker
            return "suspected", f"breaker_{br.state}"
        if status == "ok":
            if fresh:
                br.record_success()
                self._sync_breaker_gauge(replica.name)
            if not replica.alive():
                # the worker answered but reports its loop dead
                return "dead", "worker_loop_exit"
            age = self.replica_heartbeat_age(replica)
            if age is not None and age > self.config.heartbeat_timeout_s:
                return "dead", "heartbeat_expired"
            return "ok", None
        if status == "refused":
            # connection refused = nothing listening = process exit
            return "dead", "connection_refused"
        if fresh:
            was = br.state
            br.record_failure()
            if br.state == "open" and was != "open":
                self._m_breaker_opens.inc()
            self._sync_breaker_gauge(replica.name)
        if br.exhausted:
            return "dead", f"breaker_exhausted({status})"
        return "suspected", status

    async def check_replicas(self) -> List[str]:
        """Probe the fleet and classify each up replica: OK (in
        rotation), SUSPECTED (probe timeouts / open breaker — routed
        around, mid-stream requests KEEP streaming) or DEAD (process
        exit / exhausted breaker / local loop death), then fail the
        dead ones over: queued requests with no tokens yet re-dispatch
        onto survivors; requests that already streamed tokens end with
        an explicit error (their KV exists only on the dead replica).
        Returns the names declared dead this call."""
        # remote replicas: re-poll /healthz (rate-limited client-side);
        # an OPEN breaker holds its probes back until its half-open
        # window, so a struggling worker is not hammered
        up = [r for r in self.replicas if r.started and r.state == "up"]
        await asyncio.gather(
            *(r.refresh() for r in up
              if not self._is_remote(r)
              or self._breaker(r.name).allow_probe()),
            return_exceptions=True)
        died = []
        for r in up:
            self._note_weight_version(r)
            verdict, why = self._verdict(r)
            if verdict == "dead":
                died.append(r)
                self._unsuspect(r.name)
            elif verdict == "suspected":
                self._suspect(r.name, why)
            else:
                self._unsuspect(r.name)
        for replica in died:
            t0 = time.perf_counter()
            requeued = failed = resurrected = 0
            replica.state = "dead"
            self._m_state.labels(replica=replica.name).set(-1)
            self._m_dead.inc()
            # session resurrection: a survivor adopts the dead
            # replica's disk spill namespace BEFORE the reap below
            # closes the tier — the adoption moves the files out via
            # atomic rename, so the reap's own-namespace sweep finds
            # nothing to destroy
            adopter = None
            if self.config.resurrection:
                adopter = await self._adopt_spill_from(replica)
            # empty the dead replica's admission queue so a later
            # recovery cannot also run the re-enqueued work, tell its
            # loop to halt (if the thread ever unwedges it cancels
            # everything and exits instead of lingering as a zombie),
            # and stop its watchdog thread
            try:
                replica.reap()
            except Exception:
                pass
            for rec in [rec for rec in self._requests.values()
                        if rec.replica == replica.name]:
                if rec.pump is not None:
                    rec.pump.cancel()
                if rec.stream.pushed == 0 and not rec.handed_off:
                    # queued / not-yet-prefilled: safe to re-run
                    # elsewhere (prompts are idempotent)
                    self._m_requeued.inc()
                    requeued += 1
                    if adopter is not None and \
                            self._resurrects(rec, adopter):
                        self._m_resurrected.inc()
                        resurrected += 1
                    try:
                        await self._dispatch(rec)
                    except (OverloadedError, RequestFailed) as e:
                        self._finish(rec, "error",
                                     f"re-enqueue after replica death "
                                     f"shed: {e}")
                else:
                    failed += 1
                    self._finish(
                        rec, "error",
                        f"replica {replica.name} died mid-stream "
                        f"({rec.stream.pushed} tokens emitted)")
            trace.record("router_failover", t0,
                         time.perf_counter() - t0, lane=_ROUTER_LANE,
                         replica=replica.name, requeued=requeued,
                         failed_mid_stream=failed,
                         resurrected=resurrected)
        return [r.name for r in died]

    async def _adopt_spill_from(self, dead) -> Optional[Replica]:
        """Find the dead replica's disk spill namespace and have the
        least-loaded routable survivor adopt it. Returns the adopter
        (None when the dead replica had no disk tier, no survivor has
        one, or the namespace was empty) — every failure mode degrades
        to plain recompute, never a typed error."""
        try:
            fn = getattr(dead, "spill_namespace", None)
            ns = fn() if fn is not None else None
        except Exception:
            return None
        if not ns:
            return None
        for r in sorted(self._routable(), key=lambda r: r.load()):
            try:
                adopted = await r.adopt_spill(ns)
            except Exception:
                adopted = 0
            if adopted:
                self._m_resurrections.inc()
                return r
            # 0 = this survivor has no disk tier (or the source is
            # already gone): try the next one — adoption is an atomic
            # rename, so at most one survivor can win
        return None

    def _resurrects(self, rec: _RoutedRequest, adopter) -> bool:
        """True when the re-enqueued request's prefix digests survive
        in the adopter's spill tier (recompute avoided). Exact probe
        in-process; bloom-claimed for remote adopters."""
        try:
            digests = prefix_digest(
                np.asarray(rec.prompt, np.int64), self.block_size,
                adapter=rec.kw.get("adapter"))
        except Exception:
            return False
        if not digests:
            return False
        summary = adopter.spill_summary()
        if summary is None:
            return False
        claimed = [d for d in digests if summary.claims(d)]
        if not claimed:
            return False
        probe = adopter.spill_probe(claimed)
        return bool(claimed) if probe is None else probe > 0

    # -- introspection (the ServingAPI surface) -------------------------
    def health(self) -> dict:
        up = [r for r in self.replicas if r.state == "up"]
        healths = {r.name: r.health() for r in self.replicas}
        return {
            "status": "ok" if up and not self._stopped else "draining",
            "replicas": healths,
            "queue_depth": sum(h.get("queue_depth", 0)
                               for h in healths.values()),
            "queued_tokens": sum(h.get("queued_tokens", 0)
                                 for h in healths.values()),
            "inflight": sum(h.get("inflight", 0)
                            for h in healths.values()),
            "routable": [r.name for r in self._routable()],
        }

    def replica_statusz(self) -> dict:
        """Per-replica forensics rollup for the aggregated /statusz."""
        out = {}
        for r in self.replicas:
            # one probe feeds the gauge AND this document (satellite:
            # dashboards, check_replicas and /statusz share the source)
            age = self.replica_heartbeat_age(r)
            out[r.name] = {
                "state": r.state,
                "health": r.health(),
                "load": r.load(),
                "heartbeat_age_s": (round(age, 3)
                                    if age is not None else None),
                "backoff_remaining_s": max(
                    0.0, round(self._backoff_until.get(r.name, 0.0)
                               - self.clock(), 3)),
                "suspected": self._suspected.get(r.name),
                "breaker": (self._breaker(r.name).snapshot()
                            if self._is_remote(r) else None),
            }
        for p in self.prefill_replicas:
            out[p.name] = p.health()
        return out

    def router_statusz(self) -> dict:
        return {
            "placement": self.config.placement,
            "disaggregated": self.config.disaggregated,
            "affinity_entries": len(self._affinity),
            "inflight_routed": len(self._requests),
            "replica_states": {r.name: r.state for r in self.replicas},
            "suspected": dict(self._suspected),
            "last_fleet_bundle": self._last_fleet_bundle,
            # blue/green rollout state: the fleet has converged when
            # every up replica's version equals the target
            "target_weight_version": self.target_weight_version,
            "weight_updating": sorted(self._updating),
            "replica_weight_versions": {
                r.name: self._replica_weight_version(r)
                for r in self.replicas},
        }

    # -- fleet observability surfaces -----------------------------------
    def _remote_replicas(self) -> List:
        return [r for r in self.replicas if hasattr(r, "fetch_spans")]

    def fleet_timeline(self, trace_id: Optional[str] = None):
        """The stitched fleet Chrome trace: one process row per lane —
        the router plus every replica (in-process replicas share the
        ring; spans are lane-tagged; remote replicas' rings are fetched
        over ``GET /debug/spans`` and rebased onto this clock, which
        makes the result a coroutine when any replica is remote).
        ``trace_id`` filters to one request's hops across the whole
        fleet (the router-level ``GET /debug/timeline?trace=<id>``
        body)."""
        from ....telemetry import timeline
        remotes = self._remote_replicas()
        if not remotes:
            return timeline.stitch_fleet(trace_id=trace_id)

        async def stitch():
            rings = {"host": trace.export()}
            spans = await asyncio.gather(
                *(r.fetch_spans() for r in remotes),
                return_exceptions=True)
            for r, s in zip(remotes, spans):
                if isinstance(s, list):
                    rings[r.name] = s
            return timeline.stitch_fleet(rings, trace_id=trace_id)

        return stitch()

    def federated_metrics(self) -> str:
        """The router-level ``/metrics`` exposition: when replicas own
        registries (``Replica(registry=...)``), every replica's series
        is federated under a ``replica`` label next to the router's own
        (process-default) series; with shared registries the process
        default already aggregates the fleet and renders unchanged.
        Remote replicas contribute their LAST-FETCHED exposition
        (``federated_metrics_async`` refreshes before rendering — the
        HTTP layer prefers it)."""
        from ....telemetry import get_registry
        from ....telemetry.registry import render_federated
        own = [(r.name, r.registry) for r in self.replicas
               if getattr(r, "registry", None) is not None]
        if own:
            text = render_federated([("router", get_registry())] + own)
        else:
            text = get_registry().render_prometheus()
        for r in self._remote_replicas():
            remote_text = r.metrics_text()
            if remote_text:
                text += _relabel_exposition(remote_text, "replica",
                                            r.name)
        return text

    async def federated_metrics_async(self) -> str:
        """Fetch fresh expositions from remote replicas, then render
        the federated view."""
        await asyncio.gather(
            *(r.fetch_metrics() for r in self._remote_replicas()),
            return_exceptions=True)
        return self.federated_metrics()

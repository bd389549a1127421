"""Asyncio front end of the serving runtime.

:class:`ServingEngine` decouples clients from the model loop: ``await
submit(...)`` admission-checks the request (raising
:class:`~.admission.OverloadedError` under overload — explicit
backpressure, never an unbounded queue) and returns a
:class:`TokenStream`, an async iterator that yields tokens as the
background :class:`~.loop.ServingLoop` emits them. Cancelling a stream —
``cancel()``, ``aclose()`` (e.g. via ``contextlib.aclosing``), or as a
garbage-collection safety net when the stream is dropped — releases the
request's KV blocks back to the pool mid-decode. A bare ``break`` out of
``async for`` does NOT call ``aclose()`` on a plain async iterator:
callers abandoning a stream early should ``await stream.cancel()`` (the
GC net is best-effort and its timing is the collector's). Per-request
deadlines cancel overdue work wherever it is (pending or mid-decode).

Tokens are byte-identical to the direct scheduler path: the runtime
changes WHEN work runs, never what it computes.

Port note: a copy of ``deepspeed_tpu/inference/v2/serve/frontend.py``
(``ServingConfig``, ``TokenStream``, ``ServingEngine``, and the fleet's
handles ``ChunkedHandoff`` and ``WeightUpdate``: KV handoffs through
``resume`` / ``begin_handoff``, live weight updates through
``begin_weight_update`` / ``apply_weights``). ``ServingConfig.autotune``
(an ``OnlineAdapterConfig``) builds the SLO-driven online adapter
(``autotuning/online.py``) over the engine, the admission controller and
the SLO monitor; the loop ticks it between scheduler steps.
"""

import asyncio
import itertools
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from ....telemetry import context as trace_context
from ....telemetry.anomaly import (DiagnosticsConfig, KVLeakDetector,
                                   SLOBurnRateMonitor, StallWatchdog)
from ....telemetry.recorder import get_recorder
from ....autotuning.online import OnlineAdapter, OnlineAdapterConfig
from ..scheduler import DynamicSplitFuseScheduler
from .admission import AdmissionConfig, AdmissionController
from .loop import FollowerLoop, LeaderEngine, ModelGroup, ServingLoop


class DeadlineExceeded(Exception):
    """The request's deadline passed before it finished; its KV blocks
    were released and no further tokens will arrive."""


class RequestFailed(RuntimeError):
    """The model loop could not run the request (e.g. the prompt exceeds
    max_seq_len, or a step-time engine failure)."""


@dataclass
class ServingConfig:
    token_budget: Optional[int] = None      # scheduler step budget
    chunk: Optional[int] = None             # prefill chunk size
    max_inflight: Optional[int] = None      # requests inside the scheduler
    idle_wait_s: float = 0.002
    # 'auto' | 'on' | 'off': override the engine's ragged unified-step
    # dispatch (config_v2.ragged_attention) for this serving runtime —
    # 'off' is the rollback knob to the stitched prefill/decode
    # families; None leaves the engine's own setting alone
    ragged_attention: Optional[str] = None
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    # active observability: flight-recorder budget, SLO burn-rate
    # monitoring, stall watchdog, KV-leak check at drain (telemetry/
    # anomaly.py; docs/TELEMETRY.md § Anomaly detectors)
    diagnostics: DiagnosticsConfig = field(
        default_factory=DiagnosticsConfig)
    # SLO-driven online adaptation of the registry's online=True knobs
    # (decode window, admission token budget) between scheduler steps —
    # autotuning/online.py; None disables it
    autotune: Optional[OnlineAdapterConfig] = None


class ServingDiagnostics:
    """The serving runtime's active-observability bundle: the SLO
    burn-rate monitor the loop ticks, the stall watchdog it beats, and
    the KV-leak detector it runs at drain. ``None`` members mean the
    feature is disabled; the loop checks for that."""

    def __init__(self, config: DiagnosticsConfig):
        self.config = config
        self.slo: Optional[SLOBurnRateMonitor] = None
        self.stall: Optional[StallWatchdog] = None
        self.leak: Optional[KVLeakDetector] = None
        if not config.enabled:
            return
        get_recorder().set_budget(config.recorder_max_bytes)
        self.slo = SLOBurnRateMonitor(config)
        self.leak = KVLeakDetector(config)
        if config.stall_enabled:
            self.stall = StallWatchdog(config).start()
            self.stall.register("serving_loop")

    def close(self) -> None:
        if self.stall is not None:
            self.stall.stop()


@dataclass
class _Entry:
    """The loop-side request record (see ServingLoop's duck-type)."""
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int]
    temperature: float
    top_p: float
    top_k: int
    seed: Optional[int]
    tenant: str
    weight: Optional[float]
    deadline_t: Optional[float]
    on_token: object = None
    on_end: object = None
    state: str = "pending"
    # LoRA adapter NAME this request is served through (None = base):
    # rides into scheduler.submit and the admission fairness key
    adapter: Optional[str] = None
    # distributed TraceContext (telemetry/context.py), captured on the
    # asyncio side: the serving-loop thread does not share the asyncio
    # contextvar context, so the entry carries it across that boundary
    trace_ctx: object = None


class TokenStream:
    """Async iterator over one request's generated tokens.

    Ends (StopAsyncIteration) when the request completes or is
    cancelled; raises :class:`DeadlineExceeded` on deadline expiry and
    :class:`RequestFailed` on model-loop errors. ``status`` is one of
    'active' | 'completed' | 'cancelled' | 'expired' | 'error'."""

    def __init__(self, serving: "ServingEngine", uid: int,
                 aio_loop: asyncio.AbstractEventLoop):
        self._serving = serving
        self._aio = aio_loop
        self._q: asyncio.Queue = asyncio.Queue()
        self._ended = False
        self.uid = uid
        self.status = "active"
        self.reason: Optional[str] = None
        self.tokens: List[int] = []

    # called from the serving-loop thread
    def _push_token(self, tok: int, finished: bool) -> None:
        self._aio.call_soon_threadsafe(self._q.put_nowait, ("tok", tok))

    def _push_end(self, status: str, reason: Optional[str]) -> None:
        self._aio.call_soon_threadsafe(self._q.put_nowait,
                                       ("end", status, reason))

    # -- async iterator -------------------------------------------------
    def __aiter__(self) -> "TokenStream":
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
            raise RequestFailed(
                f"request {self.uid}: {self.reason}")
        raise StopAsyncIteration    # completed or cancelled

    async def cancel(self) -> None:
        """Abort the request: its KV blocks return to the pool and the
        stream ends (status 'cancelled'); no further tokens arrive."""
        self._serving._loop_runner.request_cancel(self.uid)

    async def aclose(self) -> None:
        if not self._ended and self.status == "active":
            await self.cancel()

    def __del__(self):
        # best-effort net for dropped streams: without it an abandoned
        # request decodes to max_new_tokens holding its KV blocks.
        # request_cancel only touches a thread-safe deque + Event, so it
        # is safe from a finalizer; a finished uid makes it a no-op.
        if self.status == "active":
            try:
                self._serving._loop_runner.request_cancel(self.uid)
            except Exception:
                pass

    async def drain(self) -> List[int]:
        """Collect every remaining token; returns all tokens so far."""
        async for _ in self:
            pass
        return self.tokens


class ServingEngine:
    """Async serving runtime: frontend -> admission -> loop -> scheduler.

    Usage::

        serving = ServingEngine(engine, ServingConfig(token_budget=128))
        await serving.start()
        stream = await serving.submit(prompt_ids, max_new_tokens=64)
        async for tok in stream:
            ...
        await serving.stop()          # graceful drain
    """

    def __init__(self, engine, config: Optional[ServingConfig] = None,
                 clock=time.perf_counter, bridge=None,
                 lane: Optional[str] = None):
        """``bridge``: optional :class:`~...telemetry.TelemetryBridge`;
        the loop final-flushes (``close()``) it on drain/stop so the last
        partial flush interval reaches the monitor backends.

        ``lane``: fleet lane name for the serving loop's spans (the
        replica name under a router; see telemetry/trace.py
        ``set_lane``) — the stitched fleet timeline groups spans into
        one process row per lane.

        Over an SPMD engine (tensor or expert parallel) every rank of the
        engine builds its ``ServingEngine``: the group's rank 0 serves
        (front end, admission, scheduler; its engine calls reach the
        others through ``loop.LeaderEngine``) and every other rank
        follows (``loop.FollowerLoop``; ``submit`` refuses there), from
        ``start()`` until the leader's loop ends."""
        self.config = config or ServingConfig()
        self._stopped = False
        self.follower = False
        if getattr(engine, "topology", None) is not None:
            group = ModelGroup(engine)
            if not group.leader:
                self.follower = True
                self.diagnostics = None
                self._loop_runner = FollowerLoop(engine, group)
                return
            engine = LeaderEngine(engine, group)
        self.clock = clock
        if self.config.ragged_attention is not None:
            engine.set_ragged_mode(self.config.ragged_attention)
        self.scheduler = DynamicSplitFuseScheduler(
            engine, token_budget=self.config.token_budget,
            chunk=self.config.chunk, clock=clock)
        self.admission = AdmissionController(self.config.admission)
        self.diagnostics = ServingDiagnostics(self.config.diagnostics)
        # SLO-driven online adapter (autotuning/online.py): ticked by the
        # loop thread between scheduler steps — the only thread that
        # touches the engine
        self.adapter: Optional[OnlineAdapter] = None
        if (self.config.autotune is not None
                and self.config.autotune.enabled):
            self.adapter = OnlineAdapter(
                engine, admission=self.admission,
                slo=self.diagnostics.slo, config=self.config.autotune)
        self._loop_runner = ServingLoop(
            self.scheduler, self.admission,
            max_inflight=self.config.max_inflight,
            idle_wait_s=self.config.idle_wait_s, clock=clock,
            bridge=bridge, diagnostics=self.diagnostics, lane=lane,
            adapter=self.adapter)
        self._uids = itertools.count(1)

    @property
    def loop_runner(self) -> ServingLoop:
        return self._loop_runner

    # -- lifecycle ------------------------------------------------------
    async def start(self) -> "ServingEngine":
        if self._stopped:
            raise RuntimeError("serving engine already stopped")
        self._loop_runner.start()
        return self

    async def stop(self, drain: bool = True,
                   timeout: Optional[float] = None) -> None:
        """Shut the runtime down. ``drain=True`` (graceful): new submits
        are rejected immediately, everything already admitted finishes.
        ``drain=False``: in-flight requests are cancelled (KV released)
        and their streams end with status 'cancelled'."""
        self._stopped = True
        if drain:
            self._loop_runner.request_drain()
        else:
            self._loop_runner.request_stop()
        if not self._loop_runner.running:
            # never started: end anything parked in the queues
            self._loop_runner.start()
        await asyncio.to_thread(self._loop_runner.join, timeout)
        if self.diagnostics is not None:
            self.diagnostics.close()

    async def __aenter__(self) -> "ServingEngine":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=exc == (None, None, None))

    # -- submission -----------------------------------------------------
    def _refuse_follower(self) -> None:
        if self.follower:
            raise RuntimeError(
                "this rank follows its engine group's rank 0, which serves "
                "the requests")

    async def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
                     eos_token_id: Optional[int] = None,
                     temperature: float = 0.0, top_p: float = 1.0,
                     top_k: int = 0, seed: Optional[int] = None,
                     tenant: str = "default",
                     weight: Optional[float] = None,
                     deadline_s: Optional[float] = None,
                     adapter: Optional[str] = None) -> TokenStream:
        """Admit a request and return its token stream.

        Raises :class:`~.admission.OverloadedError` when the runtime is
        overloaded (bounded queue full / token budget exceeded /
        draining) — callers retry with backoff or surface 429.
        ``deadline_s`` is a wall-clock budget from now; overdue requests
        are cancelled wherever they are and the stream raises
        :class:`DeadlineExceeded`. ``adapter`` names a loaded LoRA
        adapter to serve the request through (None = base model); it
        scopes admission fairness within the tenant and the engine's
        per-row adapter gather."""
        self._refuse_follower()
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        uid = next(self._uids)
        # distributed tracing: continue the caller's context (bound by
        # the HTTP layer from a traceparent header, or by the router at
        # dispatch) or mint a fresh root — every request has ONE trace
        # identity from here to its last decode token
        ctx = trace_context.get_or_new()
        stream = TokenStream(self, uid, asyncio.get_running_loop())
        entry = _Entry(
            uid=uid, prompt=list(map(int, prompt)),
            max_new_tokens=int(max_new_tokens),
            eos_token_id=eos_token_id, temperature=temperature,
            top_p=top_p, top_k=top_k, seed=seed, tenant=tenant,
            weight=weight,
            deadline_t=(self.clock() + deadline_s
                        if deadline_s is not None else None),
            on_token=stream._push_token, on_end=stream._push_end,
            trace_ctx=ctx, adapter=adapter)
        self.admission.try_admit(entry)     # raises OverloadedError
        self._loop_runner.register(entry)
        return stream

    # -- handoff (prefill/decode disaggregation; serve/handoff.py) ------
    async def resume(self, pack, *, prompt: Sequence[int],
                     generated: Sequence[int], max_new_tokens: int,
                     eos_token_id: Optional[int] = None,
                     temperature: float = 0.0, top_p: float = 1.0,
                     top_k: int = 0, rng_state=None,
                     deadline_s: Optional[float] = None,
                     trace_ctx=None) -> TokenStream:
        """Adopt a handed-off request: restore the KV ``pack`` exported
        by a prefill replica and continue decoding it here. The stream
        yields only the tokens decoded on THIS runtime — the caller
        already streamed ``generated`` (at least the prefill's first
        token). Restore and scheduler adoption run on the loop thread
        (the engine is not thread-safe); a restore failure ends the
        stream with status 'error'.

        ``trace_ctx`` continues the request's distributed trace across
        the handoff; when omitted, the pack's wire payload (embedded by
        the prefill side — serve/handoff.py) or the caller's bound
        context is used, so the decode hop lands in the SAME trace as
        router dispatch and prefill.

        Resumed requests bypass the admission queue — there is no
        pending phase to queue through; the ROUTER is the admission
        point for disaggregated traffic and picks the decode replica by
        its load signals before prefill ever runs."""
        self._refuse_follower()
        if self._stopped or self.admission.closed:
            from .admission import OverloadedError
            raise OverloadedError(
                "draining", "serving runtime is draining; not accepting "
                "handoffs",
                retry_after_s=self.config.admission.retry_after_s)
        uid = next(self._uids)
        stream = TokenStream(self, uid, asyncio.get_running_loop())
        entry = _Entry(
            uid=uid, prompt=list(map(int, prompt)),
            max_new_tokens=int(max_new_tokens),
            eos_token_id=eos_token_id, temperature=temperature,
            top_p=top_p, top_k=top_k, seed=None, tenant="handoff",
            weight=None,
            deadline_t=(self.clock() + deadline_s
                        if deadline_s is not None else None),
            on_token=stream._push_token, on_end=stream._push_end,
            state="inflight",
            trace_ctx=(trace_ctx if trace_ctx is not None
                       else trace_context.from_wire(pack.get("trace"))
                       or trace_context.current()))
        self._loop_runner.resume(entry, pack,
                                 generated=list(map(int, generated)),
                                 rng_state=rng_state)
        return stream

    async def begin_handoff(self, header_chunk: bytes) -> "ChunkedHandoff":
        """Open a chunked streaming handoff (serve/handoff.py chunk
        protocol): parse the header chunk, adopt the destination blocks
        on the loop thread, and return the feed/commit/abort handle.
        Each fed chunk applies BETWEEN scheduler steps, so the transfer
        overlaps this runtime's running batch. Raises
        :class:`~.admission.OverloadedError` while draining (the
        caller re-routes, like ``resume``)."""
        self._refuse_follower()
        from . import handoff as handoff_mod
        if self._stopped or self.admission.closed:
            from .admission import OverloadedError
            raise OverloadedError(
                "draining", "serving runtime is draining; not accepting "
                "handoffs",
                retry_after_s=self.config.admission.retry_after_s)
        header = await asyncio.to_thread(handoff_mod.parse_header,
                                         header_chunk)
        uid = next(self._uids)
        await self._loop_runner.run_on_loop(
            lambda: self._loop_runner.begin_restore(uid, header))
        return ChunkedHandoff(self, uid, header)

    # -- live weight update (serve/weights.py; blue/green hot-swap) -----
    async def begin_weight_update(self, header_chunk: bytes
                                  ) -> "WeightUpdate":
        """Open a chunked weight update: chunks stage HOST-SIDE (CRC-
        checked, off the loop thread — the running batch keeps
        stepping), then ``commit`` applies ONE atomic param swap
        between scheduler steps. A stream therefore never sees tokens
        from two weight versions unless it spans the commit — which the
        router's blue/green rollout prevents by draining a replica's
        routed streams before pushing (serve/router.py)."""
        self._refuse_follower()
        from . import weights as serve_weights
        if self._stopped or self.admission.closed:
            from .admission import OverloadedError
            raise OverloadedError(
                "draining", "serving runtime is draining; not accepting "
                "weight updates",
                retry_after_s=self.config.admission.retry_after_s)
        header = await asyncio.to_thread(
            serve_weights.parse_weights_header, header_chunk)
        return WeightUpdate(self, serve_weights.WeightStager(header))

    async def apply_weights(self, payloads: Sequence[bytes]) -> int:
        """Stage + commit a complete weight payload; returns the
        installed version."""
        update = await self.begin_weight_update(payloads[0])
        try:
            for chunk in payloads[1:]:
                await update.feed(chunk)
            return await update.commit()
        except BaseException:
            await update.abort()
            raise

    @property
    def weight_version(self) -> int:
        return int(getattr(self.scheduler.engine, "weight_version", 0))

    # -- introspection --------------------------------------------------
    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the serving loop's last stall-watchdog
        heartbeat while mid-step, or None when idle / watchdog off.
        The replica router's dead-replica detector reads this."""
        stall = self.diagnostics.stall
        if stall is None:
            return None
        return stall.heartbeat_age("serving_loop")

    def health(self) -> dict:
        age = self.heartbeat_age()
        return {
            "status": ("draining" if (self.admission.closed
                                      or self._stopped) else "ok"),
            "queue_depth": self.admission.depth(),
            "queued_tokens": self.admission.queued_tokens(),
            "inflight": self.scheduler.inflight(),
            "loop_alive": self._loop_runner.running,
            # the replica-surface signals a remote router shim maps
            # from one /healthz poll (serve/remote.py)
            "load": (self.admission.queued_tokens()
                     + self.scheduler.inflight()),
            "heartbeat_age_s": age,
            "block_size": int(
                self.scheduler.engine.state_manager.block_size),
            "max_seq_len": int(
                self.scheduler.engine.state_manager.config.max_seq_len),
            # blue/green rollout signal (serve/weights.py): the router
            # converges the fleet onto one target version off this field
            "weight_version": self.weight_version,
            # spill-aware placement signal (ragged/spill.py): the bloom
            # summary of this replica's spilled digests rides every
            # heartbeat, so the router can place a returning
            # conversation where its cold KV actually lives
            "kv_spill": self.spill_summary_doc(),
        }

    def spill_summary_doc(self) -> Optional[dict]:
        """The spill tier's digest summary as a document, or None when the
        engine runs without one."""
        spill = getattr(self.scheduler.engine, "spill", None)
        if spill is None:
            return None
        return spill.digest_summary().to_doc()


class ChunkedHandoff:
    """Client handle for one streaming handoff into a
    :class:`ServingEngine` (``begin_handoff``): ``feed`` each KV chunk
    (awaiting the ack paces the wire and lets scheduler steps
    interleave), then ``commit`` with the decode parameters to get the
    token stream — or ``abort`` to free the partially-streamed blocks."""

    def __init__(self, serving: ServingEngine, uid: int, header: dict):
        self._serving = serving
        self.uid = uid
        self.header = header
        self._open = True

    async def feed(self, chunk: bytes) -> None:
        from . import handoff as handoff_mod
        parsed = await asyncio.to_thread(handoff_mod.parse_chunk, chunk)
        loop = self._serving._loop_runner
        try:
            await loop.run_on_loop(
                lambda: loop.apply_restore(self.uid, parsed, len(chunk)))
        except asyncio.CancelledError:
            # the AWAIT was cancelled, not the apply — the loop-side
            # restore may still be live, so the handle stays open and
            # abort()/__del__ can free it (closing here would leak the
            # blocks and wedge graceful drain)
            raise
        except BaseException:
            # the loop already freed the blocks on an apply failure
            self._open = False
            raise

    async def commit(self, *, prompt: Sequence[int],
                     generated: Sequence[int], max_new_tokens: int,
                     eos_token_id: Optional[int] = None,
                     temperature: float = 0.0, top_p: float = 1.0,
                     top_k: int = 0, rng_state=None,
                     deadline_s: Optional[float] = None,
                     trace_ctx=None) -> TokenStream:
        """Verify every chunk arrived and resume decoding here — the
        chunked counterpart of :meth:`ServingEngine.resume` (same
        parameters, same bit-identical-to-colocated contract)."""
        serving = self._serving
        stream = TokenStream(serving, self.uid,
                             asyncio.get_running_loop())
        entry = _Entry(
            uid=self.uid, prompt=list(map(int, prompt)),
            max_new_tokens=int(max_new_tokens),
            eos_token_id=eos_token_id, temperature=temperature,
            top_p=top_p, top_k=top_k, seed=None, tenant="handoff",
            weight=None,
            deadline_t=(serving.clock() + deadline_s
                        if deadline_s is not None else None),
            on_token=stream._push_token, on_end=stream._push_end,
            state="inflight",
            trace_ctx=(trace_ctx if trace_ctx is not None
                       else trace_context.current()
                       or trace_context.from_wire(
                           self.header.get("trace"))))
        loop = self._serving._loop_runner
        try:
            await loop.run_on_loop(
                lambda: loop.commit_restore(
                    entry, list(map(int, generated)), rng_state))
        except asyncio.CancelledError:
            # await cancelled mid-commit: leave the handle open so
            # abort() can still free an uncommitted restore (abort is
            # a no-op if the loop-side commit did run)
            raise
        except BaseException:
            self._open = False   # loop-side commit failed: already
            raise                # aborted there
        self._open = False
        return stream

    async def abort(self) -> None:
        if not self._open:
            return
        self._open = False
        loop = self._serving._loop_runner
        try:
            await loop.run_on_loop(
                lambda: loop._abort_restore(self.uid))
        except Exception:
            pass

    def __del__(self):
        # GC net: a dropped handle must not wedge drain holding blocks
        # (_abort_restore only touches loop-thread state via post())
        if self._open:
            try:
                self._serving._loop_runner.post(
                    lambda: self._serving._loop_runner._abort_restore(
                        self.uid))
            except Exception:
                pass


class WeightUpdate:
    """Client handle for one staged weight update into a
    :class:`ServingEngine` (``begin_weight_update``): ``feed`` each
    payload chunk (host-side staging + CRC — the loop keeps stepping
    its batch), then ``commit`` applies the atomic swap between
    scheduler steps; ``abort`` drops the staged leaves without touching
    the live params."""

    def __init__(self, serving: ServingEngine, stager):
        self._serving = serving
        self._stager = stager
        self._open = True
        self._t0 = time.perf_counter()
        loop = serving._loop_runner
        loop.weight_staging += 1
        from ....telemetry import get_registry
        self._m_seconds = get_registry().histogram(
            "serving_weight_update_seconds",
            "weight update begin -> committed swap (staging overlaps "
            "the running batch; only the final swap touches the loop)",
            unit="s", buckets=(1e-3, 1e-2, 0.1, 1.0, 10.0, 60.0))

    @property
    def version(self) -> int:
        return int(self._stager.version)

    async def feed(self, chunk: bytes) -> None:
        if not self._open:
            raise RuntimeError("weight update already closed")
        try:
            await asyncio.to_thread(self._stager.feed, chunk)
        except BaseException:
            await self.abort()
            raise

    async def commit(self) -> int:
        """Verify every chunk arrived and swap the live params between
        scheduler steps. Returns the installed version."""
        from . import weights as serve_weights
        if not self._open:
            raise RuntimeError("weight update already closed")
        stager = self._stager
        stager.commit_check()
        loop = self._serving._loop_runner

        engine = loop.scheduler.engine
        # host-side half off the loop thread: for DELTA payloads this
        # validates the base version and reconstructs base +
        # dequant(delta) (typed failure on stale base, live params
        # untouched); full payloads pass through
        try:
            flat = await asyncio.to_thread(
                serve_weights.prepare_stager, engine, stager)
        except BaseException:
            await self.abort()
            raise

        def swap() -> int:
            # full / delta -> the in-place param swap
            # (weights.install_stager)
            return serve_weights.install_stager(engine, stager, flat)
        try:
            version = await loop.run_on_loop(swap)
        finally:
            self._close()
        self._m_seconds.observe(time.perf_counter() - self._t0)
        return version

    async def abort(self) -> None:
        self._close()

    def _close(self) -> None:
        if self._open:
            self._open = False
            self._stager.leaves = {}
            self._serving._loop_runner.weight_staging -= 1

    def __del__(self):
        if self._open:
            try:
                self._close()
            except Exception:
                pass

"""Engine replicas behind the serving router.

Two replica kinds:

  * :class:`Replica` — a full serving unit: one
    :class:`~.frontend.ServingEngine` (admission + continuous-batching
    loop) over one engine. The router dispatches streaming requests to
    it, reads its load/heartbeat signals, drains it without dropping
    in-flight streams, and declares it dead when its stall-watchdog
    heartbeat expires.
  * :class:`PrefillReplica` — a dedicated prefill worker for the
    disaggregated mode: it runs whole-prompt prefill on its own engine,
    samples the request's FIRST token with the request's own rng (the
    colocated first-token path, so streams stay bit-identical), exports
    the sequence's KV for handoff (serve/handoff.py) and immediately
    flushes — it never decodes, so its pool only ever holds prompts in
    flight.

Replicas here are in-process (each owns its engine; chip-free on CPU).
The router only touches the surface defined by these classes —
``submit`` / ``resume_handoff`` / ``health`` / ``load`` /
``heartbeat_age`` / ``refresh`` / ``drain`` / ``stop`` / ``reap`` /
``kill`` / ``block_size`` — and serve/remote.py's
:class:`~.remote.RemoteReplica` implements the same surface over a
worker process's HTTP API, so socket-backed replicas slot in behind
the identical router.

Port note: a port of ``deepspeed_tpu/inference/v2/serve/replica.py``
over the port's engine. A prefill runs on a pooled worker thread, which
selects the engine's CUDA device first (a thread starts on device 0).
"""

import asyncio
import contextlib
import itertools
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ....telemetry import trace
from ....telemetry.registry import scoped_registry
from . import handoff
from .frontend import ServingConfig, ServingEngine
from .loop import select_device


class Replica:
    """One in-process serving replica: name + engine + serving runtime.

    ``state`` is router-owned: 'up' (routable) | 'draining' (finishing
    in-flight work, no new routes) | 'drained' (clean exit) | 'dead'
    (heartbeat expired or loop thread gone).

    ``registry``: optional per-replica
    :class:`~....telemetry.MetricsRegistry` — the serving stack
    (scheduler, admission, loop, diagnostics) is then BUILT inside a
    ``scoped_registry`` block so its series land there instead of the
    process default, and the router's ``/metrics`` federates every
    replica registry under a ``replica`` label. The engine was
    constructed earlier, so engine-level series stay process-global."""

    def __init__(self, name: str, engine,
                 config: Optional[ServingConfig] = None, bridge=None,
                 registry=None):
        self.name = name
        self.engine = engine
        self.registry = registry
        with (scoped_registry(registry) if registry is not None
              else contextlib.nullcontext()):
            self.serving = ServingEngine(engine, config, bridge=bridge,
                                         lane=name)
        self.state = "up"
        self.started = False

    # -- lifecycle ------------------------------------------------------
    async def start(self) -> "Replica":
        await self.serving.start()
        self.started = True
        return self

    async def drain(self) -> None:
        """Graceful: new submits are rejected immediately, everything
        already admitted (including mid-stream decodes) finishes."""
        await self.serving.stop(drain=True)

    async def stop(self) -> None:
        """Hard stop: in-flight requests are cancelled (KV released).
        Idempotent — the autoscaler's drain-then-stop calls it after a
        drain already stopped the runtime."""
        if self.serving._stopped and not self.serving.loop_runner.running:
            return
        await self.serving.stop(drain=False)

    def reap(self) -> None:
        """Dead-replica cleanup (the router declared this replica
        dead): empty the admission queue so a later recovery cannot
        also run the re-enqueued work, tell the loop to halt, stop the
        watchdog thread, and close the spill tier so the dead replica
        leaks no host RAM or disk scratch (the router adopts the disk
        namespace into a survivor BEFORE reaping, so resurrection sees
        the files first)."""
        try:
            self.serving.admission.reclaim_pending()
            self.serving.loop_runner.request_stop()
            self.serving.diagnostics.close()
        except Exception:
            pass
        try:
            spill = getattr(self.engine, "spill", None)
            if spill is not None:
                spill.close()
        except Exception:
            pass

    async def kill(self) -> None:
        """Best-effort terminate a dead replica's loop thread: an
        unwedged loop exits on the halt command; a truly stuck one
        stays a daemon thread."""
        try:
            self.serving.loop_runner.request_stop()
            await asyncio.to_thread(self.serving.loop_runner.join, 2.0)
        except Exception:
            pass

    async def refresh(self, force: bool = False) -> None:
        """In-process signals are always fresh (the remote counterpart
        re-polls /healthz here)."""

    # -- router signals -------------------------------------------------
    def alive(self) -> bool:
        """The loop thread is running (False once drained/stopped, or
        if the thread died)."""
        return self.serving.loop_runner.running

    def heartbeat_age(self) -> Optional[float]:
        """Seconds the loop has been stuck mid-step (None when idle or
        the stall watchdog is disabled) — the dead-replica signal."""
        return self.serving.heartbeat_age()

    def load(self) -> float:
        """Routing load signal: queued future work plus in-flight
        requests (the admission/token-budget signals the router
        rebalances on)."""
        return (self.serving.admission.queued_tokens()
                + self.serving.scheduler.inflight())

    def health(self) -> dict:
        return {"name": self.name, "state": self.state,
                **self.serving.health()}

    # -- spill-aware placement (ragged/spill.py; router placement) ------
    def spill_summary(self):
        """Live :class:`~..ragged.spill.SpillSummary` of this replica's
        spilled digests (None without a spill tier). In-process
        replicas answer from the tier directly — always fresh; the
        remote counterpart decodes its cached /healthz document."""
        spill = getattr(self.engine, "spill", None)
        return spill.digest_summary() if spill is not None else None

    def spill_namespace(self) -> Optional[str]:
        """Disk-tier namespace under the shared kv_spill_dir (None
        without a disk tier) — what a survivor adopts when this
        replica dies."""
        spill = getattr(self.engine, "spill", None)
        if spill is None or not spill.root_dir:
            return None
        return spill.namespace

    def spill_probe(self, digests) -> Optional[int]:
        """EXACT count of ``digests`` present in this replica's spill
        tier — the router's bloom-false-positive detector. Remote
        replicas return None (only the bloom is visible without a
        round trip)."""
        spill = getattr(self.engine, "spill", None)
        if spill is None:
            return None
        return sum(1 for d in digests if spill.has(d))

    async def adopt_spill(self, namespace: str) -> int:
        """Adopt a dead peer's disk-tier spill namespace into this
        replica's tier (session resurrection). Returns entries
        adopted; 0 without a spill tier."""
        spill = getattr(self.engine, "spill", None)
        if spill is None:
            return 0
        return await asyncio.to_thread(spill.adopt_namespace, namespace)

    @property
    def block_size(self) -> int:
        return int(self.engine.state_manager.block_size)

    @property
    def max_seq_len(self) -> int:
        return int(self.engine.state_manager.config.max_seq_len)

    @property
    def diagnostics(self):
        return self.serving.diagnostics

    def metrics_text(self) -> Optional[str]:
        """In-process replicas federate via their registries (None =
        the router reads ``self.registry`` directly)."""
        return None

    # -- live weights (serve/weights.py; blue/green rollout) ------------
    @property
    def weight_version(self) -> int:
        return self.serving.weight_version

    async def apply_weights(self, payloads: Sequence[bytes]) -> int:
        """Stage + commit a weight payload on this replica (the router's
        in-process push transport; remote replicas stream the same
        payload over ``POST /weights``)."""
        return await self.serving.apply_weights(payloads)

    # -- traffic --------------------------------------------------------
    async def submit(self, prompt: Sequence[int], max_new_tokens: int,
                     **kw):
        return await self.serving.submit(prompt, max_new_tokens, **kw)

    async def resume_handoff(self, payloads: Sequence[bytes], *,
                             chunked: bool, prompt: Sequence[int],
                             generated: Sequence[int],
                             max_new_tokens: int, eos_token_id=None,
                             temperature: float = 0.0,
                             top_p: float = 1.0, top_k: int = 0,
                             rng_state=None, deadline_s=None):
        """Adopt a handed-off request from its serialized payloads —
        the ONE handoff entry point the router uses for both transports
        (``chunked=False``: one blocking ``handoff.serialize`` buffer;
        ``chunked=True``: ``[header, kv-chunk...]``, each chunk applied
        between this replica's scheduler steps)."""
        kw = dict(max_new_tokens=max_new_tokens,
                  eos_token_id=eos_token_id, temperature=temperature,
                  top_p=top_p, top_k=top_k, rng_state=rng_state,
                  deadline_s=deadline_s)
        if not chunked:
            pack = await asyncio.to_thread(handoff.deserialize,
                                           payloads[0])
            return await self.serving.resume(pack, prompt=prompt,
                                             generated=generated, **kw)
        handle = await self.serving.begin_handoff(payloads[0])
        try:
            for chunk in payloads[1:]:
                await handle.feed(chunk)
            return await handle.commit(prompt=prompt,
                                       generated=generated, **kw)
        except BaseException:
            await handle.abort()
            raise


class PrefillReplica:
    """Dedicated prefill worker (disaggregated mode).

    The engine is not thread-safe, so one lock serializes prefills; the
    async wrapper runs them in a worker thread to keep the event loop
    (and every live token stream) unblocked."""

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine
        self.state = "up"
        self._lock = threading.Lock()
        self._uids = itertools.count(1)
        from ....telemetry import get_registry
        reg = get_registry()
        self._m_prefills = reg.counter(
            "router_prefill_requests_total",
            "requests prefilled on dedicated prefill replicas",
            labelnames=("replica",))

    async def prefill(self, prompt: Sequence[int], max_new_tokens: int, *,
                      eos_token_id: Optional[int] = None,
                      temperature: float = 0.0, top_p: float = 1.0,
                      top_k: int = 0, seed: Optional[int] = None,
                      trace_ctx=None, chunk_blocks: int = 0
                      ) -> Tuple[int, Optional[List[bytes]],
                                 Optional[dict], bool]:
        return await asyncio.to_thread(
            self.prefill_sync, prompt, max_new_tokens,
            eos_token_id=eos_token_id, temperature=temperature,
            top_p=top_p, top_k=top_k, seed=seed, trace_ctx=trace_ctx,
            chunk_blocks=chunk_blocks)

    def prefill_sync(self, prompt: Sequence[int], max_new_tokens: int, *,
                     eos_token_id: Optional[int] = None,
                     temperature: float = 0.0, top_p: float = 1.0,
                     top_k: int = 0, seed: Optional[int] = None,
                     trace_ctx=None, chunk_blocks: int = 0
                     ) -> Tuple[int, Optional[List[bytes]],
                                Optional[dict], bool]:
        """Run one whole-prompt prefill and hand the sequence off.

        Returns ``(first_token, payloads, rng_state, finished)`` —
        ``payloads`` is the serialized KV handoff (None when the
        request already finished at its first token: eos, or a 1-token
        budget): ``[serialize(pack)]`` when ``chunk_blocks == 0`` (the
        blocking transport) or the chunked wire form ``[header,
        kv-chunk...]`` with ``chunk_blocks`` KV blocks per chunk;
        ``rng_state`` is the request rng AFTER the first draw, so the
        decode side continues the exact sampling stream.

        Parity: the first token is ``host_sample`` over the prompt's
        last-token logits with a fresh per-request rng — precisely what
        the colocated scheduler's final-prompt-chunk path computes —
        and chunked-vs-whole prefill is bit-identical (pinned by the
        serving-runtime parity tests), so the handed-off KV matches the
        colocated cache bit-for-bit."""
        from ..sampling import host_sample
        with self._lock:
            # asyncio.to_thread runs this on a pooled worker thread:
            # name its fleet lane for the duration so the engine's
            # prefill span lands in THIS replica's timeline row
            prev_lane = trace.current_lane()
            trace.set_lane(self.name)
            select_device(getattr(self.engine, "device", None))
            try:
                uid = next(self._uids)
                if trace_ctx is not None:
                    self.engine.bind_trace(uid, trace_ctx.trace_id)
                logits = self.engine.put(
                    [uid], [np.asarray(list(prompt), np.int64)])
                rng = np.random.default_rng(seed)
                tok = int(host_sample(np.asarray(logits[0]), rng,
                                      temperature, top_p, top_k))
                finished = (max_new_tokens <= 1
                            or (eos_token_id is not None
                                and tok == eos_token_id))
                payloads = None
                rng_state = None
                if not finished:
                    pack = handoff.export_sequence(self.engine, uid,
                                                   trace_ctx=trace_ctx)
                    if chunk_blocks > 0:
                        payloads = handoff.chunk_pack(pack, chunk_blocks)
                    else:
                        payloads = [handoff.serialize(pack)]
                    rng_state = rng.bit_generator.state
                self.engine.flush(uid)
                self._m_prefills.labels(replica=self.name).inc()
                return tok, payloads, rng_state, finished
            finally:
                trace.set_lane(prev_lane)

    def health(self) -> dict:
        sm = self.engine.state_manager
        return {"name": self.name, "state": self.state, "role": "prefill",
                "free_blocks": sm.free_blocks(),
                "tracked_sequences": sm.tracked_sequences(),
                "weight_version": self.weight_version}

    @property
    def weight_version(self) -> int:
        return int(getattr(self.engine, "weight_version", 0))

    async def apply_weights(self, payloads: Sequence[bytes]) -> int:
        """Swap this prefill worker's params (no serving loop — the
        engine lock serializes against in-flight prefills, so a prompt
        is never half-prefilled across versions)."""
        from . import weights as serve_weights

        def swap() -> int:
            with self._lock:
                return serve_weights.apply_payload(self.engine, payloads)
        return await asyncio.to_thread(swap)


def build_replicas(engines: Sequence, config: Optional[ServingConfig]
                   = None, name_prefix: str = "replica",
                   own_registries: bool = False) -> List[Replica]:
    """Wrap N engines as named replicas sharing one serving config
    template (each replica gets its OWN config instance — admission
    state is per replica). ``own_registries=True`` gives every replica
    its own :class:`MetricsRegistry` (the federation unit the router's
    ``/metrics`` labels per replica)."""
    import copy

    from ....telemetry.registry import MetricsRegistry
    return [Replica(f"{name_prefix}{i}", eng,
                    copy.deepcopy(config) if config is not None else None,
                    registry=MetricsRegistry() if own_registries else None)
            for i, eng in enumerate(engines)]

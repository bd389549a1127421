"""Replica worker process: one ServingEngine behind the HTTP API.

``python -m deepspeed_tpu_torch.inference.v2.serve.worker`` hosts ONE
in-process :class:`~.replica.Replica` (engine + serving runtime) behind
the serve/api.py surface plus the worker-only endpoints the remote
serving plane needs:

  * ``POST /generate`` / ``GET /healthz`` / ``GET /metrics`` /
    ``GET /statusz`` / ``GET /debug/timeline`` /
    ``POST /debug/postmortem`` — unchanged from :class:`~.api.ServingAPI`
    (``/healthz`` carries the replica-level ``load`` /
    ``heartbeat_age_s`` / ``block_size`` fields the router's
    RemoteReplica maps its signals from);
  * ``POST /drain`` — graceful drain: new submits shed immediately,
    admitted work finishes, then the response returns (the process
    stays up so the autoscaler can drain-then-stop);
  * ``POST /stop`` — hard stop: in-flight requests cancel and the
    process exits;
  * ``POST /handoff`` — chunked streaming KV ingest
    (serve/remote.py frame protocol): each ``C`` frame is applied to
    the pool BETWEEN decode steps as it arrives — the transfer overlaps
    this replica's running batch — then the terminal ``P`` frame
    commits the restore and the decode token stream flows back on the
    same connection. EOF before ``P`` aborts the restore and frees the
    partially-filled blocks.
  * ``GET /debug/spans`` — the raw span ring plus a
    ``perf_counter``/wall-clock anchor, so a router in another process
    can rebase and stitch this replica's lane into the fleet timeline.
  * ``GET /resume?uid=N&offset=K`` — MID-STREAM RECONNECT:
    every streamed request keeps a bounded per-uid token log; a client
    whose connection dropped re-attaches here and the worker replays
    the log from ``offset`` (dedup by position — the stream stays
    bit-identical) then keeps streaming live. A bare connection loss
    does NOT cancel the request: the worker holds it resumable for
    ``resume_linger_s`` (the KV is still intact — dropping it would
    amplify a network blip into request loss); only an EXPLICIT client
    cancel (one cancel byte before close, serve/remote.py) or linger
    expiry frees the KV. A request cancelled by linger expiry answers
    later resumes with a typed error, never a silently-truncated
    "completed" stream.

On start the worker prints ONE ready line — ``DS_TPU_WORKER_READY
{"name", "host", "port", "pid", "block_size"}`` — to stdout (scan for
the prefix: engine-build logging precedes it), which spawners (an
autoscaler subprocess factory, the slow spawn smoke test) parse to
address it; :func:`spawn_worker` wraps the whole handshake — spawn,
wait for the ready line under an explicit timeout, and surface the
captured stderr when the worker dies before it.

Port note: a port of ``deepspeed_tpu/inference/v2/serve/worker.py``: the
same endpoints, frames and ready line, so a JAX ``RemoteReplica`` drives
a port worker. The engine (:func:`build_engine`) is the port's, on
``--device`` (default ``cuda``: the worker raises without a GPU and never
drops to the CPU on its own; ``--device cpu`` runs the kernels' plain
versions). Its weights come from ``torch.Generator`` seeded with the
spec's ``seed``, so two port processes built from one spec on one device
hold the same weights. JAX's ``--jax-platform`` and ``--compile-cache``
have no counterpart here (PyTorch runs eagerly, and the CUDA kernels are
built once into ``build/torch_kernels/``), so the port has neither flag.
"""

import argparse
import asyncio
import json
import os
import sys
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

from ....telemetry import context as trace_context
from .api import UID_HEADER, ServingAPI, _json_response, _response_head
from .frontend import ServingConfig
from .remote import (FRAME_BLOCKING, FRAME_CHUNK, FRAME_PARAMS,
                     read_frame)

# the tiny deterministic model the tests and the spawn smoke use: params
# drawn from a seeded torch.Generator are reproducible across processes on
# one device, so a remote worker built from the same spec serves
# bit-identical streams
TINY_SPEC = {
    "model": {"vocab_size": 128, "hidden_size": 64,
              "intermediate_size": 128, "num_layers": 2, "num_heads": 4,
              "num_kv_heads": 2, "max_seq_len": 256, "remat": False,
              "use_flash": False},
    "state_manager": {"max_tracked_sequences": 8, "max_seq_len": 256,
                      "num_blocks": 65, "block_size": 16,
                      "max_ragged_batch_size": 512},
    "engine": {"dtype": "float32", "prefill_bucket": 16},
    "serving": {"token_budget": 64, "chunk": 16},
}


def build_engine(spec: dict, device=None):
    """Engine from a worker spec dict (the ``--spec`` JSON layout) on
    ``device`` (None: the card). The engine draws its weights from a
    ``torch.Generator`` on ``device`` seeded with ``spec["seed"]`` (0 by
    default) in the engine's dtype."""
    from ....models import TransformerConfig, TransformerLM
    from .. import InferenceEngineV2, RaggedInferenceEngineConfig
    from ..config_v2 import DSStateManagerConfig
    model = TransformerLM(TransformerConfig(**spec["model"]))
    engine_kw = dict(spec.get("engine", {}), seed=int(spec.get("seed", 0)))
    return InferenceEngineV2(
        model, RaggedInferenceEngineConfig(
            state_manager=DSStateManagerConfig(**spec["state_manager"]),
            **engine_kw), device=device)


class _StreamRecord:
    """One resumable request: the live TokenStream, its bounded token
    log (``base`` = offset of ``tokens[0]`` once the front is trimmed),
    and the attachment/linger state. All state lives on the worker's
    one event loop — no locking."""

    def __init__(self, uid: int, stream, ctx, log_limit: int):
        self.uid = uid
        self.stream = stream
        self.ctx = ctx
        self.log_limit = log_limit
        self.tokens: List[int] = []
        self.base = 0
        self.status: Optional[str] = None
        self.detail: Optional[str] = None
        self.done = False
        self.event = asyncio.Event()
        self.attached = 0
        self.linger = None           # pending call_later handle
        self.linger_expired = False
        self.client_cancelled = False
        self.task: Optional[asyncio.Task] = None

    @property
    def end(self) -> int:
        return self.base + len(self.tokens)


class WorkerAPI(ServingAPI):
    """ServingAPI over one local Replica, plus the worker lifecycle,
    handoff-ingest and mid-stream-resume endpoints (module
    docstring)."""

    def __init__(self, replica, host: str = "127.0.0.1", port: int = 0,
                 *, resume_linger_s: float = 2.0,
                 token_log_limit: int = 4096, resume_records: int = 256,
                 auth_token: Optional[str] = None):
        super().__init__(replica, host=host, port=port,
                         auth_token=auth_token)
        self.replica = replica
        self.stopped = asyncio.Event()
        self.resume_linger_s = resume_linger_s
        self.token_log_limit = token_log_limit
        self.resume_records = resume_records
        self._records: "OrderedDict[int, _StreamRecord]" = OrderedDict()
        from ....telemetry import get_registry
        self._m_resume = get_registry().counter(
            "worker_resume_requests_total",
            "GET /resume reconnect attempts answered by this worker",
            labelnames=("outcome",))

    async def _route_extra(self, method: str, target: str, query: str,
                           headers, body, reader, writer) -> bool:
        if method == "GET" and target == "/resume":
            await self._resume_route(query, reader, writer)
            return True
        if method == "POST" and target == "/drain":
            await self.replica.drain()
            _json_response(writer, "200 OK", {"status": "drained",
                                              "name": self.replica.name})
            return True
        if method == "POST" and target == "/stop":
            _json_response(writer, "200 OK", {"status": "stopping",
                                              "name": self.replica.name})
            # respond first, then stop: the caller's request must not
            # hang on the runtime it is killing
            asyncio.ensure_future(self._stop_replica())
            return True
        if method == "POST" and target == "/handoff":
            await self._handoff(reader, writer, headers)
            return True
        if method == "POST" and target == "/weights":
            await self._weights(reader, writer)
            return True
        if method == "GET" and target == "/debug/spans":
            from ....telemetry import trace
            spans = json.loads(json.dumps(trace.export(), default=str))
            _json_response(writer, "200 OK",
                           {"spans": spans,
                            "perf_now": time.perf_counter(),
                            "wall_now": time.time()})
            return True
        if method == "POST" and target == "/spill/adopt":
            await self._spill_adopt(body, writer)
            return True
        return False

    async def _spill_adopt(self, body: bytes, writer) -> None:
        """Adopt a dead peer's disk-tier spill namespace (router session
        resurrection over a shared ``kv_spill_dir``). Answers with the
        adopted-entry count and the post-adoption /healthz summary so
        the caller's placement view updates without waiting a probe."""
        try:
            obj = json.loads(body.decode("utf-8")) if body else {}
            ns = obj["namespace"]
            if not isinstance(ns, str) or not ns:
                raise ValueError("namespace must be a non-empty string")
        except (ValueError, KeyError, UnicodeDecodeError) as e:
            _json_response(writer, "400 Bad Request",
                           {"error": "bad_request",
                            "detail": f"{type(e).__name__}: {e}"})
            return
        try:
            adopted = await self.replica.adopt_spill(ns)
        except Exception as e:  # adoption failure degrades to recompute
            _json_response(writer, "200 OK",
                           {"adopted": 0, "name": self.replica.name,
                            "detail": f"{type(e).__name__}: {e}"})
            return
        doc = self.replica.serving.spill_summary_doc()
        _json_response(writer, "200 OK",
                       {"adopted": adopted, "name": self.replica.name,
                        "kv_spill": doc})

    async def _stop_replica(self) -> None:
        try:
            await self.replica.stop()
        finally:
            self.stopped.set()

    # -- resumable streaming (mid-stream reconnect) ---------------------
    async def _stream_tokens(self, reader, writer, stream, ctx) -> None:
        """Worker override of the streaming pump: tokens flow through a
        bounded per-uid log so a dropped connection can re-attach at
        its offset (``GET /resume``) instead of killing the request."""
        rec = self._track(stream, ctx)
        await self._serve_record(reader, writer, rec, offset=0)

    def _track(self, stream, ctx) -> _StreamRecord:
        rec = _StreamRecord(stream.uid, stream, ctx,
                            self.token_log_limit)
        self._records[stream.uid] = rec
        rec.task = asyncio.ensure_future(self._pump_record(rec))
        # bounded registry: evict finished, detached records oldest
        # first (live or attached ones are never evicted)
        while len(self._records) > self.resume_records:
            for uid, r in list(self._records.items()):
                if r.done and r.attached == 0:
                    del self._records[uid]
                    break
            else:
                break
        return rec

    async def _pump_record(self, rec: _StreamRecord) -> None:
        from .frontend import DeadlineExceeded, RequestFailed
        try:
            async for tok in rec.stream:
                rec.tokens.append(int(tok))
                if len(rec.tokens) > rec.log_limit:
                    drop = len(rec.tokens) - rec.log_limit
                    del rec.tokens[:drop]
                    rec.base += drop
                rec.event.set()
            status = rec.stream.status
            detail = getattr(rec.stream, "reason", None)
        except DeadlineExceeded:
            status, detail = "expired", "deadline exceeded"
        except RequestFailed as e:
            status, detail = "error", str(e)
        except Exception as e:       # never strand a waiting client
            status, detail = "error", f"{type(e).__name__}: {e}"
        if status == "cancelled" and not rec.client_cancelled:
            # the CLIENT did not ask for this: linger expiry or a
            # server-side hard stop truncated the request — surface it
            # TYPED, never as a silently-truncated end-of-stream
            status = "error"
            detail = (f"resume window expired ({self.resume_linger_s}s "
                      f"with no client attached); request cancelled"
                      if rec.linger_expired else
                      "request cancelled by the server (hard stop)")
        rec.status, rec.detail = status, detail
        rec.done = True
        rec.event.set()

    async def _serve_record(self, reader, writer, rec: _StreamRecord,
                            offset: int) -> None:
        """Pump one connection from the record: replay the log from
        ``offset``, then follow live until the request ends (tail
        summary) or the client detaches (hangup -> linger window)."""
        rec.attached += 1
        if rec.linger is not None:
            rec.linger.cancel()
            rec.linger = None
        hangup = asyncio.ensure_future(reader.read(1))
        pos = offset
        detached = False
        try:
            while True:
                if pos < rec.base:
                    # the bounded log trimmed past this connection's
                    # position (a slow client fell behind generation):
                    # fail TYPED — serving rec.tokens[negative] would
                    # be silent stream corruption
                    writer.write(json.dumps(
                        {"done": True, "status": "error",
                         "uid": rec.uid,
                         "detail": f"client fell behind the bounded "
                                   f"token log (position {pos} < "
                                   f"retained base {rec.base})"}
                        ).encode() + b"\n")
                    await writer.drain()
                    return
                while pos < rec.end:
                    writer.write(json.dumps(
                        {"token": rec.tokens[pos - rec.base]}).encode()
                        + b"\n")
                    pos += 1
                await writer.drain()
                if rec.done:
                    break
                if hangup.done():
                    break
                rec.event.clear()
                if pos < rec.end or rec.done:
                    continue     # raced a new token past the clear
                waiter = asyncio.ensure_future(rec.event.wait())
                done, _ = await asyncio.wait(
                    {waiter, hangup},
                    return_when=asyncio.FIRST_COMPLETED)
                if hangup in done and waiter not in done:
                    waiter.cancel()
                    break
            if hangup.done() and not rec.done:
                data = (hangup.result()
                        if not hangup.cancelled() else b"")
                if data:
                    # explicit client cancel (serve/remote.py writes a
                    # cancel byte): free the KV NOW, no linger
                    rec.client_cancelled = True
                    await rec.stream.cancel()
                else:
                    detached = True   # bare loss: hold resumable
                return
            tail = {"done": True, "status": rec.status, "uid": rec.uid,
                    "n": rec.end, "tokens": list(rec.tokens),
                    "trace_id": (rec.ctx.trace_id
                                 if rec.ctx is not None else None)}
            if rec.base:
                tail["token_base"] = rec.base
            if rec.detail:
                tail["detail"] = rec.detail
            writer.write(json.dumps(tail).encode() + b"\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            detached = True
        finally:
            hangup.cancel()
            rec.attached -= 1
            if detached and not rec.done and rec.attached == 0:
                self._arm_linger(rec)

    def _arm_linger(self, rec: _StreamRecord) -> None:
        loop = asyncio.get_event_loop()
        rec.linger = loop.call_later(
            self.resume_linger_s,
            lambda: asyncio.ensure_future(self._linger_expire(rec)))

    async def _linger_expire(self, rec: _StreamRecord) -> None:
        rec.linger = None
        if rec.done or rec.attached > 0:
            return
        rec.linger_expired = True
        await rec.stream.cancel()

    async def _resume_route(self, query: str, reader, writer) -> None:
        from urllib.parse import parse_qs
        q = parse_qs(query)
        try:
            uid = int(q["uid"][0])
            offset = int(q.get("offset", ["0"])[0])
        except (KeyError, ValueError, IndexError):
            self._m_resume.labels(outcome="bad_request").inc()
            _json_response(writer, "400 Bad Request",
                           {"error": "bad_request",
                            "detail": "resume needs integer uid= and "
                                      "offset= parameters"})
            return
        rec = self._records.get(uid)
        if rec is None:
            self._m_resume.labels(outcome="unknown_uid").inc()
            _json_response(writer, "410 Gone",
                           {"error": "unknown_uid",
                            "detail": f"no resumable stream for uid "
                                      f"{uid} (finished long ago, "
                                      f"evicted, or never existed)"})
            return
        if offset < rec.base or offset > rec.end:
            self._m_resume.labels(outcome="bad_offset").inc()
            _json_response(writer, "416 Range Not Satisfiable",
                           {"error": "bad_offset",
                            "detail": f"offset {offset} outside the "
                                      f"retained log "
                                      f"[{rec.base}, {rec.end}]"})
            return
        self._m_resume.labels(outcome="ok").inc()
        extra = {UID_HEADER: str(uid)}
        if rec.ctx is not None:
            extra["traceparent"] = rec.ctx.to_traceparent()
        writer.write(_response_head("200 OK", "application/x-ndjson",
                                    extra))
        await self._serve_record(reader, writer, rec, offset)

    async def _weights(self, reader, writer) -> None:
        """Chunked weight ingest (blue/green hot-swap, serve/weights.py):
        ``C`` frames carry the payload (header first), the terminal
        ``P`` frame commits — chunks stage host-side while the running
        batch keeps stepping, then ONE atomic swap lands between decode
        steps. EOF before ``P`` aborts the staged update (the live
        params are untouched, so retransmit is idempotent)."""
        from .admission import OverloadedError

        async def fail(status: str, obj: dict) -> None:
            _json_response(writer, status, obj)
            # drain in-flight client frames before the close so the
            # verdict is not lost to a socket RST (same discipline as
            # the handoff ingest)
            try:
                await asyncio.wait_for(writer.drain(), 5.0)
                await asyncio.wait_for(reader.read(), 5.0)
            except (OSError, asyncio.TimeoutError, ConnectionError):
                pass

        update = None
        try:
            while True:
                try:
                    kind, payload = await read_frame(reader)
                except (asyncio.IncompleteReadError,
                        ConnectionResetError):
                    if update is not None:
                        await update.abort()
                    return
                if kind == FRAME_CHUNK:
                    if update is None:
                        update = await self.replica.serving \
                            .begin_weight_update(payload)
                    else:
                        await update.feed(payload)
                elif kind == FRAME_PARAMS:
                    break
                else:
                    if update is not None:
                        await update.abort()
                    await fail("400 Bad Request",
                               {"ok": False, "reason": "protocol",
                                "detail": f"unknown frame {kind!r}"})
                    return
            if update is None:
                await fail("400 Bad Request",
                           {"ok": False, "reason": "protocol",
                            "detail": "no weight chunks before the "
                                      "commit frame"})
                return
            version = await update.commit()
        except OverloadedError as e:
            await fail("429 Too Many Requests",
                       {"ok": False, "reason": e.reason,
                        "detail": str(e),
                        "retry_after_s": e.retry_after_s})
            return
        except Exception as e:
            if update is not None:
                await update.abort()
            await fail("400 Bad Request",
                       {"ok": False, "reason": "error",
                        "detail": f"{type(e).__name__}: {e}"})
            return
        _json_response(writer, "200 OK",
                       {"ok": True, "version": version,
                        "name": self.replica.name})

    async def _handoff(self, reader, writer, headers) -> None:
        """Chunked KV ingest (module docstring): apply frames as they
        arrive, commit on the params frame, stream tokens back."""
        upstream = trace_context.from_headers(headers or {})
        ctx = (upstream.child() if upstream is not None
               else trace_context.new_context())
        handle = None
        blocking_payload = None
        params = None

        async def fail(reason: str, detail: str,
                       retry_after_s=None) -> None:
            writer.write(_response_head("200 OK",
                                        "application/x-ndjson"))
            writer.write(json.dumps(
                {"ok": False, "reason": reason, "detail": detail,
                 "retry_after_s": retry_after_s}).encode() + b"\n")
            # drain the client's in-flight frames before the connection
            # closes: an unread receive buffer would RST the socket and
            # can discard the verdict the client needs to re-route
            try:
                await asyncio.wait_for(writer.drain(), 5.0)
                await asyncio.wait_for(reader.read(), 5.0)
            except (OSError, asyncio.TimeoutError, ConnectionError):
                pass

        from .admission import OverloadedError
        try:
            with trace_context.use(ctx):
                while True:
                    try:
                        kind, payload = await read_frame(reader)
                    except (asyncio.IncompleteReadError,
                            ConnectionResetError):
                        # client hung up mid-transfer: abort the restore
                        # so the partially-filled blocks free
                        if handle is not None:
                            await handle.abort()
                        return
                    if kind == FRAME_BLOCKING:
                        blocking_payload = payload
                    elif kind == FRAME_CHUNK:
                        if handle is None:
                            handle = await self.replica.serving \
                                .begin_handoff(payload)
                        else:
                            await handle.feed(payload)
                    elif kind == FRAME_PARAMS:
                        params = json.loads(payload.decode())
                        break
                    else:
                        if handle is not None:
                            await handle.abort()
                        await fail("protocol",
                                   f"unknown frame {kind!r}")
                        return
                kw = dict(
                    prompt=params["prompt"],
                    generated=params["generated"],
                    max_new_tokens=params["max_new_tokens"],
                    eos_token_id=params.get("eos_token_id"),
                    temperature=params.get("temperature", 0.0),
                    top_p=params.get("top_p", 1.0),
                    top_k=params.get("top_k", 0),
                    rng_state=_rng_state_from_wire(
                        params.get("rng_state")),
                    deadline_s=params.get("deadline_s"))
                if handle is not None:
                    stream = await handle.commit(**kw)
                elif blocking_payload is not None:
                    from . import handoff as handoff_mod
                    pack = await asyncio.to_thread(
                        handoff_mod.deserialize, blocking_payload)
                    stream = await self.replica.serving.resume(
                        pack, **kw)
                else:
                    await fail("protocol",
                               "no handoff payload before params")
                    return
        except OverloadedError as e:
            if handle is not None:
                await handle.abort()
            await fail(e.reason, str(e), retry_after_s=e.retry_after_s)
            return
        except Exception as e:
            if handle is not None:
                await handle.abort()
            await fail("error", f"{type(e).__name__}: {e}")
            return
        head = {"traceparent": ctx.to_traceparent()}
        if getattr(stream, "uid", None) is not None:
            head[UID_HEADER] = str(stream.uid)
        writer.write(_response_head(
            "200 OK", "application/x-ndjson", head))
        writer.write(json.dumps({"ok": True}).encode() + b"\n")
        await self._stream_tokens(reader, writer, stream, ctx)


def _rng_state_from_wire(state):
    """numpy bit-generator state dicts ride JSON losslessly (Python
    ints are arbitrary precision); nested lists that were tuples on
    export are accepted by numpy's setter as-is."""
    return state


class ReplicaWorker:
    """One replica + its WorkerAPI, runnable in-process (the loopback
    tests) or as the __main__ process."""

    def __init__(self, engine, serving_config: Optional[ServingConfig]
                 = None, name: str = "worker0",
                 host: str = "127.0.0.1", port: int = 0, **api_kw):
        from .replica import Replica
        self.replica = Replica(name, engine, serving_config)
        self.api = WorkerAPI(self.replica, host=host, port=port,
                             **api_kw)

    async def start(self) -> Tuple[str, int]:
        await self.replica.start()
        return await self.api.start()

    async def stop(self) -> None:
        try:
            if self.replica.serving.loop_runner.running:
                await self.replica.stop()
        finally:
            await self.api.stop()

    async def run_until_stopped(self) -> None:
        await self.api.stopped.wait()
        await self.api.stop()


def _serving_config(spec: dict) -> ServingConfig:
    kw = dict(spec.get("serving", {}))
    admission = kw.pop("admission", None)
    cfg = ServingConfig(**kw)
    if admission:
        from .admission import AdmissionConfig
        cfg.admission = AdmissionConfig(**admission)
    return cfg


READY_PREFIX = "DS_TPU_WORKER_READY "


class WorkerSpawnError(RuntimeError):
    """A spawned worker process never completed the ready handshake —
    it died first (the message carries its exit code and stderr tail)
    or the timeout expired."""


def spawn_worker(extra_args: Optional[List[str]] = None, *,
                 timeout_s: float = 60.0, env: Optional[dict] = None,
                 cmd: Optional[List[str]] = None):
    """Spawn a worker subprocess and wait for its ``DS_TPU_WORKER_READY``
    line under an explicit deadline.

    Returns ``(proc, info)`` — the live ``subprocess.Popen`` and the
    parsed ready-line dict. Both of the worker's pipes are drained for
    its whole life into bounded tails (``proc.stdout_tail``,
    ``proc.stderr_tail``): the worker logs to stdout after the handshake
    too, and a pipe nobody reads blocks it once the buffer fills (JAX's
    ``spawn_worker`` leaves stdout to the caller). Raises
    :class:`WorkerSpawnError` when the process exits before the
    handshake (the captured stderr tail rides the message, so "no chip
    / bad spec / import error" is diagnosable from the exception) or
    when the deadline passes (the stuck process is killed first).

    ``cmd`` overrides the full command line (tests); the default is
    ``python -m deepspeed_tpu_torch.inference.v2.serve.worker`` plus
    ``extra_args``."""
    import collections
    import subprocess
    import threading

    if cmd is None:
        cmd = [sys.executable, "-m",
               "deepspeed_tpu_torch.inference.v2.serve.worker"]
        cmd += list(extra_args or [])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, text=True)
    box = {}
    # stderr must be DRAINED for the worker's whole life (engine-build
    # logging goes there; an unread PIPE would block the
    # worker once the buffer fills — before OR after the handshake).
    # A bounded tail is kept for spawn-failure diagnostics.
    stderr_tail: "collections.deque" = collections.deque(maxlen=400)

    def drain_stderr():
        for line in proc.stderr:
            stderr_tail.append(line)

    drainer = threading.Thread(target=drain_stderr, daemon=True)
    drainer.start()
    proc.stderr_tail = stderr_tail   # callers can inspect it later

    stdout_tail: "collections.deque" = collections.deque(maxlen=400)
    proc.stdout_tail = stdout_tail
    ready = threading.Event()

    def scan():
        for line in proc.stdout:      # logging precedes the ready line
            if not ready.is_set() and line.startswith(READY_PREFIX):
                box["info"] = json.loads(line[len(READY_PREFIX):])
                ready.set()
            else:
                stdout_tail.append(line)
        ready.set()                   # EOF: the worker exited

    threading.Thread(target=scan, daemon=True).start()
    ready.wait(timeout_s)

    def tail() -> str:
        drainer.join(2.0)     # let the drainer flush the final lines
        return "".join(stderr_tail)[-2000:]

    if "info" in box:
        return proc, box["info"]
    if proc.poll() is None:          # still running, never handshook
        proc.kill()
        proc.wait(timeout=10)
        raise WorkerSpawnError(
            f"worker spawn timed out after {timeout_s}s without a "
            f"{READY_PREFIX.strip()} line (killed); stderr tail:\n"
            f"{tail()}")
    proc.wait(timeout=10)
    raise WorkerSpawnError(
        f"worker exited with code {proc.returncode} before the "
        f"{READY_PREFIX.strip()} handshake; stderr tail:\n{tail()}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="deepspeed_tpu_torch serving replica worker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 picks a free port (printed on stdout)")
    p.add_argument("--name", default=f"worker-{os.getpid()}")
    p.add_argument("--spec", default=None,
                   help="JSON file with model/state_manager/engine/"
                        "serving sections (default: the tiny "
                        "deterministic preset)")
    p.add_argument("--device", default="cuda",
                   help="the engine's device (default cuda: raises "
                        "without a GPU; 'cpu' runs the kernels' plain "
                        "versions)")
    p.add_argument("--resume-linger-s", type=float, default=2.0,
                   help="seconds a request stays resumable (KV held) "
                        "after a bare client connection loss before it "
                        "is cancelled")
    p.add_argument("--token-log-limit", type=int, default=4096,
                   help="per-request resume token-log bound (oldest "
                        "tokens trim first; a resume below the trim "
                        "point is refused typed)")
    p.add_argument("--auth-token", default=None,
                   help="shared-secret worker auth: every request must "
                        "carry it in the x-ds-tpu-auth header (401 "
                        "otherwise); default: $DS_TPU_WORKER_AUTH if "
                        "set, else open")
    args = p.parse_args(argv)
    if args.spec:
        with open(args.spec) as fh:
            spec = json.load(fh)
    else:
        spec = TINY_SPEC

    from .api import AUTH_ENV
    auth_token = args.auth_token or os.environ.get(AUTH_ENV) or None

    async def run() -> None:
        worker = ReplicaWorker(build_engine(spec, args.device),
                               _serving_config(spec), name=args.name,
                               host=args.host, port=args.port,
                               resume_linger_s=args.resume_linger_s,
                               token_log_limit=args.token_log_limit,
                               auth_token=auth_token)
        host, port = await worker.start()
        print(READY_PREFIX + json.dumps(
            {"name": args.name, "host": host, "port": port,
             "pid": os.getpid(),
             "block_size": spec["state_manager"]["block_size"]}),
            flush=True)
        await worker.run_until_stopped()

    asyncio.run(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Dependency-free HTTP surface for the serving runtime.

Built on stdlib ``asyncio.start_server`` — no web framework. Endpoints:

  * ``POST /generate`` — JSON body ``{"prompt": [ids], "max_new_tokens":
    n, ...}``; the response streams one NDJSON line per generated token
    (``{"token": t}``) followed by a final summary line (``{"done":
    true, "status": ..., "n": k, "tokens": [...]}``). The connection is
    ``Connection: close`` — the stream's end IS the close. A client that
    disconnects mid-stream cancels its request (KV blocks released).
    Protocol note: EOF on the client->server direction is the hangup
    signal (a TCP FIN is all a close gives us), so clients must keep
    their write side open until the stream ends — ``shutdown(SHUT_WR)``
    after the request body reads as a disconnect and cancels the work.
  * ``GET /healthz`` — JSON runtime health (status, queue depth,
    in-flight count).
  * ``GET /metrics`` — Prometheus text exposition rendered from the
    telemetry registry (queue depth, admission rejections, TTFT/TPOT
    histograms, ... — see docs/TELEMETRY.md).
  * ``GET /debug/timeline[?uid=N][&trace=ID]`` — the telemetry span
    ring buffer as Chrome-trace-event JSON (load in chrome://tracing or
    Perfetto); ``uid`` filters to one request's lifeline (queue ->
    prefill -> decode windows -> finish), ``trace`` to one distributed
    trace id. In routed mode the body is the STITCHED fleet timeline —
    one process row per lane (router + each replica) — so
    ``?trace=<id>`` shows a single request's dispatch -> prefill ->
    handoff -> decode hops across the fleet. See docs/PROFILING.md.
  * ``GET /statusz[?format=json]`` — one-call forensics snapshot:
    runtime health plus the recompile-watchdog rollup, the
    device-memory report, recent anomaly verdicts, and SLO state
    (p50/p95/p99 TTFT/TPOT from histogram quantiles plus the fast/slow
    burn rates). The document is JSON either way; ``format=json`` is
    the explicit machine-readable contract (other values are a 400, so
    a dashboard typo cannot silently read the wrong shape).
  * ``POST /debug/postmortem`` — write a post-mortem bundle (metrics
    snapshot, timeline, memory report, compiler fingerprint, last-N
    flight-recorder events, anomaly verdicts) and return its path
    (docs/SERVING.md § Post-mortem bundles).

Overload maps to ``429`` with the admission reason and a ``Retry-After``
header carrying the admission layer's backoff hint; malformed requests
to ``400``; unknown routes to ``404``.

Routed frontend mode: constructed over a
:class:`~.router.ReplicaRouter` instead of a single
:class:`~.frontend.ServingEngine`, the same endpoints serve an N-replica
deployment — ``/generate`` streams through the router's placement
(prefix affinity, overload re-routing, failover), ``/statusz`` gains
``router`` + per-replica ``replicas`` sections, ``/debug/timeline``
serves the stitched fleet trace and ``/metrics`` federates per-replica
registries under a ``replica`` label. The two are duck-compatible
(``submit`` / ``health``); nothing else changes.

Distributed tracing (telemetry/context.py): ``POST /generate`` honors
the W3C ``traceparent`` (+ ``baggage``) request headers — the request's
spans on every hop continue the CALLER's trace — or mints a root
context when absent. The response echoes ``traceparent`` (the request's
trace id, the server's span id) and the final NDJSON line carries
``trace_id``, so clients can fetch ``/debug/timeline?trace=<id>``.

Port note: a copy of ``deepspeed_tpu/inference/v2/serve/api.py``: the
same routes, status codes, headers and NDJSON lines, so a client cannot
tell the two packages apart. The routed frontend mode needs the replica
router, which is not ported (ROADMAP A7); the duck-typed hooks for it
stay and are simply absent on a single :class:`ServingEngine`.
"""

import asyncio
import json
from typing import Optional, Tuple

from .admission import OverloadedError
from .frontend import DeadlineExceeded, RequestFailed

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 8 * 1024 * 1024

# response header carrying the runtime uid at stream start — the one
# name the resume protocol hangs on (serve/remote.py reads it, the
# worker's /resume and /handoff responses echo it)
UID_HEADER = "x-ds-tpu-uid"

# shared-secret auth header (worker API): when the server is built with
# an auth token (worker --auth-token / $DS_TPU_WORKER_AUTH), EVERY
# request must carry it — a mismatch is a typed 401, never a silent
# accept. RemoteReplica sends it on every hop, /weights and /resume
# included.
AUTH_HEADER = "x-ds-tpu-auth"
AUTH_ENV = "DS_TPU_WORKER_AUTH"


async def _read_request(reader: asyncio.StreamReader):
    request_line = await reader.readline()
    if not request_line:
        raise ConnectionError("empty request")
    parts = request_line.decode("latin-1").split()
    if len(parts) < 2:
        raise ValueError("malformed request line")
    method, target = parts[0].upper(), parts[1]
    headers = {}
    total = 0
    while True:
        line = await reader.readline()
        total += len(line)
        if total > _MAX_HEADER_BYTES:
            raise ValueError("headers too large")
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    length = int(headers.get("content-length", 0) or 0)
    if length > _MAX_BODY_BYTES:
        raise ValueError("body too large")
    body = await reader.readexactly(length) if length else b""
    return method, target, headers, body


def _response_head(status: str, content_type: str,
                   extra_headers: Optional[dict] = None) -> bytes:
    lines = [f"HTTP/1.1 {status}",
             f"Content-Type: {content_type}",
             "Connection: close"]
    for name, value in (extra_headers or {}).items():
        lines.append(f"{name}: {value}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _json_response(writer: asyncio.StreamWriter, status: str, obj,
                   extra_headers: Optional[dict] = None) -> None:
    writer.write(_response_head(status, "application/json", extra_headers)
                 + json.dumps(obj).encode() + b"\n")


class ServingAPI:
    """In-process HTTP server over a :class:`ServingEngine` — or, in
    routed frontend mode, over a :class:`~.router.ReplicaRouter`
    (anything with the ``submit``/``health`` surface)."""

    def __init__(self, serving, host: str = "127.0.0.1",
                 port: int = 0, registry=None,
                 auth_token: Optional[str] = None):
        self.serving = serving
        self.host = host
        self.port = port
        # shared-secret auth (AUTH_HEADER): None = open (the in-process
        # default); a token makes every route require the header
        self.auth_token = auth_token
        if registry is None:
            from ....telemetry import get_registry
            registry = get_registry()
        self.registry = registry
        self._m_auth_failures = registry.counter(
            "serving_auth_failures_total",
            "requests rejected 401 for a missing or wrong "
            "x-ds-tpu-auth shared secret")
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # ------------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, target, headers, body = await _read_request(reader)
            except ConnectionError:
                return
            except (ValueError, asyncio.IncompleteReadError):
                _json_response(writer, "400 Bad Request",
                               {"error": "malformed request"})
                return
            target, _, query = target.partition("?")
            if self.auth_token is not None and \
                    headers.get(AUTH_HEADER) != self.auth_token:
                self._m_auth_failures.inc()
                _json_response(
                    writer, "401 Unauthorized",
                    {"error": "unauthorized",
                     "detail": f"missing or wrong {AUTH_HEADER} header "
                               f"(this worker requires the shared "
                               f"secret)"})
                if method == "POST" and not body:
                    # frame-streaming routes (/weights, /handoff) send
                    # their payload AFTER the head: drain it so the
                    # close cannot RST away the typed 401 and turn a
                    # non-retryable auth failure into a retried
                    # transport error
                    try:
                        await asyncio.wait_for(writer.drain(), 5.0)
                        await asyncio.wait_for(reader.read(), 5.0)
                    except (OSError, asyncio.TimeoutError,
                            ConnectionError):
                        pass
            elif method == "GET" and target == "/healthz":
                _json_response(writer, "200 OK", self.serving.health())
            elif method == "GET" and target == "/metrics":
                # routed frontend mode: federate per-replica registries
                # under a `replica` label (falls back to the plain
                # process-default exposition when replicas share it).
                # Remote replicas make federation async (their series
                # arrive over HTTP) — prefer the async form when the
                # router exposes one.
                fed = (getattr(self.serving, "federated_metrics_async",
                               None)
                       or getattr(self.serving, "federated_metrics",
                                  None))
                if fed is None:
                    text = self.registry.render_prometheus()
                else:
                    text = fed()
                    if asyncio.iscoroutine(text):
                        text = await text
                writer.write(_response_head(
                    "200 OK", "text/plain; version=0.0.4; charset=utf-8")
                    + text.encode())
            elif method == "GET" and target == "/debug/timeline":
                await self._timeline(writer, query)
            elif method == "GET" and target == "/statusz":
                self._statusz_response(writer, query)
            elif method == "POST" and target == "/debug/postmortem":
                await self._postmortem(writer)
            elif method == "POST" and target == "/generate":
                await self._generate(reader, writer, body, headers)
            elif await self._route_extra(method, target, query, headers,
                                         body, reader, writer):
                pass
            else:
                _json_response(writer, "404 Not Found",
                               {"error": f"no route {method} {target}"})
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                if writer.can_write_eof():
                    writer.write_eof()
            except (OSError, RuntimeError):
                pass
            writer.close()

    async def _route_extra(self, method: str, target: str, query: str,
                           headers, body, reader, writer) -> bool:
        """Subclass hook for extra endpoints (the replica worker's
        lifecycle + handoff routes, serve/worker.py); returns True when
        the request was handled."""
        return False

    async def _timeline(self, writer, query: str) -> None:
        """Chrome-trace JSON of the span ring buffer (``?uid=N`` filters
        to one request's correlated spans, ``?trace=ID`` to one
        distributed trace). Routed mode serves the STITCHED fleet form
        — a process row per lane — via the router's
        :meth:`~.router.ReplicaRouter.fleet_timeline`."""
        from urllib.parse import parse_qs

        from ....telemetry import timeline
        from ....telemetry import trace as ds_trace
        params = parse_qs(query)
        trace_id = params.get("trace", [None])[0]
        fleet = getattr(self.serving, "fleet_timeline", None)
        if fleet is not None:
            if params.get("uid"):
                _json_response(
                    writer, "400 Bad Request",
                    {"error": "routed timeline filters by ?trace=<id> "
                              "(uids are per replica, not fleet-wide)"})
                return
            doc = fleet(trace_id=trace_id)
            if asyncio.iscoroutine(doc):
                # remote replicas: their span rings arrive over HTTP
                doc = await doc
            _json_response(writer, "200 OK", doc)
            return
        spans = ds_trace.export()
        try:
            uid = params.get("uid")
            if uid:
                spans = timeline.request_spans(int(uid[0]), spans)
        except (TypeError, ValueError):
            _json_response(writer, "400 Bad Request",
                           {"error": "uid must be an integer"})
            return
        if trace_id:
            spans = timeline.trace_spans(trace_id, spans)
        _json_response(writer, "200 OK", timeline.to_chrome_trace(spans))

    def _statusz_response(self, writer, query: str) -> None:
        """``/statusz`` with the explicit ``?format=json`` contract:
        the document is JSON either way, but an unknown format is a 400
        instead of a silently-ignored parameter."""
        from urllib.parse import parse_qs
        fmt = parse_qs(query).get("format", ["json"])[0]
        if fmt != "json":
            _json_response(writer, "400 Bad Request",
                           {"error": f"unsupported format {fmt!r} "
                                     f"(only 'json')"})
            return
        _json_response(writer, "200 OK", self._statusz())

    def _statusz(self) -> dict:
        import math

        from ....telemetry import anomaly as ds_anomaly
        from ....telemetry import memory as ds_memory
        from ....telemetry import watchdog
        from ....runtime import tunables
        from ....telemetry.recorder import get_recorder
        out = {
            "health": self.serving.health(),
            "compile": {"programs": watchdog.summary(),
                        "steady_state": watchdog.is_steady(),
                        "recent_events": len(watchdog.events())},
            "memory": ds_memory.oom_report(),
            "metric_families": len(self.registry.families()),
            "recorder": get_recorder().stats(),
            "anomalies": {"recent": ds_anomaly.recent(16)},
            # every registered perf knob: effective value + provenance
            # (default|config|tuned|online) — runtime/tunables.py
            "tunables": tunables.statusz_section(),
        }
        if hasattr(self.serving, "replica_statusz"):
            # routed frontend mode: the "serving engine" is a
            # ReplicaRouter — aggregate the per-replica rollups and the
            # router's own placement state into the same document
            out["router"] = self.serving.router_statusz()
            out["replicas"] = self.serving.replica_statusz()
        diag = getattr(self.serving, "diagnostics", None)
        if diag is not None and diag.slo is not None:
            def clean(d):
                return {k: (None if isinstance(v, float)
                            and not math.isfinite(v) else v)
                        for k, v in d.items()}
            out["slo"] = {
                "quantiles": {s: clean(q) for s, q
                              in diag.slo.quantiles().items()},
                "burn": diag.slo.tick(),
            }
        return out

    async def _postmortem(self, writer) -> None:
        import json as _json
        import os

        from ....telemetry import postmortem as ds_postmortem
        diag = getattr(self.serving, "diagnostics", None)
        cfg = diag.config if diag is not None else None

        def collect():
            # bundle writing is disk I/O exactly when the server is in
            # trouble — keep it off the event-loop thread so live
            # /generate streams don't stall behind it
            path = ds_postmortem.write_bundle("http_request", config=cfg)
            with open(os.path.join(path, "manifest.json")) as fh:
                return path, _json.load(fh)

        try:
            path, manifest = await asyncio.to_thread(collect)
            _json_response(writer, "200 OK",
                           {"path": path, "manifest": manifest})
        except Exception as e:
            _json_response(writer, "500 Internal Server Error",
                           {"error": f"{type(e).__name__}: {e}"})

    async def _generate(self, reader, writer, body: bytes,
                        headers: Optional[dict] = None) -> None:
        from ....telemetry import context as trace_context
        # coerce every field up front: an unchecked value (e.g.
        # temperature="hot") would only blow up inside scheduler.step(),
        # where _step_error fails EVERY in-flight request
        try:
            payload = json.loads(body or b"{}")
            prompt = [int(t) for t in payload["prompt"]]
            max_new = int(payload.get("max_new_tokens", 64))
            kw = {}
            for name, cast in (("eos_token_id", int), ("top_k", int),
                               ("seed", int), ("temperature", float),
                               ("top_p", float), ("weight", float),
                               ("deadline_s", float), ("tenant", str)):
                if payload.get(name) is not None:
                    kw[name] = cast(payload[name])
        except (KeyError, TypeError, ValueError, json.JSONDecodeError):
            _json_response(writer, "400 Bad Request",
                           {"error": "body must be JSON with a 'prompt' "
                                     "list of token ids (and numeric "
                                     "sampling/deadline fields)"})
            return
        # distributed tracing: continue the caller's W3C traceparent
        # (+ baggage) headers, or mint the root HERE — binding before
        # submit means both the single-engine frontend and the router
        # continue ONE identity, and the API layer can echo it back.
        # child() keeps the caller's trace id but mints THIS server's
        # span id, so the echoed traceparent never hands the caller its
        # own span back (a client parenting follow-ups on it would
        # self-parent)
        upstream = trace_context.from_headers(headers or {})
        ctx = (upstream.child() if upstream is not None
               else trace_context.new_context())
        try:
            with trace_context.use(ctx):
                stream = await self.serving.submit(prompt, max_new, **kw)
        except OverloadedError as e:
            # Retry-After carries the machine-readable backoff hint the
            # admission layer attached (integer seconds, ceil'd — the
            # HTTP header grammar is delta-seconds); the JSON body keeps
            # the precise float for clients that parse it
            import math
            retry = getattr(e, "retry_after_s", None)
            headers = ({"Retry-After": str(max(1, math.ceil(retry)))}
                       if retry is not None else None)
            _json_response(writer, "429 Too Many Requests",
                           {"error": "overloaded", "reason": e.reason,
                            "retry_after_s": retry,
                            "detail": str(e)}, extra_headers=headers)
            return
        except ValueError as e:
            _json_response(writer, "400 Bad Request", {"error": str(e)})
            return

        # the runtime uid rides a response header so a client knows what
        # to resume (worker GET /resume) BEFORE the tail line arrives
        extra = {"traceparent": ctx.to_traceparent()}
        if getattr(stream, "uid", None) is not None:
            extra[UID_HEADER] = str(stream.uid)
        writer.write(_response_head(
            "200 OK", "application/x-ndjson", extra))
        await self._stream_tokens(reader, writer, stream, ctx)

    async def _stream_tokens(self, reader, writer, stream, ctx) -> None:
        """Pump one token stream as NDJSON lines + the tail summary
        (shared by /generate and the worker's /handoff response).
        With Connection: close the client sends nothing more; read()
        completing means it hung up — cancel so the KV blocks free."""
        hangup = asyncio.ensure_future(reader.read(1))
        status, detail = "completed", None
        try:
            while True:
                nxt = asyncio.ensure_future(stream.__anext__())
                done, _ = await asyncio.wait(
                    {nxt, hangup}, return_when=asyncio.FIRST_COMPLETED)
                if hangup in done and nxt not in done:
                    nxt.cancel()
                    await stream.cancel()
                    return
                try:
                    tok = nxt.result()
                except StopAsyncIteration:
                    status = stream.status
                    break
                except DeadlineExceeded:
                    status, detail = "expired", "deadline exceeded"
                    break
                except RequestFailed as e:
                    status, detail = "error", str(e)
                    break
                writer.write(json.dumps({"token": tok}).encode() + b"\n")
                await writer.drain()
            tail = {"done": True, "status": status, "uid": stream.uid,
                    "n": len(stream.tokens), "tokens": stream.tokens,
                    "trace_id": ctx.trace_id}
            if detail:
                tail["detail"] = detail
            writer.write(json.dumps(tail).encode() + b"\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            await stream.cancel()
        finally:
            hangup.cancel()

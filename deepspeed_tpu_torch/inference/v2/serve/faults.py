"""Deterministic fault injection for the remote serving plane.

A :class:`FaultPlane` wraps the asyncio transport a
:class:`~.remote.RemoteReplica` opens toward its worker — connection
dials, response-body reads, request writes — and injects scripted
faults at exact points in the byte/line stream:

  * ``latency``        — sleep ``delay_s`` inside the dial (so a caller
    timeout budget really expires: the slow-/healthz-probe scenario),
  * ``reset``          — raise ``ConnectionResetError`` (a dropped
    socket mid-stream; the mid-stream-reconnect scenario),
  * ``refuse``         — raise ``ConnectionRefusedError`` at dial (the
    process-exit signal the router treats as death, not suspicion),
  * ``corrupt``        — flip bytes in a COMPLETE frame (malformed
    NDJSON line / CRC-failing handoff chunk: data corruption that must
    surface as a typed failure, never be silently consumed),
  * ``truncate``       — return a partial line with no newline, then
    EOF (a connection that died mid-frame: reconnectable),
  * ``partial_write``  — flush only a prefix of a write, then raise
    (the handoff frame-send failure the retry layer must retransmit),
  * ``kill``           — invoke the plane's ``on_kill`` callback (tests
    wire it to hard-stop the worker) and reset the connection: the
    worker-killed-at-token-index scenario.

Scheduling is scriptable and deterministic: each :class:`FaultSpec`
keeps its own match counter across every connection the plane wraps —
``skip`` matched ops pass clean, then every ``every``-th op fires, at
most ``times`` times — and ``probability`` gates each potential firing
through the plane's seeded RNG (Python ``random``), so one seed gives
one fault schedule in either package.
Read-op counting starts at the NDJSON body (the HTTP response head is
never counted), so ``skip=K`` means "after K body lines".

Install per replica (``RemoteReplica(faults=plane)``). Every firing
increments ``chaos_faults_injected_total{kind}`` and the plane's
``injected`` counter dict, so a chaos run can assert its schedule
actually executed.

Port note: a copy of ``deepspeed_tpu/inference/v2/serve/faults.py``, which
imports no jax.
"""

import asyncio
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

_KINDS = ("latency", "reset", "refuse", "corrupt", "truncate",
          "partial_write", "kill")
_OPS = ("connect", "read", "write")


@dataclass
class FaultSpec:
    """One scripted fault: where (``op`` + ``target`` substring), when
    (``skip``/``every``/``times`` over this spec's matched-op counter,
    ``probability`` through the plane's seeded RNG), and what
    (``kind`` + ``delay_s``)."""
    kind: str
    op: str = "read"
    target: str = "*"          # substring of the request target, or "*"
    delay_s: float = 0.05      # latency kind only
    skip: int = 0              # matched ops that pass clean first
    every: int = 1             # then fire every Nth matched op
    times: Optional[int] = 1   # max firings (None = unlimited)
    probability: float = 1.0   # seeded-RNG gate per potential firing
    # internal counters (per spec, across every wrapped connection)
    seen: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {_KINDS})")
        if self.op not in _OPS:
            raise ValueError(f"unknown fault op {self.op!r} "
                             f"(one of {_OPS})")
        # only injectable combinations are scriptable: a spec that can
        # never execute must fail at script time, not count as
        # "injected" while doing nothing
        allowed = {"connect": ("latency", "reset", "refuse", "kill"),
                   "read": ("latency", "reset", "corrupt", "truncate",
                            "kill"),
                   "write": ("corrupt", "partial_write", "reset",
                             "kill")}[self.op]
        if self.kind not in allowed:
            raise ValueError(f"fault kind {self.kind!r} is not "
                             f"injectable on op {self.op!r} "
                             f"(allowed: {allowed})")
        if self.every < 1:
            raise ValueError("every must be >= 1")


class FaultPlane:
    """Scriptable, seedable fault schedule over one replica's wire.

    ``on_kill``: zero-arg callable (or coroutine function) invoked when
    a ``kill`` spec fires — tests wire it to hard-stop the worker so
    "worker dies at token index K" is one scripted line."""

    def __init__(self, specs=(), seed: int = 0,
                 on_kill: Optional[Callable] = None):
        self.specs: List[FaultSpec] = list(specs)
        self.rng = random.Random(seed)
        self.on_kill = on_kill
        self.injected: Dict[str, int] = {}
        from ....telemetry import get_registry
        self._m_injected = get_registry().counter(
            "chaos_faults_injected_total",
            "faults injected by the chaos plane (serve/faults.py)",
            labelnames=("kind",))

    def script(self, *specs: FaultSpec) -> "FaultPlane":
        self.specs.extend(specs)
        return self

    def clear(self) -> None:
        """Drop every scripted spec (fault-free from here on)."""
        self.specs = []

    # -- scheduling -----------------------------------------------------
    def _fire(self, op: str, target: str) -> Optional[FaultSpec]:
        """The spec (at most one) that fires on this op. EVERY matching
        spec counts the op against its own schedule — a layered script
        (e.g. latency on every read plus an occasional reset) keeps
        each spec's counter honest — but only the first spec that
        matures executes; a later spec that would also have fired keeps
        its firing for its next matured op."""
        winner: Optional[FaultSpec] = None
        for spec in self.specs:
            if spec.op != op:
                continue
            if spec.target != "*" and spec.target not in target:
                continue
            i = spec.seen
            spec.seen += 1
            if winner is not None:
                continue
            if spec.times is not None and spec.fired >= spec.times:
                continue
            if i < spec.skip or (i - spec.skip) % spec.every:
                continue
            if spec.probability < 1.0 \
                    and self.rng.random() >= spec.probability:
                continue
            spec.fired += 1
            self.injected[spec.kind] = self.injected.get(spec.kind, 0) + 1
            self._m_injected.labels(kind=spec.kind).inc()
            winner = spec
        return winner

    def _kill(self) -> None:
        if self.on_kill is None:
            return
        result = self.on_kill()
        if asyncio.iscoroutine(result):
            asyncio.ensure_future(result)

    # -- injection points ----------------------------------------------
    async def connect(self, target: str) -> None:
        """Run inside the dial (and inside the caller's timeout, so an
        injected latency really expires the probe budget)."""
        spec = self._fire("connect", target)
        if spec is None:
            return
        if spec.kind == "latency":
            await asyncio.sleep(spec.delay_s)
        elif spec.kind == "refuse":
            raise ConnectionRefusedError(
                "chaos: injected connection refusal")
        elif spec.kind == "kill":
            self._kill()
            raise ConnectionResetError("chaos: worker killed at dial")
        else:   # reset & friends at dial all read as a reset
            raise ConnectionResetError(
                "chaos: injected reset at connect")

    def wrap(self, reader: asyncio.StreamReader,
             writer: asyncio.StreamWriter, target: str):
        """Wrap one connection's streams. The returned reader counts
        read-ops only after :meth:`_FaultyReader.arm` (the HTTP client
        arms it once the response head is parsed, so scripts count
        NDJSON body lines, not header lines)."""
        return (_FaultyReader(reader, self, target),
                _FaultyWriter(writer, self, target))


class _FaultyReader:
    def __init__(self, reader, plane: FaultPlane, target: str):
        self._reader = reader
        self._plane = plane
        self._target = target
        self._armed = False
        self._eof = False

    def arm(self) -> None:
        self._armed = True

    def _pre(self) -> Optional[FaultSpec]:
        if not self._armed:
            return None
        return self._plane._fire("read", self._target)

    async def _faulted(self, read_fn):
        if self._eof:
            return b""
        spec = self._pre()
        if spec is None:
            return await read_fn()
        if spec.kind == "latency":
            await asyncio.sleep(spec.delay_s)
            return await read_fn()
        if spec.kind == "reset":
            raise ConnectionResetError("chaos: injected reset mid-read")
        if spec.kind == "kill":
            self._plane._kill()
            raise ConnectionResetError("chaos: worker killed mid-read")
        data = await read_fn()
        if spec.kind == "corrupt" and data:
            # a COMPLETE but malformed frame: keep the framing newline
            # (if any) so the consumer sees corruption, not a hangup
            tail = b"\n" if data.endswith(b"\n") else b""
            body = data[:-1] if tail else data
            data = body[:max(len(body) // 2, 1)] + b'\xff{chaos' + tail
        elif spec.kind == "truncate" and data:
            # a frame cut mid-byte-stream, then EOF: the connection died
            self._eof = True
            data = data.rstrip(b"\n")[:max(len(data) // 2, 1)]
        return data

    async def readline(self):
        return await self._faulted(self._reader.readline)

    async def readexactly(self, n: int):
        return await self._faulted(lambda: self._reader.readexactly(n))

    async def read(self, n: int = -1):
        return await self._faulted(lambda: self._reader.read(n))

    def __getattr__(self, name):
        return getattr(self._reader, name)


class _FaultyWriter:
    def __init__(self, writer, plane: FaultPlane, target: str):
        self._writer = writer
        self._plane = plane
        self._target = target
        self._broken = False

    def write(self, data: bytes) -> None:
        spec = self._plane._fire("write", self._target)
        if spec is not None:
            if spec.kind == "corrupt" and data:
                i = len(data) // 2
                data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
            elif spec.kind == "partial_write":
                # flush a prefix, then the connection IS gone: close the
                # real socket (the peer must see EOF and abort — a
                # half-sent frame that quietly lingers would deadlock
                # both sides) and surface the failure on drain()
                self._writer.write(data[:max(len(data) // 2, 1)])
                self._broken = True
                try:
                    self._writer.close()
                except Exception:
                    pass
                return
            elif spec.kind in ("reset", "kill"):
                if spec.kind == "kill":
                    self._plane._kill()
                self._broken = True
                try:
                    self._writer.close()
                except Exception:
                    pass
                return
        self._writer.write(data)

    async def drain(self) -> None:
        if self._broken:
            raise ConnectionResetError(
                "chaos: injected write failure")
        await self._writer.drain()

    def close(self) -> None:
        self._writer.close()

    def __getattr__(self, name):
        return getattr(self._writer, name)

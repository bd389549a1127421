"""Request-scoped distributed trace context.

One request crossing the serving fleet — router dispatch, a prefill
replica, a serialized KV handoff, a decode replica — must land in the
telemetry of every hop under ONE identity, or per-request attribution
stops at the first process boundary. :class:`TraceContext` is that
identity: a 128-bit ``trace_id``, the 64-bit id of the enclosing span
(``span_id`` — the PARENT of whatever the receiving side records), and
a small string ``baggage`` dict for deployment-defined correlation
(tenant, experiment arm).

Three codecs, one per boundary the context crosses:

  * **HTTP** — the W3C Trace Context headers (``traceparent:
    00-<trace_id>-<span_id>-<flags>`` plus an optional ``baggage:
    k=v,...``), so external load balancers and clients interoperate
    (:func:`from_headers` / :meth:`TraceContext.to_traceparent`);
  * **wire payloads** — a plain JSON-able dict
    (:meth:`TraceContext.to_wire` / :func:`from_wire`) embedded in the
    KV handoff manifest (serve/handoff.py), so the decode replica
    CONTINUES the prefill replica's trace rather than starting its own;
  * **in-process** — a :mod:`contextvars` variable
    (:func:`current` / :func:`use`), which asyncio propagates per task,
    so the serving frontend never threads the context by hand.

The serving loop thread does not share the asyncio context: request
records (scheduler ``_Request``, frontend ``_Entry``) carry the context
explicitly across that boundary, and span call sites attach
``trace_id`` to their attrs — the stitched fleet timeline
(telemetry/timeline.py) selects on it.

``trace_contexts_total{origin=new|header|wire}`` counts where contexts
came from (all-new under a router with no upstream means nobody is
propagating headers to you).

Port note: a copy of ``deepspeed_tpu/telemetry/context.py`` (which imports no
jax); the metric names and documents are the same in both packages.
"""

import os
import re
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Dict, Iterator, Mapping, Optional

from .registry import get_registry

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")
_BAGGAGE_MAX_ENTRIES = 16
_BAGGAGE_MAX_CHARS = 256


def _count(origin: str) -> None:
    get_registry().counter(
        "trace_contexts_total",
        "distributed trace contexts minted (origin=new) or continued "
        "from a traceparent header / handoff wire payload",
        labelnames=("origin",)).labels(origin=origin).inc()


@dataclass(frozen=True)
class TraceContext:
    """One hop's view of a distributed trace (module docstring)."""

    trace_id: str                      # 32 lowercase hex chars
    span_id: str                       # 16 lowercase hex chars (parent)
    baggage: Mapping[str, str] = field(default_factory=dict)
    sampled: bool = True

    def child(self) -> "TraceContext":
        """The context a downstream hop should receive: same trace,
        fresh span id (this hop becomes the parent)."""
        return TraceContext(self.trace_id, os.urandom(8).hex(),
                            dict(self.baggage), self.sampled)

    # -- HTTP (W3C Trace Context) --------------------------------------
    def to_traceparent(self) -> str:
        return (f"00-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")

    def to_baggage_header(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.baggage.items())

    # -- wire payloads (handoff manifest) ------------------------------
    def to_wire(self) -> Dict[str, object]:
        out: Dict[str, object] = {"trace_id": self.trace_id,
                                  "span_id": self.span_id,
                                  "sampled": self.sampled}
        if self.baggage:
            out["baggage"] = dict(self.baggage)
        return out


def new_context(**baggage: str) -> TraceContext:
    """Mint a fresh root context (a request arriving with no upstream
    trace)."""
    _count("new")
    return TraceContext(os.urandom(16).hex(), os.urandom(8).hex(),
                        {str(k): str(v) for k, v in baggage.items()})


def from_traceparent(header: Optional[str],
                     baggage_header: Optional[str] = None
                     ) -> Optional[TraceContext]:
    """Parse the W3C ``traceparent`` (+ optional ``baggage``) headers;
    None on anything malformed (a bad header must degrade to a fresh
    trace, never a 500)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":
        return None     # explicitly invalid version per the spec
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None     # all-zero ids are invalid per the spec
    baggage: Dict[str, str] = {}
    if baggage_header:
        for item in baggage_header.split(",")[:_BAGGAGE_MAX_ENTRIES]:
            key, sep, value = item.strip().partition("=")
            if sep and key:
                baggage[key[:_BAGGAGE_MAX_CHARS]] = \
                    value[:_BAGGAGE_MAX_CHARS]
    _count("header")
    return TraceContext(trace_id, span_id, baggage,
                        sampled=bool(int(flags, 16) & 1))


def from_headers(headers: Mapping[str, str]) -> Optional[TraceContext]:
    """Extract a context from lowercase-keyed HTTP headers."""
    return from_traceparent(headers.get("traceparent"),
                            headers.get("baggage"))


def from_wire(d: Optional[Mapping[str, object]]
              ) -> Optional[TraceContext]:
    """Rebuild a context from :meth:`TraceContext.to_wire`; None on
    missing/malformed payloads (old handoff payloads have no trace)."""
    if not isinstance(d, Mapping):
        return None
    trace_id, span_id = d.get("trace_id"), d.get("span_id")
    if (not isinstance(trace_id, str) or len(trace_id) != 32
            or not isinstance(span_id, str) or len(span_id) != 16):
        return None
    baggage = d.get("baggage") or {}
    if not isinstance(baggage, Mapping):
        baggage = {}
    _count("wire")
    return TraceContext(trace_id, span_id,
                        {str(k): str(v) for k, v in baggage.items()},
                        sampled=bool(d.get("sampled", True)))


# ---------------------------------------------------------------------------
# in-process propagation (asyncio-side; contextvars follow tasks)
# ---------------------------------------------------------------------------
_current: ContextVar[Optional[TraceContext]] = ContextVar(
    "ds_tpu_trace_context", default=None)


def current() -> Optional[TraceContext]:
    return _current.get()


@contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Bind ``ctx`` as the current context for the enclosed block."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def get_or_new(**baggage: str) -> TraceContext:
    """The current context, or a fresh root when none is bound."""
    ctx = _current.get()
    return ctx if ctx is not None else new_context(**baggage)

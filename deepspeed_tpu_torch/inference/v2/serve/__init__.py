"""Async serving runtime over the SplitFuse scheduler, and its fleet.

Port of ``deepspeed_tpu/inference/v2/serve/``:

  frontend.py  — asyncio ServingEngine: async submit() -> token stream,
                 per-request deadlines, cancellation that releases KV;
                 the handoff (resume, begin_handoff) and live weight
                 update (begin_weight_update, apply_weights) entry points
  admission.py — bounded pending queue, token-budget load shedding,
                 weighted-fair scheduling across tenants
  loop.py      — background thread continuously draining the SplitFuse
                 scheduler (continuous batching) with graceful drain;
                 chunked KV restores apply between its steps
  api.py       — dependency-free HTTP endpoint: streaming /generate,
                 /healthz, /metrics (Prometheus text from the registry),
                 /statusz, /debug/timeline, /debug/postmortem; serves a
                 single engine or the routed front tier
  router.py    — prefix-affinity replica router: spreads traffic over N
                 replicas, backoff-aware overload re-routing, drain /
                 failover lifecycle, prefill / decode disaggregation,
                 blue/green weight pushes, spill-aware placement
  replica.py   — the units behind the router: full serving replicas and
                 dedicated prefill workers
  handoff.py   — paged-KV export / serialize / restore between replicas,
                 whole or as a chunked stream
  weights.py   — versioned chunked weight payloads (full and int8 delta)
                 and the in-place param hot-swap
  remote.py    — RemoteReplica: the Replica protocol over a socket
  worker.py    — the replica worker process behind RemoteReplica
                 (python -m deepspeed_tpu_torch.inference.v2.serve.worker)
  autoscaler.py— spawn / drain replicas off the router's load, shed,
                 SLO-burn and heartbeat signals
  resilience.py— RetryPolicy (backoff + jitter under one deadline budget)
                 and the per-replica CircuitBreaker
  faults.py    — deterministic, seeded fault injection over the remote
                 transport

LoRA adapter payloads (``weights.chunk_adapter_payload``) ride the same
wire into an engine's adapter bank, fleet-wide through
``ReplicaRouter.push_adapter``. ``ServingConfig.autotune`` turns on the
SLO-driven online adapter (``autotuning/online.py``).
"""

from . import handoff  # noqa: F401
from . import weights  # noqa: F401
from .admission import (AdmissionConfig, AdmissionController,  # noqa: F401
                        OverloadedError)
from .faults import FaultPlane, FaultSpec  # noqa: F401
from .resilience import (BreakerConfig, CircuitBreaker,  # noqa: F401
                         RetryConfig, RetryPolicy)
from .frontend import (DeadlineExceeded, RequestFailed,  # noqa: F401
                       ServingConfig, ServingEngine, TokenStream)
from .loop import ServingLoop  # noqa: F401
from .api import ServingAPI  # noqa: F401
from .replica import PrefillReplica, Replica, build_replicas  # noqa: F401
from .router import (ReplicaRouter, RoutedStream,  # noqa: F401
                     RouterConfig)
from .remote import RemoteReplica, RemoteStream  # noqa: F401
from .worker import (ReplicaWorker, WorkerAPI,  # noqa: F401
                     WorkerSpawnError, spawn_worker)
from .autoscaler import Autoscaler, AutoscalerConfig  # noqa: F401

__all__ = [
    "AdmissionConfig", "AdmissionController", "OverloadedError",
    "DeadlineExceeded", "RequestFailed", "ServingConfig", "ServingEngine",
    "TokenStream", "ServingLoop", "ServingAPI",
    "PrefillReplica", "Replica", "build_replicas",
    "ReplicaRouter", "RoutedStream", "RouterConfig",
    "RemoteReplica", "RemoteStream", "ReplicaWorker", "WorkerAPI",
    "WorkerSpawnError", "spawn_worker",
    "Autoscaler", "AutoscalerConfig", "handoff", "weights",
    "FaultPlane", "FaultSpec",
    "RetryConfig", "RetryPolicy", "BreakerConfig", "CircuitBreaker",
]

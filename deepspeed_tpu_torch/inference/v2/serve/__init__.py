"""Async serving runtime over the SplitFuse scheduler.

Port of ``deepspeed_tpu/inference/v2/serve/``, the single-replica half:

  frontend.py  — asyncio ServingEngine: async submit() -> token stream,
                 per-request deadlines, cancellation that releases KV
  admission.py — bounded pending queue, token-budget load shedding,
                 weighted-fair scheduling across tenants
  loop.py      — background thread continuously draining the SplitFuse
                 scheduler (continuous batching) with graceful drain
  api.py       — dependency-free HTTP endpoint: streaming /generate,
                 /healthz, /metrics (Prometheus text from the registry),
                 /statusz, /debug/timeline, /debug/postmortem

The fleet half — ``router``, ``replica``, ``remote``, ``worker``,
``autoscaler``, ``handoff``, ``weights``, ``faults`` and ``resilience`` —
is not ported (ROADMAP A7); the serving surface's entry points into it
raise ``NotImplementedError`` naming that item.
"""

from .admission import (AdmissionConfig, AdmissionController,  # noqa: F401
                        OverloadedError)
from .frontend import (DeadlineExceeded, RequestFailed,  # noqa: F401
                       ServingConfig, ServingEngine, TokenStream)
from .loop import ServingLoop  # noqa: F401
from .api import ServingAPI  # noqa: F401

__all__ = [
    "AdmissionConfig", "AdmissionController", "OverloadedError",
    "DeadlineExceeded", "RequestFailed", "ServingConfig", "ServingEngine",
    "TokenStream", "ServingLoop", "ServingAPI",
]

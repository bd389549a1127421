"""Admission control and backpressure for the serving runtime.

Overload policy (the reference's MII deployments sit behind an RPC
queue; here the policy is explicit and observable):

  * **bounded pending queue** — at most ``max_pending`` requests wait for
    the model loop; the queue never grows without bound,
  * **token-budget load shedding** — each request costs
    ``len(prompt) + max_new_tokens`` tokens of future work; when the
    queued cost would exceed ``max_queued_tokens`` the request is shed
    at the door (an explicit :class:`OverloadedError`, never a silent
    stall),
  * **weighted-fair scheduling** — pending requests drain in virtual-
    finish-time order across tenants (start-time fair queuing weighted
    by tenant weight, cost measured in tokens), so one chatty tenant
    cannot starve the rest.

Thread-safety: ``try_admit`` runs on the asyncio thread, ``pop`` on the
serving-loop thread — every public method takes the controller lock.

Port note: a copy of ``deepspeed_tpu/inference/v2/serve/admission.py``
over the port's ``runtime/tunables.py``; the rejection reasons, metric
names and ``Retry-After`` hint are the same.
"""

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from ....telemetry import recorder as flight


class OverloadedError(RuntimeError):
    """Explicit admission rejection (HTTP surfaces map it to 429).

    ``reason`` is one of ``queue_full`` / ``token_budget`` / ``draining``
    — the same labels the rejection counter uses. ``retry_after_s`` is a
    machine-readable backoff hint: the HTTP surface emits it as a
    ``Retry-After`` header and the replica router uses it to take the
    rejecting replica out of rotation for exactly that long
    (backoff-aware re-routing) instead of hammering it."""

    def __init__(self, reason: str, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclass
class AdmissionConfig:
    max_pending: int = 128            # bounded pending queue
    # cap on queued future work, in tokens (prompt + max_new per
    # request); None disables token-budget shedding
    max_queued_tokens: Optional[int] = None
    # per-tenant weights for fair scheduling; tenants not listed get 1.0
    tenant_weights: Dict[str, float] = field(default_factory=dict)
    # backoff hint attached to every rejection (OverloadedError
    # .retry_after_s / HTTP Retry-After): how long a shed client should
    # wait before retrying THIS runtime
    retry_after_s: float = 0.5

    def __post_init__(self):
        # the shed threshold is a registered tunable: a bad value fails
        # naming the registry entry + documented range, and /statusz
        # shows the effective value with its provenance
        if self.max_queued_tokens is not None:
            from ....runtime import tunables
            tunables.check("serving.max_queued_tokens",
                           self.max_queued_tokens,
                           label="max_queued_tokens")
            tunables.observe("serving.max_queued_tokens",
                             self.max_queued_tokens, "config")


def request_cost(entry) -> int:
    """Future-work cost of a request in tokens (admission currency)."""
    return len(entry.prompt) + max(int(entry.max_new_tokens), 1)


class AdmissionController:
    """Bounded, tenant-fair pending queue between submit() and the loop."""

    def __init__(self, config: Optional[AdmissionConfig] = None):
        self.config = config or AdmissionConfig()
        self._lock = threading.Lock()
        self._queues: Dict[str, Deque] = {}
        # start-time fair queuing state: virtual time advances to the
        # finish tag of each popped request; a tenant head's finish tag
        # is max(vtime, tenant's last finish) + cost / weight
        self._vtime = 0.0
        self._last_finish: Dict[str, float] = {}
        self._head_finish: Dict[str, float] = {}
        self._depth = 0
        self._tokens = 0
        self._closed = False
        self._init_telemetry()

    def _init_telemetry(self):
        from ....telemetry import get_registry
        reg = get_registry()
        self._m_depth = reg.gauge(
            "serving_admission_queue_depth",
            "requests waiting in the admission queue")
        self._m_tokens = reg.gauge(
            "serving_admission_queued_tokens",
            "queued future work in tokens (prompt + max_new)")
        self._m_admitted = reg.counter(
            "serving_admission_admitted_total", "requests admitted")
        self._m_rejected = reg.counter(
            "serving_admission_rejections_total",
            "requests shed at admission", labelnames=("reason",))

    def _update_gauges(self):
        self._m_depth.set(self._depth)
        self._m_tokens.set(self._tokens)

    def _weight(self, entry) -> float:
        if entry.weight is not None:
            return max(float(entry.weight), 1e-6)
        return max(self.config.tenant_weights.get(entry.tenant, 1.0), 1e-6)

    @staticmethod
    def _lane(entry) -> str:
        """Fairness-queue key: tenant, sub-divided by LoRA adapter. A
        tenant hammering one adapter then cannot starve its OWN other
        adapters either — each (tenant, adapter) pair drains in
        virtual-finish-time order like a tenant of its own (weights
        still come from the tenant, via ``_weight``). ``|`` cannot
        appear ambiguously: it is appended only when an adapter is
        set."""
        adapter = getattr(entry, "adapter", None)
        return f"{entry.tenant}|{adapter}" if adapter else entry.tenant

    def _reject(self, reason: str, message: str):
        self._m_rejected.labels(reason=reason).inc()
        flight.record("shed", reason=reason, depth=self._depth,
                      queued_tokens=self._tokens)
        raise OverloadedError(reason, message,
                              retry_after_s=self.config.retry_after_s)

    # ------------------------------------------------------------------
    def try_admit(self, entry) -> None:
        """Admit ``entry`` into the pending queue or raise
        :class:`OverloadedError` (the explicit backpressure signal)."""
        cost = request_cost(entry)
        with self._lock:
            if self._closed:
                self._reject("draining",
                             "serving runtime is draining; not accepting "
                             "new requests")
            if self._depth >= self.config.max_pending:
                self._reject(
                    "queue_full",
                    f"admission queue full ({self.config.max_pending} "
                    f"pending); retry later")
            budget = self.config.max_queued_tokens
            if budget is not None and self._tokens + cost > budget:
                self._reject(
                    "token_budget",
                    f"queued token budget exceeded ({self._tokens} "
                    f"queued + {cost} requested > {budget}); shed")
            t = self._lane(entry)
            q = self._queues.setdefault(t, deque())
            if not q:
                self._head_finish[t] = (max(self._vtime,
                                            self._last_finish.get(t, 0.0))
                                        + cost / self._weight(entry))
            q.append(entry)
            self._depth += 1
            self._tokens += cost
            self._m_admitted.inc()
            flight.record("admit", uid=entry.uid, tenant=entry.tenant,
                          adapter=getattr(entry, "adapter", None),
                          cost_tokens=cost, depth=self._depth)
            self._update_gauges()

    def pop(self):
        """Next request in weighted-fair order, or None if empty."""
        with self._lock:
            best_t, best_f = None, None
            for t, q in self._queues.items():
                if q and (best_f is None or self._head_finish[t] < best_f):
                    best_t, best_f = t, self._head_finish[t]
            if best_t is None:
                return None
            return self._pop_locked(best_t)

    def _pop_locked(self, tenant: str):
        q = self._queues[tenant]
        entry = q.popleft()
        self._vtime = self._head_finish[tenant]
        self._last_finish[tenant] = self._head_finish[tenant]
        if q:
            head = q[0]
            self._head_finish[tenant] = (
                self._last_finish[tenant]
                + request_cost(head) / self._weight(head))
        else:
            self._drop_tenant(tenant)
        self._depth -= 1
        self._tokens -= request_cost(entry)
        self._update_gauges()
        return entry

    def _drop_tenant(self, tenant: str) -> None:
        """Forget an idle tenant's fairness state. Tenant names are
        client-controlled (the HTTP surface passes them verbatim), so
        keeping every tenant ever seen would grow these dicts without
        bound and make pop()'s head scan O(tenants-ever). Equivalent for
        fairness: once a tenant's last pop advanced vtime to its finish
        tag, max(vtime, last_finish) == vtime for it from then on."""
        self._queues.pop(tenant, None)
        self._head_finish.pop(tenant, None)
        self._last_finish.pop(tenant, None)

    def remove(self, uid: int) -> bool:
        """Drop a still-pending request (cancellation / deadline expiry
        before it reached the model loop)."""
        with self._lock:
            for t, q in self._queues.items():
                for entry in q:
                    if entry.uid == uid:
                        was_head = q[0] is entry
                        q.remove(entry)
                        self._depth -= 1
                        self._tokens -= request_cost(entry)
                        if not q:
                            self._drop_tenant(t)
                        elif was_head:
                            head = q[0]
                            self._head_finish[t] = (
                                max(self._vtime,
                                    self._last_finish.get(t, 0.0))
                                + request_cost(head) / self._weight(head))
                        self._update_gauges()
                        return True
        return False

    def reclaim_pending(self) -> List:
        """Empty the pending queues and return the reclaimed entries —
        the dead-replica failover path (serve/router.py): when a
        replica's heartbeat expires, its queued (not-yet-prefilled)
        requests are pulled back here and re-enqueued on survivors.
        Entries are marked ``done`` under the lock so a loop thread that
        later recovers cannot ALSO run them (it skips done entries at
        admit time)."""
        with self._lock:
            out: List = []
            for tenant in list(self._queues):
                q = self._queues[tenant]
                while q:
                    entry = q.popleft()
                    entry.state = "done"
                    out.append(entry)
                self._drop_tenant(tenant)
            self._depth = 0
            self._tokens = 0
            self._update_gauges()
            return out

    def set_max_queued_tokens(self, budget: Optional[int], *,
                              source: str = "online") -> Optional[int]:
        """Retarget the queued-token shed threshold at runtime (the
        online adapter's actuation path — autotuning/online.py).
        ``try_admit`` reads the config under the lock on every call, so
        the new budget applies to the next admission decision. ``None``
        disables token-budget shedding (the config default)."""
        from ....runtime import tunables
        if budget is not None:
            budget = tunables.check("serving.max_queued_tokens", budget,
                                    label="max_queued_tokens")
        with self._lock:
            old = self.config.max_queued_tokens
            self.config.max_queued_tokens = budget
        if budget != old:
            tunables.observe("serving.max_queued_tokens", budget, source)
            flight.record("tunable_set", name="serving.max_queued_tokens",
                          value=budget, source=source)
        return budget

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Stop admitting (graceful drain): subsequent try_admit raises
        OverloadedError(reason='draining'); queued requests still pop."""
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def depth(self) -> int:
        return self._depth

    def queued_tokens(self) -> int:
        return self._tokens

    def empty(self) -> bool:
        return self._depth == 0

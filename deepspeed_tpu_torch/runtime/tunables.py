"""Registry of the performance tunables the port reads.

Adapted copy of ``deepspeed_tpu/runtime/tunables.py`` (which imports no
jax), holding only the entries that code in this package reads:

  * the four ZeRO geometry knobs, checked by ``runtime/config.py``,
  * ``serving.decode_window`` and ``serving.prefill_bucket``, checked by
    ``inference/v2/config_v2.py`` (the window also by the engine's
    ``set_decode_window``),
  * ``serving.max_queued_tokens``, the admission controller's
    token-budget shed threshold (``inference/v2/serve/admission.py``),
  * ``state_manager.kv_spill_host_bytes`` / ``kv_spill_disk_bytes``, the
    KV spill tier's budgets, checked by ``inference/v2/config_v2.py``.

Each entry has the same name, default, hard range and cost signal as in
the JAX package, so a bad value fails with the same message in both.
Consumers report the value they run with through :func:`observe`, and
``/statusz`` renders :func:`statusz_section`: the effective value and
its provenance (``default | config | tuned | online``) per knob. The
search ladders of the JAX registry belong to its offline tuner, and the
handoff and autoscaler entries to the fleet modules (ROADMAP A7): they
come with the code that reads them.
"""

import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

PROVENANCES = ("default", "config", "tuned", "online")


@dataclass(frozen=True)
class Tunable:
    """One performance knob. ``lo``/``hi`` are the INCLUSIVE hard
    validity bounds (``None`` = unbounded on that side) enforced at
    config load."""

    name: str                     # dotted config path, e.g. "serving.decode_window"
    default: Any
    cost_signal: str              # telemetry metric this knob moves
    doc: str
    kind: type = int
    lo: Optional[float] = None
    hi: Optional[float] = None
    online: bool = False          # reported on /statusz as in the JAX package

    def range_str(self) -> str:
        lo = "-inf" if self.lo is None else f"{self.lo:g}"
        hi = "inf" if self.hi is None else f"{self.hi:g}"
        return f"[{lo}, {hi}]"

    def in_range(self, value) -> bool:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return False
        if math.isnan(v):
            return False
        if self.lo is not None and v < self.lo:
            return False
        if self.hi is not None and v > self.hi:
            return False
        return True


class TunableRegistry:
    """Ordered name -> :class:`Tunable` map with provenance tracking.

    Provenance is process-wide last-writer-wins: consumers call
    :meth:`observe` with the value they actually run with, and
    :meth:`statusz_section` reports it. Engines in one process share
    the table."""

    def __init__(self):
        self._entries: Dict[str, Tunable] = {}
        self._lock = threading.Lock()
        self._effective: Dict[str, Tuple[Any, str]] = {}

    def register(self, t: Tunable) -> Tunable:
        existing = self._entries.get(t.name)
        if existing is not None and existing != t:
            raise ValueError(f"tunable {t.name!r} already registered "
                             f"with a different definition")
        self._entries[t.name] = t
        return t

    def get(self, name: str) -> Tunable:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown tunable {name!r} — registered entries: "
                f"{sorted(self._entries)}") from None

    def names(self) -> List[str]:
        return list(self._entries)

    def check(self, name: str, value, *, exc=ValueError, label=None):
        """Validate ``value`` against the entry's hard range, raising
        ``exc`` with the JAX package's message, which names the registry
        entry, its range and the repo's catalog of them. Returns the
        value coerced to the entry's kind."""
        t = self.get(name)
        if not t.in_range(value):
            label = label or t.name
            raise exc(
                f"{label} must be in {t.range_str()}, got {value!r} — "
                f"registered tunable '{t.name}' (docs/TUNING.md "
                f"§ Tunable registry)")
        return t.kind(value)

    def observe(self, name: str, value, source: str) -> None:
        """Record the value a consumer actually runs with. ``source``
        is one of PROVENANCES; a value equal to the default demotes
        ``config`` back to ``default`` (loading a config that does not
        move the knob is not a provenance change)."""
        t = self.get(name)
        if source not in PROVENANCES:
            raise ValueError(f"provenance must be one of {PROVENANCES}, "
                             f"got {source!r}")
        if source == "config" and value == t.default:
            source = "default"
        with self._lock:
            self._effective[name] = (value, source)

    def statusz_section(self) -> Dict[str, Dict[str, Any]]:
        """The /statusz ``tunables`` document: one row per entry with
        effective value + provenance next to the declared default,
        range, and cost signal."""
        out: Dict[str, Dict[str, Any]] = {}
        for t in self._entries.values():
            with self._lock:
                value, source = self._effective.get(
                    t.name, (t.default, "default"))
            out[t.name] = {
                "value": value,
                "provenance": source,
                "default": t.default,
                "range": t.range_str(),
                "cost_signal": t.cost_signal,
                "online": t.online,
            }
        return out


REGISTRY = TunableRegistry()


def _r(**kw) -> Tunable:
    return REGISTRY.register(Tunable(**kw))


# -- training: ZeRO bucket geometry & quantized-reduce wire ------------
_r(name="zero_optimization.reduce_bucket_size", default=500_000_000,
   lo=1, hi=None, cost_signal="train_grad_exposed_collective_fraction",
   doc="reduce-scatter bucket cap in elements; smaller buckets start "
       "reducing earlier but pay more launches")
_r(name="zero_optimization.allgather_bucket_size", default=500_000_000,
   lo=1, hi=None, cost_signal="train_grad_exposed_collective_fraction",
   doc="all-reduce bucket cap in elements "
       "(min(reduce_bucket_size, allgather_bucket_size) applies)")
_r(name="zero_optimization.stage3_prefetch_bucket_size",
   default=50_000_000, lo=1, hi=None,
   cost_signal="offload_prefetch_hit_fraction",
   doc="streamed optimizer-update prefetch granularity in elements")
_r(name="zero_optimization.quant_block", default=2048, lo=1, hi=1 << 20,
   cost_signal="train_quant_reduce_wire_ratio",
   doc="elements per wire-quantization block for quantized_reduce; "
       "smaller blocks track outliers better but ship more fp32 scales")

# -- serving: decode/prefill geometry and admission --------------------
_r(name="serving.decode_window", default=8, lo=1, hi=64, online=True,
   cost_signal="inference_decode_host_syncs_total",
   doc="fused decode steps per dispatch K (config_v2.decode_window); "
       "larger K amortizes host syncs, smaller K cuts tail waste and "
       "TTFT interference")
_r(name="serving.prefill_bucket", default=64, lo=1, hi=8192,
   cost_signal="inference_ragged_pad_fraction",
   doc="prompt lengths pad to multiples of this "
       "(config_v2.prefill_bucket)")
_r(name="serving.max_queued_tokens", default=None, lo=1, hi=1 << 24,
   online=True, cost_signal="serving_admission_queued_tokens",
   doc="admission token-budget shed threshold "
       "(AdmissionConfig.max_queued_tokens; None disables shedding)")

# -- serving: KV spill tier --------------------------------------------
_r(name="state_manager.kv_spill_host_bytes", default=64 << 20,
   lo=1, hi=None, cost_signal="kv_spill_resident_bytes",
   doc="host-RAM LRU budget for spilled prefix-cache KV blocks")
_r(name="state_manager.kv_spill_disk_bytes", default=256 << 20,
   lo=0, hi=None, cost_signal="kv_spill_dropped_blocks_total",
   doc="disk-tier LRU budget for spilled KV blocks (0 = host tier "
       "only)")


# -- module-level conveniences (the registry singleton) ----------------
def check(name: str, value, *, exc=ValueError, label=None):
    return REGISTRY.check(name, value, exc=exc, label=label)


def observe(name: str, value, source: str) -> None:
    REGISTRY.observe(name, value, source)


def statusz_section() -> Dict[str, Dict[str, Any]]:
    return REGISTRY.statusz_section()

"""Declarative registry of every performance tunable.

Port of ``deepspeed_tpu/runtime/tunables.py`` (which imports no jax), a
copy: the same entries, each with the same name, type, hard validity
range, default, search ladder and ``cost_signal`` (the telemetry metric
the knob moves), so a bad value fails with the same message in both
packages.

  * config validation routes through :meth:`TunableRegistry.check`
    (``runtime/config.py``, ``inference/v2/config_v2.py``, the engine's
    ``set_decode_window``, the admission controller, the router and the
    autoscaler),
  * the offline tuner (``autotuning/offline.py``) walks
    :meth:`TunableRegistry.ladder` per knob; the online adapter
    (``autotuning/online.py``) clamps every nudge with
    :meth:`TunableRegistry.clamp` and only touches ``online=True``
    entries,
  * consumers report the value they actually run with via
    :func:`observe`; ``/statusz`` renders :func:`statusz_section` —
    effective value + provenance (``default | config | tuned |
    online``) per knob.

This module stays import-light (no torch, no package siblings): config
loading happens before any device is up.
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
    config load and on every online nudge; ``search`` is the offline
    tuner's candidate ladder (a subset of the valid range — empty means
    the knob is not searched offline)."""

    name: str                     # dotted config path, e.g. "serving.decode_window"
    default: Any
    cost_signal: str              # telemetry metric this knob moves
    doc: str
    kind: type = int
    lo: Optional[float] = None
    hi: Optional[float] = None
    online: bool = False          # may the online adapter move it live?
    search: Tuple = ()

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
    :meth:`observe` with the value they are actually running with (a
    config load, a tuned-config apply, an online nudge), and
    :meth:`statusz_section` reports it. Multiple engines in one process
    share the table — acceptable for /statusz, documented in
    docs/TUNING.md."""

    def __init__(self):
        self._entries: Dict[str, Tunable] = {}
        self._lock = threading.Lock()
        self._effective: Dict[str, Tuple[Any, str]] = {}

    # -- catalog -------------------------------------------------------
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

    def entries(self) -> List[Tunable]:
        return list(self._entries.values())

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    # -- validation ----------------------------------------------------
    def check(self, name: str, value, *, exc=ValueError, label=None):
        """Validate ``value`` against the entry's hard range, raising
        ``exc`` with a message that names the registry entry and its
        documented range (the satellite contract: no more bare
        ``must be > 0``). Returns the value coerced to the entry's
        kind."""
        t = self.get(name)
        if not t.in_range(value):
            label = label or t.name
            raise exc(
                f"{label} must be in {t.range_str()}, got {value!r} — "
                f"registered tunable '{t.name}' (docs/TUNING.md "
                f"§ Tunable registry)")
        return t.kind(value)

    def clamp(self, name: str, value):
        """Snap ``value`` into the entry's hard range (the online
        adapter's bound — a nudge can never leave the documented
        range)."""
        t = self.get(name)
        v = float(value)
        if t.lo is not None:
            v = max(v, t.lo)
        if t.hi is not None:
            v = min(v, t.hi)
        return t.kind(v)

    def ladder(self, name: str) -> List:
        """Offline search candidates, in-range and sorted, always
        including the default."""
        t = self.get(name)
        vals = {t.kind(v) for v in t.search if t.in_range(v)}
        if t.default is not None:
            vals.add(t.kind(t.default))
        return sorted(vals)

    # -- provenance ----------------------------------------------------
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

    def effective(self, name: str) -> Tuple[Any, str]:
        """(value, provenance) — the default when never observed."""
        t = self.get(name)
        with self._lock:
            return self._effective.get(name, (t.default, "default"))

    def reset_observations(self) -> None:
        with self._lock:
            self._effective.clear()

    def statusz_section(self) -> Dict[str, Dict[str, Any]]:
        """The /statusz ``tunables`` document: one row per entry with
        effective value + provenance next to the declared default,
        range, and cost signal."""
        out: Dict[str, Dict[str, Any]] = {}
        for t in self.entries():
            value, source = self.effective(t.name)
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
   search=(1 << 22, 1 << 24, 1 << 26, 1 << 28, 500_000_000),
   doc="reduce-scatter bucket cap in elements (grad_overlap.py); "
       "smaller buckets start reducing earlier but pay more launches")
_r(name="zero_optimization.allgather_bucket_size", default=500_000_000,
   lo=1, hi=None, cost_signal="train_grad_exposed_collective_fraction",
   search=(1 << 22, 1 << 24, 1 << 26, 1 << 28, 500_000_000),
   doc="all-reduce bucket cap in elements "
       "(min(reduce_bucket_size, allgather_bucket_size) applies)")
_r(name="zero_optimization.stage3_prefetch_bucket_size",
   default=50_000_000, lo=1, hi=None,
   cost_signal="offload_prefetch_hit_fraction",
   search=(1 << 20, 1 << 22, 1 << 24, 50_000_000),
   doc="streamed optimizer-update prefetch granularity in elements "
       "(runtime/offload.py)")
_r(name="zero_optimization.quant_block", default=2048, lo=1, hi=1 << 20,
   cost_signal="train_quant_reduce_wire_ratio",
   search=(256, 512, 1024, 2048, 4096, 8192),
   doc="elements per wire-quantization block for quantized_reduce; "
       "smaller blocks track outliers better but ship more fp32 scales")

# -- serving: decode/prefill geometry ----------------------------------
_r(name="serving.decode_window", default=8, lo=1, hi=64, online=True,
   cost_signal="inference_decode_host_syncs_total",
   search=(1, 2, 4, 8, 16, 32),
   doc="fused decode steps per dispatch K (config_v2.decode_window); "
       "larger K amortizes host syncs, smaller K cuts tail waste and "
       "TTFT interference")
_r(name="serving.prefill_bucket", default=64, lo=1, hi=8192,
   cost_signal="inference_ragged_pad_fraction",
   search=(16, 32, 64, 128, 256),
   doc="prompt lengths pad to multiples of this "
       "(config_v2.prefill_bucket); finer buckets waste less padding "
       "but compile more programs")
_r(name="serving.token_budget", default=768, lo=1, hi=1 << 16,
   cost_signal="inference_ragged_pad_fraction",
   search=(128, 256, 512, 768, 1024),
   doc="SplitFuse scheduler per-step token budget "
       "(ServingConfig.token_budget; default = "
       "state_manager.max_ragged_batch_size)")
_r(name="serving.max_queued_tokens", default=None, lo=1, hi=1 << 24,
   online=True, cost_signal="serving_admission_queued_tokens",
   search=(1024, 4096, 16384, 65536),
   doc="admission token-budget shed threshold "
       "(AdmissionConfig.max_queued_tokens; None disables shedding)")
_r(name="serving.handoff_chunk_blocks", default=4, lo=1, hi=256,
   cost_signal="handoff_chunk_overlap_steps_total",
   search=(1, 2, 4, 8, 16),
   doc="KV blocks per chunk in live-migration handoff streams "
       "(serve/handoff.py export_chunks)")

# -- serving: KV spill tier --------------------------------------------
_r(name="state_manager.kv_spill_host_bytes", default=64 << 20,
   lo=1, hi=None, cost_signal="kv_spill_resident_bytes",
   search=(16 << 20, 64 << 20, 256 << 20),
   doc="host-RAM LRU budget for spilled prefix-cache KV blocks")
_r(name="state_manager.kv_spill_disk_bytes", default=256 << 20,
   lo=0, hi=None, cost_signal="kv_spill_dropped_blocks_total",
   search=(0, 256 << 20, 1 << 30),
   doc="disk-tier LRU budget for spilled KV blocks (0 = host tier "
       "only)")

# -- fleet: autoscaler thresholds --------------------------------------
_r(name="autoscaler.load_high", default=64.0, kind=float, lo=1e-6,
   hi=None, cost_signal="router_autoscale_replicas",
   search=(16.0, 32.0, 64.0, 128.0),
   doc="per-replica queued-token load above which a scale-up tick "
       "accrues")
_r(name="autoscaler.scale_up_after_ticks", default=2, lo=1, hi=1000,
   cost_signal="router_autoscale_up_total",
   doc="consecutive high-load ticks before spawning a replica")
_r(name="autoscaler.scale_down_after_ticks", default=5, lo=1, hi=10000,
   cost_signal="router_autoscale_down_total",
   doc="consecutive low-load ticks before retiring a replica")
_r(name="autoscaler.cooldown_s", default=2.0, kind=float, lo=0.0,
   hi=3600.0, cost_signal="router_autoscale_tick_seconds",
   doc="minimum seconds between autoscaler actions")


# -- module-level conveniences (the registry singleton) ----------------
def check(name: str, value, *, exc=ValueError, label=None):
    return REGISTRY.check(name, value, exc=exc, label=label)


def clamp(name: str, value):
    return REGISTRY.clamp(name, value)


def observe(name: str, value, source: str) -> None:
    REGISTRY.observe(name, value, source)


def statusz_section() -> Dict[str, Dict[str, Any]]:
    return REGISTRY.statusz_section()

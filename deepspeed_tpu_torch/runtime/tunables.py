"""Validation of the training tunables the config schema checks.

Local copy of the part of ``deepspeed_tpu/runtime/tunables.py`` that
``runtime/config.py`` calls at load (``check``): the four ZeRO geometry
knobs with their hard ranges, so a bad value fails with the same message
in both packages. The registry's search ladders, provenance tracking and
the serving/fleet entries come with the modules that read them.
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class Tunable:
    """One knob: dotted config path, default and INCLUSIVE hard bounds
    (``None`` = unbounded on that side)."""

    name: str
    default: Any
    kind: type = int
    lo: Optional[float] = None
    hi: Optional[float] = None

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


REGISTRY: Dict[str, Tunable] = {t.name: t for t in (
    Tunable("zero_optimization.reduce_bucket_size", 500_000_000, lo=1),
    Tunable("zero_optimization.allgather_bucket_size", 500_000_000, lo=1),
    Tunable("zero_optimization.stage3_prefetch_bucket_size", 50_000_000,
            lo=1),
    Tunable("zero_optimization.quant_block", 2048, lo=1, hi=1 << 20),
)}


def check(name: str, value, *, exc=ValueError, label=None):
    """Raise ``exc`` naming the entry and its range when ``value`` is out
    of it; returns the value coerced to the entry's kind."""
    t = REGISTRY[name]
    if not t.in_range(value):
        label = label or t.name
        raise exc(
            f"{label} must be in {t.range_str()}, got {value!r} — "
            f"registered tunable '{t.name}' (docs/TUNING.md "
            f"§ Tunable registry)")
    return t.kind(value)

"""Device-memory accounting.

Port of ``deepspeed_tpu/telemetry/memory.py``. The JAX module publishes
XLA's per-program memory analysis; eager PyTorch compiles no programs, so
this one publishes what the CUDA caching allocator knows instead, beside
the same buffer table:

  * **device** — :func:`record_device` reads ``torch.cuda.memory_allocated``,
    ``max_memory_allocated`` and ``mem_get_info`` on a device into
    ``device_memory_{allocated,peak,free,total}_bytes{device=...}``
    gauges (a CPU device records zeros). ``InferenceEngineV2.memory_report``
    calls it on the engine's device.
  * **buffers** — :func:`record_buffer` publishes long-lived allocations
    (KV pool, weights, optimizer state) as ``device_buffer_bytes{buffer=
    ...}``, the JAX package's gauge name.

:func:`oom_report` ranks the buffers and names the largest, with the
last device reading beside them — the first thing to read after a CUDA
out-of-memory error. Its ``programs`` list, XLA's per-program table in the
JAX package, is always empty here.
"""

import threading
from typing import Any, Dict, Optional

from .registry import get_registry

_lock = threading.Lock()
_buffers: Dict[str, int] = {}
_devices: Dict[str, Dict[str, int]] = {}


def _device_gauges():
    reg = get_registry()
    kinds = (("allocated", "bytes held by live tensors"),
             ("peak", "high-water mark of allocated bytes"),
             ("free", "free device memory (driver view)"),
             ("total", "total device memory"))
    return {k: reg.gauge(f"device_memory_{k}_bytes",
                         f"{doc} on the device (CUDA caching allocator)",
                         unit="bytes", labelnames=("device",))
            for k, doc in kinds}


def tree_bytes(tree) -> int:
    """Total bytes of a nested dict / list / tuple of tensors or arrays
    (KV cache, params, optimizer state). Leaves with ``nbytes`` (numpy)
    or ``numel``/``element_size`` (torch) count; others count 0. A
    weight-only quantized leaf counts its stored data and scales."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        return int(tree.numel()) * int(tree.element_size())
    nbytes = getattr(tree, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if hasattr(tree, "__dict__"):
        return sum(tree_bytes(v) for v in vars(tree).values()
                   if hasattr(v, "numel") or hasattr(v, "nbytes"))
    return 0


def device_memory(device) -> Dict[str, int]:
    """``{allocated, peak, free, total}`` bytes on ``device`` from the CUDA
    caching allocator and the CUDA driver; zeros for a CPU device. Reads host
    counters only: no kernel launches and no synchronization."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return {"allocated": 0, "peak": 0, "free": 0, "total": 0}
    free, total = torch.cuda.mem_get_info(device)
    return {"allocated": int(torch.cuda.memory_allocated(device)),
            "peak": int(torch.cuda.max_memory_allocated(device)),
            "free": int(free), "total": int(total)}


def record_device(device) -> Dict[str, int]:
    """Publish :func:`device_memory` of ``device`` as gauges; returns it."""
    rec = device_memory(device)
    name = str(device)
    g = _device_gauges()
    for k, v in rec.items():
        g[k].labels(device=name).set(v)
    with _lock:
        _devices[name] = dict(rec)
    return rec


def record_buffer(name: str, nbytes: int) -> None:
    """Publish a long-lived device allocation (KV pool, weights, ...)."""
    get_registry().gauge(
        "device_buffer_bytes",
        "long-lived device allocations (KV pool, weights, optimizer "
        "state)", unit="bytes", labelnames=("buffer",)).labels(
        buffer=name).set(int(nbytes))
    with _lock:
        _buffers[name] = int(nbytes)


def buffers() -> Dict[str, int]:
    with _lock:
        return dict(_buffers)


def devices() -> Dict[str, Dict[str, int]]:
    with _lock:
        return {k: dict(v) for k, v in _devices.items()}


def reset() -> None:
    with _lock:
        _buffers.clear()
        _devices.clear()


def oom_report(top: int = 5) -> Dict[str, Any]:
    """One-call OOM forensics: buffers by size, largest first, the last
    device readings, and the headline culprit."""
    all_buffers = buffers()
    bufs = sorted(({"buffer": name, "bytes": b}
                   for name, b in all_buffers.items()),
                  key=lambda r: -r["bytes"])[:top]
    rep: Dict[str, Any] = {
        "programs": [],
        "buffers": bufs,
        # the total covers EVERY recorded buffer, not just the top-N
        # shown — a truncated "total" would mislead the OOM triage
        "total_buffer_bytes": sum(all_buffers.values()),
        "devices": devices(),
    }
    if bufs:
        rep["largest_buffer"] = bufs[0]["buffer"]
        rep["largest_buffer_bytes"] = bufs[0]["bytes"]
    return rep


def format_oom_report(rep: Optional[Dict[str, Any]] = None) -> str:
    """Human-readable :func:`oom_report` (what to paste into an OOM
    issue)."""
    rep = rep or oom_report()
    lines = ["device-memory forensics (largest first):", "  devices:"]
    for name, d in rep.get("devices", {}).items():
        lines.append(
            f"    {name:<24} allocated={d['allocated'] / 2**20:8.1f} MiB "
            f"peak={d['peak'] / 2**20:.1f} free={d['free'] / 2**20:.1f} "
            f"total={d['total'] / 2**20:.1f}")
    lines.append("  buffers:")
    for b in rep["buffers"]:
        lines.append(f"    {b['buffer']:<24} {b['bytes'] / 2**20:8.1f} MiB")
    if not rep.get("devices") and not rep["buffers"]:
        lines.append("    (nothing recorded yet — build an engine or run "
                     "memory_report() first)")
    return "\n".join(lines)

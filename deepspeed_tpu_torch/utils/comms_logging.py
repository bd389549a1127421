"""Per-op communication logging.

Port of ``deepspeed_tpu/utils/comms_logging.py`` (``calc_bw_log`` :24,
``CommsLogger`` :40), the reference's ``deepspeed/utils/comms_logging.py``:
per-collective message size, latency and the derived algorithmic and bus
bandwidth, with a summary table. ``comm.timed_op`` records a collective's
latency here after synchronizing the device, so a record is the
collective's own time on the card (``async_op`` calls record only their
enqueue).
"""

from collections import defaultdict
from typing import Dict, List

from .logging import logger


def calc_bw_log(comm_op: str, size_bytes: int, duration_s: float, n: int) -> tuple:
    """algbw/busbw in GB/s (reference comms_logging.py:34). `n` = group size."""
    duration_s = max(duration_s, 1e-9)
    tput = size_bytes / duration_s
    if comm_op in ("all_to_all_single", "all_to_all"):
        busbw = tput * ((n - 1) / max(n, 1))
    elif comm_op in ("all_gather_into_tensor", "allgather_fn", "reduce_scatter_tensor",
                     "reduce_scatter_fn"):
        size_bytes = size_bytes * n
        tput = size_bytes / duration_s
        busbw = tput * ((n - 1) / max(n, 1))
    elif comm_op in ("all_reduce", "inference_all_reduce"):
        tput = size_bytes * 2 / duration_s
        busbw = size_bytes / duration_s * (2 * (n - 1) / max(n, 1))
    else:
        busbw = tput
    return tput / 1e9, busbw / 1e9


class CommsLogger:
    """Accumulates comm records; reference utils/comms_logging.py:67."""

    def __init__(self, verbose=False, debug=False, prof_all=True, prof_ops=None,
                 world_size: int = 1):
        self.verbose = verbose
        self.debug = debug
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        self.comms_dict: Dict[str, Dict[int, List[float]]] = defaultdict(lambda: defaultdict(lambda: [0, []]))
        self.world_size = world_size
        # unified registry series (telemetry/): per-op call/byte counters
        # and latency histogram, labeled by collective name
        from ..telemetry import get_registry
        reg = get_registry()
        self._m_ops = reg.counter("comm_ops_total", "collective calls",
                                  labelnames=("op",))
        self._m_bytes = reg.counter("comm_bytes_total",
                                    "bytes moved by collectives",
                                    labelnames=("op",))
        self._m_latency = reg.histogram(
            "comm_latency_seconds", "collective latency", unit="s",
            labelnames=("op",))

    def append(self, log_name: str, raw_name: str, latency_s: float,
               msg_size: int):
        if not self.prof_all and log_name not in self.prof_ops:
            return
        self._m_ops.labels(op=log_name).inc()
        self._m_bytes.labels(op=log_name).inc(msg_size)
        self._m_latency.labels(op=log_name).observe(latency_s)
        rec = self.comms_dict[log_name][msg_size]
        rec[0] += 1
        rec[1].append(latency_s)
        if self.verbose:
            algbw, busbw = calc_bw_log(raw_name, msg_size, latency_s,
                                       self.world_size)
            logger.info(
                f"comm op: {log_name} | time(ms): {latency_s*1e3:.2f} | "
                f"msg size: {msg_size} | algbw (GB/s): {algbw:.2f} | busbw (GB/s): {busbw:.2f}")

    def log_summary(self, show_straggler: bool = False):
        lines = [f"{'Comm. Op':<28}{'Message Size':>14}{'Count':>8}"
                 f"{'Total Lat(ms)':>16}{'Avg Lat(ms)':>14}{'algbw(GB/s)':>13}{'busbw(GB/s)':>13}"]
        for op, sizes in sorted(self.comms_dict.items()):
            for size, (count, lats) in sorted(sizes.items()):
                total = sum(lats)
                avg = total / max(count, 1)
                algbw, busbw = calc_bw_log(op, size, avg, self.world_size)
                lines.append(f"{op:<28}{size:>14}{count:>8}{total*1e3:>16.2f}"
                             f"{avg*1e3:>14.3f}{algbw:>13.2f}{busbw:>13.2f}")
        logger.info("\n".join(lines))
        return "\n".join(lines)

"""Memory breadcrumbs (reference deepspeed/utils — see_memory_usage).

Port of ``deepspeed_tpu/utils/memory.py``. The JAX module reads PJRT's
``device.memory_stats()``; here the figures come from the CUDA caching
allocator (``torch.cuda.memory_allocated`` / ``max_memory_allocated``) and
``torch.cuda.mem_get_info``'s total, with host RSS from
``resource``. On a CPU device (or with no GPU) the device figures are 0.
"""

import resource
import sys
from typing import Optional

import torch

from .logging import _process_index, logger


def _device_stats(device) -> dict:
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return {}
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": total}


def see_memory_usage(message: str, force: bool = False,
                     ranks: Optional[list] = None, device=None) -> dict:
    """Log device + host memory usage. Returns the stats dict
    (``device_used_gb``, ``device_peak_gb``, ``device_limit_gb``,
    ``host_max_rss_gb``, GiB rounded to 3 places, as in the JAX package);
    logging obeys ``force`` like the reference, and ``ranks`` restricts
    which processes log (default [0], matching log_dist). ``device``
    defaults to the current CUDA device, or the CPU without one."""
    log_ranks = ranks if ranks is not None else [0]
    if _process_index() not in log_ranks:
        force = False
    stats = _device_stats(device)
    gib = 1024 ** 3
    used = stats.get("bytes_in_use", 0) / gib
    peak = stats.get("peak_bytes_in_use", 0) / gib
    limit = stats.get("bytes_limit", 0) / gib
    # ru_maxrss is KiB on Linux but bytes on macOS
    rss_div = 1024 ** 3 if sys.platform == "darwin" else 1024 ** 2
    host_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / rss_div
    out = {"device_used_gb": round(used, 3),
           "device_peak_gb": round(peak, 3),
           "device_limit_gb": round(limit, 3),
           "host_max_rss_gb": round(host_rss, 3)}
    if force:
        logger.info(
            f"{message} | device used {used:.2f} GB (peak {peak:.2f}, "
            f"limit {limit:.2f}) | host maxRSS {host_rss:.2f} GB")
    return out

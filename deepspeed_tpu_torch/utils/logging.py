"""Logging utilities.

Port of ``deepspeed_tpu/utils/logging.py`` (logger + ``log_dist(ranks=...)``).
The process index is the ``torch.distributed`` rank when a process group is
initialized, else 0. The logger is ``deepspeed_tpu_torch.log``, printing to
stdout like the JAX package's ``deepspeed_tpu`` logger.
"""

import logging
import os
import sys
from typing import Iterable, Optional

LOG_LEVEL = os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper()

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


# a child of the package logger, so the modules' own
# ``logging.getLogger(__name__)`` loggers keep propagating to the root
def _create_logger(name: str = "deepspeed_tpu_torch.log",
                   level: str = LOG_LEVEL) -> logging.Logger:
    lg = logging.getLogger(name)
    if not lg.handlers:
        lg.setLevel(getattr(logging, level, logging.INFO))
        lg.propagate = False
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        lg.addHandler(handler)
    return lg


logger = _create_logger()


def _process_index() -> int:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # pragma: no cover - torch without distributed
        pass
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO) -> None:
    """Log `message` only on the listed process indices (None/-1 => all)."""
    my_rank = _process_index()
    ranks = list(ranks) if ranks is not None else None
    if ranks is None or my_rank in ranks or -1 in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message: str, _seen=set()) -> None:  # noqa: B006 - intentional cache
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)

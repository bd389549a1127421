"""Accelerator selection.

Port of ``deepspeed_tpu/accelerator/real_accelerator.py``: the
``get_accelerator()`` singleton with an environment override and
auto-detection (reference accelerator/real_accelerator.py:45,52-120).
Override: ``DS_ACCELERATOR=cuda|cpu``; otherwise CUDA when
``torch.cuda.is_available()``.
"""

import os
from typing import Optional

from .abstract_accelerator import DeepSpeedAccelerator

_accelerator: Optional[DeepSpeedAccelerator] = None

SUPPORTED = ("cuda", "cpu")


def _detect() -> str:
    override = os.environ.get("DS_ACCELERATOR")
    if override:
        if override not in SUPPORTED:
            raise ValueError(
                f"DS_ACCELERATOR={override!r} not in {SUPPORTED}")
        return override
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def get_accelerator() -> DeepSpeedAccelerator:
    global _accelerator
    if _accelerator is None:
        from .cuda_accelerator import CpuAccelerator, CudaAccelerator

        _accelerator = (CudaAccelerator() if _detect() == "cuda"
                        else CpuAccelerator())
    return _accelerator


def set_accelerator(accel: DeepSpeedAccelerator) -> None:
    global _accelerator
    _accelerator = accel


def is_current_accelerator_supported() -> bool:
    return get_accelerator()._name in SUPPORTED

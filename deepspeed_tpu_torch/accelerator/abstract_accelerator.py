"""Accelerator abstraction.

Port of ``deepspeed_tpu/accelerator/abstract_accelerator.py``
(``DeepSpeedAccelerator`` :17), the portability seam of the reference's
``accelerator/abstract_accelerator.py``. On PyTorch the seam is real CUDA:
streams, events, the caching allocator's counters and the device RNG;
:class:`~.cuda_accelerator.CpuAccelerator` answers for the host.
``communication_backend_name()`` names the ``torch.distributed`` backend
that ``comm.init_distributed`` starts (``nccl`` on the card, ``gloo`` on
the CPU).
"""

import abc
import contextlib
from typing import Any, Dict, List, Optional


class DeepSpeedAccelerator(abc.ABC):
    """Portability interface. Subclasses: CudaAccelerator, CpuAccelerator."""

    def __init__(self):
        self._name: Optional[str] = None
        self._communication_backend_name: Optional[str] = None

    # --- device identity (reference abstract_accelerator.py:22-60) --------
    @abc.abstractmethod
    def device_name(self, device_index: Optional[int] = None) -> str:
        ...

    def device(self, device_index: Optional[int] = None):
        """The ``torch.device`` of ``device_index`` (the current one when
        None)."""
        import torch

        return torch.device(self.device_name(device_index))

    @abc.abstractmethod
    def device_count(self) -> int:
        ...

    def set_device(self, device_index: int) -> None:
        self._current_device = device_index

    def current_device(self) -> int:
        return getattr(self, "_current_device", 0)

    def current_device_name(self) -> str:
        return self.device_name(self.current_device())

    @abc.abstractmethod
    def is_available(self) -> bool:
        ...

    # --- synchronization (reference :62-94) -------------------------------
    def synchronize(self, device_index: Optional[int] = None) -> None:
        pass

    def default_stream(self, device_index: Optional[int] = None):
        return None

    def current_stream(self, device_index: Optional[int] = None):
        return None

    def stream(self, _stream):
        return contextlib.nullcontext()

    def create_event(self, **kwargs):
        return None

    # --- RNG (reference :96-120) ------------------------------------------
    def manual_seed(self, seed: int) -> None:
        import torch

        self._seed = seed
        torch.manual_seed(seed)

    def initial_seed(self) -> int:
        return getattr(self, "_seed", 0)

    def default_generator(self, device_index: int):
        import torch

        gen = torch.Generator(device=self.device_name(device_index))
        gen.manual_seed(self.initial_seed() + device_index)
        return gen

    # --- memory (reference :122-170) --------------------------------------
    @abc.abstractmethod
    def memory_stats(self, device_index: Optional[int] = None) -> Dict[str, int]:
        """``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit``, the
        JAX package's key names."""

    def memory_allocated(self, device_index: Optional[int] = None) -> int:
        return self.memory_stats(device_index).get("bytes_in_use", 0)

    def max_memory_allocated(self, device_index: Optional[int] = None) -> int:
        return self.memory_stats(device_index).get("peak_bytes_in_use", 0)

    def reset_peak_memory_stats(self, device_index: Optional[int] = None) -> None:
        pass

    def total_memory(self, device_index: Optional[int] = None) -> int:
        return self.memory_stats(device_index).get("bytes_limit", 0)

    def available_memory(self, device_index: Optional[int] = None) -> int:
        s = self.memory_stats(device_index)
        return s.get("bytes_limit", 0) - s.get("bytes_in_use", 0)

    def empty_cache(self) -> None:
        pass

    # --- dtype support (reference :200-240) --------------------------------
    def is_bf16_supported(self) -> bool:
        return True

    def is_fp16_supported(self) -> bool:
        return True

    def supported_dtypes(self) -> List[Any]:
        import torch

        return [torch.float32, torch.bfloat16, torch.float16, torch.int8]

    # --- comm backend (reference :189) -------------------------------------
    def communication_backend_name(self) -> str:
        return self._communication_backend_name or "gloo"

    # --- profiler range markers (reference :177-181) ------------------------
    def range_push(self, msg: str):
        import torch

        ctx = torch.profiler.record_function(msg)
        ctx.__enter__()
        self._ranges = getattr(self, "_ranges", [])
        self._ranges.append(ctx)

    def range_pop(self):
        ranges = getattr(self, "_ranges", [])
        if ranges:
            ranges.pop().__exit__(None, None, None)

    # --- pinned / host memory ----------------------------------------------
    def pin_memory(self, tensor):
        return tensor

    def is_pinned(self, tensor) -> bool:
        return False

    # --- op builder registry (reference :244-259) ---------------------------
    @abc.abstractmethod
    def op_builder_dir(self) -> str:
        ...

    def create_op_builder(self, class_name: str):
        builder = self.get_op_builder(class_name)
        return builder() if builder is not None else None

    def get_op_builder(self, class_name: str):
        import importlib

        mod = importlib.import_module(self.op_builder_dir())
        return getattr(mod, class_name, None)

    def build_extension(self):
        return None  # kernels are built at first use (ops/op_builder)

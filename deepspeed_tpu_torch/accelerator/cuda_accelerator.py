"""CUDA and CPU accelerator implementations.

Counterpart of ``deepspeed_tpu/accelerator/tpu_accelerator.py`` (the
reference's ``cuda_accelerator.py`` is the template both follow): device
naming, streams, events, memory counters and the RNG on ``torch.cuda``,
and ``nccl`` as the communication backend. :class:`CpuAccelerator` is the
host, on ``gloo``.
"""

from typing import Dict, Optional

from .abstract_accelerator import DeepSpeedAccelerator

class CudaAccelerator(DeepSpeedAccelerator):
    def __init__(self):
        super().__init__()
        self._name = "cuda"
        self._communication_backend_name = "nccl"

    def device_name(self, device_index: Optional[int] = None) -> str:
        if device_index is None:
            return "cuda"
        return f"cuda:{device_index}"

    def device_count(self) -> int:
        import torch

        return torch.cuda.device_count()

    def is_available(self) -> bool:
        import torch

        return torch.cuda.is_available()

    def set_device(self, device_index: int) -> None:
        import torch

        super().set_device(device_index)
        torch.cuda.set_device(device_index)

    def current_device(self) -> int:
        import torch

        return torch.cuda.current_device()

    def synchronize(self, device_index: Optional[int] = None) -> None:
        import torch

        torch.cuda.synchronize(device_index)

    def default_stream(self, device_index: Optional[int] = None):
        import torch

        return torch.cuda.default_stream(device_index)

    def current_stream(self, device_index: Optional[int] = None):
        import torch

        return torch.cuda.current_stream(device_index)

    def stream(self, _stream):
        import torch

        return torch.cuda.stream(_stream)

    def create_event(self, **kwargs):
        import torch

        return torch.cuda.Event(**kwargs)

    def manual_seed(self, seed: int) -> None:
        import torch

        super().manual_seed(seed)
        torch.cuda.manual_seed_all(seed)

    def memory_stats(self, device_index: Optional[int] = None) -> Dict[str, int]:
        import torch

        dev = self.current_device() if device_index is None else device_index
        return {"bytes_in_use": torch.cuda.memory_allocated(dev),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
                "bytes_reserved": torch.cuda.memory_reserved(dev),
                "bytes_limit": torch.cuda.get_device_properties(
                    dev).total_memory}

    def reset_peak_memory_stats(self, device_index: Optional[int] = None) -> None:
        import torch

        torch.cuda.reset_peak_memory_stats(device_index)

    def empty_cache(self) -> None:
        import torch

        torch.cuda.empty_cache()

    def is_bf16_supported(self) -> bool:
        import torch

        return torch.cuda.is_bf16_supported()

    def pin_memory(self, tensor):
        return tensor.pin_memory()

    def is_pinned(self, tensor) -> bool:
        return tensor.is_pinned()

    def op_builder_dir(self) -> str:
        return "deepspeed_tpu_torch.ops.op_builder.cuda"


class CpuAccelerator(DeepSpeedAccelerator):
    """The host (reference cpu_accelerator.py): tests, and the host side
    of the offloaded optimizers."""

    def __init__(self):
        super().__init__()
        self._name = "cpu"
        self._communication_backend_name = "gloo"

    def device_name(self, device_index: Optional[int] = None) -> str:
        return "cpu"

    def device_count(self) -> int:
        return 1

    def is_available(self) -> bool:
        return True

    def memory_stats(self, device_index: Optional[int] = None) -> Dict[str, int]:
        try:
            with open("/proc/meminfo") as f:
                info = {}
                for line in f:
                    parts = line.split()
                    info[parts[0].rstrip(":")] = int(parts[1]) * 1024
            total = info.get("MemTotal", 0)
            avail = info.get("MemAvailable", 0)
            return {"bytes_limit": total, "bytes_in_use": total - avail,
                    "peak_bytes_in_use": total - avail}
        except OSError:
            return {}

    def is_fp16_supported(self) -> bool:
        return False  # matches reference cpu_accelerator (bf16 only on host)

    def op_builder_dir(self) -> str:
        return "deepspeed_tpu_torch.ops.op_builder.cpu"

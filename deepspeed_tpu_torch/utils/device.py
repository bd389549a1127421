"""Where the port's entry points run."""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises: the
    port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; deepspeed_tpu_torch runs on the "
            "GPU by default — pass device='cpu' to run the plain PyTorch "
            "versions of its kernels on the CPU")
    return dev

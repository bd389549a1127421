"""Host (CPU) optimizers backed by the native C++ kernels.

Port of ``deepspeed_tpu/ops/cpu_optimizers.py`` (``DeepSpeedCPUAdam`` :59,
``DeepSpeedCPUAdagrad`` :112, ``DeepSpeedCPULion`` :154,
``build_host_optimizer`` :206), over CPU tensors instead of numpy arrays.
ZeRO-Offload keeps the fp32 master weights and moments in host memory and
runs the update in these OpenMP/SIMD kernels (``csrc/host/``) while the
card only computes gradients.

The binding is the same C ABI (``ds_adam_update``, ``ds_adam_update_bf16``,
...) through ctypes over ``tensor.data_ptr()``. Every tensor must be a
contiguous CPU tensor; a bfloat16 tensor crosses as its 16-bit words (the
C side reads ``uint16_t``). The bf16 path takes bf16 gradients and writes
the updated params, rounded to nearest even, into a bf16 output in the
same pass over memory.
"""

from ctypes import c_float, c_int, c_int64, c_void_p
from typing import Optional, Tuple

import torch

from .op_builder.cpu import CPUAdagradBuilder, CPUAdamBuilder, CPULionBuilder


def _ptr(t: torch.Tensor, dtype: torch.dtype, n: int) -> int:
    """``t``'s address after checking what the C side assumes of it."""
    if t.device.type != "cpu" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"host optimizer buffers must be contiguous CPU {dtype} tensors, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if t.numel() != n:
        raise ValueError(f"host optimizer buffer holds {t.numel()} elements, "
                         f"expected {n}")
    return t.data_ptr()


def _f32(t, n):
    return _ptr(t, torch.float32, n)


def _bf16(t, n):
    return _ptr(t, torch.bfloat16, n)


class _HostOptimizer:
    """Common ctypes lifecycle: created with the object, destroyed by
    ``destroy()``."""

    _lib = None
    _destroy_fn = ""

    def __init__(self):
        self._id: Optional[int] = None

    def destroy(self):
        if self._id is not None and self._lib is not None:
            getattr(self._lib, self._destroy_fn)(self._id)
            self._id = None

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self.destroy()
        except Exception:
            pass

    def _step(self, f32_fn, bf16_fn, head, params, grads, moments, lr,
              params_out_bf16):
        """``f32_fn(*head, lr, params, grads, *moments, n)`` for f32 grads,
        else ``bf16_fn(..., params_out_bf16, n)``; with f32 grads a given
        ``params_out_bf16`` gets the rounded params afterwards."""
        n = params.numel()
        lr_c = -1.0 if lr is None else float(lr)
        ms = [_f32(m, n) for m in moments]
        if grads.dtype == torch.float32:
            f32_fn(*head, lr_c, _f32(params, n), _f32(grads, n), *ms, n)
            if params_out_bf16 is not None:
                params_out_bf16.copy_(params)
            return
        if params_out_bf16 is None:
            raise ValueError("bf16 gradients need a params_out_bf16 buffer")
        bf16_fn(*head, lr_c, _f32(params, n), _bf16(grads, n), *ms,
                _bf16(params_out_bf16, n), n)


class DeepSpeedCPUAdam(_HostOptimizer):
    """Reference ops/adam/cpu_adam.py:181 (create_adam/adam_update)."""

    _destroy_fn = "ds_adam_destroy"

    def __init__(self, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 bias_correction: bool = True):
        super().__init__()
        if DeepSpeedCPUAdam._lib is None:
            lib = CPUAdamBuilder().load()
            lib.ds_adam_create.restype = c_int
            lib.ds_adam_create.argtypes = [c_float] * 5 + [c_int, c_int]
            lib.ds_adam_destroy.argtypes = [c_int]
            lib.ds_adam_update.argtypes = [
                c_int, c_int64, c_float] + [c_void_p] * 4 + [c_int64]
            lib.ds_adam_update_bf16.argtypes = [
                c_int, c_int64, c_float] + [c_void_p] * 5 + [c_int64]
            DeepSpeedCPUAdam._lib = lib
        self.lr, self.betas, self.eps = lr, betas, eps
        self.weight_decay, self.adamw_mode = weight_decay, adamw_mode
        self.bias_correction = bias_correction
        self._id = self._lib.ds_adam_create(
            lr, betas[0], betas[1], eps, weight_decay,
            int(adamw_mode), int(bias_correction))

    def state_keys(self):
        return ("exp_avg", "exp_avg_sq")

    def step(self, step: int, params: torch.Tensor, grads: torch.Tensor,
             exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
             lr: Optional[float] = None,
             params_out_bf16: Optional[torch.Tensor] = None):
        """In-place Adam update on flat fp32 tensors. ``grads`` may be fp32
        or bfloat16; with bf16 grads, ``params_out_bf16`` (same size)
        receives the rounded updated params in the same pass."""
        self._step(self._lib.ds_adam_update, self._lib.ds_adam_update_bf16,
                   (self._id, step), params, grads, (exp_avg, exp_avg_sq),
                   lr, params_out_bf16)


class DeepSpeedCPUAdagrad(_HostOptimizer):
    """Reference ops/adagrad/cpu_adagrad.py (create_adagrad/adagrad_update)."""

    _destroy_fn = "ds_adagrad_destroy"

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0):
        super().__init__()
        if DeepSpeedCPUAdagrad._lib is None:
            lib = CPUAdagradBuilder().load()
            lib.ds_adagrad_create.restype = c_int
            lib.ds_adagrad_create.argtypes = [c_float] * 3
            lib.ds_adagrad_destroy.argtypes = [c_int]
            lib.ds_adagrad_update.argtypes = [
                c_int, c_float] + [c_void_p] * 3 + [c_int64]
            lib.ds_adagrad_update_bf16.argtypes = [
                c_int, c_float] + [c_void_p] * 4 + [c_int64]
            DeepSpeedCPUAdagrad._lib = lib
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay
        self._id = self._lib.ds_adagrad_create(lr, eps, weight_decay)

    def state_keys(self):
        return ("sum_sq",)

    def step(self, step: int, params: torch.Tensor, grads: torch.Tensor,
             sum_sq: torch.Tensor, lr: Optional[float] = None,
             params_out_bf16: Optional[torch.Tensor] = None):
        self._step(self._lib.ds_adagrad_update,
                   self._lib.ds_adagrad_update_bf16, (self._id,), params,
                   grads, (sum_sq,), lr, params_out_bf16)


class DeepSpeedCPULion(_HostOptimizer):
    """Reference ops/lion/cpu_lion.py (create_lion/lion_update)."""

    _destroy_fn = "ds_lion_destroy"

    def __init__(self, lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__()
        if DeepSpeedCPULion._lib is None:
            lib = CPULionBuilder().load()
            lib.ds_lion_create.restype = c_int
            lib.ds_lion_create.argtypes = [c_float] * 4
            lib.ds_lion_destroy.argtypes = [c_int]
            lib.ds_lion_update.argtypes = [
                c_int, c_float] + [c_void_p] * 3 + [c_int64]
            lib.ds_lion_update_bf16.argtypes = [
                c_int, c_float] + [c_void_p] * 4 + [c_int64]
            DeepSpeedCPULion._lib = lib
        self.lr, self.betas, self.weight_decay = lr, betas, weight_decay
        self._id = self._lib.ds_lion_create(lr, betas[0], betas[1],
                                            weight_decay)

    def state_keys(self):
        return ("exp_avg",)

    def step(self, step: int, params: torch.Tensor, grads: torch.Tensor,
             exp_avg: torch.Tensor, lr: Optional[float] = None,
             params_out_bf16: Optional[torch.Tensor] = None):
        self._step(self._lib.ds_lion_update, self._lib.ds_lion_update_bf16,
                   (self._id,), params, grads, (exp_avg,), lr,
                   params_out_bf16)


HOST_OPTIMIZERS = {
    "adam": lambda **kw: DeepSpeedCPUAdam(**{"adamw_mode": False, **kw}),
    "adamw": lambda **kw: DeepSpeedCPUAdam(**{"adamw_mode": True, **kw}),
    "fusedadam": DeepSpeedCPUAdam,
    "adagrad": DeepSpeedCPUAdagrad,
    "lion": DeepSpeedCPULion,
    "fusedlion": DeepSpeedCPULion,
}


def build_host_optimizer(name: str, params):
    key = name.lower().replace("_", "")
    if key not in HOST_OPTIMIZERS:
        raise ValueError(
            f"optimizer '{name}' has no host (offload) implementation; "
            f"available: {sorted(HOST_OPTIMIZERS)}")
    kw = dict(params)
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])
    kw.pop("torch_adam", None)
    # keep adam_w_mode semantics aligned with the device registry
    # (ops/optimizers.py): explicit adam_w_mode wins, else the name decides
    if "adam_w_mode" in kw:
        kw["adamw_mode"] = bool(kw.pop("adam_w_mode"))
    return HOST_OPTIMIZERS[key](**kw)

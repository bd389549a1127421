"""Loss scaling for fp16 training.

Port of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (:18-76). The scale
state is a dict of 0-d tensors on the training device, updated by the same
``where`` selects as the JAX function, so the scale sequence is the same
step for step. The engine reads ``finite`` on the host once per fp16 step
to skip the optimizer update (the JAX step selects on the device).
"""

from dataclasses import dataclass
from typing import Dict, Iterable

import torch


@dataclass(frozen=True)
class LossScaleConfig:
    static_scale: float = 0.0        # >0 => static
    initial_scale_power: int = 16
    scale_window: int = 1000
    hysteresis: int = 2
    min_scale: float = 1.0
    scale_factor: float = 2.0


def init_scale_state(cfg: LossScaleConfig, device="cpu") -> Dict[str, torch.Tensor]:
    scale = cfg.static_scale if cfg.static_scale > 0 else 2.0 ** cfg.initial_scale_power
    return {
        "loss_scale": torch.tensor(scale, dtype=torch.float32, device=device),
        "good_steps": torch.tensor(0, dtype=torch.int32, device=device),
        "hysteresis": torch.tensor(cfg.hysteresis, dtype=torch.int32,
                                   device=device),
    }


def grads_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global inf/nan check: one 0-d bool tensor over every gradient."""
    partials = [torch.isfinite(g).all() for g in grads]
    if not partials:
        return torch.tensor(True)
    return torch.stack(partials).all()


def update_scale(state: Dict[str, torch.Tensor], finite: torch.Tensor,
                 cfg: LossScaleConfig) -> Dict[str, torch.Tensor]:
    """Dynamic scale update (reference loss_scaler.py:137 update_scale)."""
    if cfg.static_scale > 0:
        return state
    scale, good, hyst = state["loss_scale"], state["good_steps"], state["hysteresis"]
    zero = torch.zeros_like(good)
    # overflow: consume hysteresis; once exhausted, halve the scale
    new_hyst = torch.where(finite, hyst, torch.clamp(hyst - 1, min=0))
    drop = torch.logical_and(~finite, new_hyst == 0)
    scale_after_drop = torch.clamp(scale / cfg.scale_factor, min=cfg.min_scale)
    # growth: scale_window consecutive good steps doubles the scale
    new_good = torch.where(finite, good + 1, zero)
    grow = new_good >= cfg.scale_window
    scale_after_grow = torch.where(grow, scale * cfg.scale_factor, scale)
    new_scale = torch.where(drop, scale_after_drop, scale_after_grow)
    new_good = torch.where(grow, zero, new_good)
    new_hyst = torch.where(drop, torch.full_like(hyst, cfg.hysteresis),
                           new_hyst)
    return {"loss_scale": new_scale, "good_steps": new_good,
            "hysteresis": new_hyst}


def from_fp16_config(fp16_cfg) -> LossScaleConfig:
    return LossScaleConfig(
        static_scale=fp16_cfg.loss_scale,
        initial_scale_power=fp16_cfg.initial_scale_power,
        scale_window=fp16_cfg.loss_scale_window,
        hysteresis=fp16_cfg.hysteresis,
        min_scale=fp16_cfg.min_loss_scale,
    )

"""1-bit Adam: error-compensated sign-compressed momentum allreduce.

Port of ``deepspeed_tpu/runtime/fp16/onebit/adam.py`` (the reference's
OnebitAdam, runtime/fp16/onebit/adam.py:14). Two stages:

* warm-up (step < ``freeze_step``): exact Adam on the gradients' mean over
  the data-parallel ranks, both moments updating;
* compression (step >= ``freeze_step``): the variance is frozen; each rank
  updates its momentum with its own gradients, and only the momentum is
  averaged, through the 1-bit compressed allreduce.
"""

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from .common import CompressedStep


@dataclass(frozen=True)
class OnebitAdam:
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    freeze_step: int = 100


def build_onebit_optimizer(params: Dict[str, Any]) -> OnebitAdam:
    kw = dict(params)
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])
    for drop in ("cuda_aware", "comm_backend_name", "torch_adam",
                 "adam_w_mode"):
        kw.pop(drop, None)
    return OnebitAdam(**kw)


class OnebitAdamImpl:
    def __init__(self, opt: OnebitAdam):
        self.opt = opt

    def init_extra(self, ctx):
        return {"exp_avg": ctx.zeros(), "exp_avg_sq": ctx.zeros(),
                "worker_error": torch.zeros(ctx.padded, device=ctx.device),
                "server_error": torch.zeros(ctx.padded // ctx.n,
                                            device=ctx.device)}

    def update(self, ctx, grads, master, state, step, lr):
        opt = self.opt
        b1, b2 = opt.betas
        m, v = state["exp_avg"], state["exp_avg_sq"]
        if step < opt.freeze_step:
            stepf = torch.tensor(step + 1, dtype=torch.float32)
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** stepf)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** stepf)
            gnorm_sq = 0.0
            for i in range(len(grads)):
                g = ctx.pmean(grads[i])
                grads[i] = None
                m[i].copy_(b1 * m[i] + (1 - b1) * g)
                v[i].copy_(b2 * v[i] + (1 - b2) * g * g)
                upd = (m[i] / bc1) / ((v[i] / bc2).sqrt() + opt.eps)
                master[i].copy_(master[i]
                                - lr * (upd + opt.weight_decay * master[i]))
                # the norm of the averaged gradient
                gnorm_sq = gnorm_sq + g.square().sum()
            return gnorm_sq
        # momentum from this rank's gradients, then 1-bit averaged
        new_m = []
        for i in range(len(grads)):
            new_m.append(b1 * m[i] + (1 - b1) * grads[i])
            grads[i] = None
        new_m, state["worker_error"], state["server_error"] = \
            ctx.compressed_mean(new_m, state["worker_error"],
                                state["server_error"])
        gnorm_sq = 0.0
        for i, mn in enumerate(ctx.mask_dead(new_m, v)):
            new_m[i] = None
            upd = mn / (v[i].sqrt() + opt.eps)
            master[i].copy_(master[i]
                            - lr * (upd + opt.weight_decay * master[i]))
            # the averaged gradient's norm recovered from the averaged
            # momentum (no dense allreduce, which would undo the saving)
            gnorm_sq = gnorm_sq + ((mn - b1 * m[i]) / (1 - b1)).square().sum()
            m[i].copy_(mn)
        return gnorm_sq


def build_onebit_train_step(engine):
    """The 1-bit Adam engine step."""
    opt = build_onebit_optimizer(engine.config.optimizer.params)
    return CompressedStep(engine, OnebitAdamImpl(opt))

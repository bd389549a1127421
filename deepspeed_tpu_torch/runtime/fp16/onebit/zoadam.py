"""0/1 Adam: adaptive variance freezing and 1-bit local steps.

Port of ``deepspeed_tpu/runtime/fp16/onebit/zoadam.py`` (the reference's
ZeroOneAdam, runtime/fp16/onebit/zoadam.py:14, arXiv:2202.06009):

* variance policy (step < ``var_freeze_step``): the variance, with an
  exactly averaged gradient, is refreshed only every ``var_interval``
  steps (the interval doubling every ``var_update_scaler`` refreshes);
  on the other steps the gradient is averaged through the 1-bit
  compressed allreduce and only the momentum updates;
* local steps (from ``var_freeze_step``): the variance is frozen and each
  rank steps with its own momentum, its params drifting from the
  others'; every ``local_step_interval`` steps the accumulated updates
  are 1-bit averaged and applied to the synced params, the momentum
  re-estimated from them over the accumulated learning rate. The
  interval doubles every ``local_step_scaler`` steps, up to
  ``local_step_clipper``.

The engine's master holds the last synced value; a rank's drift lives in
its ``momentum_acc`` (minus its accumulated local updates), and
:meth:`ZeroOneAdamImpl.forward_params` rebuilds the drifted params each
rank takes its gradients at. The error buffers are reset at the phase
boundary (what is compressed changes from gradients to accumulated
momentum). The interval counters are host integers, alike on every rank.
"""

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from .common import CompressedStep


@dataclass(frozen=True)
class ZeroOneAdam:
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    var_freeze_step: int = 100000
    var_update_scaler: int = 16
    local_step_scaler: int = 32768
    local_step_clipper: int = 16


def build_zeroone_adam(params: Dict[str, Any]) -> ZeroOneAdam:
    kw = dict(params)
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])
    for drop in ("cuda_aware", "comm_backend_name", "bias_correction",
                 "max_grad_norm", "amsgrad", "eps_inside_sqrt"):
        kw.pop(drop, None)
    return ZeroOneAdam(**kw)


class ZeroOneAdamImpl:
    def __init__(self, opt: ZeroOneAdam):
        self.opt = opt

    def init_extra(self, ctx):
        dev = ctx.device
        return {
            "exp_avg": ctx.zeros(), "exp_avg_sq": ctx.zeros(),
            # minus the accumulated local updates (the reference's
            # momentum_accumulator): the drifted params = master + acc
            "momentum_acc": ctx.zeros(),
            "lrs": torch.zeros((), device=dev),
            "var_interval": 1, "var_counter": 0,
            "local_step_interval": 1, "local_step_counter": 0,
            "worker_error": torch.zeros(ctx.padded, device=dev),
            "server_error": torch.zeros(ctx.padded // ctx.n, device=dev),
        }

    def forward_params(self, ctx, params, master, state):
        """The gradients are taken at this rank's drifted params."""
        return [(mp + a).to(ctx.compute_dtype)
                for mp, a in zip(master, state["momentum_acc"])]

    def update(self, ctx, grads, master, state, step, lr):
        opt = self.opt
        b1, b2 = opt.betas
        st = state
        m, v, acc = st["exp_avg"], st["exp_avg_sq"], st["momentum_acc"]
        state_step = step + 1  # the reference counts steps from 1
        gnorm_sq = 0.0
        if step < opt.var_freeze_step:
            dense_now = state_step % st["var_interval"] == 0
            if dense_now:
                g_all = (ctx.pmean(g) for g in grads)
            else:
                g_all, st["worker_error"], st["server_error"] = \
                    ctx.compressed_mean(grads, st["worker_error"],
                                        st["server_error"])
                g_all = ctx.mask_dead(g_all, v)
            for i, g in enumerate(g_all):
                grads[i] = None
                if dense_now:
                    v[i].copy_(b2 * v[i] + (1 - b2) * g * g)
                m[i].copy_(b1 * m[i] + (1 - b1) * g)
                gnorm_sq = gnorm_sq + g.square().sum()
                upd = (m[i] / (v[i].sqrt() + opt.eps)
                       + opt.weight_decay * master[i])
                master[i].copy_(master[i] - lr * upd)
            # every var_update_scaler dense refreshes the interval doubles
            if dense_now:
                st["var_counter"] += 1
            if st["var_counter"] == opt.var_update_scaler:
                st["var_counter"] = 0
                st["var_interval"] *= 2
            return gnorm_sq
        if step == opt.var_freeze_step:
            # grads -> accumulated momentum: reset the error feedback
            st["worker_error"] = torch.zeros_like(st["worker_error"])
            st["server_error"] = torch.zeros_like(st["server_error"])
        st["lrs"] = st["lrs"] + lr
        for i in range(len(grads)):
            g = grads[i]
            grads[i] = None
            gnorm_sq = gnorm_sq + g.square().sum()
            m[i].copy_(b1 * m[i] + (1 - b1) * g)
            upd = (m[i] / (v[i].sqrt() + opt.eps)
                   + opt.weight_decay * (master[i] + acc[i]))
            acc[i].copy_(acc[i] - lr * upd)
        if state_step % st["local_step_interval"] == 0:
            buf = [a * (v_.sqrt() + opt.eps) for a, v_ in zip(acc, v)]
            buf, st["worker_error"], st["server_error"] = \
                ctx.compressed_mean(buf, st["worker_error"],
                                    st["server_error"])
            lrs = torch.clamp(st["lrs"], min=1e-12)
            for i, b in enumerate(ctx.mask_dead(buf, v)):
                buf[i] = None
                m[i].copy_(-b / lrs)
                master[i].copy_(master[i] + b / (v[i].sqrt() + opt.eps))
                acc[i].zero_()
            st["lrs"] = torch.zeros_like(st["lrs"])
        # the interval doubles every local_step_scaler steps, up to
        # local_step_clipper
        st["local_step_counter"] += 1
        if st["local_step_counter"] == opt.local_step_scaler:
            st["local_step_counter"] = 0
            st["local_step_interval"] = min(
                st["local_step_interval"] * 2, opt.local_step_clipper)
        return ctx.pmean(gnorm_sq)


def build_zeroone_adam_train_step(engine):
    """The 0/1 Adam engine step."""
    opt = build_zeroone_adam(engine.config.optimizer.params)
    return CompressedStep(engine, ZeroOneAdamImpl(opt))

"""1-bit LAMB: compressed-momentum LAMB with frozen layer-wise
coefficients.

Port of ``deepspeed_tpu/runtime/fp16/onebit/lamb.py`` (the reference's
OnebitLamb, runtime/fp16/onebit/lamb.py:15, arXiv:2104.06069):

* warm-up (step < ``freeze_step``): exact LAMB on the averaged gradients;
  each leaf's coefficient clip(||w|| / ||update||, [min_coeff,
  max_coeff]) feeds an EMA (``coeff_beta``), ``lamb_coeff_freeze``;
* at the compression boundary the variance freezes (a fresh copy keeps
  updating from the reconstructed gradients), and each leaf's
  ``scaling_coeff`` (the mean momentum scale over its own) equalizes the
  leaves' momentum magnitudes so one 1-bit scale fits them all;
* compression (step >= ``freeze_step``): the momentum updates locally, is
  scaled, 1-bit averaged and unscaled; the applied coefficient is
  ``lamb_coeff_freeze * factor``, factor = max(frozen denominator / fresh
  denominator) clipped to [``factor_min``, ``factor_max``] and to within
  ``factor_threshold`` of the last step's.
"""

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from .common import CompressedStep


@dataclass(frozen=True)
class OnebitLamb:
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    freeze_step: int = 100
    max_coeff: float = 10.0
    min_coeff: float = 0.01
    coeff_beta: float = 0.9
    factor_max: float = 4.0
    factor_min: float = 0.5
    factor_threshold: float = 0.1


def build_onebit_lamb(params: Dict[str, Any]) -> OnebitLamb:
    kw = dict(params)
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])
    for drop in ("cuda_aware", "comm_backend_name", "bias_correction",
                 "max_grad_norm", "amsgrad", "eps_inside_sqrt"):
        kw.pop(drop, None)
    return OnebitLamb(**kw)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return x.square().sum().sqrt()


class OnebitLambImpl:
    def __init__(self, opt: OnebitLamb):
        self.opt = opt

    def init_extra(self, ctx):
        L, dev = ctx.num_leaves, ctx.device
        return {
            "exp_avg": ctx.zeros(), "exp_avg_sq": ctx.zeros(),
            "exp_avg_sq_fresh": ctx.zeros(),
            # one scalar a leaf (the reference keeps them per parameter)
            "scaling_coeff": torch.ones(L, device=dev),
            "lamb_coeff_freeze": torch.zeros(L, device=dev),
            "last_factor": torch.ones(L, device=dev),
            "worker_error": torch.zeros(ctx.padded, device=dev),
            "server_error": torch.zeros(ctx.padded // ctx.n, device=dev),
        }

    def update(self, ctx, grads, master, state, step, lr):
        opt = self.opt
        b1, b2 = opt.betas
        m, v, v_fresh = (state["exp_avg"], state["exp_avg_sq"],
                         state["exp_avg_sq_fresh"])
        lf = state["last_factor"]
        gnorm_sq = 0.0
        if step < opt.freeze_step:
            coeffs = []
            for i in range(len(grads)):
                g = ctx.pmean(grads[i])
                grads[i] = None
                m[i].copy_(b1 * m[i] + (1 - b1) * g)
                v[i].copy_(b2 * v[i] + (1 - b2) * g * g)
                gnorm_sq = gnorm_sq + g.square().sum()
                p_i = master[i]
                u = m[i] / (v[i].sqrt() + opt.eps) + opt.weight_decay * p_i
                w_norm, u_norm = _norm(p_i), _norm(u)
                raw = torch.clamp(w_norm / torch.clamp(u_norm, min=1e-12),
                                  opt.min_coeff, opt.max_coeff)
                c = torch.where((w_norm > 0) & (u_norm > 0), raw,
                                torch.ones_like(raw))
                coeffs.append(c)
                p_i.copy_(p_i - lr * c * u)
            coeffs = torch.stack(coeffs)
            # the EMA takes only real coefficients (the reference folds
            # no coefficient of 1.0 into the freeze value)
            lcf = state["lamb_coeff_freeze"]
            state["lamb_coeff_freeze"] = torch.where(
                coeffs != 1.0,
                opt.coeff_beta * lcf + (1 - opt.coeff_beta) * coeffs, lcf)
            return gnorm_sq
        if step == opt.freeze_step:
            # entering compression: freeze the variance (the fresh copy
            # keeps updating) and equalize the momenta
            m_scales = torch.stack([
                (m_i.square().sum() / m_i.numel()).sqrt() for m_i in m])
            for vf, v_i in zip(v_fresh, v):
                vf.copy_(v_i)
            state["scaling_coeff"] = m_scales.mean() / torch.clamp(
                m_scales, min=1e-12)
        sc, lcf = state["scaling_coeff"], state["lamb_coeff_freeze"]
        m_scaled = []
        for i in range(len(grads)):
            m_scaled.append((b1 * m[i] + (1 - b1) * grads[i]) * sc[i])
            grads[i] = None
        m_scaled, state["worker_error"], state["server_error"] = \
            ctx.compressed_mean(m_scaled, state["worker_error"],
                                state["server_error"])
        new_lf = []
        for i, mn in enumerate(ctx.mask_dead(
                (ms / sc[j] for j, ms in enumerate(m_scaled)), v)):
            m_scaled[i] = None
            g_rec = (mn - b1 * m[i]) / (1 - b1)
            gnorm_sq = gnorm_sq + g_rec.square().sum()
            v_fresh[i].copy_(b2 * v_fresh[i] + (1 - b2) * g_rec * g_rec)
            p_i = master[i]
            denom = v[i].sqrt() + opt.eps
            denom_real = v_fresh[i].sqrt() + opt.eps
            u_prelim = mn / denom
            u = u_prelim + opt.weight_decay * p_i
            factor = (denom / denom_real).max()
            if opt.weight_decay > 0.0:
                ratio = torch.clamp(
                    _norm(u_prelim) / torch.clamp(_norm(u), min=1e-12),
                    max=1.0)
                factor = factor * ratio + (1.0 - ratio)
            factor = torch.clamp(factor, opt.factor_min, opt.factor_max)
            # rate limit: within factor_threshold of the last step's
            factor = torch.minimum(torch.maximum(
                factor, lf[i] * (1.0 - opt.factor_threshold)),
                lf[i] * (1.0 + opt.factor_threshold))
            new_lf.append(factor)
            p_i.copy_(p_i - lr * (lcf[i] * factor) * u)
            m[i].copy_(mn)
        state["last_factor"] = torch.stack(new_lf)
        return gnorm_sq


def build_onebit_lamb_train_step(engine):
    """The 1-bit LAMB engine step."""
    opt = build_onebit_lamb(engine.config.optimizer.params)
    return CompressedStep(engine, OnebitLambImpl(opt))

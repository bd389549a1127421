"""Optimizers, as the JAX package defines them.

Port of ``deepspeed_tpu/ops/optimizers.py``: FusedAdam (adam / adamw,
``adam_w_mode``, ``bias_correction``; :45-85), FusedLamb, FusedLion,
FusedAdagrad, SGD and ``build_optimizer`` (:234) with its name handling.
The update rules are the JAX ones term for term; ``torch.optim.AdamW`` is
not used (its weight decay multiplies ``p`` before the step and its
epsilon sits elsewhere).

Where the JAX functions return new trees, these update the fp32 master
tensors and the state IN PLACE, one leaf at a time, so the temporaries
never exceed one leaf. ``params``, ``grads`` and every state entry are
lists of tensors in the same leaf order; ``step`` is 1-based.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

Leaves = List[torch.Tensor]


def _zeros_like(params: Leaves) -> Leaves:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


@dataclass(frozen=True)
class TpuOptimizer:
    """Base: holds hyperparameters; subclasses define leaf-wise update math."""

    lr: float = 1e-3
    weight_decay: float = 0.0
    # each element's update reads only that element (LAMB's trust ratio
    # reads its whole leaf): the tiered offload may then cut a leaf
    elementwise = True

    def init_state(self, master_params: Leaves) -> Dict[str, Any]:
        raise NotImplementedError

    def apply(self, master_params: Leaves, grads: Leaves, state, step: int,
              lr=None) -> None:
        """In-place update; lr overrides self.lr (for schedules)."""
        raise NotImplementedError


@dataclass(frozen=True)
class FusedAdam(TpuOptimizer):
    """Adam/AdamW (adam_w_mode matches reference ops/adam/fused_adam.py:195)."""

    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    adam_w_mode: bool = True
    bias_correction: bool = True

    def init_state(self, master_params):
        return {"exp_avg": _zeros_like(master_params),
                "exp_avg_sq": _zeros_like(master_params)}

    @torch.no_grad()
    def apply(self, master_params, grads, state, step, lr=None):
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        if self.bias_correction:
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        else:
            bc1 = bc2 = 1.0
        for p, g, m, v in zip(master_params, grads, state["exp_avg"],
                              state["exp_avg_sq"]):
            g = g.float()
            if self.weight_decay and not self.adam_w_mode:
                g = g + self.weight_decay * p
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            if self.weight_decay and self.adam_w_mode:
                update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-lr)


@dataclass(frozen=True)
class FusedLamb(TpuOptimizer):
    """LAMB with per-layer trust ratio (reference csrc/lamb kernels)."""

    elementwise = False
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-6
    max_coeff: float = 10.0
    min_coeff: float = 0.01

    def init_state(self, master_params):
        return {"exp_avg": _zeros_like(master_params),
                "exp_avg_sq": _zeros_like(master_params)}

    @torch.no_grad()
    def apply(self, master_params, grads, state, step, lr=None,
              norm_reduce=None):
        """``norm_reduce(i, t)``: where leaf ``i`` is cut over ranks (a
        ZeRO shard, a tensor-parallel slice), sums its partial squares
        ``t`` = [|p|^2, |update|^2] over them in place, so the trust ratio
        is the whole leaf's."""
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        for i, (p, g, m, v) in enumerate(zip(master_params, grads,
                                             state["exp_avg"],
                                             state["exp_avg_sq"])):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                update.add_(p, alpha=self.weight_decay)
            if norm_reduce is None:
                w_norm = torch.linalg.vector_norm(p)
                u_norm = torch.linalg.vector_norm(update)
            else:
                sq = torch.stack([torch.sum(p * p), torch.sum(update * update)])
                norm_reduce(i, sq)
                w_norm, u_norm = torch.sqrt(sq[0]), torch.sqrt(sq[1])
            trust = torch.where(
                (w_norm > 0) & (u_norm > 0),
                torch.clamp(w_norm / u_norm, self.min_coeff, self.max_coeff),
                torch.ones_like(w_norm))
            p.sub_(lr * trust * update)


@dataclass(frozen=True)
class FusedLion(TpuOptimizer):
    """Lion (reference csrc/lion/multi_tensor_lion.cu)."""

    lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.99)

    def init_state(self, master_params):
        return {"exp_avg": _zeros_like(master_params)}

    @torch.no_grad()
    def apply(self, master_params, grads, state, step, lr=None):
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        for p, g, m in zip(master_params, grads, state["exp_avg"]):
            g = g.float()
            update = torch.sign(b1 * m + (1.0 - b1) * g)
            if self.weight_decay:
                update.add_(p, alpha=self.weight_decay)
            m.mul_(b2).add_(g, alpha=1.0 - b2)
            p.add_(update, alpha=-lr)


@dataclass(frozen=True)
class FusedAdagrad(TpuOptimizer):
    """Adagrad (reference csrc/adagrad/cpu_adagrad.cpp)."""

    lr: float = 1e-2
    eps: float = 1e-10

    def init_state(self, master_params):
        return {"sum_sq": _zeros_like(master_params)}

    @torch.no_grad()
    def apply(self, master_params, grads, state, step, lr=None):
        lr = self.lr if lr is None else lr
        for p, g, s in zip(master_params, grads, state["sum_sq"]):
            g = g.float()
            if self.weight_decay:
                g = g + self.weight_decay * p
            s.addcmul_(g, g)
            p.sub_(lr * g / (torch.sqrt(s) + self.eps))


@dataclass(frozen=True)
class SGD(TpuOptimizer):
    lr: float = 1e-2
    momentum: float = 0.0
    nesterov: bool = False

    def init_state(self, master_params):
        if self.momentum == 0.0:
            return {}
        return {"momentum_buf": _zeros_like(master_params)}

    @torch.no_grad()
    def apply(self, master_params, grads, state, step, lr=None):
        lr = self.lr if lr is None else lr
        bufs = state.get("momentum_buf", [None] * len(master_params))
        for p, g, buf in zip(master_params, grads, bufs):
            g = g.float()
            if self.weight_decay:
                g = g + self.weight_decay * p
            if buf is None:
                p.sub_(lr * g)
                continue
            buf.mul_(self.momentum).add_(g)
            upd = g + self.momentum * buf if self.nesterov else buf
            p.sub_(lr * upd)


# reference engine._configure_basic_optimizer name dispatch
# (runtime/engine.py:1239); the 1-bit family (OneBitAdam, OneBitLamb,
# ZeroOneAdam) owns its communication, and the engine builds its step
# from runtime/fp16/onebit.ONEBIT_OPTIMIZERS instead
OPTIMIZER_REGISTRY: Dict[str, Callable[..., TpuOptimizer]] = {
    "adam": lambda **kw: FusedAdam(adam_w_mode=False, **kw),
    "adamw": lambda **kw: FusedAdam(adam_w_mode=True, **kw),
    "fusedadam": lambda **kw: FusedAdam(**kw),
    "lamb": FusedLamb,
    "fusedlamb": FusedLamb,
    "lion": FusedLion,
    "fusedlion": FusedLion,
    "adagrad": FusedAdagrad,
    "sgd": SGD,
}


def build_optimizer(name: str, params: Dict[str, Any]) -> TpuOptimizer:
    key = name.lower().replace("_", "")
    if key not in OPTIMIZER_REGISTRY:
        raise ValueError(f"unknown optimizer '{name}'; known: {sorted(OPTIMIZER_REGISTRY)}")
    kw = dict(params)
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])
    kw.pop("torch_adam", None)
    kw.pop("adam_w_mode", None) if key in ("adam", "adamw") else None
    return OPTIMIZER_REGISTRY[key](**kw)

"""MoE layer facade: the reference's class API over the functional core.

Port of ``deepspeed_tpu/moe/layer.py`` (``MoE`` :22), the reference's
``deepspeed.moe.layer.MoE`` (moe/layer.py:16): the same constructor
surface (num_experts / k / capacity_factor / min_capacity /
use_residual / noisy_gate_policy / drop_tokens) around parameter init and
apply. RSample's Gumbel noise on the top-1 router logits is drawn from
an explicit ``torch.Generator`` where JAX takes a PRNG key, so noisy
routing cannot match JAX bit for bit; "Jitter" is accepted and, as in the
JAX package, changes nothing. Without noise the layer is the JAX layer.
"""

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .sharded_moe import MoEGroups, moe_mlp, swiglu_experts


class MoE:
    """Top-k routed expert MLP (SwiGLU experts by default).

    ``expert_fn(expert_params, xe)`` runs the expert stack over
    ``[E, C, H]`` rows batched (the JAX facade's ``expert_fn`` is one
    expert, vmapped). Expert placement comes from the :class:`MoEGroups`
    given at apply time (``ep`` > 1: the params hold this rank's experts)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int = 1, k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4,
                 use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True,
                 expert_fn: Optional[Callable] = None):
        assert k in (1, 2), "top-1 and top-2 gating only (reference parity)"
        if k == 2 and noisy_gate_policy is not None:
            raise NotImplementedError(
                "noisy_gate_policy applies to top-1 gating only (top2gating "
                "has no noise path, matching reference sharded_moe.py:282)")
        if not drop_tokens:
            if k != 1:
                raise NotImplementedError(
                    f"drop_tokens=False supports top-1 routing only (got k={k})")
            if expert_fn is not None:
                raise NotImplementedError(
                    "drop_tokens=False uses the ragged SwiGLU grouped-GEMM "
                    "experts; a custom expert_fn is not supported there")
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.use_residual = use_residual
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self._expert_fn = expert_fn or swiglu_experts

    def init_params(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Seeded parameters (normal, std 0.02; the coefficient bias 0):
        the JAX layout, other bits."""
        h, f, e = self.hidden_size, self.intermediate_size, self.num_experts
        dev = generator.device

        def init(*shape):
            return torch.randn(shape, generator=generator, device=dev,
                               dtype=dtype).mul_(0.02)

        params = {"gate_w": init(h, e), "e_gate": init(e, h, f),
                  "e_up": init(e, h, f), "e_down": init(e, f, h)}
        if self.use_residual:
            params.update({
                "res_gate": init(h, f), "res_up": init(h, f),
                "res_down": init(f, h), "res_coef_w": init(h, 2),
                "res_coef_b": torch.zeros((2,), device=dev, dtype=dtype)})
        return params

    def __call__(self, params, x, groups: Optional[MoEGroups] = None,
                 generator: Optional[torch.Generator] = None,
                 train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, S, H] -> (output [B, S, H], aux_loss scalar). ``generator``
        draws the router noise of a training call."""
        cf = self.capacity_factor if train else self.eval_capacity_factor
        residual = tuple(params[k] for k in (
            "res_gate", "res_up", "res_down", "res_coef_w", "res_coef_b")) \
            if self.use_residual else None
        return moe_mlp(
            x, params["gate_w"],
            (params["e_gate"], params["e_up"], params["e_down"]),
            self._expert_fn, groups, top_k=self.k, capacity_factor=cf,
            min_capacity=self.min_capacity, dropless=not self.drop_tokens,
            residual=residual, generator=generator,
            noisy_gate_policy=self.noisy_gate_policy if train else None)

"""Transformer language model: configuration, parameters and the shared
projection helpers (Llama/Mistral path).

Port of ``deepspeed_tpu/models/transformer.py``. The parameter tree keeps
the JAX package's names and layout — stacked ``[L, ...]`` layer leaves and
``x @ W`` with ``[in, out]`` weights — so weights move between the two
packages by name with no transposes (``checkpoint/interop.py``).

Only what serving the Llama/Mistral family needs is here: the config with
its validation, the presets, the MLP/projection helpers and a seeded
``init_params``. The training forward, the flash path and the MoE/MLM
families of the JAX module wait for later slices.
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None     # GQA; None => MHA
    max_seq_len: int = 4096
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    activation: str = "swiglu"     # swiglu | geglu | geglu_exact | gelu | relu
    positional: str = "rope"               # rope | learned | alibi
    attn_bias: bool = False                # q/k/v/o projection biases
    head_dim_override: Optional[int] = None
    embed_scale: float = 1.0
    parallel_residual: bool = False
    parallel_norms: bool = False
    mlp_bias: bool = True
    rotary_pct: float = 1.0
    lm_head_bias: bool = False
    decode_kernel: bool = True
    scan_unroll: int = 1
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    remat: bool = True
    use_flash: bool = True
    flash_min_seq: int = 2048
    attn_block_q: int = 0
    attn_block_kv: int = 0
    seq_parallel: bool = False
    seq_parallel_impl: str = "ulysses"
    loss_chunk: int = 512
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.0
    moe_min_capacity: int = 4
    moe_aux_loss_coef: float = 0.01
    moe_use_residual: bool = False
    moe_dropless: bool = False
    moe_noisy_gate_policy: Optional[str] = None
    objective: str = "causal_lm"           # causal_lm | mlm
    norm_scheme: str = "pre"               # pre | post
    embed_ln: bool = False
    mlm_head: bool = False

    def __post_init__(self):
        if self.num_kv_heads and self.num_heads % self.num_kv_heads:
            divisors = [d for d in range(1, self.num_heads + 1)
                        if self.num_heads % d == 0]
            raise ValueError(
                f"GQA requires num_heads % num_kv_heads == 0, got "
                f"num_heads={self.num_heads}, "
                f"num_kv_heads={self.num_kv_heads}; pick num_kv_heads "
                f"from {divisors}")
        if self.objective not in ("causal_lm", "mlm"):
            raise ValueError(
                f"objective must be 'causal_lm' or 'mlm', got "
                f"{self.objective!r}")
        if self.norm_scheme not in ("pre", "post"):
            raise ValueError(
                f"norm_scheme must be 'pre' or 'post', got "
                f"{self.norm_scheme!r}")
        if self.norm_scheme == "post" and self.moe_num_experts > 0:
            raise NotImplementedError("post-LN + MoE is not supported")
        if self.moe_noisy_gate_policy is not None:
            raise NotImplementedError(
                "moe_noisy_gate_policy is not wired into the in-tree "
                f"transformer; got {self.moe_noisy_gate_policy!r}")

    @property
    def is_causal(self) -> bool:
        return self.objective == "causal_lm"

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_heads

    @property
    def is_gated_mlp(self) -> bool:
        return self.activation in ("swiglu", "geglu", "geglu_exact")


def rotary_dims(cfg: TransformerConfig) -> int:
    """How many leading head dims rotate (rotary_pct < 1: NeoX/Phi).
    Always even."""
    rot = int(cfg.head_dim * cfg.rotary_pct)
    return rot - (rot % 2)


def gate_act(cfg: TransformerConfig):
    """Gated-MLP gate nonlinearity: silu for swiglu, tanh gelu for geglu,
    erf gelu for geglu_exact."""
    if cfg.activation == "swiglu":
        return F.silu
    if cfg.activation == "geglu_exact":
        return lambda x: F.gelu(x, approximate="none")
    return lambda x: F.gelu(x, approximate="tanh")


def ffn_act(cfg: TransformerConfig):
    """Non-gated FFN activation ("gelu" is the tanh approximation,
    "gelu_exact" the erf form)."""
    if cfg.activation == "relu":
        return F.relu
    if cfg.activation == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if cfg.activation == "gelu_exact":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(f"unknown FFN activation {cfg.activation!r}")


def dense_mlp(cfg: TransformerConfig, lp, x):
    """Non-gated dense MLP with optional biases."""
    u = x @ lp["w_up"]
    if cfg.mlp_bias:
        u = u + lp["b_up"]
    out = ffn_act(cfg)(u) @ lp["w_down"]
    if cfg.mlp_bias:
        out = out + lp["b_down"]
    return out


def qkv_proj(lp, hn):
    """q/k/v projections with optional biases. hn: [..., H]; returns flat
    [..., nh*hd] / [..., nkv*hd] projections."""
    q = hn @ lp["wq"]
    k = hn @ lp["wk"]
    v = hn @ lp["wv"]
    if "b_q" in lp:
        q = q + lp["b_q"]
        k = k + lp["b_k"]
        v = v + lp["b_v"]
    return q, k, v


def out_proj(lp, o):
    """Attention output projection with optional bias."""
    x = o @ lp["wo"]
    if "b_o" in lp:
        x = x + lp["b_o"]
    return x


class TransformerLM:
    """Decoder-only LM: holds the config and builds the parameter tree."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    def init_params(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Seeded parameters, drawn on ``generator``'s device directly in
        ``dtype`` (a 7B model never exists in f32 on the host). Same
        distribution as the JAX package (normal, std 0.02; output
        projections 0.02 / sqrt(2L); norms 1, biases 0), other bits."""
        cfg = self.cfg
        if cfg.moe_num_experts > 0 or cfg.embed_ln or cfg.mlm_head:
            raise NotImplementedError(
                "init_params covers the dense causal families; MoE and "
                "the MLM encoder family are not ported yet")
        h, ffn, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.kv_heads
        L = cfg.num_layers
        dev = generator.device
        std = 0.02
        out_std = std / math.sqrt(2 * L)

        def init(shape, scale=std):
            return torch.randn(shape, generator=generator, device=dev,
                               dtype=dtype).mul_(scale)

        def ones(*shape):
            return torch.ones(shape, device=dev, dtype=dtype)

        def zeros(*shape):
            return torch.zeros(shape, device=dev, dtype=dtype)

        layer = {
            "attn_norm": ones(L, h),
            "wq": init((L, h, nh * hd)),
            "wk": init((L, h, nkv * hd)),
            "wv": init((L, h, nkv * hd)),
            "wo": init((L, nh * hd, h), out_std),
            "mlp_norm": ones(L, h),
        }
        if cfg.is_gated_mlp:
            layer["w_gate"] = init((L, h, ffn))
            layer["w_up"] = init((L, h, ffn))
            layer["w_down"] = init((L, ffn, h), out_std)
        else:
            layer["w_up"] = init((L, h, ffn))
            layer["w_down"] = init((L, ffn, h), out_std)
            if cfg.mlp_bias:
                layer["b_up"] = zeros(L, ffn)
                layer["b_down"] = zeros(L, h)
        if cfg.norm == "layernorm":
            layer["attn_norm_b"] = zeros(L, h)
            if not cfg.parallel_residual or cfg.parallel_norms:
                layer["mlp_norm_b"] = zeros(L, h)
        if cfg.parallel_residual and not cfg.parallel_norms:
            del layer["mlp_norm"]
        if cfg.attn_bias:
            layer["b_q"] = zeros(L, nh * hd)
            layer["b_k"] = zeros(L, nkv * hd)
            layer["b_v"] = zeros(L, nkv * hd)
            layer["b_o"] = zeros(L, h)

        params = {"embed": init((v, h)), "layers": layer}
        if cfg.norm_scheme == "pre":
            params["final_norm"] = ones(h)
            if cfg.norm == "layernorm":
                params["final_norm_b"] = zeros(h)
        if cfg.positional == "learned":
            params["pos_embed"] = init((cfg.max_seq_len, h))
        if not cfg.tie_embeddings:
            params["lm_head"] = init((h, v))
        if cfg.lm_head_bias:
            params["lm_head_b"] = zeros(v)
        return params


# -- canonical configs (model zoo) ------------------------------------------

def llama2_7b() -> TransformerConfig:
    return TransformerConfig(vocab_size=32000, hidden_size=4096,
                             intermediate_size=11008, num_layers=32,
                             num_heads=32, max_seq_len=4096)


def mistral_7b() -> TransformerConfig:
    return TransformerConfig(vocab_size=32000, hidden_size=4096,
                             intermediate_size=14336, num_layers=32,
                             num_heads=32, num_kv_heads=8, max_seq_len=8192)


def tiny_test(vocab=256, hidden=128, layers=2, heads=4,
              seq=128) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab, hidden_size=hidden,
                             intermediate_size=hidden * 4, num_layers=layers,
                             num_heads=heads, max_seq_len=seq)

"""Transformer language model: configuration, parameters and the shared
projection helpers (Llama/Mistral path).

Port of ``deepspeed_tpu/models/transformer.py``. The parameter tree keeps
the JAX package's names and layout — stacked ``[L, ...]`` layer leaves and
``x @ W`` with ``[in, out]`` weights — so weights move between the two
packages by name with no transposes (``checkpoint/interop.py``).

Here: the config with its validation, the presets, the MLP/projection
helpers, a seeded ``init_params``, and the training forward of the causal
dense families (``forward_hidden``, ``forward_logits``, ``apply`` with the
chunked cross-entropy), whose attention routes through
``sequence/layer.py`` to the flash kernels, and the dense KV-cache
forward of the v1 engine (``init_kv_cache``, ``forward_cached``), whose
one-token decode runs the dense decode kernel. The ragged engine keeps
its own layer loop (``inference/v2/paged_model.py``). Not ported yet, each
raising ``NotImplementedError``: MoE and sequence parallelism (ROADMAP
A8), PPO batches (A11), alibi, post-LN and the MLM family (A12), and in
the cached forward learned positions, alibi and parallel residual (A6d).
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.norms import layer_norm, rms_norm


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


def _rope_tables(cfg: TransformerConfig, seq_len: int, offset=0,
                 device=None):
    """f32 (cos, sin) [seq_len, rotary_dims / 2] at positions
    offset .. offset + seq_len - 1."""
    half = rotary_dims(cfg) // 2
    freqs = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, half, dtype=torch.float32, device=device) / half))
    t = offset + torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin):
    """x: [B, H, S, D]; rotate-half convention, in x's dtype (cos/sin cast
    to it by the caller). Dims past 2 * cos.shape[-1] pass through."""
    rot = 2 * cos.shape[-1]
    tail = x[..., rot:]
    half = rot // 2
    x1, x2 = x[..., :half], x[..., half:rot]
    c = cos[None, None]
    s = sin[None, None]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    if tail.shape[-1]:
        out = torch.cat([out, tail], dim=-1)
    return out.to(x.dtype)


def _chunked_ce_loss(x, targets, mask, head, chunk: int, bias=None):
    """Cross-entropy without materializing [B, S, V] logits: one
    ``torch.utils.checkpoint`` per sequence chunk, so each chunk's logits
    are rebuilt in the backward and peak memory is O(chunk * V).
    Returns (sum of masked nll, sum of mask)."""
    B, S, H = x.shape
    chunk = min(chunk, S) if chunk and chunk > 0 else S
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))

    def chunk_nll(x_c, t_c, m_c, head, bias):
        logits = (x_c @ head.to(x_c.dtype)).float()
        if bias is not None:
            logits = logits + bias.float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, t_c[..., None].long())[..., 0]
        return torch.sum((lse - tgt) * m_c)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in range(0, x.shape[1], chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            chunk_nll, x[:, a:a + chunk], targets[:, a:a + chunk],
            mask[:, a:a + chunk], head, bias, use_reentrant=False,
            preserve_rng_state=False)
    return total, torch.sum(mask)


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
    """Decoder-only LM: holds the config, builds the parameter tree and
    runs the training forward (the engine's model protocol:
    ``init_params`` + ``apply``)."""

    # the stacked [L, ...] subtree the layer loop walks (JAX :387)
    param_offload_keys = ("layers",)

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg
        # ZeRO-3: maps a layer's views of its sharded leaves to the whole
        # tensors; set by the training engine and run inside the layer's
        # activation checkpoint, so the recompute gathers again
        self.layer_gather = None

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

    # -- training forward ------------------------------------------------
    def _check_trainable(self):
        cfg = self.cfg
        if cfg.moe_num_experts > 0 or cfg.seq_parallel:
            raise NotImplementedError(
                "MoE and sequence-parallel layers are not ported to "
                "deepspeed_tpu_torch yet (ROADMAP A8)")
        if (cfg.positional == "alibi" or cfg.norm_scheme == "post"
                or cfg.objective == "mlm" or cfg.embed_ln or cfg.mlm_head):
            raise NotImplementedError(
                "alibi attention, post-LN and the MLM (BERT) family are not "
                "ported to deepspeed_tpu_torch yet (ROADMAP A12)")

    def _norm(self, x, w, b=None):
        if self.cfg.norm == "rmsnorm":
            return rms_norm(x, w, self.cfg.norm_eps)
        return layer_norm(x, w, b, self.cfg.norm_eps)

    def _attention(self, q, k, v):
        from ..sequence.layer import sharded_attention

        cfg = self.cfg
        # the flash kernels once the S^2 score tensor dominates
        use_flash = cfg.use_flash and q.shape[2] >= cfg.flash_min_seq
        return sharded_attention(q, k, v, None, causal=cfg.is_causal,
                                 use_flash=use_flash,
                                 block_q=cfg.attn_block_q,
                                 block_kv=cfg.attn_block_kv,
                                 impl=cfg.seq_parallel_impl)

    def _layer(self, x, lp, cos, sin):
        cfg = self.cfg
        B, S, H = x.shape
        nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        hn = self._norm(x, lp["attn_norm"], lp.get("attn_norm_b"))
        q, k, v = qkv_proj(lp, hn)
        q = q.reshape(B, S, nh, hd).transpose(1, 2)
        k = k.reshape(B, S, nkv, hd).transpose(1, 2)
        v = v.reshape(B, S, nkv, hd).transpose(1, 2)
        if cfg.positional == "rope":
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        o = self._attention(q, k, v)
        o = o.transpose(1, 2).reshape(B, S, nh * hd)
        if cfg.parallel_residual:
            hn2 = (self._norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"))
                   if cfg.parallel_norms else hn)
            return x + out_proj(lp, o) + dense_mlp(cfg, lp, hn2)
        x = x + out_proj(lp, o)
        hn = self._norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"))
        if cfg.is_gated_mlp:
            g = gate_act(cfg)(hn @ lp["w_gate"])
            return x + (g * (hn @ lp["w_up"])) @ lp["w_down"]
        return x + dense_mlp(cfg, lp, hn)

    def forward_hidden(self, params, input_ids):
        """Final-normed hidden states [B, S, H]. The layer loop walks views
        of the stacked ``[L, ...]`` leaves; under ``cfg.remat`` each layer
        runs inside the configured activation checkpoint."""
        cfg = self.cfg
        self._check_trainable()
        x = F.embedding(input_ids, params["embed"])
        if cfg.embed_scale != 1.0:
            x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
        S = input_ids.shape[1]
        if cfg.positional == "learned":
            x = x + params["pos_embed"][:S][None]
        if cfg.positional == "rope":
            cos, sin = _rope_tables(cfg, S, device=x.device)
            cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        else:
            cos = sin = torch.zeros((S, 1), dtype=x.dtype, device=x.device)
        body = self._layer
        if self.layer_gather is not None:
            gather, layer = self.layer_gather, self._layer

            def body(x, lp, cos, sin):
                return layer(x, gather(lp), cos, sin)
        if cfg.remat:
            from ..runtime.activation_checkpointing import \
                checkpointing as ds_ckpt
            body = ds_ckpt.checkpoint_wrapper(body)
        from ..inference.quantization import dequantize_params

        # weight-only-quantized leaves are sliced per layer and dequantized
        # here, one layer at a time (identity on dense params)
        layers = {k: (torch.unbind(v) if isinstance(v, torch.Tensor) else v)
                  for k, v in params["layers"].items()}
        for l in range(cfg.num_layers):
            x = body(x, dequantize_params({k: v[l]
                                           for k, v in layers.items()}),
                     cos, sin)
        return self._norm(x, params["final_norm"], params.get("final_norm_b"))

    def _head_inputs(self, params, x):
        """(hidden, head matrix, logit bias) of the causal LM head."""
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return x, head, params.get("lm_head_b")

    def forward_logits(self, params, input_ids):
        x = self.forward_hidden(params, input_ids)
        x, head, bias = self._head_inputs(params, x)
        logits = x @ head.to(x.dtype)
        if bias is not None:
            logits = logits + bias.to(logits.dtype)
        return logits

    def apply(self, params, batch, train: bool = True, rng=None):
        """Next-token loss on {input_ids [B, S], optional loss_mask [B, S]}:
        the masked mean of the chunked cross-entropy, f32."""
        if "ppo_old_logprobs" in batch:
            raise NotImplementedError(
                "PPO learner batches are not ported to deepspeed_tpu_torch "
                "yet (ROADMAP A11)")
        ids = batch["input_ids"]
        x = self.forward_hidden(params, ids)
        # the logit bias of the head is not in the JAX training loss either
        _, head, _ = self._head_inputs(params, x)
        mask = batch.get("loss_mask")
        mask = (mask[:, 1:].float() if mask is not None
                else torch.ones(ids[:, 1:].shape, dtype=torch.float32,
                                device=ids.device))
        total, count = _chunked_ce_loss(x[:, :-1], ids[:, 1:], mask, head,
                                        self.cfg.loss_chunk)
        return total / torch.clamp(count, min=1.0)


    # -- KV-cache inference (the v1 engine's prefill + decode) ------------
    # Port of the JAX package's dense-cache path (transformer.py:1112-1251):
    # a [L, B, kvh, M, hd] cache, updated in place here (the JAX forward
    # returns a new one).
    def _check_cached(self):
        cfg = self.cfg
        if not (cfg.is_causal and cfg.norm_scheme == "pre"):
            raise ValueError("KV-cache generation requires a causal pre-LN "
                             "model (the MLM/post-LN encoder family does "
                             "not decode)")
        if cfg.moe_num_experts > 0:
            raise NotImplementedError(
                "MoE KV-cache generation is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP A8)")
        if cfg.positional != "rope" or cfg.parallel_residual:
            raise NotImplementedError(
                f"KV-cache generation of positional={cfg.positional!r}, "
                f"parallel_residual={cfg.parallel_residual} is not ported "
                f"to deepspeed_tpu_torch yet (rope, sequential residual "
                f"only; ROADMAP A6d)")

    def init_kv_cache(self, batch_size: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device=None) -> Dict[str, torch.Tensor]:
        """Zeroed dense cache ``{"k", "v"}`` of [L, B, kvh, max_len, hd]."""
        cfg = self.cfg
        self._check_cached()
        shape = (cfg.num_layers, batch_size, cfg.kv_heads, max_len,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _layer_cached(self, x, lp, ck, cv, cos, sin, start_pos: int):
        """One layer over [B, S, H] tokens at positions start_pos ..
        start_pos + S - 1, writing their K/V into ``ck``/``cv`` [B, kvh, M,
        hd] in place and attending over the cache. A one-token step takes
        the dense decode kernel (``cfg.decode_kernel``); prefill, and
        decode without the kernel, the masked softmax over all M slots
        with dots in the cache dtype accumulated in f32, as in JAX."""
        from ..ops.decode_attention import dense_decode_attention

        cfg = self.cfg
        B, S, H = x.shape
        nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        hn = self._norm(x, lp["attn_norm"], lp.get("attn_norm_b"))
        q, k, v = qkv_proj(lp, hn)
        # f32 tables: the products promote to f32 and cast back, as in JAX
        q = apply_rotary(q.reshape(B, S, nh, hd).transpose(1, 2), cos, sin)
        k = apply_rotary(k.reshape(B, S, nkv, hd).transpose(1, 2), cos, sin)
        v = v.reshape(B, S, nkv, hd).transpose(1, 2)
        ck[:, :, start_pos:start_pos + S] = k.to(ck.dtype)
        cv[:, :, start_pos:start_pos + S] = v.to(cv.dtype)
        if cfg.decode_kernel and S == 1 and hd % 8 == 0:
            lengths = torch.full((B,), start_pos + 1, dtype=torch.int32,
                                 device=x.device)
            o = dense_decode_attention(q[:, :, 0].to(ck.dtype).contiguous(),
                                       ck, cv, lengths)
            o = o[:, :, None].to(x.dtype)                   # [B, nh, 1, hd]
        else:
            rep = nh // nkv
            kk = ck.repeat_interleave(rep, dim=1).float()    # [B, nh, M, hd]
            vv = cv.repeat_interleave(rep, dim=1)
            # JAX's `/ sqrt(hd)` compiles to a multiply by the f32 reciprocal
            inv = float(1.0 / torch.tensor(math.sqrt(hd)))
            s = torch.matmul(q.to(ck.dtype).float(),
                             kk.transpose(-1, -2)) * inv
            q_pos = start_pos + torch.arange(S, device=x.device)[:, None]
            k_pos = torch.arange(ck.shape[2], device=x.device)[None, :]
            s = torch.where(k_pos <= q_pos, s, torch.full_like(s, -1e30))
            p = torch.softmax(s, dim=-1)
            o = torch.matmul(p.to(vv.dtype).float(), vv.float()).to(x.dtype)
        o = o.transpose(1, 2).reshape(B, S, nh * hd)
        x = x + out_proj(lp, o)
        hn = self._norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"))
        if cfg.is_gated_mlp:
            g = gate_act(cfg)(hn @ lp["w_gate"])
            return x + (g * (hn @ lp["w_up"])) @ lp["w_down"]
        return x + dense_mlp(cfg, lp, hn)

    def forward_cached(self, params, input_ids, cache, start_pos: int):
        """Forward over [B, S] tokens at positions start_pos .. start_pos
        + S - 1, attending to and updating ``cache`` in place. Returns
        [B, S, V] f32 logits. Used for prefill (start_pos 0, the prompt)
        and decode (S = 1)."""
        cfg = self.cfg
        self._check_cached()
        S = input_ids.shape[1]
        x = params["embed"][input_ids.long()].to(cache["k"].dtype)
        if cfg.embed_scale != 1.0:
            x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
        from ..inference.quantization import dequantize_params

        cos, sin = _rope_tables(cfg, S, start_pos, device=x.device)
        layers = params["layers"]
        for l in range(cfg.num_layers):
            lp = dequantize_params({k: v[l] for k, v in layers.items()})
            x = self._layer_cached(x, lp, cache["k"][l], cache["v"][l], cos,
                                   sin, start_pos)
        x = self._norm(x, params["final_norm"], params.get("final_norm_b"))
        x, head, bias = self._head_inputs(params, x)
        logits = (x @ head.to(x.dtype)).float()
        if bias is not None:
            logits = logits + bias.float()
        return logits


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

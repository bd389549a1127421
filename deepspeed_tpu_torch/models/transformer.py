"""Transformer language model: configuration, parameters and the shared
projection helpers (Llama/Mistral path).

Port of ``deepspeed_tpu/models/transformer.py``. The parameter tree keeps
the JAX package's names and layout — stacked ``[L, ...]`` layer leaves and
``x @ W`` with ``[in, out]`` weights — so weights move between the two
packages by name with no transposes (``checkpoint/interop.py``).

Here: the config with its validation, the presets, the MLP/projection
helpers, a seeded ``init_params``, and the training forward of the causal
dense and MoE families (``forward_hidden``, ``forward_logits``, ``apply``
with the chunked cross-entropy and the MoE aux loss), whose attention
routes through ``sequence/layer.py`` to the flash kernels, and the dense
KV-cache forward of the v1 engine (``init_kv_cache``, ``forward_cached``),
whose one-token decode runs the dense decode kernel. An MoE layer
(``moe_num_experts`` > 0) replaces the MLP with capacity, dropless or
residual routing (``moe/sharded_moe.py``); the engine sets
``moe_groups`` for its collectives across ranks. The ragged engine keeps
its own layer loop (``inference/v2/paged_model.py``).

Tensor parallelism (``set_topology`` with a model axis > 1): the leaves
are this rank's slices of the JAX ``param_partition_specs`` (JAX :487;
:func:`tp_shard_dims`), and the forward runs Megatron-style on them:
``tp_copy`` before each column-split group (q / k / v, gate / up), a
``tp_reduce`` after each row-split product (wo, down) with the row's bias
added after it, a vocab-parallel embedding (a masked lookup, then the
all-reduce) and a vocab-parallel chunked cross-entropy (the row max and
the sum of exponentials all-reduced over the model group, the target
logit from the rank that owns it). Sequence parallelism (a seq axis >
1): each rank embeds its chunk of the sequence, its RoPE positions offset
by the chunk's start, attention is Ulysses or ring
(``sequence/layer.py``), and the loss sums the chunks' parts over the seq
group; an MoE layer gates each rank's chunk globally over the data x seq
ranks (its aux loss's gradient reaching each rank as 1 / sp of it, the
backward starting from sp times the loss). At one rank on both axes
every hook is the identity. A batch carrying ``ppo_old_logprobs`` takes
the clipped-PPO objective with the k3 KL term (``_ppo_total``, the RLHF
learner's loss), its per-token logprobs from the same chunked head. Not
ported yet, each raising ``NotImplementedError``: alibi, post-LN and the
MLM family (A12), uneven tensor-parallel splits (A8), and in the cached
forward learned positions, alibi and parallel residual (A6d).
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..comm import comm
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


def _identity(x):
    return x


def dense_mlp(cfg: TransformerConfig, lp, x, row=_identity):
    """Non-gated dense MLP with optional biases. ``row`` reduces the
    down product's partial sums (tensor parallelism) before its bias."""
    u = x @ lp["w_up"]
    if cfg.mlp_bias:
        u = u + lp["b_up"]
    out = row(ffn_act(cfg)(u) @ lp["w_down"])
    if cfg.mlp_bias:
        out = out + lp["b_down"]
    return out


def gated_mlp(cfg: TransformerConfig, wg, wu, wd, x, row=_identity):
    """Gated MLP (SwiGLU / GeGLU); ``row`` as in :func:`dense_mlp`."""
    return row((gate_act(cfg)(x @ wg) * (x @ wu)) @ wd)


def embed_lookup(table, ids, tp_rank: int = 0, row=None):
    """The embedding rows of ``ids``. Under tensor parallelism (``row``:
    the all-reduce over the model group) ``table`` is this rank's vocab
    rows: a masked lookup, zeros elsewhere, summed by ``row``."""
    if row is None:
        return F.embedding(ids, table)
    vl = table.shape[0]
    local = ids.long() - tp_rank * vl
    mine = (local >= 0) & (local < vl)
    x = F.embedding(torch.where(mine, local, torch.zeros_like(local)), table)
    return row(torch.where(mine[..., None], x, torch.zeros_like(x)))


def gather_vocab(logits, tp: int, group):
    """[..., V / tp] -> [..., V]: every rank's vocab columns (no
    gradient flows through the gather)."""
    if tp == 1:
        return logits
    import torch.distributed as dist
    parts = [torch.empty_like(logits) for _ in range(tp)]
    dist.all_gather(parts, logits.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


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


def _chunked_token_logprobs(x, targets, head, chunk: int, start: int = 0,
                            group=None):
    """Per-token ``log softmax(x @ head)[target]`` [B, S] without
    materializing [B, S, V] logits (JAX :347): the sequence chunks of
    :func:`_chunked_ce_loss`, each rebuilt in the backward, returning the
    per-position values (the PPO ratio and KL terms need each token's).
    Under tensor parallelism ``head`` holds this rank's vocab columns
    ``[start, start + V / tp)`` and the softmax spans the model group
    (:func:`vocab_parallel_nll`)."""
    B, S, H = x.shape
    chunk = min(chunk, S) if chunk and chunk > 0 else S

    def chunk_lp(x_c, t_c, head):
        logits = (x_c @ head.to(x_c.dtype)).float()
        if group is not None:
            return -vocab_parallel_nll(logits, t_c, start, group)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, t_c[..., None].long())[..., 0]
        return tgt - lse

    return torch.cat([
        torch.utils.checkpoint.checkpoint(
            chunk_lp, x[:, a:a + chunk], targets[:, a:a + chunk], head,
            use_reentrant=False, preserve_rng_state=False)
        for a in range(0, S, chunk)], dim=1)


def lora_target_leaves(cfg: "TransformerConfig"):
    """Flat leaf paths multi-tenant serving LoRA may target (the q and v
    projections) mapped to their layer-stacked (fan_in, fan_out) dims
    (JAX :298): the validation surface of
    ``InferenceEngineV2.load_adapter`` and of adapter payloads, in the
    flat key space the hybrid engine's external adapters fuse into
    (``runtime/hybrid_engine.fuse_flat_leaves``)."""
    h, hd = cfg.hidden_size, cfg.head_dim
    return {"layers/wq": (h, cfg.num_heads * hd),
            "layers/wv": (h, cfg.kv_heads * hd)}


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[target]`` of vocab-split f32
    logits [..., V / tp] (this rank's columns ``[start, start + V / tp)``):
    the row max (MAX) and the sum of exponentials (SUM) all-reduced over
    the model group, the target logit from its owning rank (SUM of the
    others' zeros). Backward: ``softmax - onehot`` on this rank's
    columns."""

    @staticmethod
    def forward(ctx, logits, targets, start, group):
        multi = comm.get_world_size(group) > 1
        m = logits.amax(dim=-1)
        if multi:
            m = m.contiguous()
            comm.all_reduce(m, op=comm.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        se = e.sum(dim=-1)
        if multi:
            comm.all_reduce(se, group=group)
        lse = m + torch.log(se)
        local = targets.long() - start
        mine = (local >= 0) & (local < logits.shape[-1])
        idx = torch.where(mine, local, torch.zeros_like(local))
        tgt = torch.gather(logits, -1, idx[..., None])[..., 0]
        tgt = torch.where(mine, tgt, torch.zeros_like(tgt))
        if multi:
            comm.all_reduce(tgt, group=group)
        ctx.save_for_backward(e, se, idx, mine)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        e, se, idx, mine = ctx.saved_tensors
        grad = e / se[..., None] * g[..., None]
        hit = torch.where(mine, g, torch.zeros_like(g))
        grad.scatter_add_(-1, idx[..., None], -hit[..., None])
        return grad, None, None, None


def vocab_parallel_nll(logits, targets, start: int = 0, group=None):
    """Per-token NLL of vocab-split f32 logits over the model group (see
    :class:`_VocabParallelNLL`); at one rank it is the whole-vocab NLL."""
    return _VocabParallelNLL.apply(logits, targets, start, group)


def _vocab_parallel_ce_loss(x, targets, mask, head, chunk: int, start: int,
                            group):
    """The chunked cross-entropy of :func:`_chunked_ce_loss` over this
    rank's vocab columns (``head`` [H, V / tp]): every rank enters every
    chunk's collectives. Returns (sum of masked nll, sum of mask)."""
    B, S, H = x.shape
    chunk = min(chunk, S) if chunk and chunk > 0 else S
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))

    def chunk_nll(x_c, t_c, m_c, head):
        logits = (x_c @ head.to(x_c.dtype)).float()
        return torch.sum(vocab_parallel_nll(logits, t_c, start, group) * m_c)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in range(0, x.shape[1], chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            chunk_nll, x[:, a:a + chunk], targets[:, a:a + chunk],
            mask[:, a:a + chunk], head, use_reentrant=False,
            preserve_rng_state=False)
    return total, torch.sum(mask)


def tp_shard_dims(cfg: "TransformerConfig") -> Dict[str, Optional[int]]:
    """The tensor-parallel plan: for each leaf path of the parameter
    tree, the dimension cut over the model axis (None: replicated) — the
    "model" entries of JAX ``param_partition_specs`` (:487-556) for one
    pipeline stage. Column-split: wq / wk / wv / w_gate / w_up, the res_*
    columns, the q / k / v biases and b_up; row-split: wo / w_down /
    res_down; the experts' e_gate / e_up on f and e_down on its f rows;
    embed, lm_head and lm_head_b on the vocab."""
    col, row = 2, 1
    layer = {"attn_norm": None, "mlp_norm": None, "wq": col, "wk": col,
             "wv": col, "wo": row}
    if cfg.moe_num_experts > 0:
        layer.update({"moe_gate_w": None, "e_gate": 3, "e_up": 3,
                      "e_down": 2})
        if cfg.moe_use_residual:
            layer.update({"res_gate": col, "res_up": col, "res_down": row,
                          "res_coef_w": None, "res_coef_b": None})
    else:
        layer.update({"w_up": col, "w_down": row})
        if cfg.is_gated_mlp:
            layer["w_gate"] = col
        elif cfg.mlp_bias:
            layer.update({"b_up": 1, "b_down": None})
    if cfg.norm == "layernorm":
        layer["attn_norm_b"] = None
        if not cfg.parallel_residual or cfg.parallel_norms:
            layer["mlp_norm_b"] = None
    if cfg.parallel_residual and not cfg.parallel_norms:
        layer.pop("mlp_norm")
    if cfg.attn_bias:
        layer.update({"b_q": 1, "b_k": 1, "b_v": 1, "b_o": None})
    out = {f"layers/{k}": v for k, v in layer.items()}
    out["embed"] = 0
    if cfg.norm_scheme == "pre":
        out["final_norm"] = None
        if cfg.norm == "layernorm":
            out["final_norm_b"] = None
    if cfg.positional == "learned":
        out["pos_embed"] = None
    if cfg.embed_ln:
        out["embed_ln_w"] = out["embed_ln_b"] = None
    if cfg.lm_head_bias:
        out["lm_head_b"] = 0
    if cfg.mlm_head:
        for k in ("mlm_transform_w", "mlm_transform_b", "mlm_ln_w",
                  "mlm_ln_b", "mlm_bias"):
            out[k] = None
    if not cfg.tie_embeddings:
        out["lm_head"] = 1
    return out


def check_tp(cfg: "TransformerConfig", tp: int) -> None:
    """The head and width counts a model axis of ``tp`` must divide. The
    JAX engine raises ``ValueError`` on such a split too (its attention's
    ``shard_map`` and its state's output shardings need every sharded
    dimension to divide by the model axis), so no JAX run holds a padded
    layout yet."""
    if tp <= 1:
        return
    bad = [(n, v) for n, v in (("num_heads", cfg.num_heads),
                               ("num_kv_heads", cfg.kv_heads),
                               ("vocab_size", cfg.vocab_size),
                               ("intermediate_size", cfg.intermediate_size))
           if v % tp]
    if bad:
        raise NotImplementedError(
            f"tensor parallelism at tp={tp} needs each of "
            f"{', '.join(f'{n}={v}' for n, v in bad)} divisible by it; "
            f"uneven head or width splits (e.g. num_kv_heads % tp != 0) "
            f"are not ported to deepspeed_tpu_torch yet (ROADMAP A8)")


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


def out_proj(lp, o, row=_identity):
    """Attention output projection with optional bias; ``row`` as in
    :func:`dense_mlp`."""
    x = row(o @ lp["wo"])
    if "b_o" in lp:
        x = x + lp["b_o"]
    return x


class TransformerLM:
    """Decoder-only LM: holds the config, builds the parameter tree and
    runs the training forward (the engine's model protocol:
    ``init_params`` + ``apply``)."""

    # the stacked [L, ...] subtree the layer loop walks (JAX :387)
    param_offload_keys = ("layers",)
    # pp x ep composes: inside the 1F1B schedule the MoE layers dispatch
    # through moe_layer_manual (JAX :380)
    supports_pp_ep = True

    @property
    def supports_param_offload(self) -> bool:
        # without remat every streamed layer would stay on the device as a
        # saved tensor for the backward, which voids what the offload is
        # for: the engine refuses (JAX :389)
        return bool(self.cfg.remat)

    @property
    def expert_leaves(self) -> Dict[str, int]:
        """The expert leaves and their expert dimension (JAX
        ``param_partition_specs``: the leaves on the expert axis)."""
        if self.cfg.moe_num_experts <= 0:
            return {}
        return {"layers/e_gate": 1, "layers/e_up": 1, "layers/e_down": 1}

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg
        # ZeRO-3: maps a layer's views of its sharded leaves to the whole
        # tensors; set by the training engine and run inside the layer's
        # activation checkpoint, so the recompute gathers again
        self.layer_gather = None
        # offload_param {device: cpu}: the engine sets the flag and the
        # stream (``runtime/offload.HostLayerStream``) that brings one
        # layer of the host-resident stack to the device
        self.stream_params_from_host = False
        self.host_stream = None
        # the MoE layers' collectives (``moe.sharded_moe.MoEGroups``): the
        # data-parallel group of the global gating and the expert group;
        # set by the training engine, None at one rank
        self.moe_groups = None
        # the process topology (``parallel/topology.MeshTopology``) whose
        # model and seq axes the forward runs on; None: one rank
        self.topology = None
        self._tp = (1, 0, None)
        self._sp = (1, 0, None)
        self._pp = (1, 0, None)
        # set while the 1F1B schedule or the pipelined forward runs (JAX
        # ``_inside_manual_pipe``): MoE layers then dispatch through
        # ``moe_layer_manual`` at ep > 1
        self._inside_manual_pipe = False

    def set_topology(self, topo):
        """Run on ``topo``'s model, seq and pipe groups (JAX :400); the
        leaves the model is given are then this rank's tensor-parallel
        slices, and under a pipe axis > 1 its stage's ``[L / pp, ...]``
        slice of the layer stack (JAX ``param_partition_specs`` :487-530
        puts ``pipe`` on dim 0 of every layer leaf)."""
        self.topology = topo
        tp = topo.axis_size("model") if topo is not None else 1
        sp = topo.axis_size("seq") if topo is not None else 1
        pp = topo.axis_size("pipe") if topo is not None else 1
        check_tp(self.cfg, tp)
        if pp > 1 and self.cfg.num_layers % pp:
            raise ValueError(f"num_layers={self.cfg.num_layers} is not "
                             f"divisible by the pipeline stages {pp}")
        self._tp = ((tp, topo.tp_rank, topo.group("model")) if tp > 1
                    else (1, 0, None))
        self._sp = ((sp, topo.sp_rank, topo.group("seq")) if sp > 1
                    else (1, 0, None))
        self._pp = ((pp, topo.pp_rank, topo.group("pipe")) if pp > 1
                    else (1, 0, None))

    @property
    def tp_shard_dims(self) -> Dict[str, Optional[int]]:
        """The leaves' tensor-parallel dimensions (:func:`tp_shard_dims`)."""
        return tp_shard_dims(self.cfg)

    @property
    def pipe_shard_dims(self) -> Dict[str, int]:
        """The leaves cut over the pipe axis: every layer leaf on its layer
        dimension (JAX ``param_partition_specs``)."""
        return {k: 0 for k in tp_shard_dims(self.cfg)
                if k.startswith("layers/")}

    # -- tensor-parallel hooks (identities at tp 1) ------------------------
    def _col(self, x):
        """Entering a column-split group: all-reduce of the backward."""
        tp, _, g = self._tp
        return comm.tp_copy(x, group=g) if tp > 1 else x

    def _row(self, x):
        """After a row-split product: all-reduce of the partial sums."""
        tp, _, g = self._tp
        return comm.tp_reduce(x, group=g) if tp > 1 else x

    def _embed(self, table, ids):
        tp, r, _ = self._tp
        return embed_lookup(table, ids, r, self._row if tp > 1 else None)

    def _gather_vocab(self, logits):
        return gather_vocab(logits, self._tp[0], self._tp[2])

    def init_params(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Seeded parameters, drawn on ``generator``'s device directly in
        ``dtype`` (a 7B model never exists in f32 on the host). Same
        distribution as the JAX package (normal, std 0.02; output
        projections 0.02 / sqrt(2L); norms 1, biases 0), other bits."""
        cfg = self.cfg
        if cfg.embed_ln or cfg.mlm_head:
            raise NotImplementedError(
                "init_params covers the causal families; the MLM encoder "
                "family is not ported yet")
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
        if cfg.moe_num_experts > 0:
            E = cfg.moe_num_experts
            layer["moe_gate_w"] = init((L, h, E))
            layer["e_gate"] = init((L, E, h, ffn))
            layer["e_up"] = init((L, E, h, ffn))
            layer["e_down"] = init((L, E, ffn, h), out_std)
            if cfg.moe_use_residual:
                layer["res_gate"] = init((L, h, ffn))
                layer["res_up"] = init((L, h, ffn))
                layer["res_down"] = init((L, ffn, h), out_std)
                layer["res_coef_w"] = init((L, h, 2))
                layer["res_coef_b"] = zeros(L, 2)
        elif cfg.is_gated_mlp:
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
        if cfg.moe_dropless and cfg.moe_top_k != 1:
            raise NotImplementedError(
                "moe_dropless supports top-1 routing only "
                f"(got moe_top_k={cfg.moe_top_k})")
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
        return sharded_attention(q, k, v, self.topology,
                                 causal=cfg.is_causal,
                                 use_flash=use_flash,
                                 block_q=cfg.attn_block_q,
                                 block_kv=cfg.attn_block_kv,
                                 impl=cfg.seq_parallel_impl)

    def _moe(self, lp, hn):
        """The MoE MLP of one layer (JAX :640-697): (output, aux). The
        gating and routing run replicated; under tensor parallelism each
        expert and the residual branch is a column-then-row pair on this
        rank's f columns (``_col`` / ``_row`` are identities at tp 1)."""
        from ..moe.sharded_moe import (moe_mlp, ragged_swiglu_experts,
                                       swiglu_experts)

        cfg = self.cfg

        def experts_fn(p, xe):
            return self._row(swiglu_experts(p, self._col(xe)))

        def ragged_fn(p, xs, sizes):
            return self._row(ragged_swiglu_experts(p, self._col(xs), sizes))

        residual = tuple(lp[k] for k in ("res_gate", "res_up", "res_down",
                                         "res_coef_w", "res_coef_b")) \
            if cfg.moe_use_residual else None
        manual = (self._inside_manual_pipe and self.moe_groups is not None
                  and self.moe_groups.ep > 1)
        if manual and cfg.moe_dropless:
            raise NotImplementedError(
                "dropless MoE is not supported inside the manual pipeline "
                "program with ep>1 (use capacity routing for pp x ep)")
        return moe_mlp(hn, lp["moe_gate_w"],
                       (lp["e_gate"], lp["e_up"], lp["e_down"]), experts_fn,
                       self.moe_groups, top_k=cfg.moe_top_k,
                       capacity_factor=cfg.moe_capacity_factor,
                       min_capacity=cfg.moe_min_capacity,
                       dropless=cfg.moe_dropless, residual=residual,
                       ragged_expert_fn=ragged_fn, dense_fn=experts_fn,
                       manual=manual)

    def _layer(self, x, lp, cos, sin):
        """One layer: (output, the MoE aux loss or None)."""
        cfg = self.cfg
        B, S, H = x.shape
        hd = cfg.head_dim
        hn = self._norm(x, lp["attn_norm"], lp.get("attn_norm_b"))
        q, k, v = qkv_proj(lp, self._col(hn))
        # this rank's heads (all of them at tp 1)
        q = q.reshape(B, S, -1, hd).transpose(1, 2)
        k = k.reshape(B, S, -1, hd).transpose(1, 2)
        v = v.reshape(B, S, -1, hd).transpose(1, 2)
        if cfg.positional == "rope":
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        o = self._attention(q, k, v)
        o = o.transpose(1, 2).reshape(B, S, -1)
        if cfg.parallel_residual:
            hn2 = (self._norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"))
                   if cfg.parallel_norms else hn)
            return x + out_proj(lp, o, self._row) + \
                dense_mlp(cfg, lp, self._col(hn2), self._row), None
        x = x + out_proj(lp, o, self._row)
        hn = self._norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"))
        if cfg.moe_num_experts > 0:
            out, aux = self._moe(lp, hn)
            return x + out, aux
        if cfg.is_gated_mlp:
            return x + gated_mlp(cfg, lp["w_gate"], lp["w_up"], lp["w_down"],
                                 self._col(hn), self._row), None
        return x + dense_mlp(cfg, lp, self._col(hn), self._row), None

    def forward_hidden(self, params, input_ids):
        """Final-normed hidden states [B, S, H]."""
        return self.forward_hidden_aux(params, input_ids)[0]

    def forward_hidden_aux(self, params, input_ids):
        """(final-normed hidden states [B, S, H], the layers' mean MoE aux
        loss or None for a dense model). The layer loop walks views of the
        stacked ``[L, ...]`` leaves; under ``cfg.remat`` each layer runs
        inside the configured activation checkpoint."""
        cfg = self.cfg
        self._check_trainable()
        S = input_ids.shape[1]
        # under sequence parallelism input_ids is this rank's chunk
        start = self._sp[1] * S
        x = self._embed_tokens(params, input_ids, start)
        cos, sin = self._rope(S, x.dtype, x.device, start)
        layer, gather = self._layer, self.layer_gather
        stream = self.host_stream if self.stream_params_from_host else None

        def body(x, lp, cos, sin, l):
            if stream is not None:
                # offload_param (JAX :729-738): this layer's leaves come
                # from host memory here, inside the checkpoint, so the
                # recompute fetches them again and no device copy is saved
                lp = stream.fetch(l)
            if gather is not None:
                lp = gather(lp)
            return layer(x, lp, cos, sin)
        if cfg.remat:
            from ..runtime.activation_checkpointing import \
                checkpointing as ds_ckpt
            body = ds_ckpt.checkpoint_wrapper(body)
        from ..inference.quantization import dequantize_params

        # weight-only-quantized leaves are sliced per layer and dequantized
        # here, one layer at a time (identity on dense params)
        layers = {k: (torch.unbind(v) if isinstance(v, torch.Tensor) else v)
                  for k, v in params["layers"].items()}
        if stream is not None:
            stream.forward_sweep(True)
        auxs = []
        for l in range(cfg.num_layers):
            x, aux = body(x, dequantize_params({k: v[l]
                                                for k, v in layers.items()}),
                          cos, sin, l)
            if aux is not None:
                auxs.append(aux)
        if stream is not None:
            stream.forward_sweep(False)     # later fetches: the recompute
        x = self._norm(x, params["final_norm"], params.get("final_norm_b"))
        return x, (torch.mean(torch.stack(auxs)) if auxs else None)

    # -- pipeline parallelism (JAX :793-996) ------------------------------
    def _stage_layers(self, x, layers, cos, sin):
        """This stage's layers (the ``[L / pp, ...]`` leaves) on ``x``:
        (output, the sum of their MoE aux losses or None)."""
        body = self._layer
        if self.cfg.remat:
            from ..runtime.activation_checkpointing import \
                checkpointing as ds_ckpt
            body = ds_ckpt.checkpoint_wrapper(body)
        views = {k: torch.unbind(v) for k, v in layers.items()}
        aux = None
        for l in range(len(next(iter(views.values())))):
            x, a = body(x, {k: v[l] for k, v in views.items()}, cos, sin)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def _embed_tokens(self, params, ids, start: int = 0):
        """The embedding of ``ids`` (positions ``start`` on), scaled, with
        the learned positions added."""
        x = self._embed(params["embed"], ids)
        if self.cfg.embed_scale != 1.0:
            x = x * torch.tensor(self.cfg.embed_scale, dtype=x.dtype)
        if self.cfg.positional == "learned":
            S = ids.shape[-1]
            x = x + params["pos_embed"][start:start + S].to(x.dtype)
        return x

    def _rope(self, S, dtype, device, start: int = 0):
        """(cos, sin) at positions ``start`` .. ``start + S - 1`` in
        ``dtype`` (zeros [S, 1] without RoPE)."""
        if self.cfg.positional == "rope":
            cos, sin = _rope_tables(self.cfg, S, start, device=device)
            return cos.to(dtype), sin.to(dtype)
        z = torch.zeros((S, 1), dtype=dtype, device=device)
        return z, z

    def _stage_aux(self, aux):
        """A stage's pre-scaled share of the layer-mean aux loss."""
        return (self.cfg.moe_aux_loss_coef * aux / self.cfg.num_layers
                ).float()

    def stage_function(self, stage: int, S: int, dtype, device):
        """The 1F1B schedule's stage function ``(params, ids_mb, h) ->
        h_out`` of pipeline stage ``stage`` at sequence length ``S``:
        stage 0 embeds ``ids_mb``, the others read ``h``; then this rank's
        ``L / pp`` layers (remat as configured). An MoE model returns
        ``(h_out, this stage's pre-scaled share of the aux loss)``."""
        cos, sin = self._rope(S, dtype, device)
        moe = self.cfg.moe_num_experts > 0

        def stage_fn(p, ids_mb, h):
            x = self._embed_tokens(p, ids_mb) if stage == 0 else h
            out, aux = self._stage_layers(x, p["layers"], cos, sin)
            return (out, self._stage_aux(aux)) if moe else out

        return stage_fn

    def loss_and_grads(self, params, batch, rng=None, grad_acc=None):
        """(loss, grads) through the 1F1B schedule (``runtime/pipe/
        pipeline.pipeline_1f1b``), the training path at pp > 1 (JAX
        :883-996). ``batch``: this rank's ``{input_ids [M, b, S],
        optional loss_mask}``. Stage 0 embeds, each stage runs its
        ``L / pp`` layers (remat as configured), the last stage takes the
        final norm, the head and the chunked cross-entropy of each
        micro-batch; an MoE stage differentiates its share of the aux loss
        in its own backward slot. The layer leaves' gradients stay on
        their stage; every other leaf's is summed over the pipe group.
        The data-parallel mean is the engine's (JAX ``dp_reduce``).
        ``grad_acc``: the caller's f32 buffers the gradients accumulate
        in (``pipeline_1f1b``)."""
        from ..runtime.pipe.pipeline import pipeline_1f1b

        cfg = self.cfg
        self._check_trainable()
        pp, stage, group = self._pp
        ids = batch["input_ids"]
        M, B, S = ids.shape
        mask = batch.get("loss_mask")
        moe = cfg.moe_num_experts > 0
        dtype = params["embed"].dtype
        stage_fn = self.stage_function(stage, S, dtype, ids.device)

        def loss_fn(p, ys, ids_mb, *m_mb):
            # per-micro-batch masked mean, averaged over micro-batches by
            # the schedule (the engine's GAS mean-of-means)
            ys = self._norm(ys, p["final_norm"], p.get("final_norm_b"))
            _, head, _ = self._head_inputs(p, ys)
            m = (m_mb[0][:, 1:].float() if m_mb else
                 torch.ones(ids_mb[:, 1:].shape, dtype=torch.float32,
                            device=ids_mb.device))
            total, count = _chunked_ce_loss(ys[:, :-1], ids_mb[:, 1:], m,
                                            head, cfg.loss_chunk)
            return total / torch.clamp(count, min=1.0)

        # the layer stack is cut over the pipe axis; every other leaf is
        # replicated over it (the mask's default)
        reduce_mask = {"layers": {n: False for n in params["layers"]}}
        self._inside_manual_pipe = True
        try:
            return pipeline_1f1b(
                stage_fn, loss_fn, params, ids, pp,
                h_spec=((B, S, cfg.hidden_size), dtype),
                loss_args=(ids,) + ((mask,) if mask is not None else ()),
                pipe_reduce_mask=reduce_mask, stage_aux=moe, group=group,
                grad_acc=grad_acc)
        finally:
            self._inside_manual_pipe = False

    def _apply_pipelined(self, params, batch, train: bool = True, rng=None):
        """The pipelined loss (JAX :793-880): ``{input_ids [M, b, S]}``
        through ``pipeline_scan``, then the last stage's masked mean over
        all M micro-batches, broadcast to every stage (plus the stages'
        aux). Eval, and the fp16 path, which differentiates it through
        the schedule's permutes. Under autograd the gradients are whole:
        a stage holds its slice of the layer stack, and each replicated
        leaf (embedding, norm, head) passes through one ``tp_copy`` over
        the pipe group, whose backward sums the stages' contributions
        (JAX: the transpose of the shard_map's replicated inputs)."""
        from ..runtime.pipe.pipeline import (broadcast_from_last,
                                             pipeline_scan)

        cfg = self.cfg
        self._check_trainable()
        pp, stage, group = self._pp
        if torch.is_grad_enabled():
            rep = sorted(k for k in params if k != "layers")
            params = dict(params, **dict(zip(rep, comm.tp_copy(
                [params[k] for k in rep], axis_name="pipe", group=group))))
        ids = batch["input_ids"]
        M, B, S = ids.shape
        moe = cfg.moe_num_experts > 0
        dtype = params["embed"].dtype
        cos, sin = self._rope(S, dtype, ids.device)
        if stage == 0:
            x = self._embed_tokens(params, ids)
        else:       # stage 0 alone reads the micro-batches
            x = torch.zeros((1, B, S, cfg.hidden_size), dtype=dtype,
                            device=ids.device).expand(M, -1, -1, -1)

        def stage_fn(h):
            out, aux = self._stage_layers(h, params["layers"], cos, sin)
            return (out, self._stage_aux(aux)) if moe else out

        self._inside_manual_pipe = True
        try:
            r = pipeline_scan(stage_fn, x, pp, remat=False, stage_aux=moe,
                              group=group, anchor=params["final_norm"])
        finally:
            self._inside_manual_pipe = False
        ys, aux_sum = r if moe else (r, None)
        if stage == pp - 1:
            ys = self._norm(ys, params["final_norm"],
                            params.get("final_norm_b"))
            _, head, bias = self._head_inputs(params, ys)
            mask = batch.get("loss_mask")
            m = (mask[..., 1:].float() if mask is not None else
                 torch.ones(ids[..., 1:].shape, dtype=torch.float32,
                            device=ids.device))
            total = count = 0.0
            for i in range(M):
                t_i, c_i = _chunked_ce_loss(ys[i, :, :-1], ids[i, :, 1:],
                                            m[i], head, cfg.loss_chunk,
                                            bias=bias)
                total, count = total + t_i, count + c_i
            loss_local = total / torch.clamp(count, min=1.0)
        else:       # no loss here; the graph still reaches the outputs
            loss_local = ys.float().sum() * 0
        loss = broadcast_from_last(loss_local, pp, group)
        if aux_sum is not None:
            # every stage contributed aux for its own layers
            loss = loss + comm.tp_reduce(aux_sum, axis_name="pipe",
                                         group=group) / M
        return loss

    def _head_inputs(self, params, x):
        """(hidden, head matrix, logit bias) of the causal LM head."""
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return x, head, params.get("lm_head_b")

    def forward_logits(self, params, input_ids):
        """[B, S, V] logits; under tensor parallelism the vocab columns are
        all-gathered (no gradient flows through the gather)."""
        x = self.forward_hidden(params, input_ids)
        x, head, bias = self._head_inputs(params, x)
        logits = self._col(x) @ head.to(x.dtype)
        if bias is not None:
            logits = logits + bias.to(logits.dtype)
        return self._gather_vocab(logits)

    def apply(self, params, batch, train: bool = True, rng=None):
        """Next-token loss on {input_ids [B, S], optional loss_mask [B, S]}:
        the masked mean of the chunked cross-entropy, f32. A batch carrying
        ``ppo_old_logprobs`` takes the clipped-PPO objective instead (the
        RLHF learner's loss, :meth:`_ppo_total`; JAX :1048)."""
        ppo = "ppo_old_logprobs" in batch
        if ppo:
            assert self.cfg.is_causal, \
                "PPO batches require objective='causal_lm' (the rollout " \
                "policy is a decoder)"
            assert self._pp[0] == 1, \
                "PPO learner batches are not supported under pipeline " \
                "parallelism yet (the shifted per-token logprob gather " \
                "needs the last stage's full sequence)"
        if self._pp[0] > 1:
            # input_ids [M, b, S] through the pipeline (JAX :1011-1016)
            return self._apply_pipelined(params, batch, train=train, rng=rng)
        ids = batch["input_ids"]
        mask = batch.get("loss_mask")
        mask = (mask[:, 1:].float() if mask is not None
                else torch.ones(ids[:, 1:].shape, dtype=torch.float32,
                                device=ids.device))
        # the PPO per-token inputs, shifted like the mask (the token at t
        # is predicted at t - 1)
        per_tok = ([batch[k][:, 1:].float()
                    for k in ("ppo_old_logprobs", "ppo_advantages")]
                   if ppo else [])
        sp, r, sg = self._sp
        if sp > 1:
            # this rank's chunk of the sequence: its tokens, and the next
            # token of each as the target (the last position has none)
            S = ids.shape[1]
            if S % sp:
                raise ValueError(f"sequence length {S} is not divisible by "
                                 f"sequence_parallel_size {sp}")
            n = S // sp
            tgt = F.pad(ids[:, 1:], (0, 1))[:, r * n:(r + 1) * n]
            mask, *per_tok = [F.pad(t, (0, 1))[:, r * n:(r + 1) * n]
                              for t in [mask] + per_tok]
            ids = ids[:, r * n:(r + 1) * n]
            x, aux = self.forward_hidden_aux(params, ids)
        else:
            tgt = ids[:, 1:]
            x, aux = self.forward_hidden_aux(params, ids)
            x = x[:, :-1]
        # the logit bias of the head is not in the JAX training loss either
        _, head, _ = self._head_inputs(params, x)
        tp, tr, tg = self._tp
        if ppo:
            new_lp = _chunked_token_logprobs(
                self._col(x), tgt, head, self.cfg.loss_chunk,
                tr * head.shape[-1], tg if tp > 1 else None)
            total, count = self._ppo_total(new_lp, mask, *per_tok,
                                           batch["ppo_hparams"])
        elif tp > 1:
            total, count = _vocab_parallel_ce_loss(
                self._col(x), tgt, mask, head, self.cfg.loss_chunk,
                tr * head.shape[-1], tg)
        else:
            total, count = _chunked_ce_loss(x, tgt, mask, head,
                                            self.cfg.loss_chunk)
        if sp > 1:
            # the mean over the whole sequence: this rank's sum over the
            # global count; the sum over the seq group (forward) is the
            # loss, and each rank's backward starts from its own part
            count = count.detach().clone()
            comm.all_reduce(count, group=sg)
            loss = comm.tp_reduce(total / torch.clamp(count, min=1.0),
                                  group=sg)
        else:
            loss = total / torch.clamp(count, min=1.0)
        if aux is not None:
            if sp > 1:
                # the aux loss is global over the data x seq ranks, and
                # each rank's backward (from sp times its loss) reaches it
                # through its own tokens: 1 / sp of it each
                aux = aux.detach() + (aux - aux.detach()) / sp
            loss = loss + self.cfg.moe_aux_loss_coef * aux
        return loss

    @staticmethod
    def _ppo_total(new_lp, mask, old_lp, adv, hparams):
        """(masked sum, mask count) of the clipped-PPO objective with the
        k3 KL term (JAX ``_apply_ppo`` :1048-1106). Per masked token:
        ratio = exp(new - old), pg = -min(ratio * adv, clip(ratio, 1 +- eps)
        * adv), kl = exp(old - new) - 1 - (old - new), the loss term
        pg + kl_coef * kl; ``old_lp`` (the rollout's logprobs) is both the
        importance-ratio denominator and the KL reference. ``hparams``
        [B, 2] holds ``[clip_eps, kl_coef]`` on every row."""
        hp = hparams.float()
        clip_eps = torch.mean(hp[:, 0])
        kl_coef = torch.mean(hp[:, 1])
        ratio = torch.exp(new_lp - old_lp)
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv)
        log_ref_over_new = old_lp - new_lp
        kl = torch.exp(log_ref_over_new) - 1.0 - log_ref_over_new
        per_token = -surrogate + kl_coef * kl
        return torch.sum(per_token * mask), torch.sum(mask)

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
        # under tensor parallelism: this rank's kv heads
        shape = (cfg.num_layers, batch_size, cfg.kv_heads // self._tp[0],
                 max_len, cfg.head_dim)
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
        # this rank's heads (all of them at tp 1)
        tp = self._tp[0]
        nh, nkv, hd = cfg.num_heads // tp, cfg.kv_heads // tp, cfg.head_dim
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
        x = x + out_proj(lp, o, self._row)
        hn = self._norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"))
        if cfg.moe_num_experts > 0:
            return x + self._row(self._moe_cached(lp, hn))
        if cfg.is_gated_mlp:
            return x + gated_mlp(cfg, lp["w_gate"], lp["w_up"], lp["w_down"],
                                 hn, self._row)
        return x + dense_mlp(cfg, lp, hn, self._row)

    def _moe_cached(self, lp, hn):
        """Inference MoE of the cached forward (JAX :1192-1206): top-k
        gating without capacity, the chosen weights renormalized (at k = 1
        too, as there). JAX gathers each token's expert matrices; this
        computes the same function grouped by expert."""
        from ..moe.sharded_moe import serve_moe

        B, S, H = hn.shape
        out = serve_moe(hn.reshape(B * S, H), lp["moe_gate_w"],
                        (lp["e_gate"], lp["e_up"], lp["e_down"]),
                        self.cfg.moe_top_k, renormalize_top1=True,
                        logits_in_f32=False)
        return out.reshape(B, S, H).to(hn.dtype)

    def forward_cached(self, params, input_ids, cache, start_pos: int):
        """Forward over [B, S] tokens at positions start_pos .. start_pos
        + S - 1, attending to and updating ``cache`` in place. Returns
        [B, S, V] f32 logits. Used for prefill (start_pos 0, the prompt)
        and decode (S = 1)."""
        cfg = self.cfg
        self._check_cached()
        S = input_ids.shape[1]
        x = self._embed(params["embed"], input_ids.long()).to(
            cache["k"].dtype)
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
        return self._gather_vocab(logits)


# -- canonical configs (model zoo) ------------------------------------------

def llama2_7b() -> TransformerConfig:
    return TransformerConfig(vocab_size=32000, hidden_size=4096,
                             intermediate_size=11008, num_layers=32,
                             num_heads=32, max_seq_len=4096)


def mistral_7b() -> TransformerConfig:
    return TransformerConfig(vocab_size=32000, hidden_size=4096,
                             intermediate_size=14336, num_layers=32,
                             num_heads=32, num_kv_heads=8, max_seq_len=8192)


def mixtral_8x7b() -> TransformerConfig:
    """Mixtral-8x7B (JAX :1313): 8 experts, top-2 routing, Mistral
    attention geometry, 32k context with rope_theta 1e6."""
    return TransformerConfig(vocab_size=32000, hidden_size=4096,
                             intermediate_size=14336, num_layers=32,
                             num_heads=32, num_kv_heads=8, max_seq_len=32768,
                             rope_theta=1e6,
                             moe_num_experts=8, moe_top_k=2)


def tiny_test(vocab=256, hidden=128, layers=2, heads=4,
              seq=128) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab, hidden_size=hidden,
                             intermediate_size=hidden * 4, num_layers=layers,
                             num_heads=heads, max_seq_len=seq)

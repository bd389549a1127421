"""Paged (blocked-KV) transformer forward for the ragged engine.

Port of ``deepspeed_tpu/inference/v2/paged_model.py``, the bf16/fp32
path:

* ``paged_ragged_step`` — one mixed batch (prefill chunks, continuations
  and decode rows as one flat token buffer); attention through the ragged
  kernel, once per layer.
* ``paged_prefill`` / ``paged_continue`` — the stitched dispatch of
  ``ragged_attention="off"``: one prompt, its causal self-attention
  through the flash forward kernel (bucket ``C % 128 == 0``); one
  multi-token continuation over the sequence's whole table (``_kv_read``).
* ``paged_decode`` — one token for each of N sequences; attention through
  the paged decode kernel, once per layer.
* ``paged_decode_window`` — K decode steps (greedy or sampled) on the
  device with one host transfer for the whole window.

The KV pool is ``[L, num_blocks, block_size, kv_heads, head_dim]`` per K
and V; block 0 is the null block that padding writes land in. Under
``kv_quant`` the pool is int8 with per-(block, kv head) f32 scales
``ks``/``vs`` ``[L, num_blocks, kv_heads]`` (about half the bytes of a
bf16 pool), and the kernels dequantize in-kernel. The JAX functions are
pure and return a new pool (XLA donates the old buffer); here the pool is
updated in place and every entry point mutates the ``cache`` dict it is
given.

An MoE model (``moe_num_experts`` > 0) routes each token to its top-k
experts (``_moe_mlp``, JAX :216): softmax in f32, renormalized over the
chosen set for k >= 2. Its tokens, sorted by expert, go through a grouped
GEMM whose group offsets stay on the device
(``moe.sharded_moe.serve_topk_experts``), so a decode window keeps its
one host sync. Under expert parallelism (a :class:`ShardedServeConfig`
with ``ep_size`` > 1, JAX :238-255) a rank holds ``E / ep`` experts of
each layer and the tokens go through the worst-case-capacity dispatch of
``moe.sharded_moe.moe_layer_dropless_ep`` (C = k T, so no token is
dropped) and its all-to-alls over the expert group; every rank runs the
same tokens and gets every token's output back.

The layer loop is a Python loop over views of the stacked ``[L, ...]``
leaves: ``params["layers"][k][l]`` copies nothing. Under weight-only
quantization (``quant_bits``) the leaves are ``QuantizedTensor``s: every
entry point dequantizes the embedding and the head at entry (a decode
window once), and the loop dequantizes one layer's weights at the top of
its iteration (``inference/quantization.py``), so no dense copy of the
stack is ever held.

Tensor parallelism: under a :class:`ShardedServeConfig` (a rank's view of
the model: its heads, its model group) the leaves are the rank's slices
(``models/transformer.tp_shard_dims``), the pool holds its ``kv_heads /
tp`` heads and the attention kernels run on them; the embedding is a
masked lookup all-reduced over the model group, the wo and down products
are all-reduced before their biases, and the logits are all-gathered, so
every rank samples the same token.
"""

from dataclasses import dataclass, field, fields
from typing import Any, Dict

import torch

from ...models.transformer import (TransformerConfig, dense_mlp,
                                   embed_lookup, gated_mlp, gather_vocab,
                                   out_proj, qkv_proj, rotary_dims)
from ...ops.norms import layer_norm, rms_norm
from ..quantization import dequantize_nonlayer, dequantize_params
from .kernels.paged_attention import (NEG_INF, paged_attention,
                                      paged_attention_plain)
from .kernels.ragged_attention import (ragged_attention,
                                       ragged_attention_plain)
from .sampling import (fold_in_rows, greedy_tokens, key_uniforms,
                       sample_tokens_uniform)


@dataclass(frozen=True)
class ShardedServeConfig(TransformerConfig):
    """A tensor- or expert-parallel rank's view of the model:
    ``num_heads`` and ``num_kv_heads`` are its own heads (the head size
    kept), the model group is ``tp_group``; the expert group of ``ep_size``
    ranks is ``ep_group``, this rank holding experts ``[ep_rank * E / ep,
    (ep_rank + 1) * E / ep)``."""

    tp_size: int = 1
    tp_rank: int = 0
    tp_group: Any = field(default=None, compare=False, hash=False,
                          repr=False)
    ep_size: int = 1
    ep_rank: int = 0
    ep_group: Any = field(default=None, compare=False, hash=False,
                          repr=False)


def shard_serve_config(cfg: TransformerConfig, tp: int, rank: int,
                       group, ep: int = 1, ep_rank: int = 0,
                       ep_group=None) -> ShardedServeConfig:
    """The :class:`ShardedServeConfig` of rank ``rank`` of ``tp`` (and
    ``ep_rank`` of ``ep``)."""
    from ...models.transformer import check_tp

    check_tp(cfg, tp)
    kw = {f.name: getattr(cfg, f.name) for f in fields(TransformerConfig)}
    kw.update(num_heads=cfg.num_heads // tp,
              num_kv_heads=cfg.kv_heads // tp,
              head_dim_override=cfg.head_dim)
    return ShardedServeConfig(**kw, tp_size=tp, tp_rank=rank, tp_group=group,
                              ep_size=ep, ep_rank=ep_rank, ep_group=ep_group)


def _tp(cfg):
    return getattr(cfg, "tp_size", 1), getattr(cfg, "tp_rank", 0), \
        getattr(cfg, "tp_group", None)


def _row(cfg):
    """The reduction of a row-split product's partial sums: the
    all-reduce over the model group (identity at tp 1)."""
    tp, _, g = _tp(cfg)
    if tp == 1:
        return lambda x: x

    def reduce(x):
        from ...comm import comm
        x = x.contiguous()
        comm.all_reduce(x, group=g)
        return x

    return reduce


def check_servable(cfg: TransformerConfig) -> None:
    """The model families this port serves: causal pre-LN dense and MoE
    models with rotary positions."""
    if not (cfg.is_causal and cfg.norm_scheme == "pre"):
        raise ValueError("paged serving requires a causal pre-LN model (the "
                         "MLM/post-LN encoder family does not decode)")
    if cfg.positional != "rope":
        raise NotImplementedError(
            f"positional={cfg.positional!r} serving is not ported yet "
            f"(rope only; ROADMAP A6d)")
    if cfg.parallel_residual:
        raise NotImplementedError(
            "the parallel-residual family is not ported yet (ROADMAP A6d)")


# 1 / 127 rounded to f32: the int8 pool's per-token scale is absmax / 127
_INV_QMAX = float(torch.tensor(1.0) / 127.0)


def init_paged_kv_cache(cfg: TransformerConfig, num_blocks: int,
                        block_size: int, dtype: torch.dtype, device,
                        kv_quant: bool = False) -> Dict[str, torch.Tensor]:
    """The zeroed pool. ``kv_quant``: int8 ``k``/``v`` and f32 ``ks``/``vs``
    scales ``[L, num_blocks, kv_heads]``; a scale of 0 means nothing was
    written to that (block, head) yet."""
    shape = (cfg.num_layers, num_blocks, block_size, cfg.kv_heads,
             cfg.head_dim)
    if kv_quant:
        sshape = (cfg.num_layers, num_blocks, cfg.kv_heads)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
                "vs": torch.zeros(sshape, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_write(kc: torch.Tensor, ksc, l: int, blocks: torch.Tensor,
              offs: torch.Tensor, k: torch.Tensor, touched=None) -> None:
    """Scatter one write-set into layer ``l`` of the pool, in place (the
    JAX package's ``kc.at[l, blocks, offs].set`` returns a new pool and
    relies on buffer donation). ``blocks``/``offs`` are int64. Padding
    tokens all target block 0, slot 0, so the indices repeat there and
    which write lands is unspecified; no unmasked read ever touches
    block 0.

    Under ``kv_quant`` (``ksc`` the f32 scales ``[L, nb, kvh]``) this is
    the JAX ``_kv_write`` (:72): per-token scale absmax / 127, a running
    per-(block, head) absmax that only grows (``scatter_reduce`` amax,
    deterministic; the JAX package's ``/ 127.0`` is compiled by XLA into a
    multiply by the f32 reciprocal, so this multiplies by it too), the
    block's existing int8 content requantized to the
    grown scale as ``round(q * old / new)``, then the new tokens quantized
    as ``clip(round(x / s), -127, 127)``. ``touched`` [D] int64 holds the
    distinct blocks of the write-set (padding to the null block allowed).
    JAX requantizes every write-set block under a ``lax.cond`` on any
    scale growing; requantizing ``touched`` unconditionally is
    bit-identical and needs no host sync: an unchanged scale gives a ratio
    of exactly 1.0 and ``round(q * 1.0) == q``, and a block whose scale is
    0 holds only zeros. As in JAX, nothing resets a freed block's scale:
    its next tenant quantizes against the old absmax."""
    if ksc is None:
        kc[l].index_put_((blocks, offs), k.to(kc.dtype))
        return
    xf = k.float()                                        # [C, kvh, hd]
    tok_scale = xf.abs().amax(dim=-1) * _INV_QMAX         # [C, kvh]
    old = ksc[l]                                          # [nb, kvh]
    new = old.scatter_reduce(0, blocks[:, None].expand_as(tok_scale),
                             tok_scale, "amax")           # running absmax
    o, n = old[touched], new[touched]                     # [D, kvh]
    pos = n > 0
    ratio = torch.where(pos, o / torch.where(pos, n, torch.ones_like(n)),
                        torch.zeros_like(n))
    pages = kc[l][touched].float()                        # [D, bs, kvh, hd]
    kc[l][touched] = torch.round(pages * ratio[:, None, :, None]).to(
        torch.int8)
    s_tok = torch.where(new > 0, new, torch.ones_like(new))[blocks]
    q = torch.clamp(torch.round(xf / s_tok[..., None]), -127, 127)
    kc[l].index_put_((blocks, offs), q.to(torch.int8))
    old.copy_(new)


def _norm(cfg, x, w, b=None):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, w, cfg.norm_eps)
    return layer_norm(x, w, b, cfg.norm_eps)


def _rope_at(cfg: TransformerConfig, pos: torch.Tensor):
    """f32 cos/sin tables at integer positions ``pos`` [...] ->
    [..., half]."""
    half = rotary_dims(cfg) // 2
    freqs = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, half, dtype=torch.float32, device=pos.device)
        / half))
    angles = pos.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., D]; f32 cos/sin broadcastable to [..., rot/2]. The product
    with the f32 tables promotes to f32 and casts back, as in JAX; with
    partial rotary the trailing dims pass through."""
    rot = 2 * cos.shape[-1]
    tail = x[..., rot:]
    half = rot // 2
    x1, x2 = x[..., :half], x[..., half:rot]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if tail.shape[-1]:
        out = torch.cat([out, tail.to(out.dtype)], dim=-1)
    return out.to(x.dtype)


def _mlp(cfg, lp, x):
    if cfg.moe_num_experts > 0:
        # under tensor parallelism each expert's f columns are this
        # rank's: the combined output is a partial sum
        return _row(cfg)(_moe_mlp(cfg, lp, x))
    if cfg.is_gated_mlp:
        return gated_mlp(cfg, lp["w_gate"], lp["w_up"], lp["w_down"], x,
                         _row(cfg))
    return dense_mlp(cfg, lp, x, _row(cfg))


def _moe_mlp(cfg, lp, x, ep_route=None):
    """Routed-expert MLP for serving (JAX :216), dropless: top-1 keeps the
    raw gate probability, top-k >= 2 renormalizes over the chosen set (the
    Mixtral convention). At ep 1 the grouped GEMM; at ep > 1 (or
    ``ep_route``, a ``MoEGroups``) the worst-case-capacity dispatch over
    the expert group (top-1 / top-2)."""
    from ...moe.sharded_moe import (MoEGroups, moe_layer_dropless_ep,
                                    residual_moe_combine, serve_moe,
                                    swiglu_experts)

    orig_shape = x.shape
    xt = x.reshape(-1, orig_shape[-1])
    experts = (lp["e_gate"], lp["e_up"], lp["e_down"])
    ep = getattr(cfg, "ep_size", 1)
    if ep > 1 and ep_route is None:
        ep_route = MoEGroups(None, 1, 0, cfg.ep_group, ep, cfg.ep_rank)
    if ep_route is not None:
        out = moe_layer_dropless_ep(xt[None], lp["moe_gate_w"], experts,
                                    swiglu_experts, ep_route,
                                    top_k=cfg.moe_top_k)[0][0]
    else:
        out = serve_moe(xt, lp["moe_gate_w"], experts, cfg.moe_top_k,
                        renormalize_top1=False, logits_in_f32=True)
    if cfg.moe_use_residual:
        dense = (torch.nn.functional.silu(xt @ lp["res_gate"])
                 * (xt @ lp["res_up"])) @ lp["res_down"]
        out = residual_moe_combine(xt, out, dense, lp["res_coef_w"],
                                   lp["res_coef_b"])
    return out.reshape(orig_shape)


def _embed_ln(cfg, params, x):
    """Embedding LayerNorm of the Bloom/BERT families (keyed on param
    presence)."""
    if "embed_ln_w" in params:
        return layer_norm(x, params["embed_ln_w"], params.get("embed_ln_b"),
                          cfg.norm_eps)
    return x


def _embed(cfg, params, ids):
    tp, r, _ = _tp(cfg)
    x = embed_lookup(params["embed"], ids.long(), r,
                     _row(cfg) if tp > 1 else None)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    return _embed_ln(cfg, params, x)


def _logits(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = (x @ head.to(x.dtype)).float()
    if "lm_head_b" in params:
        out = out + params["lm_head_b"].float()
    # every rank's vocab columns, so every rank samples alike
    tp, _, g = _tp(cfg)
    return gather_vocab(out, tp, g)


def _layers(cfg, params, x, cos, sin, cache, write_blocks, write_offsets,
            touched, attend):
    """The shared layer loop: norm, qkv, rotary, KV write, then attention
    (``attend(q, k, v, kc_l, vc_l, ks_l, vs_l)``: the batch's own k / v
    and the layer's pool, the scales None unless the pool is int8),
    out-projection and MLP. Each layer writes its K/V into the pool before
    it reads it, on the same stream. ``touched`` is the write-set's
    distinct blocks (read for an int8 pool only)."""
    T = x.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    layers = params["layers"]
    kc, vc = cache["k"], cache["v"]
    ksc, vsc = cache.get("ks"), cache.get("vs")
    write_blocks, write_offsets = write_blocks.long(), write_offsets.long()
    if ksc is not None:
        touched = touched.long()
    for l in range(cfg.num_layers):
        lp = dequantize_params({name: leaf[l]
                                for name, leaf in layers.items()})
        hn = _norm(cfg, x, lp["attn_norm"], lp.get("attn_norm_b"))
        q, k, v = qkv_proj(lp, hn)
        q = q.reshape(T, nh, hd)
        k = k.reshape(T, nkv, hd)
        v = v.reshape(T, nkv, hd)
        q = _rotate(q, cos[:, None], sin[:, None])
        k = _rotate(k, cos[:, None], sin[:, None])
        _kv_write(kc, ksc, l, write_blocks, write_offsets, k, touched)
        _kv_write(vc, vsc, l, write_blocks, write_offsets, v, touched)
        o = attend(q, k, v, kc[l], vc[l], None if ksc is None else ksc[l],
                   None if vsc is None else vsc[l]).reshape(T, nh * hd)
        x = x + out_proj(lp, o, _row(cfg))
        hn = _norm(cfg, x, lp["mlp_norm"], lp.get("mlp_norm_b"))
        x = x + _mlp(cfg, lp, hn)
    return _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))


def _kv_read(kc: torch.Tensor, ksc, l: int, table: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Gather layer ``l``'s pages ``table`` [...] -> [..., bs, kvh, hd],
    dequantizing when scales exist (JAX :117): the per-(block, head)
    scale broadcast over the page's slots and head dim, ``f32(q8) *
    scale`` rounded to ``dtype`` — the multiply the kernels' int8
    variants run per tile."""
    pages = kc[l][table]
    if ksc is None:
        return pages
    return (pages.float() * ksc[l][table][..., None, :, None]).to(dtype)


def _plain_attention(q, k, v, mask, dtype):
    """Softmax attention of the JAX stitched paths: q [C, nh, hd] over k /
    v [Ck, kvh, hd], f32 scores of the ``dtype`` product, masked with
    ``NEG_INF`` by ``mask`` [C, Ck], the probabilities rounded to
    ``dtype``."""
    nh, nkv, hd = q.shape[1], k.shape[1], q.shape[2]
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k).float()
    scores = scores / torch.sqrt(torch.tensor(float(hd)))
    scores = torch.where(mask[None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("hqk,khd->qhd", probs, v)


def _need_touched(cache, touched, name):
    if "ks" in cache and touched is None:
        raise ValueError(f"{name}: an int8 pool needs touched_blocks (the "
                         f"write-set's distinct blocks)")


# ---------------------------------------------------------------------------
# Stitched prefill and continuation (ragged_attention="off")
# ---------------------------------------------------------------------------
def paged_prefill(cfg: TransformerConfig, params, ids: torch.Tensor,
                  prompt_len: int, cache: Dict[str, torch.Tensor],
                  block_ids: torch.Tensor, offsets: torch.Tensor,
                  use_kernel: bool = True,
                  touched_blocks: torch.Tensor = None) -> torch.Tensor:
    """ids [1, C] (the padded prompt); ``prompt_len`` its valid tokens;
    ``block_ids`` / ``offsets`` [C] map a chunk position to its (cache
    block, slot), padding to the null block. Returns the last token's
    [V] f32 logits and writes the prompt's K/V into ``cache`` in place
    (JAX :319). An int8 pool also needs ``touched_blocks``.

    With ``use_kernel``, a bucket ``C % 128 == 0`` and no ALiBi, the
    prompt's causal self-attention runs the hand-written flash forward
    (``ops/flash_attention.flash_attention``: the Hopper kernel of
    ``csrc/flash_attention.cu`` on the card, its plain version on CPU
    tensors), as JAX runs its Pallas flash kernel there: padding keys sit
    after every valid query, so the causal mask alone hides them.
    Otherwise plain attention with the causal and valid mask."""
    from ...ops.flash_attention import flash_attention

    _need_touched(cache, touched_blocks, "paged_prefill")
    C = ids.shape[1]
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    flash_ok = (use_kernel and C % 128 == 0 and hd % 8 == 0
                and cfg.positional != "alibi")
    params = dequantize_nonlayer(params)
    x = _embed(cfg, params, ids[0])                           # [C, H]
    pos = torch.arange(C, device=x.device)
    cos, sin = _rope_at(cfg, pos)
    valid = pos < int(prompt_len)
    mask = (pos[:, None] >= pos[None, :]) & valid[None, :]    # [C, C]

    def attend(q, k, v, kc, vc, ks, vs):
        if flash_ok:
            return flash_attention(
                q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                v.transpose(0, 1)[None], causal=True)[0].transpose(0, 1)
        return _plain_attention(q, k, v, mask, x.dtype)

    x = _layers(cfg, params, x, cos, sin, cache, block_ids, offsets,
                touched_blocks, attend)
    return _logits(cfg, params, x[int(prompt_len) - 1])


def paged_continue(cfg: TransformerConfig, params, ids: torch.Tensor,
                   start_pos: int, n_new: int,
                   cache: Dict[str, torch.Tensor], block_ids: torch.Tensor,
                   offsets: torch.Tensor, block_table: torch.Tensor,
                   block_size: int,
                   touched_blocks: torch.Tensor = None) -> torch.Tensor:
    """A multi-token continuation of ONE cached sequence in one pass (JAX
    :417): ids [1, C] (the padded chunk), ``start_pos`` the tokens already
    cached, ``n_new`` the chunk's valid tokens, ``block_ids`` /
    ``offsets`` [C] the chunk's write-set (padding to the null block),
    ``block_table`` [MB] the sequence's whole table. The chunk's K/V go
    into the pool, then every chunk token attends causally over the whole
    table (``_kv_read``, int8 pages dequantized) up to its own position.
    Returns the last valid token's [V] f32 logits."""
    _need_touched(cache, touched_blocks, "paged_continue")
    C = ids.shape[1]
    MB = block_table.shape[0]
    ctx = MB * block_size
    nkv, hd = cfg.kv_heads, cfg.head_dim
    params = dequantize_nonlayer(params)
    x = _embed(cfg, params, ids[0])                           # [C, H]
    pos = int(start_pos) + torch.arange(C, device=x.device)
    cos, sin = _rope_at(cfg, pos)
    ctx_pos = torch.arange(ctx, device=x.device)
    mask = ctx_pos[None, :] <= pos[:, None]                   # [C, ctx]
    table = block_table.long()

    def attend(q, k, v, kc, vc, ks, vs):
        kp = _kv_read(kc[None], None if ks is None else ks[None], 0, table,
                      x.dtype).reshape(ctx, nkv, hd)
        vp = _kv_read(vc[None], None if vs is None else vs[None], 0, table,
                      x.dtype).reshape(ctx, nkv, hd)
        return _plain_attention(q, kp, vp, mask, x.dtype)

    x = _layers(cfg, params, x, cos, sin, cache, block_ids, offsets,
                touched_blocks, attend)
    return _logits(cfg, params, x[int(n_new) - 1])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def paged_decode(cfg: TransformerConfig, params, toks: torch.Tensor,
                 pos: torch.Tensor, block_tables: torch.Tensor,
                 cache: Dict[str, torch.Tensor], active: torch.Tensor,
                 block_size: int, use_kernel: bool = True) -> torch.Tensor:
    """toks/pos/active [N]; block_tables [N, MB] int32. One token per
    sequence; returns [N, V] f32 logits and updates ``cache`` in place.
    Inactive rows write to the null block and produce garbage logits
    (masked by the caller). Each live row writes its own block, so the
    per-row write blocks are the write-set's distinct blocks (repeats are
    the null block)."""
    MB = block_tables.shape[1]
    params = dequantize_nonlayer(params)
    x = _embed(cfg, params, toks)
    cos, sin = _rope_at(cfg, pos)
    # an inactive row's position may sit one past its table; clamp the
    # lookup (the row writes to the null block either way)
    page = torch.clamp(pos.long() // block_size, max=MB - 1)
    blk = torch.gather(block_tables, 1, page[:, None])[:, 0]
    blk = torch.where(active, blk, torch.zeros_like(blk))
    off = pos % block_size
    lengths = pos + 1
    attn = paged_attention if use_kernel else paged_attention_plain
    x = _layers(cfg, params, x, cos, sin, cache, blk, off, blk,
                lambda q, k, v, kc, vc, ks, vs: attn(q, kc, vc, block_tables,
                                                     lengths, ks, vs))
    return _logits(cfg, params, x)


# ---------------------------------------------------------------------------
# Ragged unified step (mixed prefill + decode, one launch per layer)
# ---------------------------------------------------------------------------
def paged_ragged_step(cfg: TransformerConfig, params, ids: torch.Tensor,
                      row_ids: torch.Tensor, pos: torch.Tensor,
                      lengths: torch.Tensor, write_blocks: torch.Tensor,
                      write_offsets: torch.Tensor,
                      block_tables: torch.Tensor, last_index: torch.Tensor,
                      cache: Dict[str, torch.Tensor], block_size: int,
                      use_kernel: bool = True,
                      touched_blocks: torch.Tensor = None) -> torch.Tensor:
    """One mixed batch as a flat token buffer ``ids`` [TB] with per-token
    descriptors (``row_ids``, ``pos``, ``lengths`` = pos + 1 or 0 for
    padding, the KV write-set ``write_blocks``/``write_offsets``), per-row
    ``block_tables`` [RB, MBw] and ``last_index`` [RB]. Returns [RB, V]
    f32 last-token logits per row and updates ``cache`` in place. An int8
    pool also needs ``touched_blocks``, the write-set's distinct blocks
    (``RaggedBatch.touched_blocks``, host data): never one page per token,
    which at a 4608-token chunk would gather gigabytes per layer."""
    if "ks" in cache and touched_blocks is None:
        raise ValueError("paged_ragged_step: an int8 pool needs "
                         "touched_blocks (the write-set's distinct blocks)")
    params = dequantize_nonlayer(params)
    x = _embed(cfg, params, ids)
    cos, sin = _rope_at(cfg, pos)
    attn = ragged_attention if use_kernel else ragged_attention_plain
    x = _layers(cfg, params, x, cos, sin, cache, write_blocks, write_offsets,
                touched_blocks,
                lambda q, k, v, kc, vc, ks, vs: attn(q, kc, vc, row_ids,
                                                     lengths, block_tables,
                                                     ks, vs))
    return _logits(cfg, params, x[last_index.long()])


# ---------------------------------------------------------------------------
# Fused multi-token decode window
# ---------------------------------------------------------------------------
def paged_decode_window(cfg: TransformerConfig, params, toks: torch.Tensor,
                        pos: torch.Tensor, block_tables: torch.Tensor,
                        cache: Dict[str, torch.Tensor],
                        steps_left: torch.Tensor, eos_ids: torch.Tensor,
                        block_size: int, window: int,
                        rng: torch.Tensor = None,
                        row_seeds: torch.Tensor = None,
                        gen_idx0: torch.Tensor = None,
                        temp: torch.Tensor = None, topp: torch.Tensor = None,
                        topk: torch.Tensor = None,
                        use_kernel: bool = True) -> torch.Tensor:
    """``window`` decode steps with no host round trip: the next-token
    pick (argmax, or the sampler), the active mask, the EOS and budget cuts
    and the output block all stay on the device. Returns tokens [N, window]
    int32 with -1 in the steps a row did not take (emitted tokens form a
    prefix of each row).

    Sampling (``rng`` is not None): step s draws row i with the key
    ``fold_in_rows(rng, row_seeds, gen_idx0 + s)`` (``sampling.py``), so a
    row's draw depends only on its own seed and generated-token index —
    the per-token path derives the same keys, and the two give the same
    stream for a fixed seed. ``temp`` / ``topp`` / ``topk`` are [N].

    The host pre-allocates every block a row can write in its
    ``steps_left[i]`` steps, so block advancement is position arithmetic
    over a complete table. A row that emits its EOS goes inactive: the EOS
    is emitted but never fed back, later steps write to the null block.
    The JAX loop exits once every row is inactive; this loop always runs
    ``window`` steps, since testing for that would cost a host sync per
    step. The extra steps change no live block and emit only -1, so the
    output is the same."""
    N = toks.shape[0]
    # the embedding and the head once per window; paged_decode's own call
    # then finds them dense
    params = dequantize_nonlayer(params)
    active = steps_left > 0
    out = torch.full((N, window), -1, dtype=torch.int32, device=toks.device)
    if rng is not None:
        # every step's keys at once: the key hash is ~190 tiny launches,
        # paid once a window instead of once a step (same bits)
        steps = torch.arange(window, device=toks.device)
        u = key_uniforms(fold_in_rows(
            rng, row_seeds[:, None].expand(N, window),
            gen_idx0[:, None] + steps))
    for s in range(window):
        logits = paged_decode(cfg, params, toks, pos, block_tables, cache,
                              active, block_size, use_kernel=use_kernel)
        if rng is not None:
            nxt = sample_tokens_uniform(logits, u[:, s], temp, topp, topk)
        else:
            nxt = greedy_tokens(logits)
        out[:, s] = torch.where(active, nxt, torch.full_like(nxt, -1))
        pos = torch.where(active, pos + 1, pos)
        toks = torch.where(active, nxt, toks)
        active = active & (nxt != eos_ids) & (steps_left > s + 1)
    return out

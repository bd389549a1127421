"""Inference engine (v1): dense KV-cache generation.

Port of ``deepspeed_tpu/inference/engine.py`` (``InferenceEngine``, :30) on
one device: what plain ``init_inference()`` returns. ``generate`` runs a
prefill over the prompt into a dense ``[L, B, kvh, M, hd]`` cache, then one
token per step through ``TransformerLM.forward_cached``, whose decode
attention is the dense decode kernel (``ops/decode_attention.py``). The
JAX package compiles the loop as one ``lax.scan``; here it is an eager
Python loop whose tokens stay on the device until one host transfer at the
end, and which, as in JAX, skips the last step's forward (it would never
be sampled): a call runs ``max_new_tokens - 1`` decode forwards.

Under ``quant_bits`` 8 or 4 the weights rest quantized
(``inference/quantization.py``): ``forward`` and ``generate`` dequantize
the embedding and the head once per call, and the model's layer loop one
layer at a time.

``checkpoint`` (a training checkpoint's run or tag directory, in the
fragment format of ``checkpoint/state_checkpoint.py``, written by either
package) supplies the weights when ``params`` is not given: the master
weights where the checkpoint holds them, else its params, cast to the
engine's dtype (JAX :66-67, :107).

At ``tensor_parallel.tp_size`` > 1 every rank of a process group of tp
ranks (``comm.init_distributed()``; the launcher starts them) runs the
same engine on the same inputs, SPMD: a rank holds its slices of the
leaves (``models/transformer.tp_shard_dims``) and its heads' dense
cache, the wo / down / embedding products are all-reduced over the model
group, the logits all-gathered, so every rank samples the same token. The
decode step stays on the dense decode kernel over the local heads (JAX
keeps the einsum at tp > 1 only because its partitioner cannot split a
bare kernel call; the function is the same). ``quant_bits`` with tp > 1
is refused, as in the JAX v2 engine.
"""

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .config import DeepSpeedInferenceConfig
from .quantization import dequantize_nonlayer, quantize_params
from .v2.engine_v2 import DTYPES, _cast_tree


class InferenceEngine:
    """Wraps a model (``init_params`` + ``forward_logits`` +
    ``init_kv_cache`` / ``forward_cached``) for KV-cache generation.
    ``params`` (the JAX tree layout, tensors or arrays) replaces the
    seeded init; ``device=None`` means the GPU."""

    def __init__(self, model, config: DeepSpeedInferenceConfig, params=None,
                 device=None):
        tp = config.tensor_parallel.tp_size
        if tp > 1 and config.quant_bits:
            raise ValueError(
                "quant_bits requires tensor_parallel.tp_size == 1 (the "
                "slices are declared against dense leaves)")
        self.module = self.model = model
        self.config = config
        self.device = resolve_device(device)
        self.dtype = DTYPES[config.dtype]
        self.topology = None
        if tp > 1:
            self.topology = tensor_parallel_topology(tp, self.device)
            model.set_topology(self.topology)
        if params is not None:
            self.params = _cast_tree(params, self.device, self.dtype)
        elif config.checkpoint:
            from ..checkpoint.state_checkpoint import \
                load_params_for_inference
            self.params = load_params_for_inference(
                config.checkpoint, self.dtype, self.device)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            self.params = model.init_params(gen, dtype=self.dtype)
        if self.topology is not None:
            self.params = tp_slices(model, self.params, self.topology)
        if config.quant_bits:
            # quantize_params validates bits in {4, 8}: an invalid value
            # raises instead of serving unquantized weights
            self.params, self._qmeta = quantize_params(
                self.params, bits=config.quant_bits)

    def forward(self, input_ids, **_kw):
        """Plain logits forward (reference engine.forward)."""
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device)
        with torch.no_grad():
            return self.model.forward_logits(
                dequantize_nonlayer(self.params), ids)

    __call__ = forward

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_token_id: Optional[int] = None,
                 seed: int = 0, **_kw) -> np.ndarray:
        """Autoregressive generation. input_ids: [B, S_prompt]. Returns
        [B, S_prompt + max_new_tokens] int32 token ids (positions after a
        row's EOS hold the EOS). The draws of ``temperature`` > 0 come from
        a ``torch.Generator`` seeded with ``seed``: repeatable, but not the
        JAX package's threefry draws."""
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        if ids.shape[0] > self.config.max_batch_size:
            raise ValueError(
                f"batch size {ids.shape[0]} exceeds config.max_batch_size="
                f"{self.config.max_batch_size}")
        total = ids.shape[1] + int(max_new_tokens)
        if total > self.config.max_out_tokens:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds "
                f"config.max_out_tokens={self.config.max_out_tokens}")
        if int(max_new_tokens) < self.config.min_out_tokens:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} below "
                f"config.min_out_tokens={self.config.min_out_tokens}")
        eos = -1 if eos_token_id is None else int(eos_token_id)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        toks = generate_tokens(
            self.model, dequantize_nonlayer(self.params),
            torch.as_tensor(ids, dtype=torch.int64, device=self.device), gen,
            self.dtype, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), eos=eos)
        # the loop's one device-to-host transfer
        return np.concatenate([ids.astype(np.int32), toks.cpu().numpy()],
                              axis=1)


def tensor_parallel_topology(tp: int, device, ep: int = 1):
    """The process topology of a tensor- (and expert-) parallel engine: the
    default group (started here from the launcher's environment if it is
    not yet) with its ranks on the model and expert axes (tp x ep must
    divide the world; more ranks are replicas)."""
    from ..comm import comm
    from ..parallel.topology import MeshTopology, TopologyConfig

    comm.init_distributed(dist_backend="nccl" if device.type == "cuda"
                          else "gloo")
    world = comm.get_world_size()
    if world % (tp * ep):
        what = (f"tensor_parallel tp_size={tp}" if ep == 1 else
                f"tp_size={tp} x expert_parallel_size={ep}")
        raise ValueError(f"{what} does not divide the process group's "
                         f"{world} ranks")
    return MeshTopology(TopologyConfig(model=tp, expert=ep))


def tp_slices(model, params, topology):
    """This rank's tensor-parallel slices of a whole parameter tree (the
    model's ``tp_shard_dims``), contiguous."""
    from ..comm.quantized import shard_of
    from ..runtime.engine import _flatten, _unflatten

    dims = model.tp_shard_dims
    tp, r = topology.tp_size, topology.tp_rank
    return _unflatten([
        (k, v if dims.get(k) is None else
         shard_of(v, dims[k], r, tp).contiguous())
        for k, v in _flatten(params)])


def expert_slices(model, params, topology):
    """This rank's experts of a parameter tree (the model's
    ``expert_leaves`` cut over the expert axis), contiguous; the tree
    itself at ep 1."""
    from ..comm.quantized import shard_of
    from ..runtime.engine import _flatten, _unflatten

    ep = topology.axis_size("expert")
    if ep == 1:
        return params
    dims = getattr(model, "expert_leaves", {}) or {}
    return _unflatten([
        (k, v if k not in dims else
         shard_of(v, dims[k], topology.ep_rank, ep).contiguous())
        for k, v in _flatten(params)])


@torch.no_grad()
def generate_tokens(model, params, ids, generator, dtype, *, max_new_tokens,
                    temperature, top_k, top_p, eos):
    """Prefill + decode loop; returns [B, max_new_tokens] int32 tokens on
    the device. Nothing in the loop reads a device value on the host."""
    B, S = ids.shape
    cache = model.init_kv_cache(B, S + max_new_tokens, dtype, ids.device)
    last = model.forward_cached(params, ids, cache, 0)[:, -1]
    done = torch.zeros(B, dtype=torch.bool, device=ids.device)
    fill = torch.full((B,), eos if eos >= 0 else 0, dtype=torch.int32,
                      device=ids.device)
    toks = torch.empty((B, max_new_tokens), dtype=torch.int32,
                       device=ids.device)
    for i in range(max_new_tokens):
        tok = _sample(last, generator, temperature, top_k, top_p)
        tok = torch.where(done, fill, tok)
        done = done | (tok == eos)
        toks[:, i] = tok
        # the final step's logits are never sampled: skip its forward
        if i < max_new_tokens - 1:
            last = model.forward_cached(params, tok[:, None], cache,
                                        S + i)[:, 0]
    return toks


def _mask_logits(logits, temperature, top_k, top_p):
    """The JAX ``_sample``'s temperature / top-k / nucleus masking of [B, V]
    logits (masked entries -1e30)."""
    logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    if top_p and 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1,
                                   descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # clamped: rounding can leave the whole cumsum below top_p
        cutoff_idx = torch.clamp((cum < top_p).sum(dim=-1),
                                 max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, torch.full_like(logits, -1e30),
                             logits)
    return logits


def _sample(logits, generator, temperature, top_k, top_p):
    """Greedy / temperature / top-k / nucleus sampling over [B, V] logits;
    int32 tokens [B]."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_mask_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)

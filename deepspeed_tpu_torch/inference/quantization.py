"""Weight-only quantization (WOQ) for inference.

Port of ``deepspeed_tpu/inference/quantization.py``. Weight matrices rest
in device memory as int8 (int4 packed two per byte) with one f32 scale per
block of 2048 elements, and are dequantized right before use: a layer's
weights at the top of that layer's iteration, the embedding and the head
once per forward. The footprint at rest is about 1/2 (int8) or 1/4 (int4)
of bf16, and no dense copy of the layer stack is ever held: at most the
current layer's (and, while the next one is built, the previous layer's).

On the card the (de)quantization runs the hand-written kernels of
``ops/quantizer_kernels.py``; int4 is unpacked by plain torch first, as
XLA runs it in the JAX package.
"""

from typing import Tuple

import torch

from ..ops import quantizer as Q

_MIN_QUANT_SIZE = 4096  # don't quantize norms/biases/small tables


class QuantizedTensor:
    """int8 blocks + f32 scales standing in for a dense weight; int4 is
    packed two per byte.

    ``stacked=True`` marks a per-layer stacked weight ``[L, ...]``: blocks
    are laid out ``q [L, nb, block]`` (int4: ``[L, nb, block // 2]``) and
    ``s [L, nb, 1]``, with ``shape`` the PER-LAYER logical shape, so a
    block never crosses layers. ``t[l]`` is layer ``l`` as a plain
    ``QuantizedTensor`` over views ``q[l]``, ``s[l]``: the layer loops'
    ``{name: leaf[l]}`` slices it as JAX's ``lax.scan`` does, and the
    loop body's :meth:`dequantize` rebuilds one layer."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor,
                 shape: Tuple[int, ...], dtype: torch.dtype, bits: int = 8,
                 stacked: bool = False):
        self.q, self.s, self.shape, self.dtype = q, s, tuple(shape), dtype
        self.bits = bits
        self.stacked = stacked

    def __getitem__(self, l: int) -> "QuantizedTensor":
        if not (self.stacked and self.q.dim() == 3):
            raise TypeError("only a stacked QuantizedTensor is indexed by "
                            "layer")
        return QuantizedTensor(self.q[l], self.s[l], self.shape, self.dtype,
                               self.bits)

    def dequantize(self) -> torch.Tensor:
        if self.stacked and self.q.dim() == 3:
            # the whole stack (outside a layer loop): [L, *shape]
            return torch.stack([self[l].dequantize()
                                for l in range(self.q.shape[0])])
        q = Q.unpack_int4(self.q) if self.bits == 4 else self.q
        return Q.dequantize_symmetric(q, self.s, self.shape,
                                      dtype=self.dtype)

    def __repr__(self):
        return (f"QuantizedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"bits={self.bits}, stacked={self.stacked})")


def _is_qleaf(x) -> bool:
    return isinstance(x, QuantizedTensor)


def qblock(t: QuantizedTensor) -> int:
    """The block size ``t`` was quantized with (int4 packs two a byte)."""
    return t.q.shape[-1] * (2 if t.bits == 4 else 1)


def _should_quantize(path: Tuple[str, ...], leaf: torch.Tensor) -> bool:
    if leaf.dim() < 2 or leaf.numel() < _MIN_QUANT_SIZE:
        return False
    key = str(path[-1]) if path else ""
    # biases are stacked per layer into 2-D tensors (b_q [L, nh*hd] etc.),
    # so the ndim/size gate alone would quantize them; additive biases
    # must stay exact
    if key.startswith("b_") or key.endswith("_b"):
        return False
    return "norm" not in key


def _under_scan(path: Tuple[str, ...]) -> bool:
    """Leaves under the per-layer stack (consumed one layer at a time)."""
    return "layers" in path


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _quantize_leaf(x: torch.Tensor, bits: int, block: int):
    q, s = Q.quantize_symmetric(x, block=block, bits=bits)
    return (Q.pack_int4(q) if bits == 4 else q), s


def quantize_params(params, bits: int = 8, block: int = 2048):
    """Returns (tree with QuantizedTensor leaves, meta).

    Leaves under ``params["layers"]`` are stacked ``[L, ...]`` and are
    consumed one layer at a time, so they quantize per layer
    (``stacked=True``): one quantize launch per layer and leaf (an MoE
    layer's ``[E, h, f]`` expert leaf is one block sequence). A leaf that
    is a ``QuantizedTensor`` already is kept; it raises ``ValueError``
    unless it has the ``bits`` and ``block`` asked for."""
    if bits not in (4, 8):
        # the quantizer's range pick defaults anything != 8 to the int4
        # range, so e.g. bits=16 would silently serve 15-level weights
        raise ValueError(f"quant_bits must be 4 or 8, got {bits}")
    meta = {"bits": bits, "block": block, "n_quantized": 0}

    def leaf_fn(path, leaf):
        if _is_qleaf(leaf):         # quantized already (kept as it is)
            if leaf.bits != bits or qblock(leaf) != block:
                raise ValueError(
                    f"{'/'.join(map(str, path))} is quantized at "
                    f"{leaf.bits} bits, block {qblock(leaf)}; asked for "
                    f"{bits} bits, block {block}")
            meta["n_quantized"] += 1
            return leaf
        stacked = _under_scan(path) and leaf.dim() >= 3
        per_layer = leaf[0] if stacked else leaf
        if not _should_quantize(path, per_layer):
            return leaf
        meta["n_quantized"] += 1
        if stacked:
            qs = [_quantize_leaf(leaf[l], bits, block)
                  for l in range(leaf.shape[0])]
            return QuantizedTensor(torch.stack([q for q, _ in qs]),
                                   torch.stack([s for _, s in qs]),
                                   per_layer.shape, leaf.dtype, bits=bits,
                                   stacked=True)
        q, s = _quantize_leaf(leaf, bits, block)
        return QuantizedTensor(q, s, leaf.shape, leaf.dtype, bits=bits)

    return _map(leaf_fn, params), meta


def dequantize_params(params):
    """Inverse of :func:`quantize_params` (identity on dense leaves)."""
    return _map(lambda _, x: x.dequantize() if _is_qleaf(x) else x, params)


def dequantize_nonlayer(params):
    """Dequantize every WOQ leaf OUTSIDE ``params["layers"]`` (the
    embedding and the head); layer leaves stay quantized for the layer
    loop, which dequantizes one layer at a time. The dense copies live as
    long as the caller's forward."""
    return {k: (v if k == "layers" else dequantize_params(v))
            for k, v in params.items()}


def quantized_nbytes(params) -> int:
    """Bytes of every tensor in the tree, a quantized leaf's values and
    scales included."""
    total = 0
    for _, leaf in _flatten(params):
        for t in ((leaf.q, leaf.s) if _is_qleaf(leaf) else (leaf,)):
            total += t.numel() * t.element_size()
    return total

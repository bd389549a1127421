"""PyTorch port: the blockwise quantizer, its kernels' plain versions, the
RMSNorm kernel route and the WOQ parameter tree, against the JAX package.

Inputs are made from a seed with numpy and go through ``deepspeed_tpu`` and
``deepspeed_tpu_torch`` on the CPU; the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them. Held equal:

* ``quantize_symmetric`` (bits 8 / 4, blocks 128 / 256 / 2048, f32, bf16
  and fp16 sources, ragged tails, all-zero blocks, values that land exactly
  on .5 after the division): ``q`` and the scales bit-equal to the JAX
  package's JITTED ``quantize_symmetric`` (XLA compiles ``absmax /
  qrange`` into a multiply by the f32 reciprocal, so the eager formula is
  the wrong oracle); ``dequantize_symmetric`` bit-equal in f32, bf16 and
  fp16;
* ``pack_int4`` / ``unpack_int4``, ``quantize_asymmetric`` and
  ``quantized_reduction`` equal to JAX's;
* ``quantize_blocks_plain`` / ``dequantize_blocks_plain`` bit-equal to the
  Pallas kernels ``quantize_blocks_pallas`` / ``dequantize_blocks_pallas``;
* ``rms_norm(use_pallas=True)`` on CPU tensors against ``rms_norm_pallas``:
  1e-5 in fp32, one bf16 rounding in bf16 (the reduction order and rsqrt
  differ, so not bit-equal); the kernel route raises under autograd;
* ``quantize_params`` on tiny trees: the same leaves quantized as JAX's
  (qkv biases and 2-D stacked biases stay dense), ``q`` / ``s`` bit-equal
  in the stacked ``[L, nb, block]`` layout, ``dequantize_params`` and
  ``quantized_nbytes`` equal; bit widths other than 4 and 8 raise.

The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference import quantization as JW
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.models.transformer import tiny_test as jax_tiny_test
from deepspeed_tpu.ops import norms as JN
from deepspeed_tpu.ops import quantizer as JQ
from deepspeed_tpu.ops import quantizer_kernels as JK

from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference import quantization as TW
from deepspeed_tpu_torch.ops import norms as TN
from deepspeed_tpu_torch.ops import quantizer as TQ
from deepspeed_tpu_torch.ops import quantizer_kernels as TK

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(x).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _halfway_block(block: int, qrange: float, k: int) -> np.ndarray:
    """A block whose scale is exactly 2**k (absmax = qrange * 2**k) and
    whose other elements are (m + 0.5) * 2**k: x / scale lands exactly on
    .5, where round-half-even and round-half-away differ."""
    m = np.arange(block) % (2 * int(qrange)) - qrange      # [-q, q)
    x = (m + 0.5) * 2.0 ** k
    x[0] = qrange * 2.0 ** k
    return x.astype(np.float32)


def _quant_input(block: int, bits: int, seed: int) -> np.ndarray:
    """Four blocks and a ragged tail: a random block, an all-zero block, a
    half-way block, a block of tiny values, then 77 random elements."""
    rng = np.random.default_rng(seed)
    qrange = TQ.qrange_for(bits)
    return np.concatenate([
        rng.normal(size=block).astype(np.float32) * 3.0,
        np.zeros(block, np.float32),
        _halfway_block(block, qrange, -2),
        rng.normal(size=block).astype(np.float32) * 1e-3,
        rng.normal(size=77).astype(np.float32)])


def test_halfway_block_is_exact():
    """Precondition of the half-way cases: the f32 scale of those blocks is
    exactly 2**k, so the division lands on .5."""
    for qrange in (TQ.INT8_QRANGE, TQ.INT4_QRANGE):
        x = torch.from_numpy(_halfway_block(128, qrange, -2))
        scale = x.abs().amax() * TQ.f32_reciprocal(qrange)
        assert scale.item() == 0.25
        frac = (x / scale) - torch.floor(x / scale)
        assert bool((frac[1:] == 0.5).all())


# ---------------------------------------------------------------------------
# symmetric quantize / dequantize against the jitted JAX quantizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("block", [128, 256, 2048])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_symmetric_bit_equal_to_jax(bits, block, dtype):
    jx, tx = _pair(_quant_input(block, bits, seed=block + bits), dtype)
    jq, js = JQ.quantize_symmetric(jx, block=block, bits=bits)
    tq, ts = TQ.quantize_symmetric(tx, block=block, bits=bits)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tq.shape) == (5, block) and tuple(ts.shape) == (5, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 0].item() == 1.0 and not tq[1].any()    # the zero block
    assert not tq[4, 77:].any()                           # the padded tail


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_symmetric_bit_equal_to_jax(bits, dtype):
    x = _quant_input(256, bits, seed=7)
    jq, js = JQ.quantize_symmetric(jnp.asarray(x), block=256, bits=bits)
    jdt, tdt = DTYPES[dtype]
    shape = (x.size // 7, 7)
    a = JQ.dequantize_symmetric(jq, js, shape, dtype=jdt)
    b = TQ.dequantize_symmetric(torch.from_numpy(np.asarray(jq)),
                                torch.from_numpy(np.asarray(js)), shape,
                                dtype=tdt)
    assert b.dtype == tdt and tuple(b.shape) == shape
    np.testing.assert_array_equal(_np(b), np.asarray(a.astype(jnp.float32)))


def test_int4_pack_unpack_match_jax():
    q = np.random.default_rng(0).integers(-7, 8, (6, 64)).astype(np.int8)
    packed = TQ.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JQ.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(
        TQ.unpack_int4(packed).numpy(),
        np.asarray(JQ.unpack_int4(jnp.asarray(packed.numpy()))))
    np.testing.assert_array_equal(TQ.unpack_int4(packed).numpy(), q)
    # stacked [L, nb, block // 2] unpacks layer by layer
    stacked = torch.stack([packed, packed.flip(0)])
    np.testing.assert_array_equal(TQ.unpack_int4(stacked)[1].numpy(),
                                  q[::-1])


@pytest.mark.parametrize("bits", [8, 4])
def test_asymmetric_matches_jax(bits):
    x = np.random.default_rng(bits).normal(size=5000).astype(np.float32)
    jq, js, jz = JQ.quantize_asymmetric(jnp.asarray(x), block=256, bits=bits)
    tq, ts, tz = TQ.quantize_asymmetric(torch.from_numpy(x), block=256,
                                        bits=bits)
    for t, j in ((tq, jq), (ts, js), (tz, jz)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        TQ.dequantize_asymmetric(tq, ts, tz, x.shape).numpy(),
        np.asarray(JQ.dequantize_asymmetric(jq, js, jz, x.shape)))


@pytest.mark.parametrize("n_groups", [2, 3, 4, 7])
def test_quantized_reduction_matches_jax(n_groups):
    rng = np.random.default_rng(n_groups)
    x = rng.normal(size=n_groups * 8 * 256).astype(np.float32)
    q, s = JQ.quantize_symmetric(jnp.asarray(x), block=256)
    jq, js = JQ.quantized_reduction(q, s, n_groups, block=256)
    tq, ts = TQ.quantized_reduction(torch.from_numpy(np.asarray(q)),
                                    torch.from_numpy(np.asarray(s)),
                                    n_groups, block=256)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_blocks_plain_matches_pallas(bits, dtype):
    x = _quant_input(256, bits, seed=11)[:4 * 256].reshape(4, 256)
    jx, tx = _pair(x, dtype)
    jq, js = JK.quantize_blocks_pallas(jx, bits=bits)
    tq, ts = TK.quantize_blocks(tx, 256, bits)        # CPU -> plain version
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the drop-in reads any shape flat
    tq2, ts2 = TK.quantize_symmetric_kernel(tx.reshape(8, 128), 256, bits)
    assert torch.equal(tq2, tq) and torch.equal(ts2, ts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dequantize_blocks_plain_matches_pallas(dtype):
    rng = np.random.default_rng(12)
    q = rng.integers(-127, 128, (6, 256)).astype(np.int8)
    s = rng.uniform(1e-3, 1.0, (6, 1)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    a = JK.dequantize_blocks_pallas(jnp.asarray(q), jnp.asarray(s),
                                    out_dtype=jdt)
    b = TK.dequantize_blocks(torch.from_numpy(q), torch.from_numpy(s), tdt)
    assert b.dtype == tdt and tuple(b.shape) == (6, 256)
    np.testing.assert_array_equal(_np(b), np.asarray(a.astype(jnp.float32)))
    # with n: the first n elements, flat (the drop-in's cut)
    c = TK.dequantize_blocks(torch.from_numpy(q), torch.from_numpy(s), tdt,
                             n=1000)
    assert torch.equal(c, b.reshape(-1)[:1000])
    d = JK.dequantize_symmetric_pallas(jnp.asarray(q), jnp.asarray(s),
                                       (10, 100), dtype=jdt)
    np.testing.assert_array_equal(
        _np(TK.dequantize_symmetric_kernel(
            torch.from_numpy(q), torch.from_numpy(s), (10, 100), tdt)),
        np.asarray(d.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# RMSNorm: the kernel route against rms_norm_pallas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(12, 64), (3, 5, 96), (7, 100)])
def test_rms_norm_kernel_route_matches_pallas(shape, dtype):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = rng.normal(size=shape).astype(np.float32) * 2.0
    w = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    a = np.asarray(JN.rms_norm_pallas(jx, jw, 1e-5).astype(jnp.float32))
    before = TN.rms_norm_kernel.launches
    b = TN.rms_norm(tx, tw, 1e-5, use_pallas=True)
    assert TN.rms_norm_kernel.launches == before     # CPU: no launch
    assert b.dtype == tx.dtype and tuple(b.shape) == shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(b), a, rtol=0, atol=1e-5)
    else:   # one bf16 rounding of the output
        assert (np.abs(_np(b) - a) <= 2.0 ** -7 * np.abs(a) + 1e-6).all()
    # the default path is the plain reference
    assert torch.equal(TN.rms_norm(tx, tw, 1e-5),
                       TN.rms_norm_ref(tx, tw, 1e-5))


def test_rms_norm_kernel_route_has_no_gradient():
    x = torch.randn(4, 32, requires_grad=True)
    w = torch.ones(32)
    with pytest.raises(RuntimeError, match="no gradient"):
        TN.rms_norm(x, w, use_pallas=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        TN.rms_norm(x.detach(), w.requires_grad_(), use_pallas=True)
    with torch.no_grad():
        out = TN.rms_norm(x, w, use_pallas=True)
    assert not out.requires_grad
    TN.rms_norm(x, w).sum().backward()          # the plain path trains
    assert x.grad is not None


# ---------------------------------------------------------------------------
# the WOQ parameter tree
# ---------------------------------------------------------------------------
def _tiny_tree(attn_bias: bool):
    cfg = dataclasses.replace(jax_tiny_test(), num_kv_heads=2,
                              attn_bias=attn_bias)
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        JModel(cfg).init_params(jax.random.PRNGKey(0)))


def _bias_tree():
    """The leaves of the JAX package's test_woq_skips_stacked_biases: 2-D
    stacked biases large enough for the size gate."""
    rng = np.random.default_rng(0)
    return {"layers": {
        "wq": rng.normal(size=(4, 64, 64)).astype(np.float32),
        "b_q": rng.normal(size=(4, 4096)).astype(np.float32),
        "attn_norm_b": rng.normal(size=(4, 4096)).astype(np.float32)},
        "embed": rng.normal(size=(100, 64)).astype(np.float32)}


def _leaves_by_path(tree, is_q):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_q)[0]
    return {tuple(p.key for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("tree,block", [("tiny", 2048), ("tiny_bias", 2048),
                                        ("biases", 128)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_matches_jax(tree, block, bits):
    np_params = {"tiny": lambda: _tiny_tree(False),
                 "tiny_bias": lambda: _tiny_tree(True),
                 "biases": _bias_tree}[tree]()
    jq, jmeta = JW.quantize_params(jax.tree.map(jnp.asarray, np_params),
                                   bits=bits, block=block)
    tq, tmeta = TW.quantize_params(params_from_numpy(np_params), bits=bits,
                                   block=block)
    assert tmeta == jmeta
    jl = _leaves_by_path(jq, JW._is_qleaf)
    tl = dict(TW._flatten(tq))
    assert set(jl) == set(tl)
    for path, j in jl.items():
        t = tl[path]
        assert isinstance(t, TW.QuantizedTensor) == JW._is_qleaf(j), path
        if JW._is_qleaf(j):
            assert (t.shape, t.bits, t.stacked) == (j.shape, j.bits,
                                                    j.stacked)
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert TW.quantized_nbytes(tq) == JW.quantized_nbytes(jq)
    jd = _leaves_by_path(JW.dequantize_params(jq), None)
    td = dict(TW._flatten(TW.dequantize_params(tq)))
    for path, j in jd.items():
        np.testing.assert_array_equal(td[path].numpy(), np.asarray(j))
    if tree == "biases":
        assert tmeta["n_quantized"] == 2      # wq and embed, no bias


def test_quantized_tensor_layer_slices():
    """``t[l]`` is layer l over views of the stack, and dequantizes to
    layer l of the whole stack's dequantization."""
    tq, _ = TW.quantize_params(params_from_numpy(_tiny_tree(False)), bits=4)
    w = tq["layers"]["w_gate"]
    full = w.dequantize()
    assert tuple(full.shape) == (w.q.shape[0], *w.shape)
    one = w[1]
    assert one.q.data_ptr() == w.q[1].data_ptr() and not one.stacked
    assert torch.equal(one.dequantize(), full[1])
    with pytest.raises(TypeError):
        one[0]


@pytest.mark.parametrize("bits", [16, 2, 0])
def test_quantize_params_rejects_other_widths(bits):
    with pytest.raises(ValueError, match="quant_bits must be 4 or 8"):
        TW.quantize_params(params_from_numpy(_bias_tree()), bits=bits)

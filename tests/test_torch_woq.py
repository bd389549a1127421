"""PyTorch port: weight-only quantized serving (``quant_bits`` 8 / 4).

The same weights (initialized by the JAX package, moved by name through
``params_from_numpy``) and the same prompts go through ``deepspeed_tpu``
and ``deepspeed_tpu_torch`` on the CPU in fp32. The quantized weights are
bit-equal to the JAX package's (``tests/test_torch_quantizer.py``), so
held equal here:

* the v2 engine under ``quant_bits`` 8 and 4: the quantized leaves and
  their bytes, put() logits (2e-4) and greedy generate() streams
  token-identical to the JAX WOQ engine's, also over the int8 KV pool
  (``kv_quant``);
* ``init_inference(use_ragged=True, quant_bits=8)`` and ``pipeline()``
  streams identical to the JAX entry points';
* the v1 ``init_inference(quant_bits=8)``: forward() logits and generate()
  streams against JAX's v1 engine;
* a WOQ engine against a dense engine built from its dequantized weights
  (logits equal), the number of dequantizations a call makes (the layer
  loop one layer at a time, the embedding and head once per call or
  window), and the rejected configurations.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

import deepspeed_tpu
from deepspeed_tpu.inference import quantization as JW
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JSM
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.models.transformer import tiny_test as jax_tiny_test

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference import quantization as TW
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.ops import quantizer_kernels as TK

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

BS = 16
SM = dict(max_tracked_sequences=8, max_seq_len=128, num_blocks=65,
          block_size=BS)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
# the 7 per-layer matrices of a gated-MLP layer, plus embed and lm_head
QUANTIZED = {("layers", k) for k in ("wq", "wk", "wv", "wo", "w_gate",
                                     "w_up", "w_down")} | {("embed",),
                                                          ("lm_head",)}


@pytest.fixture(scope="module")
def models():
    """tiny_test widths (hidden 128, 2 layers), 4 q heads over 2 kv heads:
    every weight matrix holds >= 4096 elements, so all 9 quantize."""
    jcfg = dataclasses.replace(jax_tiny_test(), num_kv_heads=2)
    jmodel = JModel(jcfg)
    np_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             jmodel.init_params(jax.random.PRNGKey(0)))
    tmodel = TransformerLM(TransformerConfig(**dataclasses.asdict(jcfg)))
    return jmodel, np_params, tmodel, params_from_numpy(np_params)


def _jax_engine(models, bits, kv_quant=False):
    jmodel, np_params, _, _ = models
    return JEngine(jmodel, JConfig(state_manager=JSM(**SM), dtype="float32",
                                   prefill_bucket=16, decode_window=8,
                                   quant_bits=bits, kv_quant=kv_quant),
                   params=np_params)


def _torch_engine(models, bits, kv_quant=False, params=None):
    _, _, tmodel, tparams = models
    return InferenceEngineV2(
        tmodel, RaggedInferenceEngineConfig(
            state_manager=DSStateManagerConfig(**SM), dtype="float32",
            prefill_bucket=16, decode_window=8, quant_bits=bits,
            kv_quant=kv_quant),
        params=tparams if params is None else params, device="cpu")


@pytest.fixture(scope="module")
def jax_engines(models):
    # module-scoped: each JAX engine compiles its programs once
    return {bits: _jax_engine(models, bits) for bits in (8, 4)}


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, n))) for n in lengths]


def _quantized_paths(params):
    out = set()
    for path, leaf in TW._flatten(params):
        if isinstance(leaf, TW.QuantizedTensor):
            out.add(path)
    return out


# ---------------------------------------------------------------------------
# the v2 engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
def test_woq_engine_weights_match_jax(models, jax_engines, bits):
    je, te = jax_engines[bits], _torch_engine(models, bits)
    assert _quantized_paths(te.params) == QUANTIZED
    assert te._qmeta == je._qmeta
    assert TW.quantized_nbytes(te.params) == JW.quantized_nbytes(je.params)
    for name in ("w_gate", "wk"):
        jq, tq = je.params["layers"][name], te.params["layers"][name]
        assert tq.stacked and tq.bits == bits and tq.shape == jq.shape
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))


@pytest.mark.parametrize("bits", [8, 4])
def test_woq_put_logits_match_jax(models, jax_engines, bits):
    je, te = jax_engines[bits], _torch_engine(models, bits)
    prompts = _prompts(0, (9, 25, 4))
    a = np.asarray(je.put([1, 2, 3], prompts))
    b = te.put([1, 2, 3], prompts)
    np.testing.assert_allclose(b, a, **LOGIT_TOL)
    # decode rows over the cached prompts
    a = np.asarray(je.put([1, 2, 3], [[5], [6], [7]]))
    b = te.put([1, 2, 3], [[5], [6], [7]])
    np.testing.assert_allclose(b, a, **LOGIT_TOL)
    for u in (1, 2, 3):
        je.flush(u)
        te.flush(u)


@pytest.mark.parametrize("bits,kv_quant", [(8, False), (4, False),
                                           (8, True), (4, True)])
def test_woq_generate_streams_match_jax(models, jax_engines, bits, kv_quant):
    prompts = _prompts(1, (9, 25, 4, 17))
    # kv_quant: fresh engines on both sides (a freed block keeps its scale)
    je = (_jax_engine(models, bits, kv_quant=True) if kv_quant
          else jax_engines[bits])
    a = je.generate(prompts, max_new_tokens=20)
    b = _torch_engine(models, bits, kv_quant=kv_quant).generate(
        prompts, max_new_tokens=20)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bits", [8, 4])
def test_woq_engine_equals_dense_engine_of_its_weights(models, bits):
    """Dequantizing per call changes nothing: a dense engine built from the
    WOQ engine's dequantized weights gives the same logits and streams."""
    woq = _torch_engine(models, bits)
    dense = _torch_engine(models, 0, params=TW.dequantize_params(woq.params))
    prompts = _prompts(2, (9, 25, 4))
    np.testing.assert_array_equal(woq.put([1, 2, 3], prompts),
                                  dense.put([1, 2, 3], prompts))
    for e in (woq, dense):
        for u in (1, 2, 3):
            e.flush(u)
    for x, y in zip(woq.generate(prompts, max_new_tokens=12),
                    dense.generate(prompts, max_new_tokens=12)):
        np.testing.assert_array_equal(x, y)


def test_woq_dequantizes_one_layer_at_a_time(models, monkeypatch):
    """Per ragged step and per decode step the layer loop dequantizes the
    7 matrices of each layer; the embedding and head are dequantized once
    per put() and once per fused decode window (the counts the card run
    asserts as kernel launches)."""
    te = _torch_engine(models, 8)
    L = te.model.cfg.num_layers
    calls = []
    real = TK.dequantize_blocks

    def spy(q, s, out_dtype=torch.float32, n=None):
        calls.append(n)
        return real(q, s, out_dtype, n)

    monkeypatch.setattr(TK, "dequantize_blocks", spy)
    prompts = _prompts(3, (9, 25, 4))
    te.put([1, 2, 3], prompts)
    assert len(calls) == 7 * L + 2
    for u in (1, 2, 3):
        te.flush(u)
    calls.clear()
    r0, w0, d0 = te.ragged_steps, te.decode_windows, te.decode_steps
    te.generate(prompts, max_new_tokens=12)
    ragged, windows = te.ragged_steps - r0, te.decode_windows - w0
    steps = te.decode_steps - d0
    assert (ragged, windows, steps) == (1, 2, 16)
    assert len(calls) == 7 * L * (ragged + steps) + 2 * (ragged + windows)


def test_woq_init_inference_and_pipeline_match_jax(models):
    jmodel, np_params, tmodel, tparams = models
    prompts = _prompts(4, (9, 25, 4))
    ragged = {"prefill_bucket": 16, "decode_window": 8, "state_manager": SM}
    je = deepspeed_tpu.init_inference(
        jmodel, config={"dtype": "fp32", "use_ragged": True,
                        "quant_bits": 8, "ragged": ragged},
        params=np_params)
    te = deepspeed_tpu_torch.init_inference(
        tmodel, config={"dtype": "fp32", "use_ragged": True,
                        "quant_bits": 8, "ragged": ragged},
        params=tparams, device="cpu")
    assert isinstance(te, InferenceEngineV2) and te.config.quant_bits == 8
    assert _quantized_paths(te.params) == QUANTIZED
    for x, y in zip(je.generate(prompts, max_new_tokens=12),
                    te.generate(prompts, max_new_tokens=12)):
        np.testing.assert_array_equal(x, y)
    jpipe = deepspeed_tpu.ServePipeline(je)
    tpipe = deepspeed_tpu_torch.pipeline(
        tmodel.cfg, params=tparams, device="cpu", quant_bits=8,
        config={"dtype": "float32", "ragged": ragged})
    assert tpipe.engine.config.quant_bits == 8
    for x, y in zip(jpipe(prompts, max_new_tokens=12),
                    tpipe(prompts, max_new_tokens=12)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the v1 engine
# ---------------------------------------------------------------------------
def test_woq_v1_engine_matches_jax(models):
    jmodel, np_params, tmodel, tparams = models
    je = deepspeed_tpu.init_inference(
        jmodel, config={"dtype": "fp32", "quant_bits": 8}, params=np_params)
    te = deepspeed_tpu_torch.init_inference(
        tmodel, config={"dtype": "fp32", "quant_bits": 8}, params=tparams,
        device="cpu")
    assert _quantized_paths(te.params) == QUANTIZED
    ids = np.asarray(_prompts(5, (12, 12, 12)))
    np.testing.assert_allclose(te.forward(ids).numpy(),
                               np.asarray(je.forward(ids)), **LOGIT_TOL)
    np.testing.assert_array_equal(te.generate(ids, max_new_tokens=16),
                                  np.asarray(je.generate(
                                      ids, max_new_tokens=16)))


# ---------------------------------------------------------------------------
# rejected configurations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{"tensor_parallel_size": 2},
                                {"expert_parallel_size": 2}])
def test_woq_rejects_parallel_serving(kw):
    with pytest.raises(ValueError, match="quant_bits"):
        RaggedInferenceEngineConfig(quant_bits=8, **kw)


def test_woq_rejects_other_bit_widths(models):
    _, _, tmodel, tparams = models
    with pytest.raises(ValueError, match="quant_bits must be 4 or 8"):
        _torch_engine(models, 16)
    with pytest.raises(ValueError, match="quant_bits must be 4 or 8"):
        deepspeed_tpu_torch.init_inference(
            tmodel, config={"dtype": "fp32", "quant_bits": 16},
            params=tparams, device="cpu")

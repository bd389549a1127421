"""PyTorch port: the v1 dense-cache engine behind ``init_inference()``.

The same weights (initialized by the JAX package, moved by name through
``params_from_numpy``) and the same numpy inputs go through
``deepspeed_tpu`` and ``deepspeed_tpu_torch`` on the CPU in fp32; the JAX
dense decode kernel runs in interpret mode, as its own tests run it. Held
equal:

* ``dense_decode_attention_plain`` against the JAX ``dense_decode_attention``
  kernel: GQA groups 1, 2 and 4, cache lengths that are no multiple of the
  kernel's block with unequal row lengths (2e-5, the JAX tests' tolerance),
  and a bf16 cache (2e-2);
* ``TransformerLM.forward_cached`` prefill and decode logits against JAX
  and against the port's own uncached ``forward_logits`` (1e-4);
* ``InferenceEngine.generate`` greedy streams token-identical to JAX's,
  with the decode kernel and without it, and with an EOS cut;
* ``_sample``'s top-k / top-p masking equal to JAX's (the draw itself uses a
  seeded ``torch.Generator``: repeatable, not JAX's threefry bits);
* the ``generate`` limit errors and ``init_inference``'s routing.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JInfConfig
from deepspeed_tpu.inference import InferenceEngine as JInferenceEngine
from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.models import TransformerConfig as JConfig
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.ops.decode_attention import \
    dense_decode_attention as jax_dense_decode

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference import engine as tengine
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.ops.decode_attention import (
    dense_decode_attention, dense_decode_attention_plain)

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _jcfg(**kw):
    base = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64,
                use_flash=False, remat=False)
    base.update(kw)
    return JConfig(**base)


@pytest.fixture(scope="module")
def weights():
    jcfg = _jcfg()
    np_params = jax.tree.map(
        lambda x: np.asarray(x, np.float32),
        JModel(jcfg).init_params(jax.random.PRNGKey(0)))
    return jcfg, np_params, params_from_numpy(np_params)


def _engines(weights, decode_kernel=True, **cfg_kw):
    jcfg, np_params, tparams = weights
    jcfg = dataclasses.replace(jcfg, decode_kernel=decode_kernel)
    je = JInferenceEngine(
        JModel(jcfg), JInfConfig.from_dict_or_kwargs(
            None, dict(dtype="float32", **cfg_kw)), params=np_params)
    te = deepspeed_tpu_torch.init_inference(
        TransformerLM(TransformerConfig(**dataclasses.asdict(jcfg))),
        config=dict(dtype="float32", **cfg_kw), params=tparams,
        device="cpu")
    return je, te


@pytest.fixture(scope="module")
def engines(weights):
    return {dk: _engines(weights, dk) for dk in (True, False)}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# dense decode attention
# ---------------------------------------------------------------------------
def _decode_inputs(rng, B, nh, kvh, M, hd):
    q = rng.normal(size=(B, nh, hd)).astype(np.float32)
    kc = rng.normal(size=(B, kvh, M, hd)).astype(np.float32)
    vc = rng.normal(size=(B, kvh, M, hd)).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("nh,kvh", [(4, 4), (4, 2), (8, 2)])  # groups 1,2,4
def test_dense_decode_plain_matches_jax_kernel(nh, kvh):
    rng = np.random.default_rng(0)
    q, kc, vc = _decode_inputs(rng, 3, nh, kvh, 64, 16)
    lengths = np.array([1, 17, 64], np.int32)
    ref = np.asarray(jax_dense_decode(*map(jnp.asarray, (q, kc, vc, lengths)),
                                      block_kv=16))
    out = dense_decode_attention_plain(*_t(q, kc, vc, lengths)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("M,block", [(48, 32), (20, 256), (300, 256)])
def test_dense_decode_plain_nondivisible_cache(M, block):
    rng = np.random.default_rng(1)
    q, kc, vc = _decode_inputs(rng, 2, 4, 2, M, 16)
    lengths = np.array([max(1, M - 7), M], np.int32)
    ref = np.asarray(jax_dense_decode(*map(jnp.asarray, (q, kc, vc, lengths)),
                                      block_kv=block))
    out = dense_decode_attention_plain(*_t(q, kc, vc, lengths)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_dense_decode_plain_bf16_cache():
    rng = np.random.default_rng(2)
    q, kc, vc = _decode_inputs(rng, 2, 4, 2, 32, 8)
    lengths = np.array([5, 32], np.int32)
    ref = np.asarray(jax_dense_decode(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, kc, vc)),
        jnp.asarray(lengths), block_kv=16), np.float32)
    qt, kt, vt, lt = _t(q, kc, vc, lengths)
    out = dense_decode_attention_plain(qt.bfloat16(), kt.bfloat16(),
                                       vt.bfloat16(), lt)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)


def test_dense_decode_wrapper_takes_plain_on_cpu_uncounted():
    rng = np.random.default_rng(3)
    args = _t(*_decode_inputs(rng, 2, 4, 2, 24, 16),
              np.array([0, 9], np.int32))
    before = dense_decode_attention.launches
    out = dense_decode_attention(*args)
    assert torch.equal(out, dense_decode_attention_plain(*args))
    assert (out[0] == 0).all()          # a row of length 0 writes zeros
    assert dense_decode_attention.launches == before
    meta = torch.empty((2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dense_decode_attention(meta, meta, meta, meta)


@pytest.mark.parametrize("case", ["accepted", "dtype", "int64", "strided",
                                  "shape", "row_bytes"])
def test_dense_decode_kernel_argument_checks(case):
    from deepspeed_tpu_torch.ops.decode_attention import _check_args

    q = torch.zeros((2, 4, 16), dtype=torch.bfloat16)
    c = torch.zeros((2, 2, 10, 16), dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32)
    args, exc = (q, c, c.clone(), lens), ValueError
    if case == "dtype":
        args, exc = (q, c.float(), c.float(), lens), TypeError
    elif case == "int64":
        args, exc = (q, c, c, lens.long()), TypeError
    elif case == "strided":
        args = (q, c.transpose(2, 3), c, lens)
    elif case == "shape":
        args = (q, c[:1], c[:1], lens)
    elif case == "row_bytes":          # 3 bf16 = 6-byte rows
        args = (q[..., :3].contiguous(), c[..., :3].contiguous(),
                c[..., :3].contiguous(), lens)
    if case == "accepted":
        _check_args(*args)
        return
    with pytest.raises(exc):
        _check_args(*args)


# ---------------------------------------------------------------------------
# forward_cached
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decode_kernel", [True, False])
def test_forward_cached_matches_jax_and_full_forward(weights, decode_kernel):
    jcfg, np_params, tparams = weights
    jcfg = dataclasses.replace(jcfg, decode_kernel=decode_kernel)
    jmodel = JModel(jcfg)
    tmodel = TransformerLM(TransformerConfig(**dataclasses.asdict(jcfg)))
    jparams = jax.tree.map(jnp.asarray, np_params)
    ids = np.random.default_rng(4).integers(0, 64, (2, 10))
    full = tmodel.forward_logits(tparams, torch.from_numpy(ids)).float()
    jcache = jmodel.init_kv_cache(2, 16, jnp.float32)
    tcache = tmodel.init_kv_cache(2, 16, torch.float32, "cpu")
    with torch.no_grad():
        jl, jcache = jax.jit(
            lambda p, x, c: jmodel.forward_cached(p, x, c, 0))(
                jparams, jnp.asarray(ids[:, :6]), jcache)
        tl = tmodel.forward_cached(tparams, torch.from_numpy(ids[:, :6]),
                                   tcache, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, :6].numpy(),
                                   **LOGIT_TOL)
        step = jax.jit(lambda p, x, c, pos: jmodel.forward_cached(
            p, x, c, pos), static_argnums=3)
        for i in range(6, 10):
            jl, jcache = step(jparams, jnp.asarray(ids[:, i:i + 1]), jcache,
                              i)
            tl = tmodel.forward_cached(tparams,
                                       torch.from_numpy(ids[:, i:i + 1]),
                                       tcache, i)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
            np.testing.assert_allclose(tl[:, 0].numpy(), full[:, i].numpy(),
                                       **LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **LOGIT_TOL)


@pytest.mark.parametrize("kw,item", [
    (dict(moe_num_experts=2), "A8"), (dict(positional="alibi"), "A6d"),
    (dict(parallel_residual=True), "A6d")])
def test_cached_forward_families_not_ported_raise(kw, item):
    model = TransformerLM(TransformerConfig(**dataclasses.asdict(
        _jcfg(**kw))))
    if "moe_num_experts" in kw:
        # MoE generation is ported now (tests/test_torch_moe.py)
        cache = model.init_kv_cache(1, 8, torch.float32, "cpu")
        assert cache["k"].shape[0] == model.cfg.num_layers
        return
    with pytest.raises(NotImplementedError, match=item):
        model.init_kv_cache(1, 8, torch.float32, "cpu")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decode_kernel", [True, False])
def test_generate_greedy_streams_match_jax(engines, decode_kernel):
    je, te = engines[decode_kernel]
    prompts = np.random.default_rng(5).integers(1, 64, (3, 7))
    a = je.generate(prompts, max_new_tokens=12)
    b = te.generate(prompts, max_new_tokens=12)
    assert b.dtype == np.int32 and b.shape == (3, 19)
    np.testing.assert_array_equal(b, a)


def test_generate_eos_cut_matches_jax(engines):
    je, te = engines[True]
    prompts = np.random.default_rng(6).integers(1, 64, (2, 5))
    ref = je.generate(prompts, max_new_tokens=10)
    eos = int(ref[0, 5 + 2])                     # row 0's third token
    a = je.generate(prompts, max_new_tokens=10, eos_token_id=eos)
    b = te.generate(prompts, max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(b, a)
    assert (b[0, 5 + 2:] == eos).all()           # EOS fills the rest


def test_forward_matches_jax(engines):
    je, te = engines[True]
    ids = np.random.default_rng(7).integers(0, 64, (2, 9))
    np.testing.assert_allclose(te.forward(ids).numpy(),
                               np.asarray(je.forward(ids)), **LOGIT_TOL)


def test_decode_loop_skips_the_last_forward(engines, monkeypatch):
    """max_new_tokens tokens take one prefill and max_new_tokens - 1
    decode forwards, as the JAX loop's cond skips the last."""
    _, te = engines[True]
    calls = []
    orig = te.model.forward_cached
    monkeypatch.setattr(te.model, "forward_cached",
                        lambda *a: calls.append(a[1].shape[1]) or orig(*a))
    te.generate(np.array([[1, 2, 3]]), max_new_tokens=5)
    assert calls == [3, 1, 1, 1, 1]


def test_sample_masking_matches_jax(monkeypatch):
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(4, 50)).astype(np.float32) * 3
    # JAX's _sample with the categorical draw replaced by the identity
    # returns its masked logits
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, lg, axis=-1: lg)
    for temperature, top_k, top_p in ((0.7, 0, 0.0), (0.9, 10, 0.0),
                                      (1.3, 0, 0.8), (0.8, 20, 0.9)):
        ref = np.asarray(jengine._sample(jnp.asarray(logits), None,
                                         temperature, top_k, top_p))
        out = tengine._mask_logits(torch.from_numpy(logits), temperature,
                                   top_k, top_p).numpy()
        np.testing.assert_array_equal(out == -1e30, ref == -1e30)
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_sample_draw_repeats_under_a_seed():
    logits = torch.from_numpy(
        np.random.default_rng(9).normal(size=(6, 40)).astype(np.float32))

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.stack([tengine._sample(logits, gen, 0.9, 8, 0.95)
                            for _ in range(5)])

    a, b = draw(3), draw(3)
    assert torch.equal(a, b) and a.dtype == torch.int32
    allowed = tengine._mask_logits(logits, 0.9, 8, 0.95) > -1e30
    assert allowed.gather(1, a.long().T).all()     # draws stay in the mask
    assert torch.equal(tengine._sample(logits, None, 0.0, 0, 0.0),
                       logits.argmax(-1).int())


def test_generate_sampled_repeats_under_a_seed(engines):
    _, te = engines[True]
    p = np.array([[4, 5, 6], [7, 8, 9]])
    kw = dict(max_new_tokens=6, temperature=0.8, top_k=10, top_p=0.9)
    a = te.generate(p, seed=3, **kw)
    np.testing.assert_array_equal(a, te.generate(p, seed=3, **kw))
    assert ((a >= 0) & (a < 64)).all()


@pytest.mark.parametrize("cfg_kw,call_kw", [
    (dict(max_batch_size=2), dict(input_ids=np.ones((3, 4), np.int64))),
    (dict(max_out_tokens=10), dict(input_ids=np.ones((1, 6), np.int64),
                                   max_new_tokens=5)),
    (dict(min_out_tokens=4), dict(input_ids=np.ones((1, 2), np.int64),
                                  max_new_tokens=3))])
def test_generate_limit_errors_match_jax(weights, cfg_kw, call_kw):
    je, te = _engines(weights, **cfg_kw)
    with pytest.raises(ValueError) as ja:
        je.generate(**call_kw)
    with pytest.raises(ValueError) as ta:
        te.generate(**call_kw)
    assert str(ta.value) == str(ja.value)


def test_init_inference_routes_v1_and_v2(weights, monkeypatch):
    jcfg, _, tparams = weights
    model = TransformerLM(TransformerConfig(**dataclasses.asdict(jcfg)))
    v1 = deepspeed_tpu_torch.init_inference(model, params=tparams,
                                            dtype="fp32", device="cpu")
    assert isinstance(v1, InferenceEngine)
    assert (v1.config.max_out_tokens, v1.config.min_out_tokens,
            v1.config.max_batch_size, v1.config.seed) == (1024, 1, 8, 0)
    assert v1.params["embed"].dtype == torch.float32
    v2 = deepspeed_tpu_torch.init_inference(
        model, params=tparams, device="cpu",
        config={"dtype": "fp32", "use_ragged": True})
    assert isinstance(v2, InferenceEngineV2)
    # no weights given: seeded init in the engine's dtype
    seeded = deepspeed_tpu_torch.init_inference(model, dtype="bf16", seed=1,
                                                device="cpu")
    assert seeded.params["embed"].dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(model, params=tparams)


def test_v1_config_fields_match_jax():
    fields = set(DeepSpeedInferenceConfig.__dataclass_fields__)
    jfields = set(JInfConfig.__dataclass_fields__)
    # enable_cuda_graph and replace_with_kernel_inject are read by nothing
    # in the port yet (ROADMAP A6e): they take the unknown-key warning
    assert jfields - fields == {"enable_cuda_graph",
                                "replace_with_kernel_inject"}
    assert fields <= jfields
    for name in fields - {"tensor_parallel"}:
        assert getattr(DeepSpeedInferenceConfig(), name) == \
            getattr(JInfConfig(), name), name

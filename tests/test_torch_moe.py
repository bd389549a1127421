"""PyTorch port: mixture-of-experts against the JAX package.

The same numpy inputs and weights (the JAX package's, moved by name
through ``checkpoint.interop.params_from_numpy``) go through
``deepspeed_tpu`` and ``deepspeed_tpu_torch`` on the CPU, in f32:

* gating (``_capacity``, ``top1gating``, ``top2gating``): masks equal,
  combine and aux within 1e-6, with inputs that drop tokens;
* ``moe_layer`` (identity and SwiGLU experts), ``moe_layer_dropless``,
  ``dropless_topk_dispatch`` at k 1 / 2 / 4 (the training and serving
  routes; serving reads no size on the host),
  ``residual_moe_combine``: 1e-5;
* the ``MoE`` facade without noise (1e-5); RSample's routing drawn as
  softmax probabilities (a Gumbel-max check), Jitter inert as in JAX;
* ``TransformerLM`` loss + aux for top-1, top-2, residual and dropless
  (1e-5 relative), and 4 engine steps at ZeRO 0 and 1 (1e-5 relative);
* the v2 engine at top_k 1 / 2 / 4 and residual (put() logits 2e-4,
  greedy streams token-identical), WOQ int8 / int4 MoE engines and v1
  ``generate()`` against JAX's, ``mixtral_8x7b()`` field for field;
* what still raises: expert- / tensor-parallel serving and pp x MoE.

The multi-rank cases (global gating at dp 2, ep 2 under ZeRO 1 and 3,
expert checkpoints) are ``tests/test_torch_moe_distributed.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jmoe

from deepspeed_tpu_torch.checkpoint.interop import (params_from_numpy,
                                                    params_to_numpy)
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tmoe

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

H, F, E = 64, 96, 4


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _skewed_logits(seed, T, E):
    # expert 0 favoured: capacity 1.0 drops tokens there
    lg = _rand(seed, (T, E))
    lg[:, 0] += 1.5
    return lg


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,E_,cf,mc", [(64, 4, 1.0, 4), (10, 8, 1.25, 4),
                                        (3, 4, 1.0, 1), (128, 8, 2.0, 16)])
def test_capacity_matches_jax(T, E_, cf, mc):
    assert tmoe._capacity(T, E_, cf, mc) == jmoe._capacity(T, E_, cf, mc)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.0, 2.0])
def test_gating_matches_jax(top_k, cf):
    logits = _skewed_logits(top_k * 10 + int(cf * 4), 96, 8)
    if top_k == 1:
        ja, jc, jd = jax.jit(lambda l: jmoe.top1gating(l, cf, 4))(logits)
        ta, tc, td = tmoe.top1gating(_t(logits), cf, 4)
    else:
        ja, jc, jd = jax.jit(lambda l: jmoe.top2gating(l, cf, 4))(logits)
        ta, tc, td = tmoe.top2gating(_t(logits), cf, 4)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    if cf <= 1.0:       # the skew drops tokens at these capacities
        assert float(np.asarray(jd).sum()) < 96 * top_k


def test_gating_refuses_dropless():
    with pytest.raises(NotImplementedError, match="dropless"):
        tmoe.top1gating(torch.zeros(4, 2), drop_tokens=False)
    with pytest.raises(NotImplementedError, match="dropless"):
        tmoe.top2gating(torch.zeros(4, 2), drop_tokens=False)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def _experts(seed, e=E):
    return (_rand(seed, (e, H, F), 0.1), _rand(seed + 1, (e, H, F), 0.1),
            _rand(seed + 2, (e, F, H), 0.1))


def _jswiglu(p, xe):
    g_, u_, d_ = p
    return (jax.nn.silu(xe @ g_) * (xe @ u_)) @ d_


def test_moe_layer_identity_experts_matches_jax():
    x = _rand(0, (2, 16, 16))
    gate_w = _rand(1, (16, E))
    eye = np.broadcast_to(np.eye(16, dtype=np.float32), (E, 16, 16)).copy()
    jo, ja = jax.jit(lambda x, g, w: jmoe.moe_layer(
        x, g, w, lambda p, xe: xe @ p, None, top_k=1,
        capacity_factor=1.0))(x, gate_w, eye)
    to, ta = tmoe.moe_layer(_t(x), _t(gate_w), _t(eye),
                            lambda p, xe: xe @ p, None, top_k=1,
                            capacity_factor=1.0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    # the capacity dropped tokens: their output rows are zero
    assert (np.abs(np.asarray(jo)).sum(-1) == 0).any()


@pytest.mark.parametrize("top_k,cf", [(1, 1.0), (2, 1.0), (2, 0.5)])
def test_moe_layer_swiglu_matches_jax(top_k, cf):
    x = _rand(3, (2, 24, H))
    gate_w = _rand(4, (H, E))
    ex = _experts(5)
    jo, ja = jax.jit(lambda x, g, ex: jmoe.moe_layer(
        x, g, ex, _jswiglu, None, top_k=top_k, capacity_factor=cf,
        min_capacity=2))(x, gate_w, ex)
    to, ta = tmoe.moe_layer(_t(x), _t(gate_w), tuple(map(_t, ex)),
                            tmoe.swiglu_experts, None, top_k=top_k,
                            capacity_factor=cf, min_capacity=2)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_moe_layer_dropless_matches_jax():
    x = _rand(6, (2, 16, H))
    gate_w = _rand(7, (H, E))
    ex = _experts(8)
    jo, ja = jax.jit(lambda x, g, ex: jmoe.moe_layer_dropless(x, g, ex))(
        x, gate_w, ex)
    to, ta = tmoe.moe_layer_dropless(_t(x), _t(gate_w), tuple(map(_t, ex)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("route", ["grouped", "serve"])
def test_dropless_topk_dispatch_matches_jax(k, route):
    T = 40
    xt = _rand(9 + k, (T, H))
    gates = jax.nn.softmax(_rand(10 + k, (T, 8)), -1)
    topv, topi = jax.lax.top_k(gates, k)
    ex = _experts(11, e=8)
    jo = jax.jit(lambda xt, i, v, ex: jmoe.dropless_topk_dispatch(
        xt, i, v, ex, 8))(xt, topi, topv, ex)
    ti, tv = torch.from_numpy(np.array(topi)).long(), _t(topv)
    if route == "grouped":
        to = tmoe.dropless_topk_dispatch(_t(xt), ti, tv, tuple(map(_t, ex)),
                                         8)
    else:
        to = tmoe.serve_topk_experts(_t(xt), ti, tv, tuple(map(_t, ex)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("T", [1, 8, 80])
def test_serve_moe_reads_no_size_on_the_host(T, monkeypatch):
    """The serving route keeps its group offsets on the device, so a decode
    window needs no sync: no tensor is read on the host inside it, also
    when an expert gets no row."""
    xt, gate_w = _t(_rand(30, (T, H))), _t(_rand(31, (H, 8)))
    ex = tuple(map(_t, _experts(32, e=8)))
    ref = tmoe.serve_moe(xt, gate_w, ex, 2, False, True)

    def refuse(*_a, **_k):
        raise AssertionError("a tensor was read on the host")

    for name in ("tolist", "item", "__bool__", "__int__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = tmoe.serve_moe(xt, gate_w, ex, 2, False, True)
    monkeypatch.undo()
    assert torch.equal(out, ref)


def test_residual_moe_combine_matches_jax():
    x, mo, ml = _rand(13, (2, 8, H)), _rand(14, (2, 8, H)), \
        _rand(15, (2, 8, H))
    cw, cb = _rand(16, (H, 2)), _rand(17, (2,))
    jo = jax.jit(jmoe.residual_moe_combine)(x, mo, ml, cw, cb)
    to = tmoe.residual_moe_combine(_t(x), _t(mo), _t(ml), _t(cw), _t(cb))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)


def test_dropless_ep_and_manual_raise():
    g = tmoe.MoEGroups(ep=2)
    with pytest.raises(NotImplementedError, match="moe_layer_dropless_ep"):
        tmoe.moe_layer_dropless(torch.zeros(1, 2, H), torch.zeros(H, E),
                                tuple(map(_t, _experts(0))), groups=g)
    # moe_layer_manual is ported now (the pipeline's pp x ep dispatch;
    # tests/test_torch_pipeline*.py): it refuses experts that the expert
    # group cannot split evenly
    with pytest.raises(ValueError, match="not divisible by ep"):
        tmoe.moe_layer_manual(torch.zeros(1, 2, H), torch.zeros(H, E),
                              tuple(map(_t, _experts(0))),
                              tmoe.swiglu_experts, tmoe.MoEGroups(ep=3))


# ---------------------------------------------------------------------------
# the MoE facade
# ---------------------------------------------------------------------------
def _facade_params(layer, seed):
    jp = layer.init_params(jax.random.PRNGKey(seed))
    return jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("kw", [dict(k=2, capacity_factor=2.0),
                                dict(k=1, use_residual=True),
                                dict(k=1, drop_tokens=False),
                                dict(k=1, capacity_factor=0.5)])
def test_moe_facade_matches_jax(kw):
    j = jlayer.MoE(hidden_size=16, intermediate_size=32, num_experts=4, **kw)
    t = tlayer.MoE(hidden_size=16, intermediate_size=32, num_experts=4, **kw)
    jp, tp = _facade_params(j, 3)
    x = _rand(18, (2, 8, 16))
    jo, ja = j(jp, jnp.asarray(x))
    to, ta = t(tp, _t(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_moe_facade_init_shapes_match_jax():
    kw = dict(hidden_size=16, intermediate_size=32, num_experts=4,
              use_residual=True)
    jp = jlayer.MoE(**kw).init_params(jax.random.PRNGKey(0))
    tp = tlayer.MoE(**kw).init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def test_moe_facade_rsample_routes_by_softmax():
    """Gumbel-max: RSample's top-1 expert is drawn with the softmax
    probabilities of the router logits (threefry's bits cannot match, so
    this is the check)."""
    t = tlayer.MoE(hidden_size=4, intermediate_size=8, num_experts=4,
                   noisy_gate_policy="RSample", capacity_factor=4.0)
    logits = torch.tensor([[1.0, 0.0, -1.0, 0.5]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    r = tmoe._route_top1(logits, 4.0, 4, "RSample", gen, None)
    freq = torch.bincount(r.experts[:, 0], minlength=4).float() / 4000
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(logits[0], -1).numpy(),
                               atol=0.03)
    # without noise every token takes the argmax
    r0 = tmoe._route_top1(logits, 4.0, 4, None, None, None)
    assert (r0.experts == 0).all()
    # the facade's output keeps its shape and changes with the draw
    p = t.init_params(torch.Generator().manual_seed(1))
    x = torch.randn(2, 8, 4, generator=torch.Generator().manual_seed(2))
    a, _ = t(p, x, generator=torch.Generator().manual_seed(3))
    b, _ = t(p, x, generator=torch.Generator().manual_seed(4))
    assert a.shape == x.shape and torch.isfinite(a).all()
    assert not torch.equal(a, b)


def test_moe_facade_jitter_is_inert_as_in_jax():
    kw = dict(hidden_size=16, intermediate_size=32, num_experts=4)
    jp, tp = _facade_params(jlayer.MoE(**kw), 4)
    x = _rand(19, (2, 8, 16))
    jo, _ = jlayer.MoE(noisy_gate_policy="Jitter", **kw)(
        jp, jnp.asarray(x), rng=jax.random.PRNGKey(1))
    to, _ = tlayer.MoE(noisy_gate_policy="Jitter", **kw)(
        tp, _t(x), generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(k=2, drop_tokens=False), "top-1"),
    (dict(k=1, drop_tokens=False, expert_fn=lambda p, x: x), "expert_fn"),
    (dict(k=2, noisy_gate_policy="RSample"), "top-1")])
def test_moe_facade_guards(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        tlayer.MoE(hidden_size=16, intermediate_size=32, num_experts=2, **kw)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, max_seq_len=64, use_flash=False,
             moe_num_experts=4)
ROUTINGS = {"top1": dict(moe_top_k=1, moe_capacity_factor=1.0),
            "top2": dict(moe_top_k=2),
            "residual": dict(moe_top_k=1, moe_use_residual=True),
            "dropless": dict(moe_top_k=1, moe_dropless=True)}


def _pair(**kw):
    jcfg = JCfg(**dict(SMALL, **kw))
    jm = JModel(jcfg)
    w = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = TransformerLM(TransformerConfig(**dataclasses.asdict(jcfg)))
    return jm, tm, w


def test_mixtral_preset_matches_jax():
    assert dataclasses.asdict(ttr.mixtral_8x7b()) == \
        dataclasses.asdict(jtr.mixtral_8x7b())


def test_init_params_moe_layout_matches_jax():
    for name in ROUTINGS:
        jm, tm, w = _pair(**ROUTINGS[name])
        tp = tm.init_params(torch.Generator().manual_seed(0))
        jl = {k: v.shape for k, v in w["layers"].items()}
        assert {k: tuple(v.shape) for k, v in tp["layers"].items()} == jl
    # the weights move by name, both ways
    back = params_to_numpy(params_from_numpy(w))
    for k, v in w["layers"].items():
        np.testing.assert_array_equal(back["layers"][k], v)


@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_model_loss_with_aux_matches_jax(name):
    jm, tm, w = _pair(**ROUTINGS[name])
    ids = np.random.default_rng(1).integers(0, 128, (2, 64))
    jl = float(jax.jit(lambda p, b: jm.apply(p, b))(
        w, {"input_ids": jnp.asarray(ids)}))
    tl = tm.apply(params_from_numpy(w), {"input_ids": torch.from_numpy(ids)})
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    # the aux term is in the loss
    _, aux = tm.forward_hidden_aux(params_from_numpy(w),
                                   torch.from_numpy(ids))
    assert float(aux) > 0


def test_model_gradients_match_jax():
    jm, tm, w = _pair(**ROUTINGS["top2"])
    ids = np.random.default_rng(2).integers(0, 128, (2, 64))
    jg = jax.jit(jax.grad(lambda p: jm.apply(p, {"input_ids": ids})))(w)
    tp = params_from_numpy(w)
    leaves = {k: v.requires_grad_(True) for k, v in tp["layers"].items()}
    loss = tm.apply(tp, {"input_ids": torch.from_numpy(ids)})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (k, _), g in zip(leaves.items(), grads):
        ref = np.asarray(jg["layers"][k])
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-9,
                                   err_msg=k)


def test_dropless_top2_raises():
    tm = TransformerLM(TransformerConfig(**dict(SMALL, moe_top_k=2,
                                                moe_dropless=True)))
    with pytest.raises(NotImplementedError, match="top-1"):
        tm.apply({}, {"input_ids": torch.zeros(1, 4, dtype=torch.long)})


# ---------------------------------------------------------------------------
# the training engine at one rank
# ---------------------------------------------------------------------------
def _train_config(stage):
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": 1.0,
            "zero_optimization": {"stage": stage},
            "moe": {"enabled": True, "num_experts": 4,
                    "expert_parallel_size": 1},
            "steps_per_print": 10 ** 9, "telemetry": {"enabled": False}}


@pytest.mark.parametrize("stage", [0, 1])
def test_engine_steps_match_jax(stage):
    """4 train_batch steps (gas 2, top-2, capacity 1.0 drops tokens)
    against the JAX dp=1 engine on the same weights and batches."""
    import deepspeed_tpu_torch
    from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
    from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

    kw = dict(SMALL, moe_top_k=2, moe_capacity_factor=1.0)
    jcfg = JCfg(**kw)
    jeng = JEngine(JModel(jcfg), JDSConfig(_train_config(stage),
                                           world_size=1),
                   topology=MeshTopology(TopologyConfig(),
                                         devices=jax.devices()[:1]))
    tree = jeng.master_params if jeng.has_master else jeng.params
    w = jax.tree.map(lambda a: np.array(a, np.float32), tree)
    rng = np.random.default_rng(3)
    batches = [{"input_ids": rng.integers(0, 128, (2, 2, 64))}
               for _ in range(4)]
    jl = [float(jeng.train_batch(batch=b)) for b in batches]
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**kw)),
        config=_train_config(stage), params=params_from_numpy(w),
        device="cpu")
    tl = [teng.train_batch(batch=b) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
BS = 16
SM = dict(max_tracked_sequences=8, max_seq_len=64, num_blocks=33,
          block_size=BS)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
SERVE = {"top1": dict(moe_top_k=1), "top2": dict(moe_top_k=2),
         "top4": dict(moe_top_k=4), "residual": dict(moe_top_k=2,
                                                     moe_use_residual=True)}


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 128, n))) for n in lengths]


def _engines(name, bits=0):
    from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JV2
    from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JRC
    from deepspeed_tpu.inference.v2.config_v2 import \
        DSStateManagerConfig as JSM
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.config_v2 import \
        DSStateManagerConfig

    jm, tm, w = _pair(**SERVE[name])
    common = dict(dtype="float32", prefill_bucket=16, decode_window=8,
                  quant_bits=bits)
    je = JV2(jm, JRC(state_manager=JSM(**SM), **common), params=w)
    te = InferenceEngineV2(tm, RaggedInferenceEngineConfig(
        state_manager=DSStateManagerConfig(**SM), **common),
        params=params_from_numpy(w), device="cpu")
    return je, te


@pytest.mark.parametrize("name", sorted(SERVE))
def test_v2_engine_matches_jax(name):
    je, te = _engines(name)
    prompts = _prompts(0, (9, 41, 30))
    np.testing.assert_allclose(te.put([1, 2, 3], prompts),
                               np.asarray(je.put([1, 2, 3], prompts)),
                               **LOGIT_TOL)
    # decode rows over the cached prompts
    np.testing.assert_allclose(te.put([1, 2, 3], [[5], [6], [7]]),
                               np.asarray(je.put([1, 2, 3], [[5], [6], [7]])),
                               **LOGIT_TOL)
    for u in (1, 2, 3):
        je.flush(u)
        te.flush(u)
    # greedy streams through the fused decode windows, one host sync each
    prompts = _prompts(1, (7, 12))
    syncs = te.host_syncs
    for x, y in zip(je.generate(prompts, max_new_tokens=17),
                    te.generate(prompts, max_new_tokens=17)):
        np.testing.assert_array_equal(x, y)
    assert te.host_syncs - syncs == te.decode_windows


@pytest.mark.parametrize("bits", [8, 4])
def test_woq_moe_engine_matches_jax(bits):
    from deepspeed_tpu_torch.inference import quantization as TW

    je, te = _engines("top2", bits=bits)
    for name in ("e_gate", "e_up", "e_down"):
        jq, tq = je.params["layers"][name], te.params["layers"][name]
        assert isinstance(tq, TW.QuantizedTensor) and tq.stacked
        assert tq.shape == tuple(jq.shape)
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))
        # the stacked 4-D leaf slices and dequantizes one layer at a time
        np.testing.assert_array_equal(tq[1].dequantize().numpy(),
                                      np.asarray(jq.dequantize())[1])
    prompts = _prompts(2, (9, 41, 30))
    for x, y in zip(je.generate(prompts, max_new_tokens=12),
                    te.generate(prompts, max_new_tokens=12)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["bits", "block", "dtype", "device"])
def test_kept_quantized_leaves_must_match_the_engine(case):
    """A tree quantized beforehand (as the card's Mixtral tree is, a layer
    at a time) serves only at the bits, block, dtype and device asked."""
    from deepspeed_tpu_torch.inference import quantization as TW
    from deepspeed_tpu_torch.inference.v2.engine_v2 import _cast_tree

    w = {"layers": {"e_gate": torch.randn(2, 4, 64, 96)}}
    tree, _ = TW.quantize_params(w, bits=8)
    leaf = tree["layers"]["e_gate"]
    assert TW.qblock(leaf) == 2048
    assert TW.quantize_params(tree, bits=8)[0]["layers"]["e_gate"] is leaf
    assert _cast_tree(tree, "cpu", torch.float32)["layers"]["e_gate"] is leaf
    with pytest.raises(ValueError):
        if case == "bits":
            TW.quantize_params(tree, bits=4)
        elif case == "block":
            TW.quantize_params(tree, bits=8, block=1024)
        elif case == "dtype":
            _cast_tree(tree, "cpu", torch.bfloat16)
        else:
            meta = TW.QuantizedTensor(leaf.q.to("meta"), leaf.s.to("meta"),
                                      leaf.shape, leaf.dtype, stacked=True)
            _cast_tree({"layers": {"e_gate": meta}}, "cpu", torch.float32)


def test_v1_generate_matches_jax():
    import deepspeed_tpu
    import deepspeed_tpu_torch

    jm, tm, w = _pair(**SERVE["top2"])
    je = deepspeed_tpu.init_inference(jm, config={"dtype": "fp32"},
                                      params=w)
    te = deepspeed_tpu_torch.init_inference(
        tm, config={"dtype": "fp32"}, params=params_from_numpy(w),
        device="cpu")
    ids = np.asarray(_prompts(3, (12, 12, 12)))
    np.testing.assert_allclose(te.forward(ids).numpy(),
                               np.asarray(je.forward(ids)), **LOGIT_TOL)
    np.testing.assert_array_equal(
        te.generate(ids, max_new_tokens=16),
        np.asarray(je.generate(ids, max_new_tokens=16)))


def test_mixtral_preset_serves_scaled_down():
    """mixtral_8x7b() cut to 2 layers and hidden 64 (its other fields as
    published) through pipeline() against the JAX ServePipeline."""
    import deepspeed_tpu
    import deepspeed_tpu_torch
    from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JRC
    from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JV2
    from deepspeed_tpu.inference.v2.config_v2 import \
        DSStateManagerConfig as JSM

    small = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                 num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64)
    jcfg = dataclasses.replace(jtr.mixtral_8x7b(), **small)
    assert jcfg.moe_num_experts == 8 and jcfg.moe_top_k == 2
    jm = JModel(jcfg)
    w = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
    tcfg = dataclasses.replace(ttr.mixtral_8x7b(), **small)
    ragged = {"prefill_bucket": 16, "decode_window": 8, "state_manager": SM}
    je = JV2(jm, JRC(state_manager=JSM(**SM), dtype="float32",
                     prefill_bucket=16, decode_window=8), params=w)
    pipe = deepspeed_tpu_torch.pipeline(
        tcfg, params=params_from_numpy(w), device="cpu",
        config={"dtype": "float32", "ragged": ragged})
    prompts = _prompts(4, (9, 25))
    for x, y in zip(deepspeed_tpu.ServePipeline(je)(prompts,
                                                    max_new_tokens=10),
                    pipe(prompts, max_new_tokens=10)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# what still raises (ROADMAP A8)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("field", ["expert_parallel_size",
                                   "tensor_parallel_size"])
def test_parallel_serving_still_raises(field):
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig

    # tensor-parallel serving runs now (tests/test_torch_tensor_
    # parallel.py), and so does expert-parallel serving (tests/test_torch_
    # parallel_serving.py); quant_bits still refuses either, as JAX does
    assert getattr(RaggedInferenceEngineConfig(**{field: 2}), field) == 2
    with pytest.raises(ValueError, match="quant_bits requires"):
        RaggedInferenceEngineConfig(quant_bits=8, **{field: 2})


def test_pipeline_with_moe_still_raises():
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    check_ported)

    cfg = dict(_train_config(1), pipeline={"stages": 2})
    cfg["moe"]["expert_parallel_size"] = 2
    # pp x ep is ported now (moe_layer_manual inside the 1F1B schedule;
    # tests/test_torch_pipeline_distributed.py): the config passes, and
    # what still raises is dropless routing there (test_torch_pipeline.py)
    check_ported(DeepSpeedConfig(cfg, world_size=4))


# ---------------------------------------------------------------------------
# expert parallelism's plan and refusals (no process group needed)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world,stage", [(2, 1), (4, 1), (4, 3)])
def test_zero_plan_of_expert_leaves_matches_jax(world, stage):
    """An expert leaf's ZeRO shard takes the free data axes only, on
    another dimension than the expert one (JAX partition.py:56-67); the
    port's plan is over this rank's expert slice."""
    from deepspeed_tpu.parallel.topology import MeshTopology as JTopo
    from deepspeed_tpu.parallel.topology import TopologyConfig as JTopoCfg
    from deepspeed_tpu.runtime.zero import partition as jpart
    from deepspeed_tpu_torch.runtime.zero import partition as tpart

    jm, tm, w = _pair(**ROUTINGS["top2"])
    topo = JTopo(JTopoCfg(expert=2), devices=jax.devices()[:world])
    plan = jpart.build_zero_plan(
        topo, stage, jax.tree.map(lambda a: jax.ShapeDtypeStruct(
            a.shape, a.dtype), w), base_specs=jm.param_partition_specs(topo))
    got = tpart.build_zero_plan(
        world, stage, {f"layers/{k}": (v.shape[:1] + (v.shape[1] // 2,)
                                       + v.shape[2:]
                                       if k in ("e_gate", "e_up", "e_down")
                                       else v.shape)
                       for k, v in w["layers"].items()},
        expert_dims=tm.expert_leaves, expert_world=world // 2)
    for k in ("e_gate", "e_up", "e_down", "wq", "moe_gate_w"):
        spec = tuple(plan.master_sharding["layers"][k].spec)
        spec = spec + (None,) * (w["layers"][k].ndim - len(spec))
        data = [d for d, a in enumerate(spec)
                if a is not None and "data" in (a if isinstance(a, tuple)
                                                else (a,))]
        assert got.master_dims[f"layers/{k}"] == (data[0] if data else None)


def _ep_engine(world=2, stage=1, ep=2, model_kw=None, **zero):
    from deepspeed_tpu_torch.parallel.topology import (MeshTopology,
                                                       TopologyConfig)
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedTpuEngine

    cfg = _train_config(stage)
    cfg["moe"]["expert_parallel_size"] = ep
    cfg["zero_optimization"].update(zero)
    model = TransformerLM(TransformerConfig(**dict(SMALL, **(model_kw or
                                                             {}))))
    return DeepSpeedTpuEngine(
        model, DeepSpeedConfig(cfg, world_size=world), device="cpu",
        topology=MeshTopology(TopologyConfig(expert=ep), world_size=world,
                              rank=0))


@pytest.mark.parametrize("kw,err,match", [
    # ported now (tests/test_torch_expert_zero_distributed.py holds them
    # against JAX at world 4): no error
    pytest.param(dict(world=4, stage=1), None, None,
                 id="kw0-NotImplementedError-expert-data"),
    pytest.param(dict(world=4, stage=3), None, None,
                 id="kw1-NotImplementedError-expert-data"),
    pytest.param(dict(offload_optimizer={"device": "cpu"}), None, None,
                 id="kw2-NotImplementedError-ZeRO-Offload"),
    (dict(model_kw={"moe_num_experts": 0}), ValueError, "MoE model"),
    (dict(model_kw={"moe_num_experts": 3}), ValueError, "divides"),
    # JAX refuses the bucketed reduction at ep > 1 too (its words,
    # deepspeed_tpu/runtime/grad_overlap.py:567)
    pytest.param(dict(overlap_grad_reduce="bucketed"), Exception,
                 "'expert' mesh axis > 1",
                 id="kw5-Exception-expert-data group")])
def test_expert_parallel_refusals(kw, err, match):
    if err is None:
        eng = _ep_engine(**kw)
        i = eng._leaf_names.index("layers/e_up")
        if kw.get("world") == 4:
            # the expert leaf's master is cut over the 2 ranks holding
            # the same experts
            assert eng._expert_zero[1] == 2 and eng._odims[i] is not None
            assert eng._zero[i] is eng._expert_zero
        else:
            assert eng.host_opt is not None
        eng.close()
        return
    with pytest.raises(err, match=match):
        _ep_engine(**kw)


def test_param_offload_nvme_refuses_moe_as_jax(tmp_path):
    """``offload_param`` nvme stays refused for an MoE model, with the JAX
    engine's words (``deepspeed_tpu/runtime/engine.py:566-574``)."""
    from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
    from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedTpuEngine

    cfg = _train_config(3)
    cfg["zero_optimization"]["offload_param"] = {
        "device": "nvme", "nvme_path": str(tmp_path)}
    kw = dict(SMALL, remat=True)
    with pytest.raises(NotImplementedError) as want:
        JEngine(JModel(JCfg(**kw)), JDSConfig(cfg, world_size=1),
                topology=MeshTopology(TopologyConfig(),
                                      devices=jax.devices()[:1]))
    with pytest.raises(NotImplementedError) as got:
        DeepSpeedTpuEngine(TransformerLM(TransformerConfig(**kw)),
                           DeepSpeedConfig(cfg, world_size=1),
                           device="cpu")
    assert str(got.value) == str(want.value)
    assert "offload_param nvme x MoE" in str(got.value)


def test_expert_parallel_topology_and_slicing():
    """ep 2 at world 2 (no process group): this rank keeps its experts of
    every expert leaf and the whole of every other leaf."""
    eng = _ep_engine(world=2, stage=0)
    assert eng.topology.sizes["expert"] == 2 and eng.dp_world_size == 2
    assert tuple(eng.params["layers"]["e_up"].shape)[1] == E // 2
    assert eng._ckpt_shape("layers/e_up")[1] == E
    assert eng.grad_overlap_mode == "off"

"""PyTorch port: quantized communication in one process against the JAX
package.

Held bit for bit against jitted JAX functions on seeded numpy inputs: the
per-chunk quantizer of qgZ (a chunk that is not a multiple of the block),
the int8 and fp8 wire (its block clamped to the message), the 1-bit sign
compression (packed bytes and L1 scales) and the XLA-ordered row sum it
rests on; equal: the wire-byte counts and the quantized-ring layout of one
bucket plan built by both packages. The configuration refusals raise in
both packages with the same messages; the quantizer's tunable matches.
At one rank, where the JAX engine quantizes nothing, the ZeRO++ and
``quantized_reduce`` engines are the plain ZeRO ones bit for bit, hpZ is
refused as the JAX topology refuses it, and the 1-bit optimizers train
as the JAX ones do (their exact counterparts there): losses within 1e-5,
params within 2e-5 but for a stated share (``ONEBIT_FAR_SHARE``).
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.comm import compressed as jc
from deepspeed_tpu.comm import quantized as jq
from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime import grad_overlap as jgo
from deepspeed_tpu.runtime import tunables as jtun
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.config_utils import ConfigError as JConfigError
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.comm import compressed as tc
from deepspeed_tpu_torch.comm import quantized as tq
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.runtime import grad_overlap as tgo
from deepspeed_tpu_torch.runtime import tunables as ttun
from deepspeed_tpu_torch.runtime.config import ConfigError, DeepSpeedConfig

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, max_seq_len=64)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the quantizers, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,n,block", [((12, 50), 4, 64),
                                           ((8, 3, 70), 2, 128),
                                           ((6, 512), 3, 256)])
def test_chunked_quantize_bit_equal(shape, n, block):
    """Each chunk on its own blocks (150 and 420 elements a chunk are no
    multiple of 64 or 128), with its dequantization."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jfn = jax.jit(lambda a: jq._chunked_quantize(a, n, block, 8)[:2])
    jqv, js = jfn(x)
    q, s, chunk = tq._chunked_quantize(torch.from_numpy(x), n, block, 8)
    assert chunk == (shape[0] // n,) + shape[1:]
    np.testing.assert_array_equal(q.numpy(), _np(jqv))
    np.testing.assert_array_equal(s.numpy(), _np(js))
    want = jax.jit(lambda a, b: jq._dequantize_chunks(a, b, chunk,
                                                      jnp.float32))(jqv, js)
    got = tq._dequantize_chunks(q, s, chunk, torch.float32)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("numel,block", [(5000, 2048), (100, 2048),
                                         (1, 64), (4096, 512)])
def test_quantize_wire_bit_equal(mode, numel, block):
    """The wire's q (fp8 as its bytes) and scales, and what every rank
    reconstructs; 100 and 1 element messages clamp the block."""
    rng = np.random.default_rng(numel)
    x = (rng.standard_normal(numel) * 3).astype(np.float32)
    x[: numel // 7] = 0.0
    jqv, js = jax.jit(lambda a: jq._quantize_wire(a, block, mode))(x)
    q, s = tq._quantize_wire(torch.from_numpy(x), block, mode)
    assert q.shape == tuple(jqv.shape) and q.shape[1] == min(block, numel)
    if mode == "fp8":
        assert q.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                      _np(jqv).view(np.uint8))
    else:
        np.testing.assert_array_equal(q.numpy(), _np(jqv))
    np.testing.assert_array_equal(s.numpy(), _np(js))
    want = jax.jit(lambda a, b: jq._dequantize_wire(a, b, numel))(jqv, js)
    np.testing.assert_array_equal(
        tq._dequantize_wire(q, s, numel).numpy(), _np(want))


@pytest.mark.parametrize("k,m", [(4, 1000), (1, 37), (2, 8192), (3, 100003),
                                 (1, 8)])
def test_sign_compress_bit_equal(k, m):
    """Packed signs (jnp.packbits' order, 0 counted as +1) and L1 scales
    (summed in XLA's CPU order), and their decompression."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((k, m)).astype(np.float32)
    x[:, ::11] = 0.0
    jp, js = jax.jit(jc._sign_compress)(x)
    p, s = tc._sign_compress(torch.from_numpy(x))
    np.testing.assert_array_equal(p.numpy(), _np(jp))
    np.testing.assert_array_equal(s.numpy(), _np(js))
    want = jax.jit(lambda a, b: jc._sign_decompress(a, b, m))(jp, js)
    np.testing.assert_array_equal(tc._sign_decompress(p, s, m).numpy(),
                                  _np(want))
    assert tc.padded_numel(m, 4) == jc.padded_numel(m, 4)


@pytest.mark.parametrize("m", [5, 32, 33, 77, 1000, 4096, 100000])
def test_xla_row_sum_order(m):
    """The row sum follows XLA's CPU tree reduction, bit for bit."""
    x = np.abs(np.random.default_rng(m).standard_normal((3, m))
               ).astype(np.float32)
    want = jax.jit(lambda a: jnp.sum(a, axis=1))(x)
    np.testing.assert_array_equal(
        tc.xla_row_sum(torch.from_numpy(x)).numpy(), _np(want))


# ---------------------------------------------------------------------------
# plans and wire bytes
# ---------------------------------------------------------------------------
def _plans():
    """One unit list, bucketed by both packages (two stacked layers, an
    all-reduce unit that is no multiple of the world)."""
    spec = [("embed", 8192, "reduce_scatter", -1),
            ("final_norm", 62, "all_reduce", -1),
            ("layers/ln1[1]", 61, "all_reduce", 1),
            ("layers/wq[1]", 4096, "reduce_scatter", 1),
            ("layers/ln1[0]", 61, "all_reduce", 0),
            ("layers/wq[0]", 4096, "reduce_scatter", 0),
            ("hpz_leaf", 512, "cross_group", -1)]
    out = []
    for mod in (jgo, tgo):
        units = [mod.GradUnit(i, layer, n, name, kind)
                 for i, (name, n, kind, layer) in enumerate(spec)]
        out.append(mod.build_bucket_plan(units, 6000, 5000))
    return out


def test_wire_bytes_and_layout_equal_jax():
    jplan, tplan = _plans()
    assert tplan.to_dict() == jplan.to_dict()
    sizes = {"data": 4, "shard": 1}
    for a2a in (False, True):
        assert tgo.quant_reduce_layout(tplan, ("data", "shard"), 4, sizes,
                                       a2a_quantized=a2a) == \
            jgo.quant_reduce_layout(jplan, ("data", "shard"), 4, sizes,
                                    a2a_quantized=a2a)
    assert tgo.quant_reduce_layout(tplan, ("data", "shard"), 4,
                                   {"data": 2, "shard": 2}) == {}
    for q in (False, True):
        for block in (256, 2048):
            assert tgo.ring_wire_bytes(tplan, 4, q, block) == \
                jgo.ring_wire_bytes(jplan, 4, q, block)
    for numel, block in ((100, 2048), (5000, 2048), (4096, 512), (1, 64)):
        assert tq.quant_wire_bytes(numel, block) == \
            jq.quant_wire_bytes(numel, block)
        for world, groups in ((4, 1), (4, 2), (8, 4), (8, 8)):
            assert tq.hier_wire_bytes(numel, world, groups, block) == \
                jq.hier_wire_bytes(numel, world, groups, block)
    with pytest.raises(ValueError, match="groups to divide world"):
        tq.hier_wire_bytes(10, 4, 3)


def test_quant_block_tunable_matches_jax():
    j = jtun.REGISTRY.get("zero_optimization.quant_block")
    t = ttun.REGISTRY.get("zero_optimization.quant_block")
    for f in ("default", "lo", "hi", "cost_signal"):
        assert getattr(t, f) == getattr(j, f), f


# ---------------------------------------------------------------------------
# configuration refusals
# ---------------------------------------------------------------------------
BAD = [
    {"quantized_reduce": "int4"},
    {"quantized_reduce": "int8", "quant_block": 0},
    {"stage": 3, "quantized_reduce": "int8"},
    {"stage": 2, "quantized_reduce": "int8",
     "zero_quantized_gradients": True},
    {"stage": 2, "quantized_reduce_hierarchy": 2},
    {"stage": 2, "quantized_reduce": "int8",
     "quantized_reduce_hierarchy": -1},
    {"stage": 2, "quantized_reduce": "fp8",
     "offload_optimizer": {"device": "cpu"}},
    {"stage": 2, "zero_hpz_partition_size": 2},
    {"stage": 3, "zero_hpz_partition_size": 2, "mics_shard_size": 2},
]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_config_refusals_match_jax(i):
    raw = {"train_micro_batch_size_per_gpu": 1,
           "zero_optimization": copy.deepcopy(BAD[i])}
    with pytest.raises(JConfigError) as jerr:
        JDSConfig(copy.deepcopy(raw), world_size=1)
    with pytest.raises(ConfigError) as terr:
        DeepSpeedConfig(copy.deepcopy(raw))
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# engines at one rank
# ---------------------------------------------------------------------------
def _config(stage, **zero):
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": 0.5,
            "zero_optimization": dict(stage=stage,
                                      stage3_param_persistence_threshold=0,
                                      **zero),
            "steps_per_print": 10 ** 9, "telemetry": {"enabled": False}}


def _port(config, weights=None):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**SMALL)), config=config,
        device="cpu",
        params=None if weights is None else params_from_numpy(weights))
    return eng


def _batches(n=3):
    rng = np.random.default_rng(5)
    return [{"input_ids": rng.integers(0, 128, (2, 2, 64), dtype=np.int64)}
            for _ in range(n)]


def _run(eng, bs):
    losses = [eng.train_batch(batch=b) for b in bs]
    return losses, [p.detach().clone() for p in eng._param_leaves]


@pytest.mark.parametrize("stage,zero", [
    (3, {"zero_quantized_weights": True, "zero_quantized_gradients": True}),
    (2, {"zero_quantized_gradients": True}),
    (2, {"quantized_reduce": "int8"}),
    (2, {"quantized_reduce": "fp8"}),
    (1, {"quantized_reduce": "int8", "overlap_grad_reduce": "bucketed"}),
])
def test_world1_zeropp_equals_plain_zero(stage, zero, monkeypatch):
    """At one rank the JAX engine quantizes nothing: neither does the
    port, whose step equals plain ZeRO's bit for bit (and it says so, in
    JAX's words, for quantized_reduce)."""
    from deepspeed_tpu_torch.utils import logging as tlog
    said = []
    monkeypatch.setattr(tlog, "log_dist", lambda msg, **kw: said.append(msg))
    bs = _batches()
    eng = _port(_config(stage, **zero))
    got = _run(eng, bs)
    assert eng.quant_reduce_state is None
    assert any("quantized_reduce is inert" in m for m in said) == \
        ("quantized_reduce" in zero)
    plain = {k: v for k, v in zero.items()
             if k == "overlap_grad_reduce"}
    want = _run(_port(_config(stage, **plain)), bs)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


def test_world1_hpz_refused_like_jax():
    """A 2-rank hpZ group does not divide one rank: both topologies
    refuse it."""
    cfg = _config(3, zero_hpz_partition_size=2)
    with pytest.raises(ValueError, match="does not divide") as terr:
        _port(cfg)
    with pytest.raises(ValueError, match="does not divide") as jerr:
        MeshTopology(TopologyConfig(hpz_shard=2),
                     devices=jax.devices()[:1])
    assert str(terr.value) == str(jerr.value)


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in flat}


def _nested(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


ONEBIT = [("OneBitAdam", {"freeze_step": 2}),
          ("OneBitLamb", {"freeze_step": 2}),
          ("ZeroOneAdam", {"var_freeze_step": 2, "local_step_clipper": 2})]
# after the freeze an update is m / (sqrt(v) + eps) with the variance of
# two steps: where v is ~1e-13 the update is ~100 lr, and the f32 noise
# of the two packages' gradients (summation orders) moves it by up to
# ~0.5 lr. Measured: 3 (OneBitAdam) and 8 (ZeroOneAdam) of 33,344
# elements beyond 2e-5; at most 0.05% may be.
ONEBIT_FAR_SHARE = 5e-4


@pytest.mark.parametrize("opt,params", ONEBIT, ids=[o for o, _ in ONEBIT])
def test_onebit_world1_matches_jax(opt, params):
    """At one rank a 1-bit optimizer is its exact counterpart (nothing to
    compress): 3 steps across its freeze step, against the JAX engine's."""
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2, "gradient_clipping": 0.0,
           "optimizer": {"type": opt, "params": dict(lr=1e-3, **params)},
           "zero_optimization": {"stage": 0}, "steps_per_print": 10 ** 9,
           "telemetry": {"enabled": False}}
    jeng = JEngine(JModel(JCfg(**SMALL)), JDSConfig(cfg, world_size=1),
                   topology=MeshTopology(TopologyConfig(),
                                         devices=jax.devices()[:1]))
    w = _flat(jeng.params)
    eng = _port(cfg, _nested(w))
    assert eng.onebit_mode and eng.optimizer is None
    bs = _batches(1) * 3        # one batch: the loss must fall
    want = [float(jeng.train_batch(batch=b)) for b in bs]
    got = [eng.train_batch(batch=b) for b in bs]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    jp = _flat(jeng.params)
    far = total = 0
    for n, p in zip(eng._leaf_names, eng._param_leaves):
        gap = np.abs(p.detach().numpy() - jp[n])
        far += int((gap > 2e-5).sum())
        total += gap.size
    assert far <= ONEBIT_FAR_SHARE * total, (far, total)


def test_onebit_refusals_like_jax():
    """check_engine's refusals: ZeRO stage > 0 and gradient clipping."""
    base = {"train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "OneBitAdam", "params": {}},
            "steps_per_print": 10 ** 9, "telemetry": {"enabled": False}}
    for extra, match in (({"zero_optimization": {"stage": 1}},
                          "set zero stage 0"),
                         ({"gradient_clipping": 1.0}, "clipping")):
        with pytest.raises(AssertionError, match=match):
            _port(dict(base, **extra))
    with pytest.raises(NotImplementedError, match="1-bit"):
        _port(dict(base, gradient_clipping=0.0)).save_checkpoint("/nonexistent")

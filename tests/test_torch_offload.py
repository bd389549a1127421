"""PyTorch port: ZeRO-Offload (host C++ optimizers, the legacy host
offload, the tiered offload, the NVMe tier) against the JAX package.

The model is the flagship small config of ``tests/test_torch_training.py``
(2 layers, flash from S = 128), its weights drawn by the JAX package and
moved by name. The JAX engines are built on one device, dp = 1.

Held: the host optimizers bit-equal to the JAX package's on the same f32
and bf16 inputs (the same C++ sources, copied byte for byte, with the
same g++ flags); the legacy offload engine's 3-step losses and master
weights against the JAX legacy offload engine (1e-5 in fp32, 3e-2 under
bf16: one bf16 rounding of the shipped gradients); the tiered engine
bit-identical to the port's resident engine (losses, compute params,
master and moments) at ZeRO stages 1 / 2 and gas 1 / 2, with stacked
leaves cut between layers or kept whole; an fp16 overflow leaving either
host state untouched; the NVMe tier equal to the RAM one; the offload
config rejections equal to the JAX package's.
"""

import copy
import filecmp
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.ops import cpu_optimizers as jco
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime import offload as joff
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.config_utils import ConfigError as JConfigError
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.ops import cpu_optimizers as tco
from deepspeed_tpu_torch.runtime import offload as toff
from deepspeed_tpu_torch.runtime.config import ConfigError, DeepSpeedConfig

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
S, MICRO = 128, 2

# _flagship_cfg(small=True) (__graft_entry__.py:120), flash from S = 128
FLAGSHIP_SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4,
                      max_seq_len=128, flash_min_seq=128)


def _config(precision="bf16", stage=2, gas=2, offload=None, bucket=None):
    cfg = {
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 1e-4,
                                 "warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 2}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": stage},
        "steps_per_print": 10 ** 9,
        "telemetry": {"enabled": False},
    }
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    elif precision == "fp16":
        cfg["fp16"] = {"enabled": True}
    if offload is not None:
        cfg["zero_optimization"]["offload_optimizer"] = dict(offload)
    if bucket is not None:
        cfg["zero_optimization"]["stage3_prefetch_bucket_size"] = bucket
    return cfg


TIERED = {"device": "cpu", "pin_memory": True}
LEGACY = {"device": "cpu"}


@pytest.fixture(scope="module")
def weights():
    jmodel = JModel(JCfg(**FLAGSHIP_SMALL))
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jmodel.init_params(jax.random.PRNGKey(0)))


def _ids(seed, gas=2):
    return np.random.default_rng(seed).integers(0, 256, (gas, MICRO, S),
                                                dtype=np.int64)


def _port(config, weights):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=config, params=params_from_numpy(weights), device="cpu")
    return eng


def _jax_engine(config):
    ds = JDSConfig(config, world_size=1)
    topo = MeshTopology(TopologyConfig(), devices=jax.devices()[:1])
    return JEngine(JModel(JCfg(**FLAGSHIP_SMALL)), ds, topology=topo)


def _host_master(eng):
    return [m.clone() for m in eng.host_opt.get_all_leaves()[0]]


# ---------------------------------------------------------------------------
# host C++: the sources and the optimizers
# ---------------------------------------------------------------------------
HOST_SOURCES = [("ds_host.h", "includes/ds_host.h"),
                ("cpu_adam.cpp", "adam/cpu_adam.cpp"),
                ("cpu_adagrad.cpp", "adagrad/cpu_adagrad.cpp"),
                ("cpu_lion.cpp", "lion/cpu_lion.cpp"),
                ("async_io.cpp", "aio/async_io.cpp")]


@pytest.mark.parametrize("port_name,jax_path", HOST_SOURCES)
def test_host_sources_are_byte_copies(port_name, jax_path):
    assert filecmp.cmp(ROOT / "deepspeed_tpu_torch/csrc/host" / port_name,
                       ROOT / "deepspeed_tpu/csrc" / jax_path, shallow=False)


HOST_OPTS = [("adam", {"lr": 1e-2, "weight_decay": 0.1}),
             ("adamw", {"lr": 1e-2, "weight_decay": 0.1,
                        "betas": [0.8, 0.99]}),
             ("adagrad", {"lr": 1e-2, "weight_decay": 0.05}),
             ("lion", {"lr": 1e-3, "weight_decay": 0.1})]


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,params", HOST_OPTS)
def test_host_optimizer_bit_equal_to_jax(name, params, grad_dtype):
    """Three steps on 10007 elements (an odd count: the SIMD loop's tail)
    with an lr override on the last: master, moments and the bf16 copy-back
    bit-equal to the JAX package's host optimizer."""
    rng = np.random.default_rng(3)
    n = 10007
    p0 = rng.standard_normal(n).astype(np.float32)
    jopt = jco.build_host_optimizer(name, params)
    topt = tco.build_host_optimizer(name, params)
    assert jopt.state_keys() == topt.state_keys()
    jp, tp = p0.copy(), torch.from_numpy(p0.copy())
    jst = [np.zeros(n, np.float32) for _ in jopt.state_keys()]
    tst = [torch.zeros(n) for _ in topt.state_keys()]
    jout = np.zeros(n, ml_dtypes.bfloat16)
    tout = torch.zeros(n, dtype=torch.bfloat16)
    for step in (1, 2, 3):
        g = rng.standard_normal(n).astype(np.float32)
        lr = 3e-3 if step == 3 else None
        if grad_dtype == "bf16":
            jg, tg = g.astype(ml_dtypes.bfloat16), torch.from_numpy(g).bfloat16()
        else:
            jg, tg = g, torch.from_numpy(g)
        jopt.step(step, jp, jg, *jst, lr=lr, params_out_bf16=jout)
        topt.step(step, tp, tg, *tst, lr=lr, params_out_bf16=tout)
    np.testing.assert_array_equal(tp.numpy(), jp)
    for a, b in zip(tst, jst):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tout.view(torch.int16).numpy(),
                                  jout.view(np.int16))
    # the copy-back is round-to-nearest-even of the f32 result
    assert torch.equal(tout, tp.bfloat16())
    jopt.destroy()
    topt.destroy()


def test_host_optimizer_rejects_bad_buffers():
    opt = tco.DeepSpeedCPUAdam()
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="contiguous CPU"):
        opt.step(1, p, torch.zeros(16)[::2], torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError, match="elements"):
        opt.step(1, p, torch.zeros(9), torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError, match="params_out_bf16"):
        opt.step(1, p, torch.zeros(8, dtype=torch.bfloat16), torch.zeros(8),
                 torch.zeros(8))
    with pytest.raises(ValueError, match="no host"):
        tco.build_host_optimizer("lamb", {})
    opt.destroy()


# ---------------------------------------------------------------------------
# the legacy host offload against the JAX legacy offload engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision,tol", [("fp32", 1e-5), ("bf16", 3e-2)])
def test_legacy_offload_matches_jax(precision, tol):
    config = _config(precision, offload=LEGACY)
    jeng = _jax_engine(config)
    assert jeng.host_opt is not None and not jeng.offload_tiered
    w = jax.tree_util.tree_unflatten(
        jeng._param_treedef,
        [np.array(m, np.float32) for m in jeng.host_opt.get_master_leaves()])
    teng = _port(config, w)
    assert teng.host_opt is not None and not teng.offload_tiered
    assert teng.master_params is None and teng.opt_state is None
    for i in range(3):
        b = {"input_ids": _ids(10 + i)}
        jl = float(jeng.train_batch(batch=b))
        tl = teng.train_batch(batch=b)
        assert abs(tl - jl) <= tol, (precision, i, tl, jl)
    assert teng.global_steps == jeng.global_steps == 3
    rtol, atol = (1e-4, 1e-5) if precision == "fp32" else (tol, tol)
    tm, _ = teng.host_opt.get_all_leaves()
    for a, b in zip(tm, jeng.host_opt.get_master_leaves()):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol)
    teng.close()
    jeng.host_opt.close()


def test_legacy_offload_matches_resident_and_pipelines_segments(weights):
    """The host C++ optimizer against the port's resident engine (within
    one bf16 rounding of the shipped gradients), over a segment plan that
    cuts every stacked leaf and a ring of 2 slots."""
    off = dict(LEGACY, buffer_count=2)
    res = _port(_config(), weights)
    leg = _port(_config(offload=off, bucket=4000), weights)
    segs = leg.host_opt.segments
    assert len(segs) > len(leg._param_leaves) and len(leg.host_opt._gslots) == 2
    for i in range(3):
        b = {"input_ids": _ids(20 + i)}
        np.testing.assert_allclose(leg.train_batch(batch=b),
                                   res.train_batch(batch=b), rtol=0.05,
                                   atol=1e-2)
    for p, q in zip(leg._param_leaves, res._param_leaves):
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   q.detach().float().numpy(), rtol=0.05,
                                   atol=1e-2)
    leg.close()


# ---------------------------------------------------------------------------
# the tiered offload against the resident engine
# ---------------------------------------------------------------------------
def _assert_same_training(eng_r, eng_t):
    master_t, state_t = eng_t.host_opt.get_all_leaves()
    for a, b in zip(eng_r._master_leaves, master_t):
        assert torch.equal(a, b)
    for a, b in zip(eng_r._param_leaves, eng_t._param_leaves):
        assert torch.equal(a, b)
    for key in eng_t.host_opt.state_keys:
        for a, b in zip(eng_r.opt_state[key], state_t[key]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("stage,gas", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_tiered_offload_bit_identical_to_resident(weights, stage, gas):
    eng_r = _port(_config(stage=stage, gas=gas), weights)
    eng_t = _port(_config(stage=stage, gas=gas, offload=TIERED,
                          bucket=20000), weights)
    assert eng_t.offload_tiered and eng_t.opt_state is None
    for i in range(3):
        b = {"input_ids": _ids(30 + i, gas)}
        assert eng_r.train_batch(batch=b) == eng_t.train_batch(batch=b)
    _assert_same_training(eng_r, eng_t)
    # every fetch after the first step's was issued ahead of its bucket
    assert eng_t.host_opt.prefetch_hit_fraction == 1.0
    assert 0.0 <= eng_t.host_opt.prefetch_exposed_fraction <= 1.0
    n = sum(p.numel() for p in eng_t._param_leaves)
    assert eng_t.host_opt.offload_bytes == n * 4 * 3
    assert eng_t.host_opt.h2d_bytes >= 3 * n * 12
    assert eng_t.host_opt.d2h_bytes == 3 * n * 12
    eng_t.close()


@pytest.mark.parametrize("bucket,split", [(4000, True), (10 ** 9, False)])
def test_layer_split_buckets_bit_identical(weights, bucket, split):
    """A cap below one stacked leaf cuts it between layers (each w_gate,
    w_up, w_down row is 32768 elements, its own bucket); a huge cap keeps
    whole leaves in one bucket. Both give the resident step's bits."""
    eng_r = _port(_config(), weights)
    eng_t = _port(_config(offload=TIERED, bucket=bucket), weights)
    segs = [s for b in eng_t.host_opt.buckets for s in b]
    leaves = len(eng_t._param_leaves)
    assert (len(segs) > leaves) == split
    if split:
        names = eng_t._leaf_names
        cut = {names[i] for i, a, e in segs
               if e - a < eng_t._param_leaves[i].numel()}
        assert cut and all(n.startswith("layers/") for n in cut)
    else:
        assert len(eng_t.host_opt.buckets) == 1
    for i in range(2):
        b = {"input_ids": _ids(40 + i)}
        assert eng_r.train_batch(batch=b) == eng_t.train_batch(batch=b)
    _assert_same_training(eng_r, eng_t)
    eng_t.close()


def test_bucket_plans():
    # the JAX package's plan on leaf sizes
    for numels, cap in (([32, 1024, 32, 1024], 600),
                        ([32, 1024, 32, 1024], 10 ** 9),
                        ([32, 1024], 1056), ([5, 5, 5, 5, 5], 11)):
        assert toff.plan_prefetch_buckets(numels, cap) == \
            joff.plan_prefetch_buckets(numels, cap)
    with pytest.raises(ValueError, match="> 0"):
        toff.plan_prefetch_buckets([1], 0)
    # the layer axis: runs of whole rows, at least one row
    shapes = [(4, 10), (4, 10), (100,), (3, 2, 5)]
    assert toff.leaf_segments(shapes, [True, False, True, True], 25) == [
        (0, 0, 20), (0, 20, 40), (1, 0, 40), (2, 0, 100), (3, 0, 20),
        (3, 20, 30)]
    assert toff.leaf_segments(shapes, [True] * 4, 5) == [
        (0, 0, 10), (0, 10, 20), (0, 20, 30), (0, 30, 40), (1, 0, 10),
        (1, 10, 20), (1, 20, 30), (1, 30, 40), (2, 0, 100), (3, 0, 10),
        (3, 10, 20), (3, 20, 30)]
    # LAMB's trust ratio reads its whole leaf: never cut
    from deepspeed_tpu_torch.ops.optimizers import FusedAdam, FusedLamb
    leaves = [torch.zeros(4, 10), torch.zeros(100)]
    for opt, n_buckets in ((FusedLamb(), 2), (FusedAdam(), 5)):
        tier = toff.TieredOptimizerOffload(opt, leaves, bucket_elems=10,
                                           splittable=[True, False])
        assert len(tier.buckets) == n_buckets
        tier.close()


# ---------------------------------------------------------------------------
# fp16 overflow, NVMe, config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("offload", [LEGACY, TIERED])
def test_fp16_overflow_leaves_host_state_untouched(weights, offload):
    config = _config("fp16", offload=offload)
    config["fp16"].update({"initial_scale_power": 40, "hysteresis": 1})
    eng = _port(config, weights)
    master = _host_master(eng)
    moments = {k: [t.clone() for t in v]
               for k, v in eng.host_opt.get_all_leaves()[1].items()}
    params = [p.detach().clone() for p in eng._param_leaves]
    eng.train_batch(batch={"input_ids": _ids(50)})
    assert eng.skipped_steps == 1 and eng.global_steps == 0
    assert eng._step == 0 and eng.loss_scale == 2.0 ** 39
    got_m, got_s = eng.host_opt.get_all_leaves()
    assert all(torch.equal(a, b) for a, b in zip(master, got_m))
    for k in moments:
        assert all(torch.equal(a, b) for a, b in zip(moments[k], got_s[k]))
    assert all(torch.equal(a, b.detach())
               for a, b in zip(params, eng._param_leaves))
    eng.close()


def test_nvme_offload_equals_cpu(weights, tmp_path):
    nvme = {"device": "nvme", "nvme_path": str(tmp_path)}
    cfg = _config(offload=nvme, bucket=20000)
    cfg["aio"] = {"block_size": 65536, "thread_count": 2}
    eng_n = _port(cfg, weights)
    eng_c = _port(_config(offload=LEGACY, bucket=20000), weights)
    swap = tmp_path / "ds_tpu_swap"
    assert any(swap.rglob("*.bin"))
    for i in range(2):
        b = {"input_ids": _ids(60 + i)}
        np.testing.assert_allclose(eng_n.train_batch(batch=b),
                                   eng_c.train_batch(batch=b), rtol=1e-5)
    (mn, sn), (mc, sc) = (eng_n.host_opt.get_all_leaves(),
                          eng_c.host_opt.get_all_leaves())
    assert all(torch.equal(a, b) for a, b in zip(mn, mc))
    assert all(torch.equal(a, b) for k in sn for a, b in zip(sn[k], sc[k]))
    assert eng_n.host_opt.swap_bytes > 0
    eng_n.close()
    eng_c.close()
    assert not any(swap.rglob("*.bin"))


BAD_OFFLOAD = [
    {"zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "nvme", "nvme_path": "/x", "pin_memory": True}}},
    {"zero_optimization": {"stage": 0, "offload_optimizer": TIERED}},
    {"zero_optimization": {"stage": 3, "offload_optimizer": TIERED}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": TIERED,
                           "zero_quantized_gradients": True}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "nvme"}}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "disk"}}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": LEGACY,
                           "quantized_reduce": "int8"}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "cpu", "buffer_count": 0}}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": LEGACY},
     "optimizer": {"type": "OneBitAdam", "params": {}}},
]


@pytest.mark.parametrize("i", range(len(BAD_OFFLOAD)))
def test_offload_config_rejections_match_jax(i):
    raw = dict(_config(), **copy.deepcopy(BAD_OFFLOAD[i]))
    with pytest.raises(JConfigError) as jerr:
        JDSConfig(copy.deepcopy(raw), world_size=1)
    with pytest.raises(ConfigError) as terr:
        DeepSpeedConfig(copy.deepcopy(raw))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("extra", [
    {"zero_optimization": {"stage": 1, "offload_optimizer": LEGACY}},
    {"zero_optimization": {"stage": 0, "offload_optimizer": LEGACY}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": dict(
        TIERED, buffer_count=2), "stage3_prefetch_bucket_size": 10 ** 6},
     "aio": {"block_size": 4096, "thread_count": 2, "queue_depth": 4}},
])
def test_offload_configs_run(weights, extra):
    eng = _port(dict(_config(), **extra), weights)
    assert np.isfinite(eng.train_batch(batch={"input_ids": _ids(70)}))
    eng.close()


def test_unported_offload_keys_raise():
    """The offload keys that once raised here run now: ``ratio`` below 1
    is accepted as the JAX package accepts it (validated in (0, 1], read
    nowhere; ``test_offload_ratio_is_inert``), and a ratio outside it
    raises the same ConfigError in both packages."""
    for extra in (
            {"zero_optimization": {"stage": 3, "offload_param": {
                "device": "cpu", "ratio": 0.5}}},
            {"zero_optimization": {"stage": 2, "offload_optimizer": dict(
                LEGACY, ratio=0.5)}}):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
            config=dict(_config(), **extra), device="cpu")
        eng.close()
    for ratio in (0.0, 1.5):
        raw = dict(_config(), zero_optimization={
            "stage": 2, "offload_optimizer": dict(LEGACY, ratio=ratio)})
        with pytest.raises(JConfigError) as jerr:
            JDSConfig(copy.deepcopy(raw))
        with pytest.raises(ConfigError) as terr:
            DeepSpeedConfig(copy.deepcopy(raw))
        assert str(terr.value) == str(jerr.value)
    # ZeRO++ is ported now (tests/test_torch_zeropp*.py): qgZ at one rank
    # builds and, as in JAX, quantizes nothing
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=dict(_config(), zero_optimization={
            "stage": 2, "zero_quantized_gradients": True}), device="cpu")
    assert not eng._zpp_g
    eng.close()


@pytest.mark.parametrize("offload", ["tiered", "legacy"])
def test_offload_ratio_is_inert(weights, offload):
    """``ratio`` 0.5 (JAX validates it and reads it nowhere) trains
    bit for bit as ``ratio`` 1.0: every tier moves all of its state."""
    tier = TIERED if offload == "tiered" else LEGACY
    out = []
    for ratio in (1.0, 0.5):
        eng = _port(_config(offload=dict(tier, ratio=ratio), bucket=20000),
                    weights)
        losses = [eng.train_batch(batch={"input_ids": _ids(s)})
                  for s in (71, 72)]
        out.append((losses, _host_master(eng),
                    [p.detach().clone() for p in eng._param_leaves]))
        eng.close()
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1] + out[0][2], out[1][1] + out[1][2]):
        assert torch.equal(a, b)


def test_host_op_builder_caches_and_reports(tmp_path, monkeypatch):
    """The library is keyed by sources + flags and built once; a failed
    build raises with g++'s output."""
    from deepspeed_tpu_torch.ops.op_builder import builder, cpu
    tco.DeepSpeedCPUAdam().destroy()
    lib = cpu.CPUAdamBuilder().so_path()
    assert lib.exists() and lib.parent.parent == builder.BUILD_ROOT
    assert cpu.CPUAdamBuilder().build() == lib
    src = tmp_path / "host"
    src.mkdir()
    (src / "ds_host.h").write_text("")
    (src / "cpu_adam.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(builder, "HOST_SRC", src)
    monkeypatch.setattr(builder, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*cpu_adam"):
        cpu.CPUAdamBuilder().build()
    assert not list((tmp_path / "build").rglob("*.so"))

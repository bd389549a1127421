"""PyTorch port: the training slice against the JAX package.

The same weights (initialized by the JAX package, moved by name through
``checkpoint.interop.params_from_numpy``) and the same numpy batches go
through ``deepspeed_tpu`` and ``deepspeed_tpu_torch`` on the CPU. The
model is ``_flagship_cfg(small=True)``'s numbers (``__graft_entry__.py``:
8 q heads over 4 kv heads, 2 layers) with ``flash_min_seq=128``, so that
attention takes the flash route at S = 128 in both packages (Pallas in
interpret mode on the JAX side, the plain versions of the CUDA kernels on
the port's). The JAX engine is built as ``_dp_baseline_loss`` builds it:
one device, dp = 1, ZeRO 0.

Held equal: forward logits (1e-4), the loss (1e-5), the gradients
(1e-4 relative), a 3-step train_batch loss trajectory at gas 2 with AdamW,
a warmup schedule and clipping (1e-5 in fp32, 3e-2 under bf16, the
``_run_tiny`` tolerance), eval_batch, the fp16 loss-scale sequence and
skip-step, the config schema's batch math and errors, the optimizers, the
schedules and the loss scaler. Keys the port does not run raise
``NotImplementedError``.
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
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.config_utils import ConfigError as JConfigError
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.interop import (params_from_numpy,
                                                    params_to_numpy)
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as tckpt
from deepspeed_tpu_torch.runtime.config import (ConfigError,
                                                DeepSpeedConfig)
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

S, MICRO, GAS = 128, 2, 2

# _flagship_cfg(small=True) (__graft_entry__.py:120), flash from S = 128
FLAGSHIP_SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4,
                      max_seq_len=128, flash_min_seq=128)

TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": MICRO,
    "gradient_accumulation_steps": GAS,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                             "warmup_num_steps": 2}},
    "gradient_clipping": 1.0,
    "zero_optimization": {"stage": 0},
    "steps_per_print": 10 ** 9,
    # no metrics registry, anomaly ledger or watchdog thread left behind
    # in the test process by the JAX engines
    "telemetry": {"enabled": False},
}


@pytest.fixture(scope="module")
def models():
    jmodel = JModel(JCfg(**FLAGSHIP_SMALL))
    np_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             jmodel.init_params(jax.random.PRNGKey(0)))
    return jmodel, np_params, TransformerLM(TransformerConfig(**FLAGSHIP_SMALL))


def _ids(seed, shape=(MICRO, S)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.int64)


def _jax_engine(config):
    ds = JDSConfig(config, world_size=1)
    topo = MeshTopology(TopologyConfig(), devices=jax.devices()[:1])
    return JEngine(JModel(JCfg(**FLAGSHIP_SMALL)), ds, topology=topo)


def _engine_weights(eng):
    tree = eng.master_params if eng.has_master else eng.params
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


# ---------------------------------------------------------------------------
# model forward / loss / grads
# ---------------------------------------------------------------------------
def test_forward_logits_matches_jax(models):
    jmodel, np_params, tmodel = models
    ids = _ids(0)
    ref = np.asarray(jmodel.forward_logits(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(ids)))
    out = tmodel.forward_logits(params_from_numpy(np_params),
                                torch.from_numpy(ids))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_apply_loss_matches_jax(models, masked):
    jmodel, np_params, tmodel = models
    batch = {"input_ids": _ids(1)}
    if masked:
        batch["loss_mask"] = (np.random.default_rng(2).random((MICRO, S))
                              > 0.3).astype(np.int32)
    ref = float(jmodel.apply(jax.tree.map(jnp.asarray, np_params),
                             jax.tree.map(jnp.asarray, batch)))
    out = float(tmodel.apply(params_from_numpy(np_params),
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()}))
    assert abs(out - ref) <= 1e-5, (out, ref)


@pytest.mark.parametrize("remat", [True, False])
def test_grads_match_jax_grad(models, remat):
    jmodel, np_params, _ = models
    cfg = dict(FLAGSHIP_SMALL, remat=remat)
    tmodel = TransformerLM(TransformerConfig(**cfg))
    ids = _ids(3)
    ref = jax.grad(lambda p: JModel(JCfg(**cfg)).apply(
        p, {"input_ids": jnp.asarray(ids)}))(
        jax.tree.map(jnp.asarray, np_params))
    tparams = params_from_numpy(np_params)
    leaves = [tparams["layers"][k] for k in sorted(tparams["layers"])] + [
        tparams[k] for k in ("embed", "final_norm", "lm_head")]
    for p in leaves:
        p.requires_grad_(True)
    loss = tmodel.apply(tparams, {"input_ids": torch.from_numpy(ids)})
    grads = torch.autograd.grad(loss, leaves)
    refs = [ref["layers"][k] for k in sorted(ref["layers"])] + [
        ref[k] for k in ("embed", "final_norm", "lm_head")]
    for g, r in zip(grads, refs):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())


def test_rope_and_chunked_ce_match_jax():
    cfg = TransformerConfig(**FLAGSHIP_SMALL)
    jcfg = JCfg(**FLAGSHIP_SMALL)
    cos, sin = ttr._rope_tables(cfg, 40, offset=3)
    jcos, jsin = jtr._rope_tables(jcfg, 40, offset=3)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=1e-6,
                               atol=1e-6)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 40, 16)).astype(np.float32)
    np.testing.assert_allclose(
        ttr.apply_rotary(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(jtr.apply_rotary(jnp.asarray(x), jcos, jsin)),
        rtol=1e-6, atol=1e-6)
    # 40 tokens in chunks of 16: the last chunk is padded
    h = rng.normal(size=(2, 40, 8)).astype(np.float32)
    head = rng.normal(size=(8, 32)).astype(np.float32)
    tgt = rng.integers(0, 32, (2, 40))
    mask = (rng.random((2, 40)) > 0.2).astype(np.float32)
    jt, jc = jtr._chunked_ce_loss(jnp.asarray(h), jnp.asarray(tgt),
                                  jnp.asarray(mask), jnp.asarray(head), 16)
    tt, tc = ttr._chunked_ce_loss(torch.from_numpy(h), torch.from_numpy(tgt),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(head), 16)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    assert float(tc) == float(jc)


# ---------------------------------------------------------------------------
# the engine against DeepSpeedTpuEngine at dp = 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision,tol", [("fp32", 1e-5), ("bf16", 3e-2)])
def test_train_trajectory_matches_jax_engine(precision, tol):
    config = dict(TRAIN_CONFIG, bf16={"enabled": precision == "bf16"})
    jeng = _jax_engine(config)
    weights = _engine_weights(jeng)
    teng, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=config, params=params_from_numpy(weights), device="cpu")
    assert loader is None and opt is teng.optimizer and \
        sched is teng.lr_scheduler
    assert teng.has_master == (precision == "bf16")
    batches = [{"input_ids": _ids(10 + i, (GAS, MICRO, S))} for i in range(3)]
    for b in batches:
        jl = float(jeng.train_batch(batch=b))
        tl = teng.train_batch(batch=b)
        assert abs(tl - jl) <= tol, (precision, tl, jl)
        assert abs(teng.get_global_grad_norm()
                   - jeng.get_global_grad_norm()) <= max(tol, 1e-4) * 10
        assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    assert teng.global_steps == jeng.global_steps == 3
    assert teng.skipped_steps == jeng.skipped_steps == 0
    eval_b = {"input_ids": _ids(20, (GAS, MICRO, S))}
    assert abs(teng.eval_batch(batch=eval_b)
               - jeng.eval_batch(batch=eval_b)) <= tol
    if precision == "fp32":
        trained = params_to_numpy(teng.params)
        ref = _engine_weights(jeng)
        np.testing.assert_allclose(trained["layers"]["wq"],
                                   ref["layers"]["wq"], rtol=1e-4, atol=1e-5)


def test_fp16_overflow_skips_and_scale_sequence_matches_jax():
    """A scale of 2**40 overflows the fp16 gradients: every step is
    skipped, the state stays as it was, and hysteresis (2) halves the
    scale on every second overflow — the same sequence as the JAX
    engine."""
    config = dict(TRAIN_CONFIG, fp16={"enabled": True,
                                      "initial_scale_power": 40})
    jeng = _jax_engine(config)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=config, params=params_from_numpy(_engine_weights(jeng)),
        device="cpu")
    before = {k: v.clone() for k, v in
              zip(teng._leaf_names, teng._master_leaves)}
    params_before = [p.detach().clone() for p in teng._param_leaves]
    moments_before = [m.clone() for m in teng.opt_state["exp_avg"]]
    j_scales, t_scales = [], []
    for i in range(4):
        b = {"input_ids": _ids(30 + i, (GAS, MICRO, S))}
        jeng.train_batch(batch=b)
        teng.train_batch(batch=b)
        j_scales.append(jeng.loss_scale)
        t_scales.append(teng.loss_scale)
    assert t_scales == j_scales == [2.0 ** 40, 2.0 ** 39, 2.0 ** 39,
                                    2.0 ** 38]
    assert teng.skipped_steps == jeng.skipped_steps == 4
    assert teng.global_steps == jeng.global_steps == 0
    assert teng._step == 0 and teng.lr_scheduler.last_step == 0
    for name, m in zip(teng._leaf_names, teng._master_leaves):
        assert torch.equal(m, before[name]), name
    for p, q in zip(teng._param_leaves, params_before):
        assert torch.equal(p.detach(), q)
    for m, q in zip(teng.opt_state["exp_avg"], moments_before):
        assert torch.equal(m, q)


def test_fp16_scale_growth_matches_jax():
    """No overflow at 2**8 with a window of 2: the scale doubles every
    second step and the losses follow the JAX engine."""
    config = dict(TRAIN_CONFIG, fp16={"enabled": True,
                                      "initial_scale_power": 8,
                                      "loss_scale_window": 2})
    jeng = _jax_engine(config)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=config, params=params_from_numpy(_engine_weights(jeng)),
        device="cpu")
    for i in range(3):
        b = {"input_ids": _ids(40 + i, (GAS, MICRO, S))}
        jl = float(jeng.train_batch(batch=b))
        tl = teng.train_batch(batch=b)
        assert abs(tl - jl) <= 3e-2
        assert teng.loss_scale == jeng.loss_scale
    assert teng.loss_scale == 2.0 ** 9 and teng.skipped_steps == 0


def test_device_none_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None trains there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(
            model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
            config=TRAIN_CONFIG)


@pytest.mark.parametrize("extra,item", [
    # MiCS shard groups are A4's remainder (ZeRO 3 itself runs)
    ({"zero_optimization": {"stage": 3, "mics_shard_size": 2}}, "A4"),
    ({"zero_optimization": {"stage": 3, "offload_param":
                            {"device": "cpu"}}}, "A9"),
    ({"activation_checkpointing": {"policy": "save_attn"}}, "A3"),
    ({"activation_checkpointing": {"cpu_checkpointing": True}}, "A9"),
    ({"hybrid_engine": {"enabled": True}}, "A11"),
    ({"flops_profiler": {"enabled": True}}, "A12"),
    ({"curriculum_learning": {"enabled": True}}, "A12"),
    ({"telemetry": {"flush_interval": 5}}, "A7"),
    ({"optimizer": {"type": "OneBitAdam", "params": {}}}, "A10"),
])
def test_unported_keys_raise(extra, item):
    with pytest.raises(NotImplementedError, match=item):
        deepspeed_tpu_torch.initialize(
            model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
            config=dict(TRAIN_CONFIG, **extra), device="cpu")


def test_ported_and_inert_keys_run():
    config = dict(TRAIN_CONFIG, telemetry={"enabled": False},
                  diagnostics={"enabled": False}, prescale_gradients=True,
                  wall_clock_breakdown=True,
                  fp16={"enabled": False, "consecutive_hysteresis": True})
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=config, device="cpu")
    assert np.isfinite(eng.train_batch(
        batch={"input_ids": _ids(50, (GAS, MICRO, S))}))
    # training_data= builds the dataloader (the third value), which feeds
    # train_batch() when it gets no batch
    data = [{"input_ids": _ids(60 + i, (S,))} for i in range(8)]
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=TRAIN_CONFIG, device="cpu", training_data=data)
    assert len(loader) == 4 and np.isfinite(eng.train_batch())


@pytest.mark.parametrize("field,item", [
    (dict(moe_num_experts=2), "A8"), (dict(positional="alibi"), "A12"),
    (dict(norm_scheme="post"), "A12")])
def test_unported_model_families_raise(field, item):
    model = TransformerLM(TransformerConfig(**dict(FLAGSHIP_SMALL, **field)))
    with pytest.raises(NotImplementedError, match=item):
        model.apply({}, {"input_ids": torch.from_numpy(_ids(0))})


def test_cpu_training_launches_no_kernel():
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=TRAIN_CONFIG, device="cpu")
    eng.train_batch(batch={"input_ids": _ids(51, (GAS, MICRO, S))})
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == before


# ---------------------------------------------------------------------------
# config schema
# ---------------------------------------------------------------------------
GOOD_CONFIGS = [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "gradient_accumulation_steps": 2},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 3},
    {"train_batch_size": 16},
    {"train_batch_size": "auto", "train_micro_batch_size_per_gpu": 2,
     "optimizer": {"type": "adamw", "params": {"betas": ["auto", "auto"],
                                                "lr": 3e-4}}},
    {"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
     "zero_optimization": {"stage": 3, "reduce_bucket_size": 1024},
     "diagnostics": {"loss_window": 8}},
]
BAD_CONFIGS = [
    {"train_micro_batch_size_per_gpu": 2, "not_a_key": 1},
    {"train_micro_batch_size_per_gpu": 2, "zero_optimization": {"typo": 1}},
    {"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 3},
    {"gradient_accumulation_steps": 2},
    {"train_micro_batch_size_per_gpu": 2, "zero_optimization": {"stage": 5}},
    {"train_micro_batch_size_per_gpu": 2,
     "zero_optimization": {"reduce_bucket_size": 0}},
    {"train_micro_batch_size_per_gpu": 2,
     "zero_optimization": {"offload_optimizer": {"device": "disk"}}},
    {"train_micro_batch_size_per_gpu": 2, "tensor_parallel_size": 3},
]


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("i", range(len(GOOD_CONFIGS)))
def test_config_resolves_like_jax(i, world):
    cfg = GOOD_CONFIGS[i]
    j, t = JDSConfig(cfg, world_size=world), DeepSpeedConfig(cfg,
                                                             world_size=world)
    for attr in ("train_batch_size", "train_micro_batch_size_per_gpu",
                 "gradient_accumulation_steps", "dp_world_size",
                 "zero_stage", "precision_dtype"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.to_dict() == j.to_dict()


@pytest.mark.parametrize("i", range(len(BAD_CONFIGS)))
def test_bad_config_raises_like_jax(i):
    with pytest.raises(JConfigError) as jerr:
        JDSConfig(BAD_CONFIGS[i], world_size=8)
    with pytest.raises(ConfigError) as terr:
        DeepSpeedConfig(BAD_CONFIGS[i], world_size=8)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# optimizers, schedules, loss scaler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,params", [
    ("adam", {"lr": 1e-2, "weight_decay": 0.1}),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1, "betas": [0.8, 0.9]}),
    ("adamw", {"lr": 1e-2, "bias_correction": False}),
    ("lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("lion", {"lr": 1e-3, "weight_decay": 0.1}),
    ("adagrad", {"lr": 1e-2, "weight_decay": 0.01}),
    ("sgd", {"lr": 1e-2, "momentum": 0.9, "nesterov": True}),
])
def test_optimizer_matches_jax(name, params):
    rng = np.random.default_rng(5)
    shapes = [(4, 8), (16,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jo, to = jopt.build_optimizer(name, params), topt.build_optimizer(
        name, params)
    jp = [jnp.asarray(x) for x in p0]
    jstate = jo.init_state(jp)
    tp = [torch.from_numpy(x.copy()) for x in p0]
    tstate = to.init_state(tp)
    for step in range(1, 4):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        jp, jstate = jo.apply(jp, [jnp.asarray(x) for x in g], jstate, step,
                              lr=params["lr"] * step)
        to.apply(tp, [torch.from_numpy(x) for x in g], tstate, step,
                 lr=params["lr"] * step)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 10}),
    ("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 10,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 30, "warmup_num_steps": 10}),
    ("WarmupCosineLR", {"total_num_steps": 30, "warmup_num_steps": 5}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 8, "decay_step_size": 4,
                  "decay_lr_rate": 0.5}),
    ("LRRangeTest", {"lr_range_test_step_size": 5,
                     "lr_range_test_staircase": True}),
])
def test_lr_schedule_matches_jax(name, params):
    jfn = jlr.SCHEDULE_REGISTRY[name](**params)
    tfn = tlr.SCHEDULE_REGISTRY[name](**params)
    for step in range(0, 40, 3):
        assert tfn(step) == pytest.approx(float(jfn(step)), rel=1e-5,
                                          abs=1e-9), step


def test_loss_scaler_matches_jax():
    cfg_j = jls.LossScaleConfig(initial_scale_power=4, scale_window=3,
                                hysteresis=2, min_scale=2.0)
    cfg_t = tls.LossScaleConfig(initial_scale_power=4, scale_window=3,
                                hysteresis=2, min_scale=2.0)
    js, ts = jls.init_scale_state(cfg_j), tls.init_scale_state(cfg_t)
    pattern = [True, False, True, False, False, True, True, True, True,
               False, False, False, False, False, False]
    for f in pattern:
        js = jls.update_scale(js, jnp.asarray(f), cfg_j)
        ts = tls.update_scale(ts, torch.tensor(f), cfg_t)
        for k in js:
            assert float(ts[k]) == float(js[k]), (k, f)
    g = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not bool(tls.grads_finite(g)) and bool(tls.grads_finite(g[:1]))


def test_remat_policies():
    tckpt.reset()
    try:
        with pytest.raises(NotImplementedError, match="A3"):
            tckpt.configure(policy="dots_saveable")
        tckpt.reset()
        assert tckpt.checkpoint_wrapper(len, "everything_saveable") is len
        assert tckpt.active_policy() == "nothing_saveable"
    finally:
        tckpt.reset()

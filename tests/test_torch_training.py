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
schedules and the loss scaler; the selective remat policies (loss and
gradients bit-equal to ``nothing_saveable``'s, the flash forwards and
matmuls they spare counted, ``save_attn`` against JAX's); the
``forward`` / ``backward`` / ``step`` shims (bit-equal to train_batch,
1e-5 of JAX's shims, the fp16 overflow skip, frozen leaves holding). Keys
the port does not run raise ``NotImplementedError``.
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
    # MiCS runs now (tests/test_torch_tensor_parallel.py), and so does
    # ZeRO++ hpZ, its sibling sub-group (tests/test_torch_zeropp*.py): at
    # one rank a group of 2 does not divide the data-parallel world, and
    # the port refuses it as the JAX topology does
    ({"zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}},
     ValueError),
    # once refused under the ROADMAP items they name: a partial offload
    # ratio trains now (inert, as in JAX), and a factory of
    # jax.checkpoint_policies raises ValueError (JAX cannot run it either)
    ({"zero_optimization": {"stage": 3, "offload_param":
                            {"device": "cpu", "ratio": 0.5}}}, "A9"),
    ({"activation_checkpointing": {
        "policy": "save_anything_except_these_names"}}, "A3"),
    ({"zero_optimization": {"stage": 2, "offload_optimizer":
                            {"device": "cpu", "ratio": 0.5}}}, "A9"),
    ({"hybrid_engine": {"enabled": True}}, "A11"),
    ({"flops_profiler": {"enabled": True}}, "A12"),
    ({"curriculum_learning": {"enabled": True}}, "A12"),
    ({"progressive_layer_drop": {"enabled": True}}, "A12"),
    # the 1-bit optimizers run now; with gradient clipping they refuse,
    # as the JAX engine's check_engine does
    ({"optimizer": {"type": "OneBitAdam", "params": {}}}, AssertionError),
])
def test_unported_keys_raise(extra, item):
    if item == "A9":
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
            config=dict(TRAIN_CONFIG, **extra), device="cpu")
        assert np.isfinite(eng.train_batch(
            batch={"input_ids": _ids(1, (GAS, MICRO, S))}))
        eng.close()
        return
    exc, match = ((item, None) if isinstance(item, type)
                  else (NotImplementedError, item))
    if item == "A3":
        exc, match = ValueError, "factory of jax.checkpoint_policies"
    with pytest.raises(exc, match=match):
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
    if "moe_num_experts" in field:
        # MoE trains now (tests/test_torch_moe.py), and so do sequence
        # parallelism (tests/test_torch_tensor_parallel.py) and MoE layers
        # under it (tests/test_torch_expert_zero_distributed.py)
        params = model.init_params(torch.Generator().manual_seed(0))
        loss = model.apply(params, {"input_ids": torch.from_numpy(_ids(0))})
        assert torch.isfinite(loss)
        from deepspeed_tpu_torch.parallel.topology import (MeshTopology,
                                                           TopologyConfig)
        model.set_topology(MeshTopology(TopologyConfig(seq=2), world_size=2,
                                        rank=0))
        assert model._sp[0] == 2
        return
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


def test_factory_policy_refused_by_both_packages():
    """``save_only_these_names`` names a factory of jax.checkpoint_policies:
    the JAX package hands it to ``jax.checkpoint`` as the policy, which
    raises ``TypeError`` once the checkpoint is differentiated (the factory
    receives the primitive's parameters); the port refuses the name at
    ``configure`` with ``ValueError``."""
    from deepspeed_tpu.runtime.activation_checkpointing import \
        checkpointing as jckpt

    x = jnp.ones((4, 4))

    def loss(x):
        return jckpt.checkpoint(lambda y: jnp.sum(jnp.sin(y) @ y), x,
                                policy_name="save_only_these_names")

    with pytest.raises(TypeError, match="save_only_these_names"):
        jax.grad(loss)(x)
    # the policies both packages run differentiate
    jax.grad(lambda x: jckpt.checkpoint(lambda y: jnp.sum(jnp.sin(y) @ y),
                                        x, policy_name="dots_saveable"))(x)
    tckpt.reset()
    try:
        with pytest.raises(ValueError, match="save_only_these_names"):
            tckpt.configure(policy="save_only_these_names")
    finally:
        tckpt.reset()


def test_remat_policies():
    tckpt.reset()
    try:
        with pytest.raises(ValueError, match="factory"):
            tckpt.configure(policy="save_only_these_names")
        tckpt.reset()
        with pytest.raises(ValueError, match="unknown"):
            tckpt.configure(policy="no_such_policy")
        tckpt.reset()
        tckpt.configure(policy="dots_saveable")
        assert tckpt.active_policy() == "dots_saveable"
        tckpt.reset()
        assert tckpt.checkpoint_wrapper(len, "everything_saveable") is len
        assert tckpt.active_policy() == "nothing_saveable"
    finally:
        tckpt.reset()


# ---------------------------------------------------------------------------
# the selective remat policies (runtime/activation_checkpointing)
# ---------------------------------------------------------------------------
POLICIES = ("nothing_saveable", "save_attn", "save_dots_and_attn",
            "dots_with_no_batch_dims_saveable", "dots_saveable",
            "checkpoint_dots", "checkpoint_dots_with_no_batch_dims",
            "everything_saveable")


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the matmuls dispatched (forward, recompute and backward)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _policy_grads(models, policy, monkeypatch):
    """(loss, grads, flash forwards, matmuls) of one forward + backward
    of the port's model under ``policy``."""
    _, np_params, tmodel = models
    calls = []
    plain = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    tckpt.reset()
    tckpt.configure(policy=policy)
    try:
        tparams = params_from_numpy(np_params)
        leaves = [tparams["layers"][k] for k in sorted(tparams["layers"])]
        for p in leaves:
            p.requires_grad_(True)
        with _CountOps() as mm:
            loss = tmodel.apply(tparams, {"input_ids": torch.from_numpy(
                _ids(5))})
            grads = torch.autograd.grad(loss, leaves)
    finally:
        tckpt.reset()
    return loss.detach(), grads, len(calls), mm.n


def test_selective_policies_equal_nothing_saveable(models, monkeypatch):
    """Every ported policy computes the loss and gradients of
    ``nothing_saveable`` bit for bit; the ones keeping ``attn_out`` run
    the flash forward once per layer (no recompute), the dot policies
    spare the recompute's weight matmuls."""
    L = FLAGSHIP_SMALL["num_layers"]
    out = {p: _policy_grads(models, p, monkeypatch) for p in POLICIES}
    loss0, grads0, fwd0, mm0 = out["nothing_saveable"]
    assert fwd0 == 2 * L
    for p, (loss, grads, fwd, mm) in out.items():
        assert torch.equal(loss, loss0), p
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), p
        keeps_attn = p in ("save_attn", "save_dots_and_attn",
                           "everything_saveable")
        assert fwd == (L if keeps_attn else 2 * L), (p, fwd)
        keeps_dots = "dots" in p or p == "everything_saveable"
        # the recompute stops at the last tensor the backward needs
        # (torch's early stop), before w_down: it runs six weight
        # matmuls a layer, which the dot policies spare
        assert mm == (mm0 - 6 * L if keeps_dots else mm0), (p, mm, mm0)


def test_save_attn_grads_match_jax(models):
    """The JAX model under ``save_attn`` (its attn_out tag) against the
    port's, as test_grads_match_jax_grad holds nothing_saveable."""
    from deepspeed_tpu.runtime.activation_checkpointing import \
        checkpointing as jckpt
    jmodel, np_params, tmodel = models
    ids = _ids(6)
    jckpt.configure(policy="save_attn")
    tckpt.configure(policy="save_attn")
    try:
        ref = jax.grad(lambda p: JModel(JCfg(**FLAGSHIP_SMALL)).apply(
            p, {"input_ids": jnp.asarray(ids)}))(
            jax.tree.map(jnp.asarray, np_params))
        tparams = params_from_numpy(np_params)
        leaves = [tparams["layers"][k] for k in sorted(tparams["layers"])]
        for p in leaves:
            p.requires_grad_(True)
        grads = torch.autograd.grad(
            tmodel.apply(tparams, {"input_ids": torch.from_numpy(ids)}),
            leaves)
    finally:
        jckpt.configure(policy="nothing_saveable")
        tckpt.reset()
    for g, k in zip(grads, sorted(ref["layers"])):
        r = np.asarray(ref["layers"][k])
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())


# ---------------------------------------------------------------------------
# forward / backward / step (JAX engine.py:1828-1960)
# ---------------------------------------------------------------------------
def _shim_steps(eng, batches, jax_engine=False):
    for b in batches:
        for g in range(GAS):
            micro = {"input_ids": b["input_ids"][g]}
            loss = eng.forward(micro) if not jax_engine else eng(micro)
            eng.backward(loss)
        eng.step()


@pytest.mark.parametrize("stage", [0, 3])
def test_shims_equal_train_batch_and_jax(stage):
    """forward/backward/step over gas 2 give train_batch's params bit for
    bit, and JAX's forward/backward/step within 1e-5 (fp32)."""
    config = dict(TRAIN_CONFIG, zero_optimization={"stage": stage})
    jeng = _jax_engine(config)
    w = params_from_numpy(_engine_weights(jeng))
    a, b = (deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=config, params=w, device="cpu")[0] for _ in range(2))
    batches = [{"input_ids": _ids(70 + i, (GAS, MICRO, S))}
               for i in range(2)]
    for bt in batches:
        a.train_batch(batch=bt)
    _shim_steps(b, batches)
    _shim_steps(jeng, batches, jax_engine=True)
    for p, q in zip(a._param_leaves, b._param_leaves):
        assert torch.equal(p, q)
    assert b.global_steps == a.global_steps == jeng.global_steps == 2
    assert b.micro_steps == 4 and b.is_gradient_accumulation_boundary()
    ref = _engine_weights(jeng)
    for name, p in zip(b._leaf_names, b._param_leaves):
        node = ref
        for part in name.split("/"):
            node = node[part]
        np.testing.assert_allclose(p.detach().numpy(), node, rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(RuntimeError, match="without backward"):
        b.step()
    with pytest.raises(RuntimeError, match="without forward"):
        b.backward()


def test_shims_fp16_overflow_skips_like_jax():
    """backward() takes the scaled loss's gradients; at 2**40 they
    overflow, step() skips (global_steps, schedule and params hold) and
    the scale halves — the JAX compat path's sequence."""
    config = dict(TRAIN_CONFIG, fp16={"enabled": True,
                                      "initial_scale_power": 40,
                                      "hysteresis": 1})
    jeng = _jax_engine(config)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=config, params=params_from_numpy(_engine_weights(jeng)),
        device="cpu")
    before = [p.detach().clone() for p in teng._param_leaves]
    sched = teng.lr_scheduler.state_dict()
    b = {"input_ids": _ids(80, (GAS, MICRO, S))}
    _shim_steps(teng, [b])
    _shim_steps(jeng, [b], jax_engine=True)
    assert teng.skipped_steps == jeng.skipped_steps == 1
    assert teng.global_steps == jeng.global_steps == 0
    assert teng.loss_scale == jeng.loss_scale == 2.0 ** 39
    assert teng.lr_scheduler.state_dict() == sched
    for p, q in zip(teng._param_leaves, before):
        assert torch.equal(p.detach(), q)


class _FrozenEmbedLM(TransformerLM):
    """The embedding frozen (reference requires_grad=False)."""

    def frozen_mask(self):
        return {"embed": True}


class _JFrozenEmbedLM(JModel):
    def frozen_mask(self):
        mask = jax.tree.map(lambda _: False, self.init_params(
            jax.random.PRNGKey(0)))
        mask["embed"] = True
        return mask


def test_frozen_params_hold_like_jax():
    """A frozen leaf holds on train_batch and on the shims (gradient and
    decoupled weight decay both skip it), as in JAX, and the trained
    leaves follow JAX's (1e-5); the offloaded optimizers refuse it."""
    config = dict(TRAIN_CONFIG, optimizer={
        "type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1}})
    ds = JDSConfig(config, world_size=1)
    jeng = JEngine(_JFrozenEmbedLM(JCfg(**FLAGSHIP_SMALL)), ds,
                   topology=MeshTopology(TopologyConfig(),
                                         devices=jax.devices()[:1]))
    w = params_from_numpy(_engine_weights(jeng))
    engs = [deepspeed_tpu_torch.initialize(
        model=_FrozenEmbedLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=config, params=w, device="cpu")[0] for _ in range(2)]
    embed0 = engs[0].params["embed"].detach().clone()
    b = {"input_ids": _ids(90, (GAS, MICRO, S))}
    engs[0].train_batch(batch=b)
    _shim_steps(engs[1], [b])
    jeng.train_batch(batch=b)
    ref = _engine_weights(jeng)
    for e in engs:
        assert torch.equal(e.params["embed"].detach(), embed0)
        assert not torch.equal(e.params["layers"]["wq"],
                               w["layers"]["wq"])
        np.testing.assert_allclose(e.params["layers"]["wq"].detach().numpy(),
                                   ref["layers"]["wq"], rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="frozen_mask"):
        deepspeed_tpu_torch.initialize(
            model=_FrozenEmbedLM(TransformerConfig(**FLAGSHIP_SMALL)),
            config=dict(config, zero_optimization={
                "stage": 2, "offload_optimizer": {"device": "cpu",
                                                  "pin_memory": True}}),
            params=w, device="cpu")


def test_shims_refuse_param_offload():
    config = dict(TRAIN_CONFIG, zero_optimization={
        "stage": 3, "offload_param": {"device": "cpu"}})
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=config, device="cpu")
    with pytest.raises(RuntimeError, match="offload_param cpu"):
        eng.forward({"input_ids": _ids(91)})
    eng.close()

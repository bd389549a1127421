"""PyTorch port: parameter offload to host memory (``offload_param
{device: cpu}``) and activation offload (``cpu_checkpointing``) against
the JAX package.

The model is the tiny config of JAX ``tests/unit/runtime/
test_param_offload.py`` (hidden 64, 4 layers, S 64), in fp32, its weights
the JAX engine's initial master moved by name. Held:

* ``offload_param cpu``: the stacked layer leaves live in host memory and
  the model streams them one layer at a time; losses, params and the
  evaluation loss ``torch.equal`` to the port's resident stage-3 engine
  (gas 1 and 2, alone and with the legacy optimizer offload), and within
  1e-6 of the JAX ``offload_param cpu`` engine;
* the refusals of JAX ``test_param_offload.py:116`` and
  ``test_infinity.py:142`` raise the same exception type in both packages,
  as does the tiered optimizer offload at stage 3;
* ``cpu_checkpointing``: the selective checkpoint that keeps the weight
  matmuls' outputs in host memory gives losses and gradients equal to
  ``nothing_saveable``, and within 1e-6 of the JAX ``nothing_saveable``
  engine (JAX's own policy, ``pinned_host`` offload, does not run on its
  CPU backend).
"""

import tempfile

import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.activation_checkpointing import \
    checkpointing as jckpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as tckpt

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=4, num_heads=4, max_seq_len=64, use_flash=False,
            remat=True)
MICRO, STEPS = 2, 3
# params against JAX after 3 Adam steps: losses agree to 1e-6, but an
# element whose gradient is near 0 (so is its second moment) moves by a
# few 1e-5 (lr 1e-3 a step) when the gradient is summed in another order
PARAM_ATOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def fresh_registries():
    """The JAX engines built here register metric families in the JAX
    package's process-global registry, which later test files in this
    worker read: give both packages fresh registries for this file and
    put the old ones back after."""
    from deepspeed_tpu import telemetry as jtel
    from deepspeed_tpu_torch import telemetry as ttel

    jprev = jtel.set_registry(jtel.MetricsRegistry())
    tprev = ttel.set_registry(ttel.MetricsRegistry())
    yield
    jtel.set_registry(jprev)
    ttel.set_registry(tprev)


def config(zero=None, gas=2, **extra):
    z = {"stage": 3, "stage3_param_persistence_threshold": 0}
    z.update(zero or {})
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "zero_optimization": z,
           "steps_per_print": 10 ** 9}
    cfg.update(extra)
    return cfg


def batches(gas=2):
    rng = np.random.default_rng(3)
    return [{"input_ids": rng.integers(0, 128, (gas, MICRO, 64),
                                       dtype=np.int64)}
            for _ in range(STEPS)]


def jax_engine(cfg, model_cfg=None):
    ds = JDSConfig(cfg, world_size=1)
    topo = MeshTopology(TopologyConfig(), devices=jax.devices()[:1])
    return JEngine(JModel(JCfg(**(model_cfg or TINY))), ds, topology=topo)


def port_engine(cfg, weights=None, model_cfg=None):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**(model_cfg or TINY))),
        config=cfg, device="cpu",
        params=None if weights is None else params_from_numpy(weights))
    return eng


def jax_weights(eng):
    """The JAX engine's weights before its first step (the step donates
    its buffers)."""
    tree = eng.master_params if eng.has_master else eng.params
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def port_params(eng):
    from deepspeed_tpu_torch.checkpoint import state_checkpoint as ckpt

    return {k: v.detach().float().numpy().copy()
            for k, v in ckpt.leaf_paths(eng._train_state()["params"])}


def jax_params(eng):
    flat, _ = jax.tree_util.tree_flatten_with_path(eng.params)
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in flat}


def train(eng, bs):
    return [float(eng.train_batch(batch=b)) for b in bs]


@pytest.fixture(scope="module")
def weights():
    return jax_weights(jax_engine(config()))


# ---------------------------------------------------------------------------
# offload_param {device: cpu}
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gas", [1, 2])
def test_offload_param_cpu_equals_resident_stage3(weights, gas):
    bs = batches(gas)
    res = port_engine(config(gas=gas), weights)
    off = port_engine(config({"offload_param": {"device": "cpu"}}, gas=gas),
                      weights)
    # the layer stack lives in host memory; the rest on the device
    host = off.host_stream.host
    assert set(host) == set(off.params["layers"])
    for k, v in off.params["layers"].items():
        assert v is host[k] and not v.requires_grad
    assert off.model.stream_params_from_host
    assert train(res, bs) == train(off, bs)
    pr, po = port_params(res), port_params(off)
    for k in pr:
        np.testing.assert_array_equal(pr[k], po[k], err_msg=k)
    # each fetch copies one layer: forward and recompute, gas micro-batches
    layer_bytes = sum(v[0].numel() * v.element_size() for v in host.values())
    assert off.host_stream.h2d_bytes == \
        2 * TINY["num_layers"] * gas * STEPS * layer_bytes
    assert res.eval_batch(batch=bs[0]) == off.eval_batch(batch=bs[0])


def test_host_stream_prefetch_follows_the_layer_loop():
    """The next layer's copy follows the pass the model's loop declares,
    not how often a layer was fetched: a second fetch of a layer in the
    forward still prefetches upwards."""
    from deepspeed_tpu_torch.runtime.offload import HostLayerStream

    host = {"w": torch.arange(12, dtype=torch.float32).reshape(4, 3)}
    stream = HostLayerStream(host, "cpu")
    stream.begin()
    stream.forward_sweep(True)
    ready = []
    for l in (0, 1, 1, 2, 3):
        got = stream.fetch(l)["w"]
        assert torch.equal(got, host["w"][l])
        ready.append(sorted(stream._ready))
    # up the stack; after the top layer, the top again for the recompute
    assert ready == [[1], [2], [2], [3], [3]]
    stream.forward_sweep(False)
    ready = []
    for l in (3, 2, 2, 1, 0):
        stream.fetch(l)
        ready.append(sorted(stream._ready))
    assert ready == [[2], [1], [1], [0], []]
    # one copy a fetch: nothing was prefetched that the loop did not use
    assert stream.h2d_bytes == 10 * 3 * 4


def test_offload_param_cpu_composes_with_legacy_optimizer_offload(weights):
    bs = batches()
    legacy = {"offload_optimizer": {"device": "cpu"}}
    a = port_engine(config(legacy), weights)
    b = port_engine(config(dict(legacy, offload_param={"device": "cpu"})),
                    weights)
    la, lb = train(a, bs), train(b, bs)
    assert la == lb
    pa, pb = port_params(a), port_params(b)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    a.close()
    b.close()


def test_offload_param_cpu_matches_jax():
    """JAX's host-stored layer stack runs on its CPU backend only over the
    session's 8 virtual devices (at dp=1 the step's input memory kinds
    disagree), so the oracle is the dp=8 engine JAX ``test_param_offload``
    builds, micro 1 a device; the port trains the same global batch at
    one rank, micro 8."""
    import deepspeed_tpu

    cfg = config({"offload_param": {"device": "cpu"}})
    jeng, *_ = deepspeed_tpu.initialize(model=JModel(JCfg(**TINY)),
                                        config=dict(
        cfg, train_micro_batch_size_per_gpu=1))
    assert jeng.ds_config.dp_world_size == 8
    weights = jax_weights(jeng)
    rng = np.random.default_rng(5)
    bs = [{"input_ids": rng.integers(0, 128, (2, 8, 64), dtype=np.int64)}
          for _ in range(STEPS)]
    jl = train(jeng, bs)
    teng = port_engine(dict(cfg, train_micro_batch_size_per_gpu=8), weights)
    tl = train(teng, bs)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    jp, tp = jax_params(jeng), port_params(teng)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


NVME = "__nvme__"
REJECTS = [
    # JAX test_param_offload.py:116
    ("disk device", {"offload_param": {"device": "disk"}}, {}, None),
    ("stage 2", {"stage": 2, "offload_param": {"device": "cpu"}}, {}, None),
    ("no remat", {"offload_param": {"device": "cpu"}}, {},
     dict(TINY, remat=False)),
    # JAX test_infinity.py:142
    ("nvme without a path", {"offload_param": {"device": "nvme"}}, {}, None),
    ("fp16", {"offload_param": {"device": "nvme", "nvme_path": NVME}},
     {"fp16": {"enabled": True}}, None),
    ("MoE", {"offload_param": {"device": "nvme", "nvme_path": NVME}}, {},
     dict(TINY, moe_num_experts=2, moe_top_k=1)),
    ("ZeRO++", {"offload_param": {"device": "nvme", "nvme_path": NVME},
                "zero_quantized_weights": True}, {}, None),
    ("nvme at stage 2", {"stage": 2, "offload_param": {
        "device": "nvme", "nvme_path": NVME}}, {}, None),
    # the tiered optimizer offload targets stages 1/2 only
    ("tiered at stage 3", {"offload_param": {"device": "cpu"},
                           "offload_optimizer": {"device": "cpu",
                                                 "pin_memory": True}},
     {}, None),
]


@pytest.mark.parametrize("zero,extra,model_cfg",
                         [r[1:] for r in REJECTS],
                         ids=[r[0] for r in REJECTS])
def test_offload_param_rejects_like_jax(zero, extra, model_cfg):
    path = tempfile.mkdtemp()
    zero = {k: ({kk: (path if vv == NVME else vv) for kk, vv in v.items()}
                if isinstance(v, dict) else v) for k, v in zero.items()}
    raised = []
    for build in (jax_engine, port_engine):
        with pytest.raises(Exception) as e:
            if build is jax_engine:
                build(config(zero, **extra), model_cfg)
            else:
                build(config(zero, **extra), model_cfg=model_cfg)
        raised.append(type(e.value).__name__)
    assert raised[0] == raised[1], raised
    assert raised[0] in ("ConfigError", "NotImplementedError")


# ---------------------------------------------------------------------------
# cpu_checkpointing
# ---------------------------------------------------------------------------
def test_cpu_checkpointing_equals_nothing_saveable_and_jax(weights):
    bs = batches()
    cpu_ck = {"activation_checkpointing": {"cpu_checkpointing": True}}
    out = {}
    try:
        for name, extra in (("plain", {}), ("cpu", cpu_ck)):
            eng = port_engine(config(**extra), weights)
            # the configured policy is process-global: check it while
            # this engine is the last one built
            assert tckpt.active_policy() == (
                tckpt.OFFLOAD_DOTS if extra else "nothing_saveable")
            out[name] = (train(eng, bs[:1]),
                         [g.clone() for g in eng._grad_acc],
                         train(eng, bs[1:]), port_params(eng))
        assert out["plain"][0] == out["cpu"][0]
        for a, b in zip(out["plain"][1], out["cpu"][1]):
            assert torch.equal(a, b)
        assert out["plain"][2] == out["cpu"][2]
        # JAX's cpu_checkpointing policy offloads the dots to pinned_host,
        # which its CPU backend cannot run ("No registered implementation
        # for ... annotate_device_placement for Host"): the oracle is the
        # JAX nothing_saveable engine, whose values the policy must keep
        jckpt.configure(checkpoint_in_cpu=False)
        jeng = jax_engine(config())
        assert not jckpt.get_config()["cpu_checkpointing"]
        jl = train(jeng, bs)
        np.testing.assert_allclose(out["cpu"][0] + out["cpu"][2], jl,
                                   rtol=1e-6)
        jp = jax_params(jeng)
        for k in jp:
            np.testing.assert_allclose(out["cpu"][3][k], jp[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
    finally:
        tckpt.reset()
        jckpt.configure(checkpoint_in_cpu=False)


def test_cpu_checkpointing_saves_only_weight_matmuls():
    """The forward copies each ``mm`` / ``addmm`` output and the recompute
    returns those copies in order, running everything else again."""
    from torch.utils.checkpoint import checkpoint

    w1, w2 = torch.randn(8, 8), torch.randn(8, 8)
    x = torch.randn(4, 8, requires_grad=True)
    calls = []

    def f(x):
        calls.append(1)
        return torch.tanh(torch.tanh(x @ w1) @ w2).sum()

    fwd, rec = tckpt._offload_dot_contexts()
    y = checkpoint(f, x, use_reentrant=False, preserve_rng_state=False,
                   context_fn=lambda: (fwd, rec))
    assert len(fwd.saved) == 2          # the two weight matmuls
    y.backward()
    assert len(calls) == 2 and not rec.saved     # recomputed, all used
    x2 = x.detach().clone().requires_grad_()
    f(x2).backward()
    assert torch.equal(x.grad, x2.grad)

"""PyTorch port: universal checkpoints (``checkpoint/universal.py``) and
the engine's ``load_universal_checkpoint`` against the JAX package.

The model is the flagship small config of ``tests/test_torch_training.py``
(2 layers, flash from S = 128), its weights drawn by the JAX package and
moved by name; the JAX engines run on one device, dp = 1. Held:

* a native checkpoint of either package converted by the port's
  ``ds_to_universal`` equals the JAX package's conversion of it: the same
  files, the same manifest, every fragment array-equal (so a universal
  directory of either package loads into the other); the same for a flat
  ``.npz`` state dict;
* the JAX package's universal tooling reads the port's directories
  (``load_universal_params`` / ``load_universal_into_tree``, both
  sections) and the JAX engine loads a port-written weights directory;
* the port's engine loads a JAX-converted directory: its master equals
  the JAX engine's (f32, exact) and its next losses follow the JAX
  engine's continuing trajectory (1e-5, fp32);
* optimizer moments, the step counter, global_steps, the lr schedule and
  the fp16 scale state restore: an engine loaded from the universal
  directory continues exactly (``torch.equal``) as the same engine loaded
  from the native checkpoint — resident at ZeRO 0 / 3, tiered and host
  C++ offload — and a stage-0 save loads at stage 3;
* the CLI (``python -m deepspeed_tpu_torch.checkpoint.universal``) runs;
  ``checkpoint.load_universal`` is accepted (JAX reads it nowhere);
  a directory of another model is refused before anything changes.

The world-2 restore (stage 0 at one rank into stage 3 at two) is a case of
``tests/test_torch_distributed.py``'s spawn group.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu.checkpoint import universal as juni
from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import universal as tuni
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
S, MICRO, GAS = 128, 2, 2
FLAGSHIP_SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4,
                      max_seq_len=128, flash_min_seq=128)


def _config(precision="fp32", stage=0, offload=None, fp16_power=None):
    cfg = {
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 1e-4,
                                 "warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 4}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": stage,
                              "stage3_prefetch_bucket_size": 20000},
        "steps_per_print": 10 ** 9,
        "telemetry": {"enabled": False},
    }
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    if fp16_power is not None:
        cfg["fp16"] = {"enabled": True, "initial_scale_power": fp16_power,
                       "hysteresis": 1}
    if offload is not None:
        cfg["zero_optimization"]["offload_optimizer"] = dict(offload)
    return cfg


@pytest.fixture(scope="module")
def weights():
    jmodel = JModel(JCfg(**FLAGSHIP_SMALL))
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jmodel.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def other_weights():
    jmodel = JModel(JCfg(**FLAGSHIP_SMALL))
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jmodel.init_params(jax.random.PRNGKey(9)))


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 256, (GAS, MICRO, S),
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


def _train(eng, seeds):
    return [float(eng.train_batch(batch={"input_ids": _ids(s)}))
            for s in seeds]


def _same_dirs(a, b):
    """Two universal directories: the same files, manifests and arrays."""
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    with open(os.path.join(a, tuni.MANIFEST)) as fa, \
            open(os.path.join(b, tuni.MANIFEST)) as fb:
        ma, mb = json.load(fa), json.load(fb)
    assert ma == mb
    for name in os.listdir(a):
        if name.endswith(".npy"):
            x, y = np.load(os.path.join(a, name)), np.load(
                os.path.join(b, name))
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    return ma


@pytest.fixture(scope="module")
def saved(weights, tmp_path_factory):
    """A native checkpoint of each package after 2 bf16 steps, and its
    two conversions."""
    root = tmp_path_factory.mktemp("universal")
    out = {}
    jeng = _jax_engine(_config("bf16"))
    _train(jeng, (1, 2))
    jeng.save_checkpoint(str(root / "jax_ck"), tag="t")
    teng = _port(_config("bf16"), weights)
    _train(teng, (1, 2))
    teng.save_checkpoint(str(root / "port_ck"), tag="t")
    for src in ("jax", "port"):
        ck = str(root / f"{src}_ck")
        out[src] = (ck, juni.ds_to_universal(ck, str(root / f"{src}_by_jax")),
                    tuni.ds_to_universal(ck, str(root / f"{src}_by_port")))
    return out


@pytest.mark.parametrize("src", ["jax", "port"])
def test_conversion_equals_jax(saved, src):
    _, by_jax, by_port = saved[src]
    m = _same_dirs(by_jax, by_port)
    assert m["format"] == "deepspeed_tpu_universal/1"
    assert m["step"] == 2 and m["meta"]["global_steps"] == 2
    assert m["opt_state"] and all(v["dtype"] == "float32"
                                  for v in m["params"].values())


def test_flat_archive_conversion_equals_jax(weights, tmp_path):
    eng = _port(_config("bf16"), weights)
    path = eng.save_16bit_model(str(tmp_path), "model.npz")
    _same_dirs(juni.ds_to_universal(path, str(tmp_path / "j")),
               tuni.ds_to_universal(path, str(tmp_path / "t")))


def test_jax_reads_port_universal(saved, weights):
    """The JAX tooling reads both sections of a port-written directory
    into the JAX tree, equal to the port's own reading."""
    _, _, by_port = saved["port"]
    jtpl = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), weights)
    jtree = juni.load_universal_into_tree(by_port, jtpl)
    ttree = tuni.load_universal_into_tree(
        by_port, params_from_numpy(jax.tree.map(np.zeros_like, weights)))
    jflat = juni.load_universal_params(by_port, section="opt_state")
    tflat = tuni.load_universal_params(by_port, section="opt_state")
    assert sorted(jflat) == sorted(tflat) and jflat
    for k in jflat:
        np.testing.assert_array_equal(jflat[k], tflat[k])
    for k, v in ttree["layers"].items():
        np.testing.assert_array_equal(v.numpy(), jtree["layers"][k])
    np.testing.assert_array_equal(ttree["embed"].numpy(), jtree["embed"])
    assert juni.load_universal_extras(by_port) == \
        tuni.load_universal_extras(by_port)


def test_jax_engine_loads_port_weights_directory(weights, other_weights,
                                                 tmp_path):
    """A weights-only directory (from the port's 16-bit export) loads
    into the JAX engine: its master equals the port's weights."""
    eng = _port(_config("fp32"), weights)
    _train(eng, (3,))
    path = eng.save_16bit_model(str(tmp_path), "model.npz")
    uni = tuni.ds_to_universal(path, str(tmp_path / "u"))
    jeng = _jax_engine(_config("fp32", stage=1))
    jeng.load_universal_checkpoint(uni)
    got = jax.tree.map(lambda x: np.asarray(x, np.float32),
                       jeng.master_params)
    for k, p in zip(eng._leaf_names, eng._param_leaves):
        node = got
        for part in k.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node, p.detach().numpy(), err_msg=k)


def test_port_engine_follows_jax_after_universal_load(other_weights,
                                                      tmp_path):
    """fp32: a JAX engine trains 2 steps, saves; the JAX conversion loads
    into a port engine of other weights (moments and step included),
    which then follows the JAX engine's next 2 steps."""
    jeng = _jax_engine(_config("fp32", stage=1))
    _train(jeng, (4, 5))
    jeng.save_checkpoint(str(tmp_path / "ck"), tag="t")
    uni = juni.ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "u"))
    teng = _port(_config("fp32", stage=0), other_weights)
    teng.load_universal_checkpoint(uni)
    assert teng._step == teng.global_steps == 2
    master = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jeng.master_params)
    np.testing.assert_array_equal(teng.params["layers"]["wq"].detach()
                                  .numpy(), master["layers"]["wq"])
    for s in (6, 7):
        jl = float(jeng.train_batch(batch={"input_ids": _ids(s)}))
        tl = teng.train_batch(batch={"input_ids": _ids(s)})
        assert abs(tl - jl) <= 1e-5, (tl, jl)
    assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)


def _state_of(eng):
    if eng.host_opt is not None:
        master, moments = eng.host_opt.get_all_leaves()
        return [m.clone() for m in master], {
            k: [t.clone() for t in v] for k, v in moments.items()}
    master = eng._master_leaves or eng._param_leaves
    return [m.detach().clone() for m in master], {
        k: [t.clone() for t in v] for k, v in eng.opt_state.items()}


TARGETS = {
    "stage0": _config("fp32", stage=0),
    "stage3": _config("fp32", stage=3),
    "tiered": _config("fp32", stage=2,
                      offload={"device": "cpu", "pin_memory": True}),
    "host_cpu": _config("fp32", stage=2, offload={"device": "cpu"}),
}


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_universal_load_equals_native_load(weights, other_weights, tmp_path,
                                           target):
    """A stage-0 fp32 engine trains 2 steps and saves; into fresh engines
    of other weights at ``target``, the native checkpoint and its
    universal conversion restore the same master, moments, step and
    schedule, and the next 2 steps are bit-identical."""
    src = _port(_config("fp32", stage=0), weights)
    _train(src, (8, 9))
    src.save_checkpoint(str(tmp_path / "ck"), tag="t")
    uni = tuni.ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "u"))
    nat = _port(TARGETS[target], other_weights)
    nat.load_checkpoint(str(tmp_path / "ck"), tag="t")
    un = _port(TARGETS[target], other_weights)
    un.load_universal_checkpoint(uni)
    assert (un._step, un.global_steps, un.get_lr()) == \
        (nat._step, nat.global_steps, nat.get_lr()) == (2, 2, nat.get_lr())
    (m1, o1), (m2, o2) = _state_of(nat), _state_of(un)
    assert all(torch.equal(a, b) for a, b in zip(m1, m2))
    assert all(torch.equal(a, b) for k in o1 for a, b in zip(o1[k], o2[k]))
    assert _train(un, (10, 11)) == _train(nat, (10, 11))
    for e in (src, nat, un):
        e.close()


def test_fp16_scale_state_restores(weights, other_weights, tmp_path):
    """An fp16 engine whose first step overflows (scale 2**40, hysteresis
    1) halves its scale; the universal directory carries it."""
    src = _port(_config("fp32", fp16_power=40), weights)
    _train(src, (12, 13))
    assert src.skipped_steps >= 1 and src.loss_scale < 2.0 ** 40
    src.save_checkpoint(str(tmp_path / "ck"), tag="t")
    uni = tuni.ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "u"))
    dst = _port(_config("fp32", fp16_power=16), other_weights)
    dst.load_universal_checkpoint(uni)
    assert dst.loss_scale == src.loss_scale
    for k, v in src.scale_state.items():
        assert torch.equal(dst.scale_state[k], v), k
    assert _train(dst, (14,)) == _train(src, (14,))


def test_mismatched_directory_is_refused(weights, tmp_path):
    eng = _port(_config("fp32"), weights)
    path = eng.save_16bit_model(str(tmp_path), "model.npz")
    uni = tuni.ds_to_universal(path, str(tmp_path / "u"))
    small = dict(FLAGSHIP_SMALL, hidden_size=64, intermediate_size=128)
    other, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**small)),
        config=_config("fp32"), device="cpu")
    before = [p.detach().clone() for p in other._param_leaves]
    with pytest.raises(ValueError, match="does not match"):
        other.load_universal_checkpoint(uni)
    assert all(torch.equal(a, b.detach())
               for a, b in zip(before, other._param_leaves))


def test_cli_and_load_universal_key(weights, tmp_path):
    eng = _port(dict(_config("fp32"),
                     checkpoint={"load_universal": True}), weights)
    _train(eng, (15,))
    eng.save_checkpoint(str(tmp_path / "ck"))
    out = tmp_path / "u"
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.checkpoint.universal",
         str(tmp_path / "ck"), str(out)], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "universal checkpoint written" in proc.stdout
    assert (out / "latest").read_text() == "global_step1"
    assert tuni.has_universal_opt_state(str(out))
    assert tuni.main([str(tmp_path / "ck"), str(tmp_path / "u2")]) == 0
    _same_dirs(str(out), str(tmp_path / "u2"))

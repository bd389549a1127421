"""PyTorch port: native checkpoints against the JAX package.

Both packages write one ``.npy`` fragment per leaf plus ``manifest.json``
and ``latest`` (``checkpoint/state_checkpoint.py``). Held here, on the
flagship small model (2 layers) with JAX-drawn weights:

* the port's checkpoint loads into the JAX engine, and the JAX engine's
  into the port's, for the resident (fp32 and bf16), legacy-offload and
  tiered-offload engines; the next step's loss agrees within the
  trajectory tolerances (1e-5 fp32, 3e-2 bf16), and the manifests' keys,
  files, shapes and dtypes equal what the JAX engine writes for the same
  config;
* a port save and load resumes bit-identically (the next loss and the
  state), for the resident, legacy and tiered engines, also with
  ``checkpoint.async_save`` while the saving engine trains on;
* ``zero_to_fp32`` over a port checkpoint equals the JAX tool over it;
* the v1 ``init_inference(checkpoint=...)`` logits equal
  ``init_inference(params=...)``'s on the same weights;
* a bfloat16 fragment (descr ``'<V2'``) reads through the manifest.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine
from deepspeed_tpu.utils import zero_to_fp32 as jz2f

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import state_checkpoint as tsc
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.utils import zero_to_fp32 as tz2f

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

S, MICRO, GAS = 128, 2, 2

# _flagship_cfg(small=True) (__graft_entry__.py:120), flash from S = 128
FLAGSHIP_SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4,
                      max_seq_len=128, flash_min_seq=128)

KINDS = {
    "resident_fp32": ("fp32", None),
    "resident_bf16": ("bf16", None),
    "legacy_bf16": ("bf16", {"device": "cpu"}),
    "tiered_bf16": ("bf16", {"device": "cpu", "pin_memory": True}),
}
TOL = {"fp32": 1e-5, "bf16": 3e-2}


def _config(kind, async_save=False):
    precision, offload = KINDS[kind]
    cfg = {
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 1e-4,
                                 "warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 2}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 2},
        "steps_per_print": 10 ** 9,
        "telemetry": {"enabled": False},
        "bf16": {"enabled": precision == "bf16"},
    }
    if offload is not None:
        cfg["zero_optimization"]["offload_optimizer"] = dict(offload)
        cfg["zero_optimization"]["stage3_prefetch_bucket_size"] = 20000
    if async_save:
        cfg["checkpoint"] = {"async_save": True}
    return cfg


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


def _jax_weights(jeng):
    """The JAX engine's weights before its first step (the step donates
    its buffers)."""
    if jeng.host_opt is not None:
        leaves = [np.array(m, np.float32)
                  for m in jeng.host_opt.get_master_leaves()]
        return jax.tree_util.tree_unflatten(jeng._param_treedef, leaves)
    tree = jeng.master_params if jeng.has_master else jeng.params
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _close_jax(jeng):
    if jeng.host_opt is not None:
        jeng.host_opt.close()


@pytest.fixture(scope="module")
def weights():
    jmodel = JModel(JCfg(**FLAGSHIP_SMALL))
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jmodel.init_params(jax.random.PRNGKey(0)))


def _layout(ckpt_dir):
    with open(os.path.join(ckpt_dir, "manifest.json")) as fh:
        man = json.load(fh)
    return man["tensors"], sorted(man["meta"])


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpoint_crosses_packages(weights, kind, direction, tmp_path):
    cfg = _config(kind)
    jeng = _jax_engine(cfg)
    teng = _port(cfg, _jax_weights(jeng))
    for i in range(2):
        b = {"input_ids": _ids(10 + i)}
        jeng.train_batch(batch=b)
        teng.train_batch(batch=b)
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    teng.save_checkpoint(str(tmp_path / "port"), tag="t")
    # the same files, keys, shapes and dtypes as the JAX engine writes
    assert _layout(tmp_path / "port" / "t") == _layout(tmp_path / "jax" / "t")
    assert (tmp_path / "port" / "latest").read_text() == "t"

    nxt = {"input_ids": _ids(20)}
    if direction == "port_to_jax":
        loader = _jax_engine(cfg)
        loader.load_checkpoint(str(tmp_path / "port"), tag="t")
        ref, got = teng.train_batch(batch=nxt), float(
            loader.train_batch(batch=nxt))
        assert loader.global_steps == 3
        _close_jax(loader)
    else:
        loader = _port(cfg, weights)
        path, client = loader.load_checkpoint(str(tmp_path / "jax"))
        assert path == str(tmp_path / "jax") and client == {}
        assert loader.global_steps == 2 and loader._step == 2
        assert loader.lr_scheduler.last_step == 2
        ref, got = float(jeng.train_batch(batch=nxt)), loader.train_batch(
            batch=nxt)
        loader.close()
    assert abs(got - ref) <= TOL[KINDS[kind][0]], (kind, got, ref)
    teng.close()
    _close_jax(jeng)


# ---------------------------------------------------------------------------
# port save -> port load
# ---------------------------------------------------------------------------
def _state(eng):
    st = eng._train_state()
    return [(f"{name}/{k}", v.detach().clone())
            for name, sub in st.items() if sub is not None
            for k, v in tsc.leaf_paths(sub)]


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("kind", ["resident_bf16", "legacy_bf16",
                                  "tiered_bf16"])
def test_port_resume_is_bit_identical(weights, kind, async_save, tmp_path):
    cfg = _config(kind, async_save)
    eng = _port(cfg, weights)
    for i in range(2):
        eng.train_batch(batch={"input_ids": _ids(30 + i)})
    saved = _state(eng)
    eng.save_checkpoint(str(tmp_path), client_state={"epoch": 7})
    # the saving engine trains on while an async write may be in flight
    nxt = [{"input_ids": _ids(40 + i)} for i in range(2)]
    ref = [eng.train_batch(batch=b) for b in nxt]
    eng._join_pending_saves()
    assert (tmp_path / "latest").read_text() == "global_step2"

    fresh = _port(cfg, weights)
    path, client = fresh.load_checkpoint(str(tmp_path))
    assert client == {"epoch": 7} and fresh.global_steps == 2
    for (name, a), (_, b) in zip(saved, _state(fresh)):
        assert torch.equal(a, b), name
    assert [fresh.train_batch(batch=b) for b in nxt] == ref
    for (name, a), (_, b) in zip(_state(eng), _state(fresh)):
        assert torch.equal(a, b), name
    eng.close()
    fresh.close()


def test_load_without_optimizer_states_keeps_moments(weights, tmp_path):
    cfg = _config("resident_bf16")
    eng = _port(cfg, weights)
    eng.train_batch(batch={"input_ids": _ids(50)})
    eng.save_checkpoint(str(tmp_path), tag="a")
    other = _port(cfg, weights)
    other.train_batch(batch={"input_ids": _ids(51)})
    moments = [m.clone() for m in other.opt_state["exp_avg"]]
    other.load_checkpoint(str(tmp_path), tag="a", load_optimizer_states=False)
    assert all(torch.equal(a, b)
               for a, b in zip(moments, other.opt_state["exp_avg"]))
    assert all(torch.equal(a, b)
               for a, b in zip(eng._master_leaves, other._master_leaves))
    assert other.load_checkpoint(str(tmp_path / "none")) == (None, {})


@pytest.mark.parametrize("kind", ["resident_bf16", "legacy_bf16"])
def test_checkpoint_without_master_loads_params_as_master(weights, kind,
                                                          tmp_path):
    """An fp32 ZeRO-0 checkpoint holds no master: an engine that keeps one
    takes the params' f32 value (not its own stale master)."""
    cfg = dict(_config("resident_fp32"), zero_optimization={"stage": 0})
    src = _port(cfg, weights)
    src.train_batch(batch={"input_ids": _ids(55)})
    src.save_checkpoint(str(tmp_path), tag="a")
    assert json.loads((tmp_path / "a" / "manifest.json").read_text())[
        "tensors"]["master_params"] == "__none__"
    dst = _port(_config(kind), weights)
    dst.load_checkpoint(str(tmp_path), tag="a")
    master = (dst.host_opt.get_all_leaves()[0] if dst.host_opt is not None
              else dst._master_leaves)
    for a, b, p in zip(src._param_leaves, master, dst._param_leaves):
        assert torch.equal(a.detach(), b)
        assert torch.equal(a.detach().bfloat16(), p.detach())
    dst.close()


def test_async_save_failure_raises_at_barrier(weights, tmp_path,
                                              monkeypatch):
    def boom(*a, **kw):
        raise OSError("disk full")

    eng = _port(_config("resident_fp32", async_save=True), weights)
    monkeypatch.setattr(tsc, "save_state", boom)
    eng.save_checkpoint(str(tmp_path), tag="t")
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        eng._join_pending_saves()
    eng._join_pending_saves()       # the error is reported once


# ---------------------------------------------------------------------------
# consolidation, 16-bit export, inference from a checkpoint, bf16 fragments
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["resident_bf16", "legacy_bf16"])
def test_zero_to_fp32_matches_jax_tool(weights, kind, tmp_path):
    eng = _port(_config(kind), weights)
    eng.train_batch(batch={"input_ids": _ids(60)})
    eng.save_checkpoint(str(tmp_path))
    got = tz2f.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    ref = jz2f.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    master, _ = (eng.host_opt.get_all_leaves() if eng.host_opt is not None
                 else (eng._master_leaves, None))
    for name, m in zip(eng._leaf_names, master):
        np.testing.assert_array_equal(got[name], m.numpy())
    out = tz2f.convert_zero_checkpoint_to_fp32_state_dict(
        str(tmp_path), str(tmp_path / "fp32.npz"))
    with np.load(out) as z:
        assert sorted(z.files) == sorted(ref)
    eng.close()


def test_save_16bit_model_matches_jax_layout(weights, tmp_path):
    cfg = _config("resident_bf16")
    jeng = _jax_engine(cfg)
    teng = _port(cfg, _jax_weights(jeng))
    jpath = jeng.save_16bit_model(str(tmp_path / "jax"))
    tpath = teng.save_16bit_model(str(tmp_path / "port"))
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            assert tz[k].dtype == jz[k].dtype and tz[k].shape == jz[k].shape
            np.testing.assert_array_equal(tz[k], jz[k])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_v1_inference_from_checkpoint_equals_params(weights, writer,
                                                    tmp_path):
    cfg = _config("resident_bf16")
    if writer == "port":
        eng = _port(cfg, weights)
        eng.train_batch(batch={"input_ids": _ids(70)})
        eng.save_checkpoint(str(tmp_path))
        trained = eng.params
    else:
        jeng = _jax_engine(cfg)
        jeng.train_batch(batch={"input_ids": _ids(70)})
        jeng.save_checkpoint(str(tmp_path))
        trained = params_from_numpy(jax.tree.map(
            lambda x: np.array(x, np.float32), jeng.master_params))
    model = TransformerLM(TransformerConfig(**FLAGSHIP_SMALL))
    icfg = {"dtype": "bfloat16", "max_out_tokens": 64}
    from_ckpt = deepspeed_tpu_torch.init_inference(
        model, config=dict(icfg, checkpoint=str(tmp_path)), device="cpu")
    from_params = deepspeed_tpu_torch.init_inference(
        model, config=icfg, params=trained, device="cpu")
    ids = _ids(71)[0]
    assert torch.equal(from_ckpt.forward(ids), from_params.forward(ids))
    with pytest.raises(NotImplementedError, match="checkpoint"):
        deepspeed_tpu_torch.init_inference(
            model, config=dict(icfg, checkpoint=str(tmp_path),
                               use_ragged=True), device="cpu")


def test_bf16_fragment_reads_through_manifest(tmp_path):
    """A bfloat16 array numpy saved through ml_dtypes has the descr
    '<V2': the port reads it by the manifest's dtype, bit for bit."""
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    np.save(tmp_path / "params__w.npy", x)
    assert np.load(tmp_path / "params__w.npy").dtype.kind == "V"
    info = {"file": "params__w.npy", "shape": [3, 5], "dtype": "bfloat16"}
    t = tsc.read_fragment(str(tmp_path), info)
    assert t.dtype == torch.bfloat16 and t.shape == (3, 5)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))
    with pytest.raises(ValueError, match="opaque"):
        tsc.read_fragment(str(tmp_path), dict(info, dtype="float32"))

"""PyTorch port: ZeRO-Infinity's NVMe parameter tier
(``runtime/zero/infinity.py``) against the JAX package's.

The model is the tiny config of JAX ``tests/unit/runtime/test_infinity.py``
(hidden 64, 4 layers, S 64) in fp32; the JAX engine's initial master (read
from its files before the first step) is the port's initial weights.
The JAX engine's layer reads are copied out of its read buffers (a
module fixture patches ``_LayerFileStream.get`` and undoes it after): its
double-buffered reader reuses a host slot once the slot's host-to-device
transfer is done, but on the CPU backend a layer's device arrays alias
that host memory, and with asynchronous dispatch a layer program can
still be reading it when the next read lands there, so its losses change
from run to run (the intermittent failures of its own
``test_infinity_loss_parity_and_files``). Held:

* losses within 1e-5 relative and the master after 3 steps within the
  params tolerance of the JAX ``InfinityParamEngine``, at gas 1 and 2,
  with the optimizer state in host RAM and on NVMe; the files' names and
  byte sizes equal JAX's; the device holds only the persistent leaves;
* checkpoints across the packages: one saved by the port's Infinity
  engine loads into a JAX resident stage-3 engine, one saved by the JAX
  Infinity engine into the port's, and the next step's loss agrees with
  the saving engine's in both directions;
* ``close`` removes the files.
"""

import os

import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=4, num_heads=4, max_seq_len=64, use_flash=False,
            remat=True)
MICRO, STEPS = 2, 3
PARAM_ATOL = 2e-5


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


@pytest.fixture(scope="module", autouse=True)
def jax_reads_copied():
    from deepspeed_tpu.runtime.zero import infinity as jinf

    get = jinf._LayerFileStream.get

    def copied(self, i, prefetch_next=None):
        return get(self, i, prefetch_next).copy()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinf._LayerFileStream, "get", copied)
        yield


def config(path, gas=1, optim_nvme=False, nvme=True):
    z = {"stage": 3, "stage3_param_persistence_threshold": 0}
    if nvme:
        z["offload_param"] = {"device": "nvme", "nvme_path": str(path)}
    if optim_nvme:
        z["offload_optimizer"] = {"device": "nvme",
                                  "nvme_path": str(path)}
    return {"train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "zero_optimization": z,
            "steps_per_print": 10 ** 9}


def batches(gas, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 128, (gas, MICRO, 64),
                                       dtype=np.int64)} for _ in range(n)]


def jax_engine(cfg):
    ds = JDSConfig(cfg, world_size=1)
    topo = MeshTopology(TopologyConfig(), devices=jax.devices()[:1])
    return JEngine(JModel(JCfg(**TINY)), ds, topology=topo)


def port_engine(cfg, weights):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**TINY)), config=cfg,
        params=params_from_numpy(weights), device="cpu")
    return eng


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.array(tree, np.float32)}


def jax_master(jeng):
    return _flat(jeng._infinity.full_master_and_state()[0])


def port_master(teng):
    master, _ = teng._infinity.get_all_leaves()
    return {k: v.numpy().copy() for k, v in zip(teng._leaf_names, master)}


def _nested(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _files(d, suffix):
    return sorted((f, os.path.getsize(os.path.join(d, f)))
                  for f in os.listdir(d) if f.endswith(suffix))


@pytest.mark.parametrize("gas,optim_nvme", [(1, False), (2, False),
                                            (1, True)])
def test_infinity_matches_jax(tmp_path, gas, optim_nvme):
    jeng = jax_engine(config(tmp_path / "jax", gas, optim_nvme))
    w0 = jax_master(jeng)
    teng = port_engine(config(tmp_path / "port", gas, optim_nvme),
                       _nested(w0))
    ji, ti = jeng._infinity, teng._infinity
    # the same files, names and byte sizes
    assert _files(ti.param_dir, ".params") == \
        _files(ji.param_dir, ".params")
    assert len(_files(ti.param_dir, ".params")) == TINY["num_layers"]
    if optim_nvme:
        assert _files(ti.optim_dir, ".optim") == \
            _files(ji.optim_dir, ".optim")
    else:
        assert ti._optim_ram[0] is not None and not \
            _files(ti.param_dir, ".optim")
    assert teng.params is None
    assert ti.device_param_bytes() == ji.device_param_bytes()
    assert ti.device_param_bytes() == sum(
        v.numel() * v.element_size() for v in ti.pp_dev.values())
    bs = batches(gas)
    jl = [float(jeng.train_batch(batch=b)) for b in bs]
    tl = [teng.train_batch(batch=b) for b in bs]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jm, tm = jax_master(jeng), port_master(teng)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    ev = batches(gas, 1, seed=9)[0]
    np.testing.assert_allclose(teng.eval_batch(batch=ev),
                               float(jeng.eval_batch(batch=ev)), rtol=1e-5)
    assert ti.timings["read_bytes"] > 0
    pdir = ti.param_dir
    teng.close()
    assert not os.path.exists(pdir)


def test_checkpoints_cross_the_packages(tmp_path):
    bs = batches(1, 4)
    # JAX Infinity saves; the port's Infinity engine loads
    jeng = jax_engine(config(tmp_path / "j"))
    w0 = jax_master(jeng)
    for b in bs[:2]:
        jeng.train_batch(batch=b)
    jeng.save_checkpoint(str(tmp_path / "ck_jax"), tag="t")
    j_next = float(jeng.train_batch(batch=bs[2]))
    teng = port_engine(config(tmp_path / "t"), _nested(w0))
    teng.load_checkpoint(str(tmp_path / "ck_jax"), tag="t")
    assert teng.global_steps == 2
    np.testing.assert_allclose(teng.train_batch(batch=bs[2]), j_next,
                               rtol=1e-5)
    # the port's Infinity engine saves; a JAX resident stage-3 engine loads
    teng.save_checkpoint(str(tmp_path / "ck_port"), tag="t")
    t_next = teng.train_batch(batch=bs[3])
    jres = jax_engine(config(tmp_path, nvme=False))
    jres.load_checkpoint(str(tmp_path / "ck_port"), tag="t")
    assert jres.global_steps == 3
    np.testing.assert_allclose(float(jres.train_batch(batch=bs[3])), t_next,
                               rtol=1e-5)
    teng.close()


def test_universal_load_refused_under_infinity(tmp_path):
    """Neither package loads a universal directory into a ZeRO-Infinity
    engine: the JAX loader maps the weights over the engine's master tree,
    which is None under Infinity, and fails with ``ValueError``; the port
    refuses with ``NotImplementedError`` (a native checkpoint loads:
    ``test_checkpoints_cross_the_packages``)."""
    from deepspeed_tpu.checkpoint import universal as juni

    jres = jax_engine(config(tmp_path, nvme=False))
    jres.save_checkpoint(str(tmp_path / "ck"), tag="t")
    juni.ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "uni"))
    jinf = jax_engine(config(tmp_path / "j"))
    with pytest.raises(ValueError):
        jinf.load_universal_checkpoint(str(tmp_path / "uni"))
    jinf._infinity.close()
    teng = port_engine(config(tmp_path / "t"), _nested(jax_master(jinf)))
    with pytest.raises(NotImplementedError, match="offload_param nvme"):
        teng.load_universal_checkpoint(str(tmp_path / "uni"))
    teng.close()

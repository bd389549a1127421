"""PyTorch port: the memory tiers at world 4 over gloo against the JAX
package: ZeRO-Infinity at N ranks and at tp > 1, the offload tiers at
tp / sp / MiCS > 1, LAMB over the tiered tier at N ranks.

One group of four ranks, started by ``torch.multiprocessing.spawn``, runs
every case in turn (``tests/torch_tiers_dist_worker.py``, which imports
only the port) and writes what each rank saw; the JAX oracles run in this
process meanwhile. They are ``DeepSpeedTpuEngine``s on
``jax.devices()[:4]`` built with ``TopologyConfig(model=..., seq=...,
mics_shard=...)``, whose initial weights (taken before the first step,
the same at every topology and in every tier) and numpy batches both
packages train on: the tiny model of ``tests/test_torch_infinity.py``
(hidden 64, 4 layers, S 64, fp32), AdamW or LAMB, clipping 0.5, gas 2, a
global micro-batch of 4 rows. The JAX Infinity engine's layer reads are
copied out of its read buffers (``test_torch_infinity.py``'s fixture:
its reader races on the CPU backend otherwise), and both packages get
fresh metric registries for the file.

Held:
* losses within 1e-5 relative and params after 3 steps within 2e-5
  absolute of JAX for ZeRO-Infinity at dp 4 and dp 2 x tp 2 (its
  optimizer state in host RAM; once on NVMe), the tiered optimizer
  offload and the host C++ optimizer (stage 2) and ``offload_param`` cpu
  (stage 3) at dp 2 x tp 2, dp 2 x sp 2 and MiCS 2 x dp 2, and LAMB over
  the tiered tier at dp 4 and dp 2 x tp 2; every rank the same losses
  and whole params;
* each tiered engine ``torch.equal`` to the port's resident engine at the
  same composition (losses, master, moments): offloading moves storage,
  not bits (JAX ``runtime/offload.py:38-45``);
* the shard geometry JAX keeps: each rank's Infinity layer files hold its
  piece (1 / dp) of its tensor-parallel slice; under Ulysses the offload
  tiers' master is cut over the data ranks only (JAX's ``include_seq``
  is off there), under tensor parallelism it is the data shard of the
  rank's slice;
* a checkpoint saved by the Infinity engine at dp 2 x tp 2 loads into the
  port's Infinity engine at world 1 and into a JAX resident stage-3
  engine, and the next loss agrees within 1e-5;
* the compositions JAX refuses by design are refused by the port with
  the same exception type: Infinity with a seq axis or MiCS
  (``NotImplementedError``), LAMB on the host C++ optimizer
  (``ValueError``: no host LAMB in either package).
"""

import os
import socket
import time

import numpy as np
import pytest

import jax
import torch
import torch.multiprocessing as mp

from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

import torch_tiers_dist_worker as W
from test_torch_infinity import fresh_registries, jax_reads_copied  # noqa: F401

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

HANG_GUARD_S = 300
PARAM_ATOL = 2e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


def _master(eng):
    if getattr(eng, "_infinity", None) is not None:
        return _flat(eng._infinity.full_master_and_state()[0])
    if getattr(eng, "host_opt", None) is not None:
        return _flat(jax.tree_util.tree_unflatten(
            eng._param_treedef,
            [np.array(x, np.float32)
             for x in eng.host_opt.get_master_leaves()]))
    return _flat(eng.master_params if eng.has_master else eng.params)


def _start_from(eng, weights):
    """The JAX Infinity and host C++ optimizer engines draw their initial
    master on the host, eagerly, and round some elements otherwise than
    the jitted init (~1e-8): they start from ``weights`` through their own
    loaders, as a checkpoint restores them."""
    if getattr(eng, "_infinity", None) is not None:
        eng._infinity.load_full(_nested(weights), None)
    elif getattr(eng, "host_opt", None) is not None:
        order = jax.tree_util.tree_unflatten(
            eng._param_treedef, list(range(eng._param_treedef.num_leaves)))
        names = sorted(_flat(order), key=lambda k: _flat(order)[k])
        eng.host_opt.load_leaves([weights[k] for k in names], None)
        eng._push_host_params(eng.host_opt.current_bf16_leaves())


def _jax_engine(cfg, world=W.WORLD, tp=1, sp=1, mics=1):
    return JEngine(JModel(JCfg(**W.TINY)), JDSConfig(cfg, world_size=world),
                   topology=MeshTopology(
                       TopologyConfig(model=tp, seq=sp, mics_shard=mics),
                       devices=jax.devices()[:world]))


def _jax_case(name, path):
    tp, sp, mics, _, _ = W.CASES[name]
    return _jax_engine(W.train_config(name, nvme_path=path), tp=tp, sp=sp,
                       mics=mics)


@pytest.fixture(scope="module")
def results(tmp_path_factory, fresh_registries, jax_reads_copied):  # noqa: F811
    work = str(tmp_path_factory.mktemp("tiers_dist"))
    rng = np.random.default_rng(23)
    batches = [{"input_ids": rng.integers(0, W.TINY["vocab_size"],
                                          (W.GAS, W.ROWS, W.S),
                                          dtype=np.int64)}
               for _ in range(W.STEPS + 1)]
    # the initial weights (the same at every topology and tier)
    weights = _master(_jax_engine(W.train_config("tiered_dp2_tp2", 1,
                                                 tier="resident"), world=1))
    inp = {"weights": _nested(weights), "batches": batches}
    torch.save(inp, os.path.join(work, "inputs.pt"))
    ctx = mp.spawn(W.run, args=(W.WORLD, _free_port(), work),
                   nprocs=W.WORLD, join=False)
    t0 = time.monotonic()
    try:
        oracle = {}
        for name in W.CASES:
            eng = _jax_case(name, os.path.join(work, "jax_nvme"))
            _start_from(eng, weights)
            for k, v in _master(eng).items():
                np.testing.assert_array_equal(v, weights[k], err_msg=k)
            oracle[f"losses_{name}"] = [float(eng.train_batch(batch=b))
                                        for b in batches[:W.STEPS]]
            oracle[f"params_{name}"] = _master(eng)
            if getattr(eng, "_infinity", None) is not None:
                eng._infinity.close()
            del eng
    finally:
        while not ctx.join(timeout=2):
            if time.monotonic() - t0 > HANG_GUARD_S:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the world-{W.WORLD} group did not finish in "
                            f"{HANG_GUARD_S} s")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(W.WORLD)]
    return {"oracle": oracle, "ranks": ranks, "work": work, "inputs": inp,
            "weights": weights}


@pytest.mark.parametrize("name", list(W.CASES))
def test_matches_jax_at_world_4(results, name):
    o, ranks = results["oracle"], results["ranks"]
    r0 = ranks[0]
    np.testing.assert_allclose(r0[f"losses_{name}"], o[f"losses_{name}"],
                               rtol=1e-5)
    for k, v in o[f"params_{name}"].items():
        np.testing.assert_allclose(r0[f"params_{name}"][k], v, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    # every rank returns the same loss and holds the same whole params
    for r in ranks[1:]:
        assert r[f"losses_{name}"] == r0[f"losses_{name}"]
        for k in r0[f"params_{name}"]:
            np.testing.assert_array_equal(r[f"params_{name}"][k],
                                          r0[f"params_{name}"][k],
                                          err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", W.TIERED)
def test_tiered_equals_resident(results, name):
    """The tiered engine and the resident one at the same composition:
    the same losses, master and moments, bit for bit."""
    for r in results["ranks"]:
        assert r[f"losses_{name}"] == r[f"res_losses_{name}"]
        for what in ("params", "moments"):
            got, want = r[f"{what}_{name}"], r[f"res_{what}_{name}"]
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{name} {what} {k}")


@pytest.mark.parametrize("name", ["inf_dp4", "inf_dp2_tp2",
                                  "inf_nvme_dp2_tp2"])
def test_infinity_files_hold_a_piece_of_the_tp_slice(results, name):
    """Each rank's ``layer_{i}.params`` holds 1 / dp of its
    tensor-parallel slice of the layer (fp32: 4 bytes an element; the
    tiny model's leaves divide evenly), ``.optim`` three times that
    (master, exp_avg, exp_avg_sq); at dp 4 a quarter of the world-1 file
    JAX writes."""
    from deepspeed_tpu_torch.models import TransformerConfig
    from deepspeed_tpu_torch.models.transformer import tp_shard_dims

    tp, sp, _, _, _ = W.CASES[name]
    dp = W.WORLD // (tp * sp)
    dims = tp_shard_dims(TransformerConfig(**W.TINY))
    w = results["weights"]
    elems = sum(v[0].size // (tp if dims.get(k) is not None else 1)
                for k, v in w.items() if k.startswith("layers/"))
    want = [(f"layer_{i:05d}.params", 4 * elems // dp)
            for i in range(W.TINY["num_layers"])]
    for r in results["ranks"]:
        assert r[f"files_{name}"] == want
        if name.startswith("inf_nvme"):
            assert r[f"optim_files_{name}"] == [
                (f.replace(".params", ".optim"), 3 * n) for f, n in want]
    if tp == 1:
        whole = sum(v[0].size for k, v in w.items() if k.startswith("layers/"))
        assert want[0][1] * dp == 4 * whole


def test_offload_tiers_keep_jax_shard_geometry(results):
    """layers/wq [L, 64, 64]: under Ulysses (dp 2 x sp 2) the offload
    tiers cut its master over the 2 data ranks (JAX leaves the seq axis
    out of their ZeRO shard), as MiCS 2 over its shard group; at dp 2 x
    tp 2 the data shard of the rank's [L, 64, 32] column slice; at dp 4
    a quarter."""
    r0 = results["ranks"][0]
    for tier in ("tiered", "host"):
        assert r0[f"master_{tier}_dp2_sp2"]["layers/wq"] == (4, 32, 64)
        assert r0[f"master_{tier}_mics2_dp2"]["layers/wq"] == (4, 32, 64)
        assert r0[f"master_{tier}_dp2_tp2"]["layers/wq"] == (4, 32, 32)
    assert r0["master_lamb_tiered_dp4"]["layers/wq"] == (4, 16, 64)
    assert r0["master_lamb_tiered_dp2_tp2"]["layers/wq"] == (4, 32, 32)


def test_infinity_checkpoint_crosses_world4_world1_jax(results):
    """The Infinity engine's checkpoint at dp 2 x tp 2 (whole leaves)
    loads into the port's Infinity engine at world 1 and into a JAX
    resident stage-3 engine; each one's next loss is the saving engine's."""
    r0, work = results["ranks"][0], results["work"]
    ck = os.path.join(work, "ck_inf")
    b = results["inputs"]["batches"][W.STEPS]
    teng = W.engine(W.CKPT_CASE, None, world=1,
                    nvme_path=os.path.join(work, "w1"))
    teng.load_checkpoint(ck, tag="t")
    assert teng.global_steps == W.STEPS
    np.testing.assert_allclose(teng.train_batch(batch=b), r0["next_inf"],
                               rtol=1e-5)
    teng.close()
    cfg = W.train_config(W.CKPT_CASE, 1, tier="resident")
    cfg["zero_optimization"]["stage"] = 3
    jres = _jax_engine(cfg, world=1)
    jres.load_checkpoint(ck, tag="t")
    assert jres.global_steps == W.STEPS
    np.testing.assert_allclose(float(jres.train_batch(batch=b)),
                               r0["next_inf"], rtol=1e-5)


REFUSED = [
    # (sp, MiCS, tier, optimizer, JAX's exception, its message)
    (2, 1, "infinity", "adamw", NotImplementedError, "seq"),
    (1, 2, "infinity", "adamw", NotImplementedError, "MiCS"),
    (1, 1, "host", "lamb", ValueError, "lamb"),
]


@pytest.mark.parametrize("sp,mics,tier,opt,exc,match", REFUSED)
def test_refused_like_jax(tmp_path, monkeypatch, sp, mics, tier, opt, exc,
                          match):
    """JAX refuses these compositions by design on 4 virtual devices; the
    port refuses them at world 4 with the same exception type, before any
    collective runs (a topology of 4 ranks built without a group)."""
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.parallel.topology import (MeshTopology,
                                                       TopologyConfig)
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedTpuEngine

    monkeypatch.setitem(W.CASES, "refused", (1, sp, mics, tier, opt))
    cfg = W.train_config("refused", nvme_path=str(tmp_path))
    with pytest.raises(exc, match=match):
        _jax_engine(cfg, sp=sp, mics=mics)
    with pytest.raises(exc, match=match):
        DeepSpeedTpuEngine(
            TransformerLM(TransformerConfig(**W.TINY)),
            DeepSpeedConfig(cfg, world_size=W.WORLD), device="cpu",
            topology=MeshTopology(TopologyConfig(seq=sp, mics_shard=mics),
                                  world_size=W.WORLD, rank=0))

"""PyTorch port: tensor, sequence and MiCS parallelism at world 4 over gloo
against the JAX package.

One group of four ranks, started by ``torch.multiprocessing.spawn``, runs
every case in turn (``tests/torch_tp_dist_worker.py``, which imports only
the port) and writes what each rank saw; the JAX oracles run in this
process meanwhile. They are ``DeepSpeedTpuEngine``s on
``jax.devices()[:4]`` built with ``TopologyConfig(model=..., seq=...,
mics_shard=...)``, whose initial weights (the same at every topology,
taken before the first step) and numpy batches both packages train on:
the flagship small model (2 layers, 8 heads / 4 kv heads, fp32; and
4-expert MoE variants: top-2 at capacity, top-2 residual with a gelu
model, dropless top-1), AdamW or LAMB, clipping, gas 2, a global
micro-batch of 4 rows of 128 tokens.

Held: losses within 1e-5 relative and params after 3 steps within 2e-5
absolute of JAX at dp 2 x tp 2 (stages 0 and 3), tp 2 x sp 2 at stage 3
(Ulysses and ring), MiCS stage 3 (shard groups of 2), LAMB at dp 2 x tp 2
(stages 1-3, the trust ratio of whole leaves) and the MoE models at dp 2 x
tp 2 (each expert and the residual branch split on f, the gating
replicated; capacity, residual and dropless routing); every rank returns the
same loss; ``reduce_scatter: false`` is ``torch.equal`` to true; a
checkpoint saved at tp 2 loads at tp 1, into the JAX engine and through a
universal directory, and one saved at tp 1 loads at tp 2; the v1 and v2
inference engines at tp 2 give the JAX tp-2 engines' greedy streams token
for token and their logits within 2e-4; the safe-mode sweep reports a
replicated leaf one rank changed, on every rank.
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

import torch_tp_dist_worker as W

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

HANG_GUARD_S = 300


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
    return _flat(eng.master_params if eng.has_master else eng.params)


def _jax_engine(name):
    stage, tp, sp, mics, _, _ = W.CASES[name]
    return JEngine(JModel(JCfg(**W.model_cfg(name))),
                   JDSConfig(W.train_config(name), world_size=W.WORLD),
                   topology=MeshTopology(
                       TopologyConfig(model=tp, seq=sp, mics_shard=mics),
                       devices=jax.devices()[:W.WORLD]))


def _jax_tp1(micro=W.MICRO_ROWS, name="dp2_tp2_z0"):
    cfg = dict(W.train_config(name), tensor_parallel_size=1,
               train_micro_batch_size_per_gpu=micro)
    return JEngine(JModel(JCfg(**W.model_cfg(name))),
                   JDSConfig(cfg, world_size=1),
                   topology=MeshTopology(TopologyConfig(),
                                         devices=jax.devices()[:1]))


def _port_tp1(weights=None):
    """The port at world 1, tp 1, stage 0, the same global batch."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    cfg = dict(W.train_config("dp2_tp2_z0"), tensor_parallel_size=1,
               train_micro_batch_size_per_gpu=W.MICRO_ROWS)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**W.model_cfg())), config=cfg,
        device="cpu",
        params=None if weights is None else params_from_numpy(weights))
    return eng


def _jax_v1(weights):
    from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu.inference.engine import InferenceEngine

    return InferenceEngine(
        JModel(JCfg(**W.FLAGSHIP_SMALL)),
        DeepSpeedInferenceConfig.from_dict_or_kwargs(
            {"tensor_parallel": {"tp_size": 2}, "dtype": "float32",
             "max_out_tokens": 64}, {}),
        params=weights)


def _jax_v2(weights):
    from deepspeed_tpu.inference.v2 import (DSStateManagerConfig,
                                            InferenceEngineV2,
                                            RaggedInferenceEngineConfig)
    sm = DSStateManagerConfig(max_tracked_sequences=4, max_seq_len=128,
                              num_blocks=17, block_size=16)
    return InferenceEngineV2(
        JModel(JCfg(**W.FLAGSHIP_SMALL)),
        RaggedInferenceEngineConfig(state_manager=sm, dtype="float32",
                                    prefill_bucket=16,
                                    tensor_parallel_size=2),
        params=weights)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tp_dist"))
    rng = np.random.default_rng(19)
    batches = [{"input_ids": rng.integers(0, 256, (2, W.MICRO_ROWS, 128),
                                          dtype=np.int64)}
               for _ in range(W.STEPS + 1)]
    weights = _master(_jax_tp1())
    case_weights = {n: _master(_jax_tp1(name=n)) for n in W.CASES
                    if n not in W.DENSE}
    inp = {"weights": _nested(weights),
           "case_weights": {n: _nested(w) for n, w in case_weights.items()},
           "batches": batches,
           "prompts_v1": rng.integers(1, 256, (2, 9)),
           "prompt_v2": list(range(3, 12)),
           "prompts_v2": [list(range(5, 14)), list(range(40, 52))]}
    # world 1, tp 1: 3 steps, save the checkpoint the ranks load at tp 2
    teng = _port_tp1(inp["weights"])
    for b in batches[:W.STEPS]:
        teng.train_batch(batch=b)
    teng.save_checkpoint(os.path.join(work, "ck_tp1"), tag="t")
    tp1 = {"params": W.full_params(teng),
           "next": teng.train_batch(batch=batches[W.STEPS])}
    teng.close()
    torch.save(inp, os.path.join(work, "inputs.pt"))
    ctx = mp.spawn(W.run, args=(W.WORLD, _free_port(), work),
                   nprocs=W.WORLD, join=False)
    t0 = time.monotonic()
    try:
        # the JAX oracles while the ranks run
        oracle = {}
        for name in W.CASES:
            eng = _jax_engine(name)
            np.testing.assert_array_equal(
                _master(eng)["embed"],
                (weights if name in W.DENSE
                 else case_weights[name])["embed"])
            oracle[f"losses_{name}"] = [float(eng.train_batch(batch=b))
                                        for b in batches[:W.STEPS]]
            oracle[f"params_{name}"] = _master(eng)
        v1 = _jax_v1(inp["weights"])
        oracle["v1_logits"] = np.asarray(v1.forward(inp["prompts_v1"]))
        oracle["v1_tokens"] = np.asarray(v1.generate(inp["prompts_v1"],
                                                     max_new_tokens=8))
        v2 = _jax_v2(inp["weights"])
        oracle["v2_put"] = np.asarray(v2.put([1], [inp["prompt_v2"]])[0])
        oracle["v2_decode"] = np.asarray(v2.put([1], [[40]])[0])
        v2.flush(1)
        oracle["v2_tokens"] = [np.asarray(t) for t in v2.generate(
            inp["prompts_v2"], max_new_tokens=8)]
    finally:
        while not ctx.join(timeout=2):
            if time.monotonic() - t0 > HANG_GUARD_S:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the world-{W.WORLD} group did not finish in "
                            f"{HANG_GUARD_S} s")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(W.WORLD)]
    return {"oracle": oracle, "ranks": ranks, "work": work, "tp1": tp1,
            "inputs": inp}


@pytest.mark.parametrize("name", list(W.CASES))
def test_matches_jax_at_world_4(results, name):
    o, ranks = results["oracle"], results["ranks"]
    r0 = ranks[0]
    np.testing.assert_allclose(r0[f"losses_{name}"], o[f"losses_{name}"],
                               rtol=1e-5)
    for k, v in o[f"params_{name}"].items():
        np.testing.assert_allclose(r0[f"params_{name}"][k], v, rtol=0,
                                   atol=2e-5, err_msg=k)
    # every rank returns the same loss and holds the same whole params
    for r in ranks[1:]:
        assert r[f"losses_{name}"] == r0[f"losses_{name}"]
        for k in r0[f"params_{name}"]:
            np.testing.assert_array_equal(r[f"params_{name}"][k],
                                          r0[f"params_{name}"][k],
                                          err_msg=f"{name} {k}")
    # a tensor-parallel rank holds its columns of wq
    tp = W.CASES[name][1]
    assert r0[f"local_wq_{name}"][2] == 8 * 16 // tp


def test_reduce_scatter_off_is_equal(results):
    for r in results["ranks"]:
        (lt, pt), (lf, pf) = r["rs_True"], r["rs_False"]
        assert lt == lf
        for k in pt:
            assert np.array_equal(pt[k], pf[k]), k


def test_tp2_checkpoint_loads_at_tp1_in_jax_and_universal(results):
    """A checkpoint saved at dp 2 x tp 2 holds whole leaves: it loads into
    the port at tp 1, into the JAX engine, and through a universal
    directory."""
    from deepspeed_tpu_torch.checkpoint import universal as tuni

    r0, work = results["ranks"][0], results["work"]
    want = r0["params_dp2_tp2_z3"]
    ck = os.path.join(work, "ck_tp2")
    teng = _port_tp1()
    teng.load_checkpoint(ck, tag="t")
    got = W.full_params(teng)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jeng = _jax_tp1()
    jeng.load_checkpoint(ck, tag="t")
    for k, v in _master(jeng).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    b = results["inputs"]["batches"][W.STEPS]
    np.testing.assert_allclose(teng.train_batch(batch=b),
                               float(jeng.train_batch(batch=b)), rtol=1e-5)
    teng.close()
    tuni.ds_to_universal(ck, os.path.join(work, "uni_tp2"))
    ueng = _port_tp1()
    ueng.load_universal_checkpoint(os.path.join(work, "uni_tp2"))
    got = W.full_params(ueng)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    ueng.close()


def test_tp1_checkpoint_loads_at_tp2(results):
    tp1 = results["tp1"]
    for r in results["ranks"]:
        for k, v in tp1["params"].items():
            np.testing.assert_array_equal(r["from_tp1"][k], v, err_msg=k)
        np.testing.assert_allclose(r["from_tp1_next"][0], tp1["next"],
                                   rtol=1e-5)


def test_inference_tp2_matches_jax(results):
    o = results["oracle"]
    for r in results["ranks"]:
        np.testing.assert_allclose(r["v1_logits"], o["v1_logits"],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(r["v1_tokens"], o["v1_tokens"])
        assert r["v1_local_wq"][2] == 8 * 16 // 2
        np.testing.assert_allclose(r["v2_put"], o["v2_put"], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r["v2_decode"], o["v2_decode"],
                                   rtol=2e-4, atol=2e-4)
        for a, b in zip(r["v2_tokens"], o["v2_tokens"]):
            np.testing.assert_array_equal(a, b)
        assert r["v2_pool_heads"] == 4 // 2


def test_sanity_reports_a_desynced_leaf(results):
    for r in results["ranks"]:
        assert r["sanity_clean"] == {"ok": True, "problems": []}
        rep = r["sanity_desync"]
        assert not rep["ok"]
        assert any(p.startswith("params['final_norm']")
                   for p in rep["problems"]), rep
        assert not any("['wq']" in p for p in rep["problems"]), rep


def test_mics_shard_size_must_divide_the_data_world():
    """JAX ``test_zeropp.py:129``: a shard group of 3 at world 4 is
    refused, with the JAX message."""
    from deepspeed_tpu_torch.parallel import topology as ttopo

    with pytest.raises(ValueError) as want:
        MeshTopology(TopologyConfig(mics_shard=3), devices=jax.devices()[:4])
    with pytest.raises(ValueError) as got:
        ttopo.MeshTopology(ttopo.TopologyConfig(mics_shard=3), world_size=4)
    assert str(got.value) == str(want.value)

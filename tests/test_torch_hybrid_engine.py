"""PyTorch port: the RLHF hybrid engine (``runtime/hybrid_engine.py``)
against the JAX package.

A JAX ``DeepSpeedHybridEngine`` at dp = 1 (fp32, ZeRO 2, AdamW; the JAX
hybrid-engine tests' model: vocab 64, hidden 32, 2 layers) and the port's,
returned by ``deepspeed_tpu_torch.initialize`` on the CPU from the JAX
engine's initial weights. Held: the first publications' leaves bit-equal
and each package's payload staged and served by the other; generate()
after train steps token-identical, with ``weight_version`` rising at each
republish; rollout streams identical (greedy and seeded sampling, the
serving runtime's draw) with logprobs within 1e-5; LoRA fuse / unfuse bit
for bit, the fused leaves equal to JAX's ``_fused_w``; external adapters
fused at publish; the ``publish_delta`` payload bit-equal to JAX's with
JAX's quantizer jitted; the bounded queue. The expert-parallel case (ep 2,
a 4-expert MoE) runs in a group of two gloo ranks
(``tests/torch_hybrid_dist_worker.py``) against a JAX engine on two
virtual devices: the loss and the generated tokens equal.
"""

import asyncio
import os
import socket
import time
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import torch
import torch.multiprocessing as mp

from deepspeed_tpu.comm import quantized as jquant
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JInfer
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JRCfg
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JSM
from deepspeed_tpu.inference.v2.serve import weights as jw
from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime import hybrid_engine as jhy
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2 import serve as tserve
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.inference.v2.serve import weights as tw
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.runtime import hybrid_engine as thy
from deepspeed_tpu_torch.runtime.engine import DeepSpeedTpuEngine

import torch_hybrid_dist_worker as W

# the suite runs in several worker processes that share the CPUs
torch.set_num_threads(2)

CFG = W.CFG
CONFIG = W.train_config()
HANG_GUARD_S = 240


def _batch(seed, seq=16):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 64, (1, 2, seq), dtype=np.int64)}


def _np_weights(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


@pytest.fixture(scope="module")
def engines():
    """The two hybrid engines from the same weights, and each one's first
    publication (before any step)."""
    jeng = jhy.DeepSpeedHybridEngine(
        JModel(JCfg(**CFG)), JDSConfig(dict(CONFIG), world_size=1),
        topology=MeshTopology(TopologyConfig(), devices=jax.devices()[:1]))
    w0 = _np_weights(jeng.master_params if jeng.has_master else jeng.params)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**CFG)), config=dict(CONFIG),
        params=params_from_numpy(w0), device="cpu")
    return SimpleNamespace(jax=jeng, torch=teng, w0=w0,
                           jpub=jeng.publish(), tpub=teng.publish())


def test_initialize_returns_hybrid_engine(engines):
    assert isinstance(engines.torch, thy.DeepSpeedHybridEngine)
    assert engines.torch.weight_version == engines.jax.weight_version == 1
    plain, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**CFG)),
        config=dict(CONFIG, hybrid_engine={"enabled": False}), device="cpu")
    assert type(plain) is DeepSpeedTpuEngine


def _leaves(mod, payloads):
    return {k: np.asarray(v) for k, v in
            mod.stage_payload(payloads).leaves.items()}


def _fresh(mod, payloads):
    """A fresh fp32 v2 engine of package ``mod`` from a payload (the
    hybrid engine's serving geometry)."""
    if mod is jw:
        stager = jw.stage_payload(payloads)
        model = JModel(JCfg(**CFG))
        shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
        eng = JInfer(model, JRCfg(
            state_manager=JSM(max_tracked_sequences=8, max_seq_len=64,
                              num_blocks=33, block_size=16),
            dtype="float32", prefill_bucket=16),
            params=jw.flat_to_tree(shapes, stager.leaves))
    else:
        stager = tw.stage_payload(payloads)
        model = TransformerLM(TransformerConfig(**CFG))
        tree = tw.flat_to_tree(model.init_params(torch.Generator()),
                               stager.leaves)
        eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
            state_manager=DSStateManagerConfig(
                max_tracked_sequences=8, max_seq_len=64, num_blocks=33,
                block_size=16),
            dtype="float32", prefill_bucket=16), params=tree, device="cpu")
    eng.weight_version = stager.version
    return eng


def test_payloads_stage_across_packages(engines):
    jl, tl = _leaves(jw, engines.jpub), _leaves(tw, engines.tpub)
    assert list(jl) == list(tl)
    for n in jl:
        assert jl[n].tobytes() == tl[n].tobytes(), n
    # each package's payload stages in the other, bit for bit
    assert all(np.array_equal(v, _leaves(tw, engines.jpub)[n])
               for n, v in jl.items())
    assert all(np.array_equal(v, _leaves(jw, engines.tpub)[n])
               for n, v in tl.items())
    # and serves there as in its own package
    prompts = [[3, 5, 7, 9], [2, 4, 6, 8, 10, 12]]
    ref = _fresh(jw, engines.jpub).generate(prompts, max_new_tokens=6)
    for payload in (engines.jpub, engines.tpub):
        got = _fresh(tw, payload).generate(prompts, max_new_tokens=6)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_generate_after_train_steps_matches_jax(engines):
    jeng, teng = engines.jax, engines.torch
    prompt = np.array([[3, 5, 7, 9], [11, 2, 40, 33]])
    for step in range(2):
        jl = float(jeng.train_batch(batch=_batch(step)))
        tl = float(teng.train_batch(batch=_batch(step)))
        assert abs(jl - tl) <= 1e-5, step
        v0 = teng.weight_version
        jout = jeng.generate(prompt, max_new_tokens=6)
        tout = teng.generate(prompt, max_new_tokens=6)
        np.testing.assert_array_equal(tout, jout)
        assert teng.weight_version == jeng.weight_version == v0 + 1
        # a second generate at one version does not republish
        np.testing.assert_array_equal(
            teng.generate(prompt, max_new_tokens=6), tout)
        assert teng.weight_version == v0 + 1
    assert teng.latency_stats["generated_tokens"] == 4 * 2 * 6
    # the colocated engine equals a fresh one built from its payload
    jeng.publish()
    payload = teng.publish()
    assert teng.weight_version == jeng.weight_version
    ref = _fresh(tw, payload).generate([[3, 5, 7, 9]], max_new_tokens=6)
    np.testing.assert_array_equal(
        teng.generate(np.array([[3, 5, 7, 9]]), max_new_tokens=6)[0],
        ref[0])


@pytest.mark.parametrize("kw", [dict(temperature=0.0),
                                dict(temperature=0.8, top_p=0.9),
                                dict(temperature=1.0, top_k=8)])
def test_rollout_streams_match_jax(engines, kw):
    jeng, teng = engines.jax, engines.torch
    prompts = [[3, 5, 7, 9, 11], [2, 4], [60, 1, 7]]
    js = jeng.rollout(prompts, max_new_tokens=6, seed=12, enqueue=False,
                      **kw)
    ts = teng.rollout(prompts, max_new_tokens=6, seed=12, enqueue=False,
                      **kw)
    for a, b in zip(js, ts):
        assert a.tokens == b.tokens
        assert (a.prompt, a.seed, a.weight_version) == \
            (b.prompt, b.seed, b.weight_version)
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=0,
                                   atol=1e-5)
        assert all(np.isfinite(lp) and lp <= 0.0 for lp in b.logprobs)

    # the rollout is the serving runtime's stream for the same request
    async def served(prompt):
        serving = tserve.ServingEngine(teng.serving_engine,
                                       tserve.ServingConfig(token_budget=32,
                                                            chunk=16))
        await serving.start()
        try:
            s = await serving.submit(prompt, 6, seed=12, **kw)
            return await s.drain()
        finally:
            await serving.stop()
    assert ts[0].tokens == asyncio.run(served(prompts[0]))


def test_rollout_queue_bounded():
    for mod in (jhy, thy):
        q = mod.RolloutQueue(maxlen=2)
        for i in range(3):
            q.push(mod.RolloutSample([i], [i], [0.0], 1, i))
        assert len(q) == q.depth == 2
        assert [s.prompt for s in q.pop(4)] == [[1], [2]]
        assert len(q) == q.depth == 0


def _lora_tree(rng):
    return {"blk": {"proj": {
        "w": (rng.standard_normal((16, 8)) * 1e3).astype(np.float32),
        "lora_a": rng.standard_normal((16, 2)).astype(np.float32),
        "lora_b": rng.standard_normal((2, 8)).astype(np.float32),
    }}, "head": rng.standard_normal((8, 4)).astype(np.float32)}


@pytest.mark.parametrize("as_tensors", [False, True])
def test_lora_fuse_unfuse_bit_exact(as_tensors):
    tree = _lora_tree(np.random.default_rng(1))
    g = tree["blk"]["proj"]
    expected = jhy._fused_w(g["w"], g["lora_a"], g["lora_b"], 0.3)
    assert thy._fused_w(g["w"], g["lora_a"], g["lora_b"], 0.3).tobytes() \
        == expected.tobytes()
    src = params_from_numpy(tree) if as_tensors else tree
    fused = thy.fuse_lora(src, scale=0.3)
    fw = fused["blk"]["proj"]["w"]
    assert np.asarray(fw).tobytes() == expected.tobytes()
    assert thy.fuse_lora(fused, scale=0.3)["blk"]["proj"]["w"] is fw
    restored = thy.unfuse_lora(fused, scale=0.3)
    rg = restored["blk"]["proj"]
    assert np.asarray(rg["w"]).tobytes() == g["w"].tobytes()
    assert set(rg) == {"w", "lora_a", "lora_b"}
    # a group fused without the kept base: the float subtraction, as JAX's
    bare = {"w": expected, "lora_a": g["lora_a"], "lora_b": g["lora_b"]}
    assert np.asarray(thy.unfuse_lora({"p": bare}, 0.3)["p"]["w"]) \
        .tobytes() == np.asarray(
            jhy.unfuse_lora({"p": bare}, 0.3)["p"]["w"]).tobytes()


def test_publisher_fuses_lora_groups_and_adapters():
    rng = np.random.default_rng(2)
    tree = _lora_tree(rng)
    ext = {"head": (rng.standard_normal((8, 2)).astype(np.float32),
                    rng.standard_normal((2, 4)).astype(np.float32))}
    jp = jhy.WeightPublisher(tree, lora_scale=2.0)
    tp = thy.WeightPublisher(params_from_numpy(tree), lora_scale=2.0)
    for kw in (dict(fuse_lora=True), dict(adapters=ext), {}):
        jl = _leaves(jw, jp.snapshot(**kw))
        tl = _leaves(tw, tp.snapshot(**kw))
        assert all(jl[n].tobytes() == tl[n].tobytes() for n in jl), kw
    assert tl["blk/proj/w"].tobytes() == tree["blk"]["proj"]["w"].tobytes()
    with pytest.raises(ValueError, match="unknown leaf"):
        tp.snapshot(adapters={"nope": ext["head"]})


def test_publish_delta_payload_bit_equal_to_jax(monkeypatch):
    """The error-feedback chain: an anchor, then two deltas over changing
    weights; JAX's quantizer jitted (XLA's reciprocal multiply, what the
    port's quantizer reproduces)."""
    monkeypatch.setattr(jquant, "_quantize_wire", jax.jit(
        jquant._quantize_wire, static_argnums=(1, 2)))
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((64, 48)).astype(np.float32),
            "b": {"c": rng.standard_normal((300,)).astype(np.float32)}}
    pubs = {"jax": jhy.WeightPublisher(tree, bucket_bytes=8192,
                                       delta_block=256),
            "torch": thy.WeightPublisher(tree, bucket_bytes=8192,
                                         delta_block=256, device="cpu")}
    got = {k: [p.publish()] for k, p in pubs.items()}
    for step in range(2):
        tree["a"] += rng.standard_normal((64, 48)).astype(np.float32) * 0.01
        tree["b"]["c"] *= np.float32(1.001)
        for k, p in pubs.items():
            got[k].append(p.publish(delta_base=p.delta_ref_version))
    for j, t in zip(got["jax"], got["torch"]):
        assert (j.version, j.base_version) == (t.version, t.base_version)
        assert (j.delta is None) == (t.delta is None)
        for jp, tp in ([(j.full, t.full)]
                       + ([(j.delta, t.delta)] if j.delta else [])):
            jh, th = (m.stage_payload(p) for m, p in ((jw, jp), (tw, tp)))
            assert jh.header == th.header
            for n in jh.leaves:
                assert np.asarray(jh.leaves[n]).tobytes() == \
                    np.asarray(th.leaves[n]).tobytes(), n
    for n in pubs["jax"]._delta_ref:
        assert pubs["jax"]._delta_ref[n].tobytes() == \
            pubs["torch"]._delta_ref[n].tobytes()
    with pytest.raises(ValueError, match="re-anchor"):
        pubs["torch"].publish(delta_base=1)


def test_fused_vs_unfused_generate(engines):
    teng = engines.torch
    prompt = np.array([[2, 4, 6]])
    base_out = teng.generate(prompt, max_new_tokens=4)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((32, 2)).astype(np.float32)
    b = rng.standard_normal((2, 64)).astype(np.float32)
    teng.attach_lora_adapter("lm_head", a, b)
    fused_payloads = teng.publish()
    fused_out = teng.generate(prompt, max_new_tokens=4)
    ref = _fresh(tw, fused_payloads).generate([[2, 4, 6]], max_new_tokens=4)
    np.testing.assert_array_equal(fused_out[0], ref[0])
    assert not np.array_equal(fused_out, base_out)
    teng.lora_adapters.clear()
    teng.publish(fuse_lora=False)
    np.testing.assert_array_equal(teng.generate(prompt, max_new_tokens=4),
                                  base_out)


def test_consolidated_param_buckets_read_only(engines):
    teng = engines.torch
    before = [(t.data_ptr(), t.clone()) for t in teng._param_leaves]
    groups = list(teng.consolidated_param_buckets(4096))
    assert len(groups) > 1
    assert all(sum(v.nbytes for v in g.values()) <= 4096 or len(g) == 1
               for g in groups)
    flat = {k: v for g in groups for k, v in g.items()}
    assert list(flat) == teng._leaf_names
    for (ptr, old), t in zip(before, teng._param_leaves):
        assert t.data_ptr() == ptr and torch.equal(t, old)
    stub = SimpleNamespace(param_offload_nvme=True)
    with pytest.raises(NotImplementedError, match="NVMe"):
        next(DeepSpeedTpuEngine.consolidated_param_buckets(stub))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_hybrid_engine_moe_expert_parallel(tmp_path):
    """ep 2 over two gloo ranks: train a step, publish (the experts
    gathered over the expert ranks), generate on each rank's colocated
    engine; the JAX engine on two virtual devices is the oracle."""
    jeng = jhy.DeepSpeedHybridEngine(
        JModel(JCfg(**W.MOE_CFG)),
        JDSConfig(W.train_config(moe=True), world_size=W.WORLD),
        topology=MeshTopology(TopologyConfig(expert=2),
                              devices=jax.devices()[:W.WORLD]))
    assert jeng.topology.axis_size("expert") == 2
    w0 = _np_weights(jeng.master_params if jeng.has_master else jeng.params)
    batch = W.moe_batch()
    loss = float(jeng.train_batch(batch=batch))
    out = jeng.generate(np.array(W.PROMPT), max_new_tokens=W.NEW)
    work = str(tmp_path)
    torch.save({"weights": w0, "batch": batch},
               os.path.join(work, "inputs.pt"))
    ctx = mp.spawn(W.run, args=(W.WORLD, _free_port(), work),
                   nprocs=W.WORLD, join=False)
    t0 = time.monotonic()
    while not ctx.join(timeout=2):
        if time.monotonic() - t0 > HANG_GUARD_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the world-{W.WORLD} group did not finish in "
                        f"{HANG_GUARD_S} s")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(W.WORLD)]
    for r in ranks:
        assert r["hybrid"] and r["local_experts"] == 2
        assert abs(r["loss"] - loss) <= 1e-5 * max(1.0, abs(loss))
        np.testing.assert_array_equal(r["generated"], out)
        assert r["weight_version"] == jeng.weight_version

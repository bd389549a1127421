"""PyTorch port: the RLHF learner (``rl/``) and the PPO objective against
the JAX package.

The host math (``gae``, ``whiten``, ``CriticValueHead``, ``PPOLearner.pack``)
is numpy in both packages and held bit-equal on seeded inputs. The learner
step runs the PPO objective (``models/transformer.py``) through each
engine's own ``train_batch``: an fp32 JAX engine at dp = 1 (built as the
training tests build it) and the port's engine on the CPU from the same
initial weights, three steps on the same packed batches (losses within
1e-5, the weights after them within 2e-5). ``ActorLearnerLoop`` runs on a
hybrid engine of each package (rollout, reward, learn, publish every 2
iterations as an int8 delta): the rollout streams and the staleness
gauges are equal iteration by iteration.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu import rl as jrl
from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.rl import learner as jlearner
from deepspeed_tpu.runtime import hybrid_engine as jhy
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.telemetry import get_registry as jregistry

import deepspeed_tpu_torch
from deepspeed_tpu_torch import rl as trl
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.runtime import hybrid_engine as thy
from deepspeed_tpu_torch.telemetry import get_registry as tregistry

# the suite runs in several worker processes that share the CPUs
torch.set_num_threads(2)

# the JAX hybrid-engine tests' model (tests/unit/runtime/
# test_hybrid_engine.py ``_cfg``), fp32
CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
           num_heads=4, max_seq_len=64, remat=False, use_flash=False)
CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
    "zero_optimization": {"stage": 2},
    "hybrid_engine": {"enabled": True, "max_out_tokens": 64},
    "steps_per_print": 10 ** 9,
    "telemetry": {"enabled": False},
}


def _sample(mod, prompt, tokens, logprobs=None, version=3, reward=None,
            done=True):
    if logprobs is None:
        logprobs = [-0.5] * len(tokens)
    return mod.RolloutSample(list(prompt), list(tokens), list(logprobs),
                             version, 0, reward=reward, done=done)


def _samples(mod, seed, n=4, version=3):
    """Seeded rollouts: prompts of 2-6 tokens, 3-9 generated, a scalar
    or per-token reward."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(1, 64, int(rng.integers(2, 7))).tolist()
        T = int(rng.integers(3, 10))
        toks = rng.integers(1, 64, T).tolist()
        lps = (-rng.uniform(0.05, 4.0, T)).astype(np.float32).tolist()
        reward = (float(rng.normal()) if i % 2 == 0
                  else rng.normal(size=T).astype(np.float32).tolist())
        out.append(_sample(mod, p, toks, lps, version, reward))
    return out


def _fake_engine(gas=2, micro=2, dp=1, max_seq_len=64, version=5):
    return SimpleNamespace(
        gas=gas, micro_batch_size=micro,
        ds_config=SimpleNamespace(dp_world_size=dp),
        model=SimpleNamespace(cfg=SimpleNamespace(max_seq_len=max_seq_len)),
        weight_version=version)


# ---------------------------------------------------------------------------
# host math: bit-equal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("values", ["none", "T", "T+1"])
@pytest.mark.parametrize("dones", [False, True])
def test_gae_bit_equal(values, dones):
    rng = np.random.default_rng(3)
    r = rng.normal(size=17).astype(np.float32)
    v = {"none": None, "T": rng.normal(size=17).astype(np.float32),
         "T+1": rng.normal(size=18).astype(np.float32)}[values]
    d = (rng.random(17) < 0.2).astype(np.float32) if dones else None
    for ja, ta in zip(jrl.gae(r, v, d, gamma=0.97, lam=0.9),
                      trl.gae(r, v, d, gamma=0.97, lam=0.9)):
        assert ja.dtype == ta.dtype == np.float32
        assert ja.tobytes() == ta.tobytes()
    for bad in (np.zeros(5, np.float32), np.zeros(20, np.float32)):
        with pytest.raises(ValueError):
            jrl.gae(r, bad)
        with pytest.raises(ValueError):
            trl.gae(r, bad)


@pytest.mark.parametrize("mask", ["none", "random", "one", "empty"])
def test_whiten_bit_equal(mask):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 16)).astype(np.float32) * 3 + 1
    m = {"none": None, "random": (rng.random((4, 16)) < 0.5),
         "one": np.arange(64).reshape(4, 16) == 7,
         "empty": np.zeros((4, 16))}[mask]
    assert jrl.whiten(x, m).tobytes() == trl.whiten(x, m).tobytes()


def test_critic_value_head_bit_equal():
    jc, tc = jrl.CriticValueHead(gamma=0.95), trl.CriticValueHead(gamma=0.95)
    for rnd in range(3):
        js, ts = _samples(jhy, 10 + rnd, 4), _samples(thy, 10 + rnd, 4)
        assert jc.observe(js) == tc.observe(ts)
        for a, b in zip(js, ts):
            assert jc(a).tobytes() == tc(b).tobytes()
            assert jc.returns(a).tobytes() == tc.returns(b).tobytes()
    assert jc._w is not None and jc._w.tobytes() == tc._w.tobytes()


@pytest.mark.parametrize("whiten,critic", [(False, False), (True, False),
                                           (True, True)])
def test_pack_arrays_equal(whiten, critic):
    kw = dict(gamma=0.9, lam=0.8, whiten_advantages=whiten, min_bucket=8)
    vf = {}
    if critic:
        for mod, rlmod in ((jhy, jrl), (thy, trl)):
            c = rlmod.CriticValueHead(gamma=0.9, min_samples=2)
            c.observe(_samples(mod, 21, 4))
            vf[mod] = c
    jl = jrl.PPOLearner(_fake_engine(), queue=jhy.RolloutQueue(8),
                        value_fn=vf.get(jhy), **kw)
    tl = trl.PPOLearner(_fake_engine(), queue=thy.RolloutQueue(8),
                        value_fn=vf.get(thy), **kw)
    jb, jst = jl.pack(_samples(jhy, 7, 3, version=2))
    tb, tst = tl.pack(_samples(thy, 7, 3, version=2))
    assert jst == tst
    assert jb.keys() == tb.keys()
    for k in jb:
        assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape, k
        assert jb[k].tobytes() == tb[k].tobytes(), k
    # the contract errors, the same types
    for mod, rlmod in ((jhy, jrl), (thy, trl)):
        lr = rlmod.PPOLearner(_fake_engine(max_seq_len=8), **kw)
        with pytest.raises(ValueError):
            lr.pack([])
        with pytest.raises(ValueError):
            lr.pack(_samples(mod, 1, 5))
        with pytest.raises(ValueError, match="max_seq_len"):
            lr.pack([_sample(mod, [1] * 6, [2] * 4)])
        with pytest.raises(ValueError):
            lr.pack([_sample(mod, [1], [2, 3], logprobs=[-1.0])])
    assert jlearner._token_rewards(_sample(jhy, [1], [2, 3], reward=2.0)) \
        .tobytes() == trl.learner._token_rewards(
            _sample(thy, [1], [2, 3], reward=2.0)).tobytes()


def test_queue_backpressure_and_drain():
    for mod, rlmod in ((jhy, jrl), (thy, trl)):
        q = mod.RolloutQueue(3)
        lr = rlmod.PPOLearner(_fake_engine(), queue=q, min_samples=2)
        assert lr.step() is None
        q.push(_samples(mod, 0, 1)[0])
        assert q.depth == 1 and lr.step() is None
        for s in _samples(mod, 1, 4):
            q.push(s)
        assert q.depth == len(q) == 3


# ---------------------------------------------------------------------------
# the PPO objective and the learner step through the engines
# ---------------------------------------------------------------------------
def _np_weights(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


@pytest.fixture(scope="module")
def engines():
    """A JAX hybrid engine at dp = 1 and the port's from its initial
    weights (taken before its first step: the step donates buffers)."""
    jeng = jhy.DeepSpeedHybridEngine(
        JModel(JCfg(**CFG)), JDSConfig(dict(CONFIG), world_size=1),
        topology=MeshTopology(TopologyConfig(), devices=jax.devices()[:1]))
    w0 = _np_weights(jeng.master_params if jeng.has_master else jeng.params)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**CFG)), config=dict(CONFIG),
        params=params_from_numpy(w0), device="cpu")
    assert isinstance(teng, thy.DeepSpeedHybridEngine)
    return jeng, teng, w0


def test_ppo_apply_matches_jax(engines):
    """One packed PPO batch through ``model.apply`` of each package."""
    _, _, w0 = engines
    jl = jrl.PPOLearner(_fake_engine(gas=1, micro=4), kl_coef=0.3)
    batch, _ = jl.pack(_samples(jhy, 31, 4))
    ref = float(JModel(JCfg(**CFG)).apply(
        jax.tree.map(jnp.asarray, w0), jax.tree.map(jnp.asarray, batch)))
    got = float(TransformerLM(TransformerConfig(**CFG)).apply(
        params_from_numpy(w0),
        {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(got - ref) <= 1e-5, (got, ref)


def test_learner_steps_match_jax(engines):
    jeng, teng, _ = engines
    jl = jrl.PPOLearner(jeng, gamma=0.95, lam=0.9, kl_coef=0.2)
    tl = trl.PPOLearner(teng, gamma=0.95, lam=0.9, kl_coef=0.2)
    assert jl.rows == tl.rows == 2
    for step in range(3):
        jr = jl.step(_samples(jhy, 40 + step, 2, version=0))
        tr = tl.step(_samples(thy, 40 + step, 2, version=0))
        assert abs(jr.pop("loss") - tr.pop("loss")) <= 1e-5, step
        assert jr == tr
    jw = dict(jeng.consolidated_param_buckets(1 << 30).__next__())
    tw = {}
    for group in teng.consolidated_param_buckets(4096):
        tw.update(group)
    assert list(tw) == list(jw)
    for n, v in jw.items():
        np.testing.assert_allclose(tw[n], v, rtol=0, atol=2e-5, err_msg=n)


def _gauge(reg, name):
    fam = reg.get(name)
    return max(s.value for _, s in fam.series())


def test_actor_learner_loop_matches_jax(engines):
    jeng, teng, _ = engines

    def prompts_fn(i):
        rng = np.random.default_rng(100 + i)
        return [rng.integers(1, 64, size=6).tolist() for _ in range(2)]

    seen = {"jax": [], "torch": []}

    def reward_fn(pkg):
        def fn(samples):
            seen[pkg].append([(s.tokens, s.logprobs, s.weight_version)
                              for s in samples])
            return [len(set(s.tokens)) / max(len(s.tokens), 1)
                    for s in samples]
        return fn

    kw = dict(publish_every=2, min_bucket=16,
              rollout_kwargs=dict(max_new_tokens=8, temperature=1.0, seed=5))
    jloop = jrl.ActorLearnerLoop(jeng, reward_fn("jax"), prompts_fn,
                                 critic=jrl.CriticValueHead(min_samples=2),
                                 **kw)
    tloop = trl.ActorLearnerLoop(teng, reward_fn("torch"), prompts_fn,
                                 critic=trl.CriticValueHead(min_samples=2),
                                 **kw)
    jeng.publish_delta()
    teng.publish_delta()
    for it in range(4):
        jq0, tq0 = len(jeng.rollout_queue), len(teng.rollout_queue)
        jpub, tpub = jloop.iteration(), tloop.iteration()
        assert (jpub is None) == (tpub is None), it
        if jpub is not None:
            assert (jpub.version, jpub.base_version) == \
                (tpub.version, tpub.base_version)
        assert jloop._steps_since_publish == tloop._steps_since_publish
        assert _gauge(jregistry(), "rl_loop_publish_staleness_steps") == \
            _gauge(tregistry(), "rl_loop_publish_staleness_steps")
        assert _gauge(jregistry(), "rl_sample_staleness_steps") == \
            _gauge(tregistry(), "rl_sample_staleness_steps")
        assert jq0 == tq0
        for (jt, jlp, jv), (tt, tlp, tv) in zip(seen["jax"][it],
                                                seen["torch"][it]):
            assert jt == tt and jv == tv, it
            np.testing.assert_allclose(tlp, jlp, atol=1e-5)
    # the streams the loop learned from: the same rollouts again, from the
    # same published weights
    js = jeng.rollout(prompts_fn(9), max_new_tokens=8, temperature=1.0,
                      seed=5, enqueue=False, allow_stale=True)
    ts = teng.rollout(prompts_fn(9), max_new_tokens=8, temperature=1.0,
                      seed=5, enqueue=False, allow_stale=True)
    for a, b in zip(js, ts):
        assert a.tokens == b.tokens
        np.testing.assert_allclose(b.logprobs, a.logprobs, atol=1e-5)
    assert jloop.publishes == tloop.publishes == 2
    assert jloop.learner.steps == tloop.learner.steps == 4

"""PyTorch port: the multi-LoRA adapter bank of the v2 engine against the
JAX package.

One tiny fp32 model in both packages (``torch_fleet_common.Models``), its
weights drawn by JAX and moved by name, and seeded rank-4 adapters on the
q / v projections, loaded into each package's bank. Held: a batch mixing
base and adapter rows gives each row the stream it gets served alone
(ragged step, decode windows, the per-token path and the stitched
dispatch); base rows with the bank on equal the bank-less engine bit for
bit; put() logits within 2e-4 of JAX's engine with the same adapters, and
its streams equal; the banks bit-equal (``interop.lora_bank_from_numpy``);
the adapter validation raises JAX's exception types; no prefix-cache hit
across adapters; an adapter payload (either package's) over the wire
equals a direct load; the scheduler and the serving runtime serve
``adapter=`` requests as JAX's do; ``publish_adapter`` reaches every
replica through ``router.push_adapter``, and a replica added later syncs
the adapter.
"""

import asyncio
import types

import numpy as np
import pytest

import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JSM
from deepspeed_tpu.inference.v2.scheduler import \
    DynamicSplitFuseScheduler as JSched
from deepspeed_tpu.inference.v2.serve import weights as jw
from deepspeed_tpu.models.transformer import \
    lora_target_leaves as jtargets
from deepspeed_tpu.runtime import hybrid_engine as jhy

from torch_fleet_common import SERVE, SM, Models, prompts, serving_config

from deepspeed_tpu_torch.checkpoint.interop import (adapters_from_numpy,
                                                    lora_bank_from_numpy)
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.inference.v2.scheduler import \
    DynamicSplitFuseScheduler
from deepspeed_tpu_torch.inference.v2.serve import weights as tw
from deepspeed_tpu_torch.models.transformer import lora_target_leaves
from deepspeed_tpu_torch.runtime import hybrid_engine as thy

LORA = dict(max_lora_adapters=4, lora_rank=4)


@pytest.fixture(scope="module")
def models():
    return Models()


def _jax(models, bank=True, **sm):
    return JEngine(models.jmodel, JConfig(
        state_manager=JSM(**dict(SM, **sm)), dtype="float32",
        prefill_bucket=16, **(LORA if bank else {})),
        params=models.np_params)


def _torch(models, bank=True, window=8, **sm):
    return InferenceEngineV2(models.tmodel, RaggedInferenceEngineConfig(
        state_manager=DSStateManagerConfig(**dict(SM, **sm)),
        dtype="float32", prefill_bucket=16, decode_window=window,
        **(LORA if bank else {})), params=models.tparams, device="cpu")


def _adapters(cfg, seed, scale=0.6, rank=4):
    rng = np.random.default_rng(seed)
    return {p: (rng.normal(size=(cfg.num_layers, i, rank))
                .astype(np.float32) * scale,
                rng.normal(size=(cfg.num_layers, rank, o))
                .astype(np.float32) * scale)
            for p, (i, o) in lora_target_leaves(cfg).items()}


def test_targets_match_jax(models):
    assert lora_target_leaves(models.tcfg) == jtargets(models.jcfg)


@pytest.mark.parametrize("path", ["window", "per_token", "stitched"])
def test_multi_tenant_rows_equal_solo(models, path):
    ada, adb = _adapters(models.tcfg, 1), _adapters(models.tcfg, 2)
    ps = prompts((12, 17, 9))
    kw = dict(window=1 if path == "per_token" else 8)

    def engine():
        e = _torch(models, **kw)
        if path == "stitched":
            e.set_ragged_mode("off")
        return e

    base = _torch(models, bank=False).generate(ps, max_new_tokens=10)

    def solo(adapter, name, prompt):
        e = engine()
        e.load_adapter(name, adapter)
        return e.generate([prompt], max_new_tokens=10, adapter=name)[0]

    sa, sb = solo(ada, "a", ps[0]), solo(adb, "b", ps[1])
    assert np.any(sa != base[0]) and np.any(sb != base[1])
    eng = engine()
    eng.load_adapter("a", ada)
    eng.load_adapter("b", adb)
    out = eng.generate(ps, max_new_tokens=10, adapter=["a", "b", None])
    np.testing.assert_array_equal(out[0], sa)
    np.testing.assert_array_equal(out[1], sb)
    np.testing.assert_array_equal(out[2], base[2])
    # a put() mixing the three: each row's logits those of the row alone
    mixed = engine()
    mixed.load_adapter("a", ada)
    mixed.load_adapter("b", adb)
    for uid, name in ((1, "a"), (2, "b")):
        mixed.assign_adapter(uid, name)
    rows = mixed.put([1, 2, 3], ps)
    for uid, name, p, row in zip((1, 2, 3), ("a", "b", None), ps, rows):
        e = engine()
        if name:
            e.load_adapter(name, ada if name == "a" else adb)
            e.assign_adapter(7, name)
        np.testing.assert_allclose(row, e.put([7], [p])[0], rtol=0,
                                   atol=1e-5)


def test_base_slot_bit_exact_with_bank(models):
    ps = prompts((15, 22), seed=4)
    ref = _torch(models, bank=False)
    eng = _torch(models)
    eng.load_adapter("a", _adapters(models.tcfg, 1))
    assert torch.equal(torch.from_numpy(eng.put([1, 2], ps)),
                       torch.from_numpy(ref.put([1, 2], ps)))
    for e in (eng, ref):
        e.flush(1)
        e.flush(2)
    for a, b in zip(eng.generate(ps, max_new_tokens=12),
                    ref.generate(ps, max_new_tokens=12)):
        np.testing.assert_array_equal(a, b)


def test_logits_and_streams_match_jax(models):
    ada, adb = _adapters(models.tcfg, 1), _adapters(models.tcfg, 2)
    jeng, teng = _jax(models), _torch(models)
    for e in (jeng, teng):
        e.load_adapter("a", ada, scale=0.5)
        e.load_adapter("b", adb)
    # the banks, moved by name, bit for bit
    jbank = lora_bank_from_numpy({k: np.asarray(v)
                                  for k, v in jeng.lora_bank.items()})
    for k, v in jbank.items():
        assert torch.equal(v, teng.lora_bank[k]), k
    ps = prompts((12, 31, 9, 20), seed=6)
    names = ["a", None, "b", "a"]
    for uid, name in enumerate(names):
        for e in (jeng, teng):
            e.assign_adapter(uid, name)
    ref = np.asarray(jeng.put(list(range(4)), ps))
    got = teng.put(list(range(4)), ps)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
    for uid in range(4):
        jeng.flush(uid)
        teng.flush(uid)
    # greedy: generate()'s device sampler draws from each package's own
    # keys (the host-sampled scheduler streams are compared below)
    js = jeng.generate(ps, max_new_tokens=10, adapter=names)
    ts = teng.generate(ps, max_new_tokens=10, adapter=names)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(b, np.asarray(a))
    # tensor adapters (interop) load as the arrays do
    e2 = _torch(models)
    e2.load_adapter("a", adapters_from_numpy(ada), scale=0.5)
    assert all(torch.equal(e2.lora_bank[k][:, 1], teng.lora_bank[k][:, 1])
               for k in e2.lora_bank)


def test_adapter_validation_raises_as_jax(models):
    cfg = models.tcfg
    ada = _adapters(cfg, 1)

    def raised(eng, fn):
        with pytest.raises(Exception) as e:
            fn(eng)
        return type(e.value)

    cases = [
        lambda e: e.generate([[1, 2, 3]], max_new_tokens=2,
                             adapter="nope"),
        lambda e: (e.load_adapter("a", ada),
                   e.generate([[1, 2, 3]], max_new_tokens=2,
                              adapter=["a", "a"])),
        lambda e: e.load_adapter("x", {"layers/wq": ada["layers/wq"]}),
        lambda e: e.load_adapter("x", {k: (a[:, :, :2], b)
                                       for k, (a, b) in ada.items()}),
        lambda e: e.load_adapter("x", _adapters(cfg, 3, rank=8)),
        lambda e: [e.load_adapter(f"n{i}", ada) for i in range(5)],
    ]
    for fn in cases:
        assert raised(_jax(models), fn) is raised(_torch(models), fn)
    assert raised(_jax(models, bank=False),
                  lambda e: e.load_adapter("a", ada)) is ValueError
    assert raised(_torch(models, bank=False),
                  lambda e: e.load_adapter("a", ada)) is ValueError
    # a smaller rank zero-pads; unload frees the slot back to the base
    eng = _torch(models)
    assert eng.load_adapter("small", _adapters(cfg, 4, rank=2)) == 1
    assert not eng.lora_bank["qa"][:, 1, :, 2:].any()
    eng.assign_adapter(9, "small")
    assert eng.adapter_of(9) == "small"
    eng.unload_adapter("small")
    assert eng.adapter_of(9) is None and not eng.lora_bank["qb"].any()
    assert eng.load_adapter("again", ada) == 1


def test_prefix_cache_never_hits_across_adapters(models):
    eng = _torch(models, enable_prefix_caching=True)
    eng.load_adapter("tenant-a", _adapters(models.tcfg, 1))
    prompt = prompts((40,), seed=7)[0]
    toks = np.asarray(prompt, np.int64)
    sm = eng.state_manager
    eng.generate([prompt], max_new_tokens=4, uids=[1], adapter="tenant-a")
    assert sm.match_prefix(101, toks, adapter="tenant-b") == ([], 0)
    assert sm.match_prefix(102, toks) == ([], 0)
    blocks, reused = sm.match_prefix(103, toks, adapter="tenant-a")
    assert reused > 0 and blocks
    sm.flush_sequence(103)
    first = eng.generate([prompt], max_new_tokens=4, uids=[2],
                         adapter="tenant-a")
    again = eng.generate([prompt], max_new_tokens=4, uids=[3],
                         adapter="tenant-a")
    np.testing.assert_array_equal(first[0], again[0])
    eng.generate([prompt], max_new_tokens=4, uids=[4])
    _, reused = sm.match_prefix(105, toks)
    assert reused > 0
    sm.flush_sequence(105)


def test_adapter_payload_over_the_wire_equals_direct_load(models):
    ada = _adapters(models.tcfg, 1)
    prompt = prompts((11,), seed=9)[0]
    direct = _torch(models)
    direct.load_adapter("t", ada, scale=0.5)
    ref = direct.generate([prompt], max_new_tokens=8, adapter="t")[0]
    for mod in (tw, jw):
        eng = _torch(models)
        pl = mod.chunk_adapter_payload("t", ada, 7, scale=0.5)
        assert tw.is_adapter_payload(pl) and not tw.is_delta_payload(pl)
        assert tw.apply_payload(eng, pl) == 7
        assert eng.weight_version == 0
        np.testing.assert_array_equal(
            eng.generate([prompt], max_new_tokens=8, adapter="t")[0], ref)
        # a redeploy under the same name rewrites its slot
        tw.apply_payload(eng, mod.chunk_adapter_payload("t", ada, 8,
                                                        scale=2.0))
        assert eng._adapter_slots == {"t": 1}
        assert np.any(eng.generate([prompt], max_new_tokens=8,
                                   adapter="t")[0] != ref)
    # the port's payload installs in the JAX engine
    jeng = _jax(models)
    jw.apply_payload(jeng, tw.chunk_adapter_payload("t", ada, 3, 0.5))
    np.testing.assert_array_equal(
        np.asarray(jeng.generate([prompt], max_new_tokens=8,
                                 adapter="t")[0]), ref)


def test_adapter_payload_malformed_typed(models):
    eng = _torch(models)
    ada = _adapters(models.tcfg, 1)
    with pytest.raises(ValueError, match="no matching"):
        tw.adapters_from_flat({"layers/wq::a": ada["layers/wq"][0]})
    with pytest.raises(ValueError, match="no matching"):
        tw.adapters_from_flat({"layers/wq::b": ada["layers/wq"][1]})
    with pytest.raises(ValueError, match="suffixed"):
        tw.adapters_from_flat({"layers/wq": ada["layers/wq"][0]})
    with pytest.raises(ValueError, match="name"):
        tw.chunk_adapter_payload("", ada, 1)
    pl = tw.chunk_adapter_payload("t", ada, 1)
    bad = [pl[0], bytes(bytearray(pl[1])[:-8]) + b"\x00" * 8]
    with pytest.raises(ValueError):
        tw.apply_payload(eng, bad)
    half = tw.chunk_adapter_payload("t", {"layers/wq": ada["layers/wq"]}, 2)
    with pytest.raises(ValueError, match="targets"):
        tw.apply_payload(eng, half)
    assert "t" not in eng._adapter_slots


def test_scheduler_and_runtime_serve_adapters_as_jax(models):
    ada = _adapters(models.tcfg, 1)
    ps = prompts((14, 25, 8), seed=12)
    names = ["a", None, "a"]
    kws = [dict(), dict(temperature=0.8, top_p=0.9, seed=4),
           dict(temperature=0.7, top_k=20, seed=5)]
    outs = {}
    for pkg, eng, sched in (("jax", _jax(models), JSched),
                            ("torch", _torch(models),
                             DynamicSplitFuseScheduler)):
        eng.load_adapter("a", ada)
        s = sched(eng, token_budget=64)
        for uid, (p, name, kw) in enumerate(zip(ps, names, kws)):
            s.submit(uid, p, 9, adapter=name, **kw)
        with pytest.raises(KeyError):
            s.submit(99, ps[0], 2, adapter="nope")
        while s.pending():
            s.step()
        outs[pkg] = [list(map(int, s.results()[u])) for u in range(3)]

        async def run():
            serving = SERVE[pkg].ServingEngine(eng, serving_config(pkg))
            await serving.start()
            st = [await serving.submit(p, 9, adapter=n, **kw)
                  for p, n, kw in zip(ps, names, kws)]
            res = [await x.drain() for x in st]
            await serving.stop()
            return res
        outs[pkg + "_runtime"] = asyncio.run(run())
    assert outs["torch"] == outs["jax"]
    assert outs["torch_runtime"] == outs["jax_runtime"]


def test_publish_adapter_reaches_the_fleet(models):
    """``publish_adapter`` packages the hybrid engine's external adapters;
    ``router.push_weights`` routes the payload to ``push_adapter``, every
    replica installs it, and a replica added later joins holding it."""
    S = SERVE["torch"]
    ada = _adapters(models.tcfg, 3)
    publisher = types.SimpleNamespace(version=4)
    stub = types.SimpleNamespace(lora_adapters=ada, lora_scale=0.5,
                                 publisher=publisher, _serving=None)
    pl = thy.DeepSpeedHybridEngine.publish_adapter(stub, "rlhf-ada")
    jpl = jhy.DeepSpeedHybridEngine.publish_adapter(
        types.SimpleNamespace(lora_adapters=ada, lora_scale=0.5,
                              publisher=types.SimpleNamespace(version=4),
                              _serving=None), "rlhf-ada")
    header = tw.parse_weights_header(pl[0])
    assert header == jw.parse_weights_header(jpl[0])
    assert header["adapter_name"] == "rlhf-ada"
    assert float(header["adapter_scale"]) == 0.5
    assert int(header["version"]) == 5 and publisher.version == 5
    with pytest.raises(ValueError, match="no adapter leaves"):
        thy.DeepSpeedHybridEngine.publish_adapter(
            types.SimpleNamespace(lora_adapters={}, lora_scale=1.0,
                                  publisher=publisher, _serving=None), "x")
    prompt = prompts((13,), seed=2)[0]
    direct = _torch(models)
    direct.load_adapter("rlhf-ada", ada, scale=0.5)
    ref = list(map(int, direct.generate([prompt], max_new_tokens=6,
                                        adapter="rlhf-ada")[0][13:]))

    async def run():
        engines = [_torch(models), _torch(models)]
        replicas = S.build_replicas(engines, serving_config("torch"))
        router = S.ReplicaRouter(replicas, S.RouterConfig(
            monitor_interval_s=0.0))
        await router.start()
        version = await router.push_weights(pl)
        slots = [e._adapter_slots for e in engines]
        late = S.build_replicas([_torch(models)], serving_config("torch"),
                                name_prefix="late")[0]
        await router.add_replica(late)
        s = await router.submit(prompt, 6, adapter="rlhf-ada")
        out = await s.drain()
        versions = [r.weight_version for r in router.replicas]
        await router.stop()
        return version, slots, late.engine._adapter_slots, out, versions

    version, slots, late_slots, out, versions = asyncio.run(run())
    assert version == 5
    assert slots == [{"rlhf-ada": 1}] * 2 and late_slots == {"rlhf-ada": 1}
    assert versions == [0, 0, 0]
    assert out == ref

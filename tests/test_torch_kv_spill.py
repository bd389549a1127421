"""PyTorch port: the KV spill tier (``inference/v2/ragged/spill.py``) and
the handoff wire format it rides (``serve/handoff.py``) against the JAX
package (JAX ``tests/unit/inference/test_kv_spill.py:46-296``).

The model is the tiny fp32 serving model of the JAX tests (vocab 128,
hidden 64, 2 layers, 4 / 2 heads, block 16), its weights the JAX
package's moved by name. Held:

* a conversation's turn 2 after its turn-1 prefix was spilled: greedy
  streams equal the JAX spill engine's and a never-pressured engine's;
  seeded sampled streams equal the port's own unpressured engine's
  (``generate()``, device-side sampling) and the JAX spill engine's through
  the scheduler (host-side sampling, the path both packages share);
  the spilled prefix is admitted as a hit;
* last-touch LRU order; the disk tier's round trip and its removal when
  the serving loop drains; a peer's disk namespace adopted and restored
  from; a corrupt entry dropped and recomputed; more
  conversations kept available than the pool holds; the int8 pool;
  a restore that never evicts its own chain; the config's refusals;
* a block the JAX engine spilled (its ``.npz`` bytes and CRC) restores
  into a port engine bit for bit, and the port's decoding continues
  token-identical; ``SpillSummary`` documents round-trip between the
  packages.

Both packages' metric registries are process-global, and these engines
register spill families in them: a module fixture gives each package a
fresh registry for this file and puts the old ones back after.
"""

import asyncio
import os

import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference.v2 import DynamicSplitFuseScheduler as JSched
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JSM
from deepspeed_tpu.inference.v2.ragged import spill as jspill
from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel

from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.inference.v2.ragged import spill as tspill
from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import \
    prefix_digest
from deepspeed_tpu_torch.inference.v2.serve import handoff
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
            remat=False, use_flash=False)


@pytest.fixture(scope="module", autouse=True)
def fresh_registries():
    jprev = jtel.set_registry(jtel.MetricsRegistry())
    tprev = ttel.set_registry(ttel.MetricsRegistry())
    yield
    jtel.set_registry(jprev)
    ttel.set_registry(tprev)


@pytest.fixture(scope="module")
def models():
    jmodel = JModel(JCfg(**TINY))
    np_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             jmodel.init_params(jax.random.PRNGKey(0)))
    return (jmodel, np_params, TransformerLM(TransformerConfig(**TINY)),
            params_from_numpy(np_params))


def _sm(spill, num_blocks, prefix, **kw):
    return dict(max_tracked_sequences=8, max_seq_len=256,
                num_blocks=num_blocks, block_size=16,
                enable_prefix_caching=prefix, enable_kv_spill=spill, **kw)


def port(models, *, spill=False, num_blocks=65, prefix=True,
         kv_quant=False, **kw):
    return InferenceEngineV2(models[2], RaggedInferenceEngineConfig(
        state_manager=DSStateManagerConfig(**_sm(spill, num_blocks, prefix,
                                                 **kw)),
        dtype="float32", prefill_bucket=16, kv_quant=kv_quant),
        params=models[3], device="cpu")


def jaxe(models, *, spill=False, num_blocks=65, prefix=True,
         kv_quant=False, **kw):
    return JEngine(models[0], JConfig(
        state_manager=JSM(**_sm(spill, num_blocks, prefix, **kw)),
        dtype="float32", prefill_bucket=16, kv_quant=kv_quant),
        params=models[1])


def _prompt(rng, n):
    return list(map(int, rng.integers(1, 127, n)))


def _pressure(eng, rng, uid, tokens=120):
    """One long request whose allocation evicts retained blocks."""
    eng.generate([_prompt(rng, tokens)], max_new_tokens=4, uids=[uid])


def _sched(eng, cls, uid, prompt, **kw):
    sched = cls(eng, token_budget=48, chunk=16)
    sched.submit(uid, prompt, 6, **kw)
    sched.run()
    out = sched.results()[uid].tolist()
    sched.release(uid)
    return out


def test_spill_restore_streams_match(models):
    pA = _prompt(np.random.default_rng(0), 50)
    ref = port(models, num_blocks=200)              # never pressured
    refA = ref.generate([pA], max_new_tokens=6, uids=[1])[0]
    engines = {"port": port(models, spill=True, num_blocks=11),
               "jax": jaxe(models, spill=True, num_blocks=11)}
    turn2, out = None, {}
    for name, eng in engines.items():
        rng = np.random.default_rng(1)
        outA = eng.generate([pA], max_new_tokens=6, uids=[1])[0]
        np.testing.assert_array_equal(outA, refA)
        _pressure(eng, rng, uid=2)                  # evicts A's prefix
        dA = prefix_digest(pA[:48], 16)
        assert any(eng.spill.has(d) for d in dA), name
        turn2 = list(map(int, outA)) + [3, 5, 7]
        sm = eng.state_manager
        reused0, hits0 = sm._m_reused_tokens.value, sm._m_hits.value
        out[name] = list(eng.generate([turn2], max_new_tokens=6,
                                      uids=[3])[0])
        # the spilled prefix was admitted as a hit: all of turn 1's KV
        assert sm._m_reused_tokens.value - reused0 == 48
        assert sm._m_hits.value - hits0 == 1
    ref2 = ref.generate([turn2], max_new_tokens=6, uids=[11])[0]
    assert out["port"] == out["jax"] == list(ref2)
    tier = engines["port"].spill
    assert tier.spilled_blocks >= 1 and tier.restored_blocks >= 1
    assert ttel.get_registry().counter(
        "kv_restore_blocks_total").value == tier.restored_blocks

    # seeded sampling through a second spill / restore cycle
    rng = np.random.default_rng(2)
    se = engines["port"]
    _pressure(se, rng, uid=4)
    refS = ref.generate([turn2], max_new_tokens=6, uids=[12],
                        temperature=0.8, seed=42)[0]
    outS = se.generate([turn2], max_new_tokens=6, uids=[5],
                       temperature=0.8, seed=42)[0]
    np.testing.assert_array_equal(outS, refS)
    # ... and through the scheduler, whose host sampler both share
    sampled = {}
    for name, cls in (("port", DynamicSplitFuseScheduler), ("jax", JSched)):
        eng = engines[name]
        _pressure(eng, np.random.default_rng(3), uid=6)
        sampled[name] = _sched(eng, cls, 7, turn2, temperature=0.7,
                               top_p=0.9, seed=11)
    assert sampled["port"] == sampled["jax"]


def test_lru_eviction_spills_least_recently_touched_first(models):
    eng = port(models, spill=True, num_blocks=30)
    sm = eng.state_manager
    pA, pB = list(range(1, 40)), list(range(60, 99))
    eng.generate([pA], max_new_tokens=4, uids=[1])
    eng.generate([pB], max_new_tokens=4, uids=[2])
    _, n = sm.match_prefix(90, np.asarray(pA))     # A is the hotter one
    assert n == 32
    eng.flush(90)
    dA, dB = prefix_digest(pA[:32], 16), prefix_digest(pB[:32], 16)
    sm._evict_retained(sm.allocator.free_blocks + 2)   # evict exactly 2
    assert all(eng.spill.has(d) for d in dB)
    assert all(d in sm._prefix for d in dA)
    assert all(sm.allocator.last_touch(sm._prefix[d]) > 0 for d in dA)


def test_disk_tier_roundtrip_and_drain_cleanup(models, tmp_path):
    from deepspeed_tpu_torch.inference.v2.serve import (ServingConfig,
                                                        ServingEngine)
    rng = np.random.default_rng(1)
    pA = _prompt(rng, 50)
    ref = port(models, num_blocks=200)
    refA = ref.generate([pA], max_new_tokens=6, uids=[1])[0]
    se = port(models, spill=True, num_blocks=11, kv_spill_host_bytes=1,
              kv_spill_dir=str(tmp_path / "spill"))
    outA = se.generate([pA], max_new_tokens=6, uids=[1])[0]
    np.testing.assert_array_equal(outA, refA)
    _pressure(se, rng, uid=2)
    stats = se.spill.stats()
    assert stats["disk_entries"] >= 1 and stats["host_entries"] <= 1
    ns = se.spill.disk_dir
    assert os.path.dirname(ns) == str(tmp_path / "spill")
    assert any(f.endswith(".npz") for f in os.listdir(ns))
    turn2 = list(map(int, outA)) + [3, 5, 7]
    ref2 = ref.generate([turn2], max_new_tokens=6, uids=[11])[0]
    out2 = se.generate([turn2], max_new_tokens=6, uids=[3])[0]
    np.testing.assert_array_equal(out2, ref2)
    # the host time of every part of the spills and restores was counted
    assert se.spill.restored_blocks >= 1
    assert all(v > 0 for v in se.spill.seconds.values()), se.spill.seconds
    _pressure(se, rng, uid=4)        # spill again, then drain the loop
    free0 = se.state_manager.free_blocks()

    async def serve_and_drain():
        serving = await ServingEngine(se, ServingConfig()).start()
        doc = serving.health()["kv_spill"]
        await serving.stop()
        return doc

    doc = asyncio.run(serve_and_drain())
    summary = tspill.SpillSummary.from_doc(doc)
    assert summary is not None and summary.entries >= 1
    assert summary.namespace == se.spill.namespace
    assert not os.path.exists(ns) and len(se.spill) == 0
    assert se.state_manager.free_blocks() == free0


def test_adopt_namespace_takes_over_a_peers_disk_entries(models,
                                                         tmp_path):
    """A second tier under the same directory adopts the first one's disk
    namespace (a dead replica's): the entries move over, restore there,
    and the emptied namespace is removed; an explicit namespace that is
    already claimed is refused."""
    rng = np.random.default_rng(8)
    pA = _prompt(rng, 50)
    root = str(tmp_path / "spill")
    a = port(models, spill=True, num_blocks=11, kv_spill_host_bytes=1,
             kv_spill_dir=root, kv_spill_namespace="replica-a")
    outA = a.generate([pA], max_new_tokens=6, uids=[1])[0]
    _pressure(a, rng, uid=2)
    held = list(a.spill._disk)
    assert held
    with pytest.raises(ValueError, match="already claimed"):
        port(models, spill=True, num_blocks=11, kv_spill_dir=root,
             kv_spill_namespace="replica-a")
    b = port(models, spill=True, num_blocks=11, kv_spill_dir=root)
    assert b.spill.adopt_namespace("replica-a") == len(held)
    assert all(b.spill.has(d) for d in held)
    assert not os.path.exists(os.path.join(root, "replica-a"))
    turn2 = list(map(int, outA)) + [3, 5, 7]
    ref = port(models, num_blocks=200)
    np.testing.assert_array_equal(
        b.generate([turn2], max_new_tokens=6, uids=[3])[0],
        ref.generate([turn2], max_new_tokens=6, uids=[3])[0])
    assert b.spill.restored_blocks >= 1
    b.spill.close()


def test_corrupt_spill_entry_degrades_to_recompute(models):
    rng = np.random.default_rng(2)
    pA = _prompt(rng, 50)
    ref = port(models, num_blocks=200)
    refA = ref.generate([pA], max_new_tokens=6, uids=[1])[0]
    se = port(models, spill=True, num_blocks=11)
    outA = se.generate([pA], max_new_tokens=6, uids=[1])[0]
    np.testing.assert_array_equal(outA, refA)
    _pressure(se, rng, uid=2)
    victim = next(iter(se.spill._host))
    buf = bytearray(se.spill._host[victim])
    buf[len(buf) // 2] ^= 0xFF
    se.spill._host[victim] = bytes(buf)
    dropped0 = ttel.get_registry().counter(
        "kv_spill_dropped_blocks_total").value
    turn2 = list(map(int, outA)) + [3, 5, 7]
    ref2 = ref.generate([turn2], max_new_tokens=6, uids=[11])[0]
    out2 = se.generate([turn2], max_new_tokens=6, uids=[3])[0]
    np.testing.assert_array_equal(out2, ref2)     # recomputed, not poison
    assert ttel.get_registry().counter(
        "kv_spill_dropped_blocks_total").value > dropped0
    assert not se.spill.has(victim)


def test_spill_keeps_strictly_more_conversations(models):
    rng = np.random.default_rng(4)
    prompts = [_prompt(rng, 40) for _ in range(5)]

    def available(spill):
        # 8 usable blocks cannot retain 5 conversations x 2 full blocks
        eng = port(models, spill=spill, num_blocks=9)
        for i, p in enumerate(prompts):
            eng.generate([p], max_new_tokens=4, uids=[10 + i])
        sm = eng.state_manager
        return sum(all(d in sm._prefix or (eng.spill is not None
                                           and eng.spill.has(d))
                       for d in prefix_digest(p[:32], 16))
                   for p in prompts)

    with_spill, without = available(True), available(False)
    assert with_spill == len(prompts) and with_spill > without


def test_spill_composes_with_kv_quant(models):
    rng = np.random.default_rng(5)
    pA = _prompt(rng, 50)
    ref = port(models, num_blocks=200, kv_quant=True)
    refA = ref.generate([pA], max_new_tokens=6, uids=[1])[0]
    se = port(models, spill=True, num_blocks=11, kv_quant=True)
    outA = se.generate([pA], max_new_tokens=6, uids=[1])[0]
    np.testing.assert_array_equal(outA, refA)
    _pressure(se, rng, uid=2)
    assert len(se.spill) >= 1
    # the int8 pages spill with their scale rows
    chunk = handoff.parse_chunk(next(iter(se.spill._host.values())))
    assert set(chunk["kv"]) == {"k", "v", "ks", "vs"}
    assert chunk["kv"]["k"].dtype == torch.int8
    turn2 = list(map(int, outA)) + [3, 5, 7]
    ref2 = ref.generate([turn2], max_new_tokens=6, uids=[11])[0]
    out2 = se.generate([turn2], max_new_tokens=6, uids=[3])[0]
    np.testing.assert_array_equal(out2, ref2)


def test_restore_eviction_never_steals_the_in_progress_chain(models):
    eng = port(models, spill=True, num_blocks=8)
    sm = eng.state_manager
    pA = list(range(1, 40))                         # 2 full blocks
    eng.generate([pA], max_new_tokens=4, uids=[1])
    dA = prefix_digest(pA[:32], 16)
    sm._evict_retained(sm.allocator.free_blocks + 2)
    assert all(eng.spill.has(d) for d in dA)
    _, n = sm.match_prefix(90, np.asarray(pA[:17]))
    assert n == 16 and dA[0] in sm._prefix and eng.spill.has(dA[1])
    sm.flush_sequence(90)
    b1 = sm._prefix[dA[0]]
    hold = [int(b) for b in sm.allocator.allocate(sm.allocator.free_blocks)]
    blocks, n = sm.match_prefix(91, np.asarray(pA))
    assert n == 16 and blocks == [b1]
    assert dA[0] in sm._prefix and sm._prefix[dA[0]] == b1
    assert sm.seqs[91].seen_tokens == 16
    assert eng.spill.has(dA[1])
    sm.flush_sequence(91)
    sm.allocator.free(hold)


@pytest.mark.parametrize("kw", [
    dict(enable_kv_spill=True),
    dict(enable_prefix_caching=True, enable_kv_spill=True,
         kv_spill_host_bytes=0),
    dict(enable_prefix_caching=True, enable_kv_spill=True,
         kv_spill_disk_bytes=-1),
    dict(enable_prefix_caching=True, kv_spill_namespace="a/b")])
def test_spill_config_rejects_like_jax(kw):
    msgs = []
    for cls in (JSM, DSStateManagerConfig):
        with pytest.raises(ValueError) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_jax_spilled_block_restores_into_port(models):
    """The JAX engine spills turn 1's prefix; its entries (``.npz`` bytes
    and CRC, unchanged) go into a port engine's tier, which restores them
    bit for bit and decodes turn 2 as a never-pressured engine does."""
    rng = np.random.default_rng(6)
    pA = _prompt(rng, 50)
    je = jaxe(models, spill=True, num_blocks=11)
    outA = je.generate([pA], max_new_tokens=6, uids=[1])[0]
    _pressure(je, rng, uid=2)
    entries = dict(je.spill._host)
    assert entries
    te = port(models, spill=True, num_blocks=11)
    for digest, buf in entries.items():
        te.spill._host[digest] = buf
        te.spill._host_bytes += len(buf)
        chunk = handoff.parse_chunk(buf)
        assert handoff._chunk_crc(chunk["kv"]) == \
            int(chunk["descriptor"]["crc32"])
    turn2 = list(map(int, outA)) + [3, 5, 7]
    out2 = te.generate([turn2], max_new_tokens=6, uids=[3])[0]
    assert te.spill.restored_blocks == len(entries)
    ref = port(models, num_blocks=200)
    ref2 = ref.generate([turn2], max_new_tokens=6, uids=[11])[0]
    np.testing.assert_array_equal(out2, ref2)
    np.testing.assert_array_equal(
        out2, je.generate([turn2], max_new_tokens=6, uids=[3])[0])
    # the restored blocks hold the spilled bytes
    for digest, buf in entries.items():
        blk = te.state_manager._prefix[digest]
        kv = handoff.parse_chunk(buf)["kv"]
        for key, leaf in te.kv_cache.items():
            assert torch.equal(leaf[:, blk], kv[key][:, 0])


def test_handoff_buffers_cross_the_packages(models):
    """A sequence exported by the JAX engine restores into the port's
    pool (and the port's export parses back into the same arrays)."""
    from deepspeed_tpu.inference.v2.serve import handoff as jhandoff

    p = _prompt(np.random.default_rng(7), 40)
    je = jaxe(models, prefix=False)
    je.put([1], [p])
    buf = jhandoff.serialize(jhandoff.export_sequence(je, 1))
    te = port(models, prefix=False)
    pack = handoff.deserialize(buf)
    handoff.restore_sequence(te, pack, 5)
    blocks = te.state_manager.seqs[5].blocks
    for key, leaf in te.kv_cache.items():
        np.testing.assert_array_equal(
            leaf[:, blocks].numpy(),
            np.asarray(je.kv_cache[key])[:, je.state_manager.seqs[1].blocks])
    chunks = handoff.export_chunks(te, 5, chunk_blocks=2)
    header = jhandoff.parse_header(chunks[0])
    assert header["n_blocks"] == len(blocks)
    for c in chunks[1:]:
        jc = jhandoff.parse_chunk(c)
        assert jhandoff._chunk_crc(jc["kv"]) == int(jc["descriptor"]["crc32"])


def test_spill_summary_doc_round_trips(models):
    digests = prefix_digest(list(range(1, 100)), 16)
    for build, decode in ((tspill.build_summary, jspill.SpillSummary),
                          (jspill.build_summary, tspill.SpillSummary)):
        doc = build(digests, seq=3, namespace="ns").to_doc()
        back = decode.from_doc(doc)
        assert back.to_doc() == doc
        assert all(back.claims(d) for d in digests)
    assert tspill.build_summary(digests, 3, "ns").to_doc() == \
        jspill.build_summary(digests, 3, "ns").to_doc()
    assert tspill.SpillSummary.from_doc({"bits": 1}) is None

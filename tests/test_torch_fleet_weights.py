"""PyTorch port: versioned weight payloads and the live param swap
(``serve/weights.py``) against the JAX package.

The wire is the JAX package's (header keys, leaf path names, fp32 leaves,
CRC32 ``.npz`` chunks), so:

* a payload the JAX package writes applies in the port, and the port's
  streams then equal JAX's engine after JAX applied the same payload, and
  a fresh port engine built from the payload;
* a payload the port writes applies in JAX, with the same streams;
* a delta payload's bytes and reconstruction are bit-equal to JAX's where
  JAX quantizes with its jitted quantizer (eager JAX divides by the block
  maximum where XLA multiplies by its reciprocal: the share of elements
  that then differ beyond 2e-5 is measured and bounded here).

The swap writes every leaf in place (each keeps its address), except a
leaf an engine borrowed from its caller, which gets storage of its own on
the first swap, so a swap never changes another engine's weights. A
corrupt chunk and a stale delta base raise before any leaf changes.
"""

import asyncio

import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu.comm import quantized as jquant
from deepspeed_tpu.inference.v2.serve import weights as jw

from torch_fleet_common import SERVE, Models, prompts, serving_config

from deepspeed_tpu_torch.inference.v2.serve import weights as tw
from deepspeed_tpu_torch.inference.v2.serve import worker as tworker

BUCKET = 64 << 10      # several chunks for the tiny model


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def jax_engine(models):
    return models.jax_engine()


def _jax_flat(models, seed):
    params = models.jmodel.init_params(jax.random.PRNGKey(seed))
    items, _ = jw.flatten_params(params)
    return {n: jw.fetch_leaf(v) for n, v in items}


def _payload(mod, flat, version):
    items = list(flat.items())
    return mod.chunk_weight_leaves(
        ({n: flat[n] for n in names}
         for names in mod.plan_buckets(items, BUCKET)), version)


def _owned_engine(models):
    """A port engine that owns its leaves (drawn from its generator)."""
    return tworker.build_engine(tworker.TINY_SPEC, "cpu")


def _streams(engine, pkg, n=8):
    async def run():
        serving = SERVE[pkg].ServingEngine(engine, serving_config(pkg))
        await serving.start()
        outs = []
        for p in prompts((23, 40, 9), seed=5):
            s = await serving.submit(p, n)
            outs.append(await s.drain())
        await serving.stop()
        return outs
    return asyncio.run(run())


def _leaves(engine):
    return [(n, t.data_ptr(), t.clone()) for n, t in
            tw.flatten_params(engine.params)]


def test_jax_payload_applies_in_port(models, jax_engine):
    flat = _jax_flat(models, 1)
    payloads = _payload(jw, flat, 1)
    assert len(payloads) > 2
    assert jw.apply_payload(jax_engine, payloads) == 1
    ref = _streams(jax_engine, "jax")
    eng = _owned_engine(models)
    before = _leaves(eng)
    assert tw.apply_payload(eng, payloads) == 1
    assert eng.weight_version == 1
    after = tw.flatten_params(eng.params)
    # every leaf kept its address and holds the payload's values
    assert [(n, p) for n, p, _ in before] == [(n, t.data_ptr())
                                              for n, t in after]
    for n, t in after:
        assert torch.equal(t, torch.from_numpy(flat[n]))
    assert _streams(eng, "torch") == ref
    fresh = models.torch_engine(params=tw.flat_to_tree(eng.params, flat))
    assert _streams(fresh, "torch") == ref
    assert eng.weight_version == 1 and tw.delta_base_of(eng) is not None


def test_port_payload_applies_in_jax(models, jax_engine):
    gen = torch.Generator()
    gen.manual_seed(2)
    params = models.tmodel.init_params(gen, dtype=torch.float32)
    flat = {n: tw.fetch_leaf(t) for n, t in tw.flatten_params(params)}
    payloads = _payload(tw, flat, 7)
    # the JAX side parses the port's header and chunks
    header = jw.parse_weights_header(payloads[0])
    assert header["version"] == 7 and set(header["leaf_meta"]) == set(flat)
    assert jw.apply_payload(jax_engine, payloads) == 7
    eng = _owned_engine(models)
    assert tw.apply_payload(eng, payloads) == 7
    assert _streams(eng, "torch") == _streams(jax_engine, "jax")


def test_corrupt_chunk_and_stale_delta_leave_the_engine_untouched(models):
    eng = _owned_engine(models)
    flat1 = _jax_flat(models, 1)
    payloads = _payload(tw, flat1, 1)
    bad = list(payloads)
    bad[1] = bytearray(bad[1])
    bad[1][len(bad[1]) // 2] ^= 0xFF
    bad[1] = bytes(bad[1])
    before = _leaves(eng)

    def untouched(version):
        assert eng.weight_version == version
        assert all(p == t.data_ptr() and torch.equal(c, t) for (_, p, c),
                   (_, t) in zip(before, tw.flatten_params(eng.params)))

    for mod in (tw, jw):                 # the same typed failure in both
        with pytest.raises(ValueError, match="crc32|corrupted"):
            mod.stage_payload(bad)
    with pytest.raises(ValueError, match="crc32|corrupted"):
        tw.apply_payload(eng, bad)
    untouched(0)
    # a delta over a base this engine does not hold: typed, before any
    # leaf changes (a boot engine holds no base at all)
    flat2 = _jax_flat(models, 2)
    delta, _ = tw.chunk_weight_deltas(flat2, flat1, 2, 1, device="cpu",
                                      bucket_bytes=BUCKET)
    with pytest.raises(ValueError, match="base_version=1"):
        tw.apply_payload(eng, delta)
    untouched(0)
    assert tw.apply_payload(eng, payloads) == 1
    stale, _ = tw.chunk_weight_deltas(flat2, flat1, 3, 2, device="cpu",
                                      bucket_bytes=BUCKET)
    before = _leaves(eng)
    with pytest.raises(ValueError, match="base_version=2"):
        tw.apply_payload(eng, stale)
    untouched(1)
    # the right base applies, and the receiver holds the publisher's recon
    recon = tw.chunk_weight_deltas(flat2, flat1, 2, 1, device="cpu",
                                   bucket_bytes=BUCKET)[1]
    assert tw.apply_payload(eng, delta) == 2
    base = tw.delta_base_of(eng)
    assert all(np.array_equal(base[n], recon[n]) for n in recon)
    assert all(p == t.data_ptr() for (_, p, _), (_, t) in
               zip(before, tw.flatten_params(eng.params)))


def _decoded(payloads, mod):
    stager = mod.stage_payload(payloads)
    return stager.header, {k: np.asarray(v) for k, v in
                           stager.leaves.items()}


def test_delta_payload_bit_equal_to_jitted_jax(models, monkeypatch):
    flat1, flat2 = _jax_flat(models, 1), _jax_flat(models, 2)
    port, port_recon = tw.chunk_weight_deltas(
        flat2, flat1, 2, 1, device="cpu", bucket_bytes=BUCKET, block=512)
    # eager JAX: the share of reconstructed elements beyond 2e-5
    eager, eager_recon = jw.chunk_weight_deltas(
        flat2, flat1, 2, 1, bucket_bytes=BUCKET, block=512)
    diff = np.concatenate([np.abs(port_recon[n] - eager_recon[n]).ravel()
                           for n in flat2])
    share = float((diff > 2e-5).mean())
    assert share < 0.01, share
    # jitted JAX: bit-equal
    jitted = jax.jit(jquant._quantize_wire, static_argnums=(1, 2))
    monkeypatch.setattr(jquant, "_quantize_wire", jitted)
    ref, ref_recon = jw.chunk_weight_deltas(
        flat2, flat1, 2, 1, bucket_bytes=BUCKET, block=512)
    ph, pleaves = _decoded(port, tw)
    jh, jleaves = _decoded(ref, jw)
    assert ph == jh, "the headers (manifest, CRCs) must be equal"
    assert pleaves.keys() == jleaves.keys()
    for k in pleaves:
        assert np.array_equal(pleaves[k], jleaves[k]), k
    for n in flat2:
        assert np.array_equal(port_recon[n], ref_recon[n]), n
    # and each side reconstructs the other's payload to the same bits
    base = {n: np.asarray(v, np.float32) for n, v in flat1.items()}
    assert all(np.array_equal(a, b) for a, b in zip(
        tw.reconstruct_delta(jh, jleaves, base).values(),
        jw.reconstruct_delta(ph, pleaves, base).values()))


def test_swap_never_changes_another_engines_weights(models):
    """Two engines over the same tensors (``_cast_tree`` reuses them): a
    swap of one gives its borrowed leaves storage of their own; the other
    engine and the caller's tensors keep their values; the next swap keeps
    every address."""
    shared = {k: v for k, v in models.tparams.items()}
    keep = {n: t.clone() for n, t in tw.flatten_params(shared)}
    a = models.torch_engine(params=shared)
    b = models.torch_engine(params=shared)
    assert a._borrowed_leaves == set(keep)
    flat1 = _jax_flat(models, 1)
    tw.apply_payload(a, _payload(tw, flat1, 1))
    for n, t in tw.flatten_params(b.params):
        assert torch.equal(t, keep[n]), n
    for n, t in tw.flatten_params(shared):
        assert torch.equal(t, keep[n]), n
    for n, t in tw.flatten_params(a.params):
        assert torch.equal(t, torch.from_numpy(flat1[n]))
    ptrs = [t.data_ptr() for _, t in tw.flatten_params(a.params)]
    tw.apply_payload(a, _payload(tw, _jax_flat(models, 2), 2))
    assert ptrs == [t.data_ptr() for _, t in tw.flatten_params(a.params)]


def test_refusals(models):
    eng = _owned_engine(models)
    # adapter payloads install into an engine's LoRA bank now (tests/
    # test_torch_multi_lora.py); an engine without one refuses, as JAX's
    payload = tw.chunk_adapter_payload("a", {}, 1)
    with pytest.raises(ValueError, match="bank disabled"):
        tw.apply_payload(eng, payload)
    assert eng.weight_version == 0

    class Spmd:
        topology = object()
        params = eng.params
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        tw.swap_engine_params(Spmd(), {}, 1)
    woq = models.torch_engine()
    woq._qmeta = {}
    with pytest.raises(NotImplementedError, match="WOQ"):
        tw.swap_engine_params(woq, {}, 1)


def test_weight_updates_through_the_serving_runtime_and_router(models):
    """Two replicas behind the router: a full push then a delta push, each
    during traffic; no stream dropped, weight_version advances on both,
    /healthz reports it, and the post-swap streams equal a fresh engine
    built from the payload."""
    S = SERVE["torch"]
    flat1, flat2 = _jax_flat(models, 1), _jax_flat(models, 2)
    full = _payload(tw, flat1, 1)
    delta, recon = tw.chunk_weight_deltas(flat2, flat1, 2, 1, device="cpu",
                                          bucket_bytes=BUCKET)

    async def run():
        engines = [_owned_engine(models), _owned_engine(models)]
        replicas = S.build_replicas(engines, serving_config("torch"))
        router = S.ReplicaRouter(replicas, S.RouterConfig(
            monitor_interval_s=0.0))
        await router.start()
        res = []
        for version, payload in ((1, full), (2, delta)):
            traffic = [await router.submit(p, 16)
                       for p in prompts((30, 12, 44), seed=version)]
            got = await router.push_weights(payload)
            outs = [await s.drain() for s in traffic]
            res.append((got, [s.status for s in traffic],
                        [len(o) for o in outs],
                        [r.weight_version for r in replicas],
                        [r.health()["weight_version"] for r in replicas]))
        streams = []
        for r in replicas:
            outs = []
            for p in prompts((23, 40, 9), seed=5):
                s = await r.submit(p, 8)
                outs.append(await s.drain())
            streams.append(outs)
        await router.stop()
        return res, streams

    res, streams = asyncio.run(run())
    for version, (got, status, lens, wv, hv) in zip((1, 2), res):
        assert got == version
        assert status == ["completed"] * 3 and lens == [16] * 3
        assert wv == hv == [version, version]
    fresh = models.torch_engine(params=tw.flat_to_tree(models.tparams,
                                                       recon))
    assert streams[0] == streams[1] == _streams(fresh, "torch")

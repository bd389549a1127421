"""PyTorch port: disaggregated prefill and the KV handoff
(``serve/replica.PrefillReplica``, ``serve/handoff.py``, the serving
runtime's ``resume`` / ``begin_handoff`` and the router's disaggregated
dispatch) against the JAX package.

* A request prefilled on a prefill replica and handed to a decode replica,
  whole (one ``handoff.serialize`` buffer) or chunked (``[header,
  kv-chunk...]``, each chunk applied between the decode replica's
  scheduler steps), streams the tokens colocated serving streams: on the
  fp32 pool (greedy and seeded sampled, held against JAX's colocated
  streams too), on a bf16 pool and on the int8 ``kv_quant`` pool (port to
  port, each request alone on fresh engines: an int8 block keeps its
  scales when freed, as in JAX).
* Across packages: chunks a JAX prefill replica exports restore into a
  port decode replica and continue JAX's colocated greedy stream, and
  chunks the port exports restore into a JAX decode replica.
* The chunk protocol's failure cases behave as in JAX's
  ``test_chunked_handoff.py``: an abort frees the partially restored
  blocks, a corrupt chunk fails its CRC and is cleaned up, a resent chunk
  is idempotent, a missing chunk fails the commit without leaking, and
  the decode replica keeps stepping its batch while chunks stream in.
"""

import asyncio
import time

import pytest

from torch_fleet_common import (SERVE, Models, colocated, prompts,
                                serving_config)

from deepspeed_tpu_torch.telemetry import get_registry


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def jax_engines(models):
    """A JAX prefill engine and a JAX decode / colocated engine."""
    return models.jax_engine(), models.jax_engine()


def _kw(kw):
    return dict(temperature=kw.get("temperature", 0.0),
                top_p=kw.get("top_p", 1.0), top_k=kw.get("top_k", 0))


async def _disagg(prefill, decode, pkg_dec, prompt, max_new, chunk_blocks,
                  kw, cfg=None):
    """[first token] + the decode replica's stream of one handed-off
    request."""
    S = SERVE[pkg_dec]
    tok, payloads, rng_state, finished = await prefill.prefill(
        prompt, max_new, chunk_blocks=chunk_blocks, seed=kw.get("seed"),
        **_kw(kw))
    assert not finished
    replica = S.Replica("decode0", decode, cfg or serving_config(pkg_dec))
    await replica.start()
    try:
        stream = await replica.resume_handoff(
            payloads, chunked=chunk_blocks > 0, prompt=prompt,
            generated=[tok], max_new_tokens=max_new, rng_state=rng_state,
            **_kw(kw))
        rest = await stream.drain()
    finally:
        await replica.stop()
    return [tok] + rest


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.8, top_p=0.9,
                                             seed=11)],
                         ids=("greedy", "sampled"))
def test_fp32_handoff_whole_and_chunked_equal_colocated_and_jax(
        models, jax_engines, kw):
    prompt, max_new = prompts((37,), seed=4)[0], 10
    ref = asyncio.run(colocated(jax_engines[1], "jax", prompt, max_new,
                                **kw))
    port = asyncio.run(colocated(models.torch_engine(), "torch", prompt,
                                 max_new, **kw))
    assert port == ref
    for chunk_blocks in (0, 1, 4):
        pre = SERVE["torch"].PrefillReplica("prefill0",
                                            models.torch_engine())
        got = asyncio.run(_disagg(pre, models.torch_engine(), "torch",
                                  prompt, max_new, chunk_blocks, kw))
        assert got == ref, f"chunk_blocks={chunk_blocks}"


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_handoff_on_bf16_and_int8_pools_equals_colocated(models, pool):
    """Each request alone on fresh engines, its prefill one put() on both
    sides (a chunk as large as the prompt), greedy and seeded sampled."""
    eng_kw = (dict(dtype="bfloat16") if pool == "bf16"
              else dict(kv_quant=True))

    def engine():
        return models.torch_engine(**eng_kw)

    S = SERVE["torch"]
    cfg = serving_config("torch", chunk=256, token_budget=256)
    for i, (prompt, kw) in enumerate(zip(
            prompts((49, 21, 70), seed=6),
            [dict(), dict(temperature=0.8, top_p=0.9, seed=3), dict()])):
        async def colo():
            serving = S.ServingEngine(engine(), cfg)
            await serving.start()
            s = await serving.submit(prompt, 9, **kw)
            out = await s.drain()
            await serving.stop()
            return out

        want = asyncio.run(colo())
        for chunk_blocks in (0, 2):
            pre = S.PrefillReplica("prefill0", engine())
            got = asyncio.run(_disagg(pre, engine(), "torch", prompt, 9,
                                      chunk_blocks, kw, cfg))
            assert got == want, (pool, i, chunk_blocks)


@pytest.mark.parametrize("chunk_blocks", [0, 2], ids=("whole", "chunked"))
def test_handoff_across_packages(models, jax_engines, chunk_blocks):
    """JAX prefill -> port decode, and port prefill -> JAX decode: both
    continue JAX's colocated greedy stream."""
    prompt, max_new = prompts((49,), seed=3)[0], 8
    ref = asyncio.run(colocated(jax_engines[1], "jax", prompt, max_new))
    jpre = SERVE["jax"].PrefillReplica("jprefill", jax_engines[0])
    got = asyncio.run(_disagg(jpre, models.torch_engine(), "torch", prompt,
                              max_new, chunk_blocks, {}))
    assert got == ref, "a JAX-exported handoff must continue in the port"
    tpre = SERVE["torch"].PrefillReplica("tprefill", models.torch_engine())
    back = asyncio.run(_disagg(tpre, jax_engines[1], "jax", prompt, max_new,
                               chunk_blocks, {}))
    assert back == ref, "a port-exported handoff must continue in JAX"


def test_router_disaggregated_parity_and_one_token_finish(models,
                                                          jax_engines):
    """The router's disaggregated dispatch (chunked, 2 blocks a chunk) over
    port replicas streams JAX's colocated tokens; a one-token request
    finishes at the prefill replica without a handoff."""
    S = SERVE["torch"]
    ps = prompts((37, 21), seed=8)

    async def routed():
        router = S.ReplicaRouter(
            [S.Replica("dec0", models.torch_engine(),
                       serving_config("torch"))],
            S.RouterConfig(disaggregated=True, handoff_chunk_blocks=2,
                           monitor_interval_s=0.0),
            prefill_replicas=[S.PrefillReplica("prefill0",
                                               models.torch_engine())])
        await router.start()
        fam = get_registry().family_total
        h0 = fam("router_handoffs_total")
        streams = [await router.submit(p, 10) for p in ps]
        outs = [await s.drain() for s in streams]
        h1 = fam("router_handoffs_total")
        one = await router.submit(ps[0], 1)
        one_out = await one.drain()
        h2 = fam("router_handoffs_total")
        await router.stop()
        return outs, one_out, one.status, (h1 - h0, h2 - h1)

    outs, one_out, status, handoffs = asyncio.run(routed())
    ref = [asyncio.run(colocated(jax_engines[1], "jax", p, 10)) for p in ps]
    assert outs == ref
    assert one_out == ref[0][:1] and status == "completed"
    assert handoffs == (len(ps), 0)


# ---------------------------------------------------------------------------
# the chunk protocol's failure cases (JAX test_chunked_handoff.py)
# ---------------------------------------------------------------------------
def _chunked(models, prompt, max_new):
    pre = SERVE["torch"].PrefillReplica("prefill0", models.torch_engine())
    return asyncio.run(pre.prefill(prompt, max_new, chunk_blocks=1))


def test_abort_and_corrupt_chunk_free_blocks_then_a_retry_succeeds(models):
    S = SERVE["torch"]
    prompt = prompts((49,), seed=3)[0]
    tok, payloads, rng_state, _ = _chunked(models, prompt, 8)
    want = asyncio.run(colocated(models.torch_engine(), "torch", prompt, 8))

    async def run():
        replica = S.Replica("decode0", models.torch_engine(),
                            serving_config("torch"))
        await replica.start()
        sm = replica.engine.state_manager
        try:
            free0 = sm.free_blocks()
            handle = await replica.serving.begin_handoff(payloads[0])
            await handle.feed(payloads[1])
            assert sm.free_blocks() < free0
            await handle.abort()
            assert sm.free_blocks() == free0
            handle = await replica.serving.begin_handoff(payloads[0])
            bad = bytearray(payloads[1])
            bad[len(bad) // 2] ^= 0xFF
            with pytest.raises(Exception, match="(?i)crc|integrity"):
                await handle.feed(bytes(bad))
            await handle.abort()
            assert sm.free_blocks() == free0
            stream = await replica.resume_handoff(
                payloads, chunked=True, prompt=prompt, generated=[tok],
                max_new_tokens=8, rng_state=rng_state)
            return [tok] + await stream.drain()
        finally:
            await replica.stop()

    assert asyncio.run(run()) == want


def test_duplicate_chunk_idempotent_and_missing_chunk_rejected(models):
    S = SERVE["torch"]
    prompt = prompts((49,), seed=6)[0]
    tok, payloads, rng_state, _ = _chunked(models, prompt, 6)
    want = asyncio.run(colocated(models.torch_engine(), "torch", prompt, 6))

    async def run():
        replica = S.Replica("decode0", models.torch_engine(),
                            serving_config("torch"))
        await replica.start()
        sm = replica.engine.state_manager
        free0 = sm.free_blocks()
        try:
            handle = await replica.serving.begin_handoff(payloads[0])
            await handle.feed(payloads[1])      # the rest never arrives
            with pytest.raises(Exception, match="(?i)missing|incomplete"):
                await handle.commit(prompt=prompt, generated=[tok],
                                    max_new_tokens=6, rng_state=rng_state)
            assert sm.free_blocks() == free0
            handle = await replica.serving.begin_handoff(payloads[0])
            for chunk in payloads[1:]:
                await handle.feed(chunk)
            await handle.feed(payloads[1])      # a resend: idempotent
            stream = await handle.commit(prompt=prompt, generated=[tok],
                                         max_new_tokens=6,
                                         rng_state=rng_state)
            return [tok] + await stream.drain()
        finally:
            await replica.stop()

    assert asyncio.run(run()) == want


def test_chunked_handoff_overlaps_running_decode(models):
    S = SERVE["torch"]
    prompt = prompts((49,), seed=7)[0]
    tok, payloads, rng_state, _ = _chunked(models, prompt, 8)
    want = asyncio.run(colocated(models.torch_engine(), "torch", prompt, 8))

    async def run():
        replica = S.Replica("decode0", models.torch_engine(),
                            serving_config("torch"))
        await replica.start()
        loop = replica.serving.loop_runner
        try:
            victim = await replica.submit(prompts((8,), seed=9)[0], 200)
            await victim.__anext__()        # the victim is mid-decode
            handle = await replica.serving.begin_handoff(payloads[0])
            s0 = loop.steps_done
            between = []
            for chunk in payloads[1:]:
                before = loop.steps_done
                deadline = time.monotonic() + 30.0
                while loop.steps_done == before:
                    assert time.monotonic() < deadline, \
                        "the decode loop stalled during the handoff"
                    await asyncio.sleep(0.002)
                between.append(loop.steps_done - before)
                await handle.feed(chunk)
            overlapped = loop.steps_done - s0
            stream = await handle.commit(prompt=prompt, generated=[tok],
                                         max_new_tokens=8,
                                         rng_state=rng_state)
            rest = await stream.drain()
            await victim.cancel()
        finally:
            await replica.stop()
        return between, overlapped, [tok] + rest

    between, overlapped, got = asyncio.run(run())
    assert len(between) >= 2 and all(g >= 1 for g in between)
    assert overlapped >= len(between)
    assert got == want


def test_chunk_codec_reads_what_np_load_reads_and_checks_zip_crcs():
    """``parse_chunk`` reads the members of a stored ``.npz`` as views of
    the buffer (no copy) and still checks each member's zip CRC-32, as
    ``np.load`` does: a flipped byte in a member's ``.npy`` header, which
    the chunk manifest's CRC does not cover, is refused."""
    import io
    import zipfile

    import numpy as np
    import torch

    from deepspeed_tpu.inference.v2.serve import handoff as jhandoff

    from deepspeed_tpu_torch.inference.v2.serve import handoff

    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 7)).astype(np.float32)
    b = rng.integers(-128, 127, (4, 9)).astype(np.int8)
    bufs = [handoff._npz_chunk({"kind": "kv", "seq": 0}, {
                "a": torch.from_numpy(a), "b": torch.from_numpy(b),
                "c": torch.from_numpy(a).to(torch.bfloat16)}),
            jhandoff._npz_chunk({"kind": "kv", "seq": 0}, {"a": a, "b": b})]
    for buf in bufs:
        got = handoff.parse_chunk(buf)
        with np.load(io.BytesIO(buf)) as z:
            assert np.array_equal(got["kv"]["a"].numpy(), z["kv_a"])
            assert np.array_equal(got["kv"]["b"].numpy(), z["kv_b"])
        assert got["descriptor"]["seq"] == 0
        views = handoff.parse_chunk_arrays(buf)["kv"]
        assert not views["a"].flags.writeable      # a view, not a copy
        assert handoff._chunk_crc(views) == handoff._chunk_crc(got["kv"])
    assert torch.equal(handoff.parse_chunk(bufs[0])["kv"]["c"],
                       torch.from_numpy(a).to(torch.bfloat16))
    bad = bytearray(bufs[0])
    at = bufs[0].index(b"(4, 9)")
    bad[at + 1] = ord("5")                         # shape (5, 9)
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        handoff.parse_chunk(bytes(bad))


def test_handoff_into_an_spmd_engine_is_refused(models):
    """A tensor- or expert-parallel engine's loop drives a ``LeaderEngine``
    (it has ``release_followers``): a KV restore there would reach the
    leader's pool alone, so both handoff forms refuse it (ROADMAP A15)."""
    S = SERVE["torch"]
    prompt = prompts((33,), seed=2)[0]
    tok, payloads, rng_state, _ = _chunked(models, prompt, 4)

    class Leader:
        """The leader's view of an SPMD engine, as the loop sees it."""

        def __init__(self, engine):
            self._engine = engine

        def __getattr__(self, name):
            return getattr(self._engine, name)

        def release_followers(self):
            pass

    async def run():
        serving = S.ServingEngine(models.torch_engine(),
                                  serving_config("torch"))
        serving.scheduler.engine = Leader(serving.scheduler.engine)
        await serving.start()
        try:
            with pytest.raises(NotImplementedError, match="ROADMAP A15"):
                await serving.begin_handoff(payloads[0])
            from deepspeed_tpu_torch.inference.v2.serve import handoff
            pack = handoff.deserialize(handoff.serialize(
                handoff.export_sequence(_prefilled(models, prompt), 1)))
            stream = await serving.resume(pack, prompt=prompt,
                                          generated=[tok], max_new_tokens=4)
            with pytest.raises(S.RequestFailed, match="ROADMAP A15"):
                await stream.drain()
        finally:
            await serving.stop()

    asyncio.run(run())


def _prefilled(models, prompt):
    eng = models.torch_engine()
    eng.put([1], [prompt])
    return eng

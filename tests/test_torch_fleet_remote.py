"""PyTorch port: remote replicas (``serve/remote.py``) and the replica
worker (``serve/worker.py``) against the JAX package.

A port ``ReplicaWorker`` serves on 127.0.0.1:0 in this process (a real
HTTP hop without a spawn), its engine on the JAX package's weights:

* its streams, greedy and seeded sampled, through the port's
  ``RemoteReplica``, through the JAX package's ``RemoteReplica`` and
  through the JAX router over JAX ``RemoteReplica`` clients, equal an
  in-process engine's and the JAX engine's;
* one trace id crosses the socket (``traceparent``), ``/healthz`` carries
  the replica fields the router maps, a drain finishes the in-flight
  stream and then sheds, a stream whose connection drops re-attaches
  through ``/resume`` and stays token-identical, a malformed frame fails
  typed, the shared-secret auth refuses a wrong token;
* ``POST /handoff`` restores chunks from a port and from a JAX prefill
  replica, also when a frame send dies half-way (the transfer is resent)
  and fails typed on a corrupt chunk;
* under a seeded ``FaultPlane`` schedule every request completes with its
  fault-free stream or fails typed, and the plane fires the same faults
  as the JAX package's plane with the same seed.

One subprocess smoke runs the real ``python -m ...serve.worker`` entry
with ``--device cpu`` (and without it, where it must refuse: no GPU).
"""

import asyncio
import os

import pytest
import torch

from torch_fleet_common import (REQ_KW, SERVE, Models, colocated,
                                drive_single, prompts, serving_config)

from deepspeed_tpu.inference.v2.serve import faults as jfaults

from deepspeed_tpu_torch.inference.v2.serve import faults as tfaults
from deepspeed_tpu_torch.telemetry import context as ttrace
from deepspeed_tpu_torch.telemetry import get_registry

S = SERVE["torch"]
J = SERVE["jax"]


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def jax_engine(models):
    return models.jax_engine()


async def _worker(models, name, plane=None, **api_kw):
    worker = S.ReplicaWorker(models.torch_engine(), serving_config("torch"),
                             name=name, **api_kw)
    host, port = await worker.start()
    replica = S.RemoteReplica(name, host, port, faults=plane,
                              probe_interval_s=0.0,
                              reconnect_backoff_s=0.01)
    return worker, replica, host, port


def test_remote_streams_equal_in_process_and_jax(models, jax_engine):
    ps = prompts((20, 7, 33, 12))
    single = asyncio.run(drive_single(models.torch_engine(), "torch", ps,
                                      REQ_KW))
    ref = asyncio.run(drive_single(jax_engine, "jax", ps, REQ_KW))
    assert single == ref

    async def run():
        w0, r0, h0, p0 = await _worker(models, "rw0")
        w1, _, h1, p1 = await _worker(models, "rw1")
        try:
            await r0.start()
            port = [await (await r0.submit(p, 12, **kw)).drain()
                    for p, kw in zip(ps, REQ_KW)]
            jclient = J.RemoteReplica("rw0", h0, p0)
            await jclient.start()
            jax_client = [await (await jclient.submit(p, 12, **kw)).drain()
                          for p, kw in zip(ps, REQ_KW)]
            router = J.ReplicaRouter(
                [J.RemoteReplica("rw0", h0, p0),
                 J.RemoteReplica("rw1", h1, p1)],
                J.RouterConfig(monitor_interval_s=0.0))
            await router.start()
            streams = [await router.submit(p, 12, **kw)
                       for p, kw in zip(ps, REQ_KW)]
            jax_routed = [await s.drain() for s in streams]
            await router.stop()
            return port, jax_client, jax_routed
        finally:
            await w0.stop()
            await w1.stop()

    port, jax_client, jax_routed = asyncio.run(run())
    assert port == ref
    assert jax_client == ref, "a JAX client must read the port worker's"
    assert jax_routed == ref


def test_trace_health_drain_and_auth(models):
    async def run():
        worker, replica, host, port = await _worker(models, "rw0")
        await replica.start()
        health = dict(replica.health())
        fields = (replica.alive(), replica.block_size, replica.load(),
                  replica.weight_version)
        ctx = ttrace.new_context(tenant="remote-test")
        with ttrace.use(ctx):
            stream = await replica.submit(prompts((18,))[0], 6)
        toks = await stream.drain()
        spans = await replica.fetch_spans()
        tid = (stream.trace_id, ctx.trace_id)
        # an in-flight stream survives the drain; later submits shed
        stream = await replica.submit(prompts((10,))[0], 8)
        drainer = asyncio.ensure_future(stream.drain())
        await replica.drain()
        drained = (len(await drainer), stream.status)
        with pytest.raises(S.OverloadedError) as e:
            await replica.submit(prompts((5,))[0], 4)
        await replica.refresh(force=True)
        draining = replica.health()["status"]
        await worker.stop()
        await replica.refresh(force=True)
        return (health, fields, toks, spans, tid, drained, e.value.reason,
                draining, replica.alive())

    (health, fields, toks, spans, tid, drained, reason, draining,
     alive_after) = asyncio.run(run())
    assert health["status"] == "ok" and health["loop_alive"]
    for key in ("load", "heartbeat_age_s", "block_size", "max_seq_len",
                "weight_version", "kv_spill", "queue_depth", "inflight"):
        assert key in health, key
    assert fields == (True, 16, 0.0, 0)
    assert len(toks) == 6 and tid[0] == tid[1]
    carried = [s for s in spans
               if tid[1] in str(s.get("attrs", {}).get("trace_ids", ""))
               or s.get("attrs", {}).get("trace_id") == tid[1]]
    assert carried and all(s.get("lane") == "rw0" for s in carried)
    assert drained == (8, "completed") and reason == "draining"
    assert draining == "draining" and not alive_after

    async def auth():
        worker = S.ReplicaWorker(models.torch_engine(),
                                 serving_config("torch"), name="auth0",
                                 auth_token="sekrit")
        host, port = await worker.start()
        try:
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(b"GET /healthz HTTP/1.1\r\nHost: x\r\n"
                         b"Connection: close\r\nContent-Length: 0\r\n\r\n")
            await writer.drain()
            status = await reader.readline()
            body = await reader.read()
            writer.close()
            bad = S.RemoteReplica("auth0", host, port, auth_token="wrong",
                                  probe_interval_s=0.0)
            with pytest.raises(ConnectionError):
                await bad.start()
            good = S.RemoteReplica("auth0", host, port, auth_token="sekrit",
                                   probe_interval_s=0.0)
            await good.start()
            out = await (await good.submit([3, 5, 7], 4)).drain()
            return status, body, out
        finally:
            await worker.stop()

    status, body, out = asyncio.run(auth())
    assert b"401" in status and b"unauthorized" in body and len(out) == 4


def test_reconnect_token_identical_and_corruption_typed(models):
    ps = prompts((12, 18, 9, 15))
    fam = get_registry().family_total

    async def run():
        plane = S.FaultPlane()
        worker, replica, _, _ = await _worker(models, "cw0", plane=plane,
                                              resume_linger_s=5.0)
        await replica.start()

        async def wave():
            outs, traces = [], []
            for p, kw in zip(ps, REQ_KW):
                ctx = ttrace.new_context()
                with ttrace.use(ctx):
                    s = await replica.submit(p, 8, **kw)
                outs.append(await asyncio.wait_for(s.drain(), 60))
                traces.append((s.trace_id == ctx.trace_id, s.reconnects))
            return outs, traces

        base, _ = await wave()
        rec0 = fam("remote_stream_reconnects_total")
        # every request loses its connection after 2 tokens
        plane.script(S.FaultSpec(kind="reset", op="read",
                                 target="/generate", skip=2, every=3,
                                 times=None))
        faulted, traces = await wave()
        reconnects = fam("remote_stream_reconnects_total") - rec0
        plane.clear()
        plane.script(S.FaultSpec(kind="corrupt", op="read",
                                 target="/generate", skip=1, times=1))
        with pytest.raises(S.RequestFailed) as e:
            s = await replica.submit(ps[0], 8)
            await asyncio.wait_for(s.drain(), 60)
        plane.clear()
        clean = await (await replica.submit(ps[0], 8)).drain()
        await worker.stop()
        return base, faulted, traces, reconnects, str(e.value), clean

    base, faulted, traces, reconnects, corrupt, clean = asyncio.run(run())
    assert faulted == base and clean == base[0]
    assert reconnects >= 4
    assert all(same and recs >= 1 for same, recs in traces)
    assert "malformed frame" in corrupt


def test_handoff_over_post_handoff_from_port_and_jax(models, jax_engine):
    prompt = prompts((49,), seed=9)[0]
    want = asyncio.run(colocated(models.torch_engine(), "torch", prompt, 8))
    fam = get_registry().family_total

    async def run():
        plane = S.FaultPlane()
        worker, replica, host, port = await _worker(models, "hw0",
                                                    plane=plane)
        await replica.start()

        async def disagg(pre, client):
            tok, payloads, rng_state, _ = await pre.prefill(
                prompt, 8, chunk_blocks=2)
            stream = await client.resume_handoff(
                payloads, chunked=True, prompt=prompt, generated=[tok],
                max_new_tokens=8, rng_state=rng_state)
            return [tok] + await asyncio.wait_for(stream.drain(), 60)

        tpre = S.PrefillReplica("tp0", models.torch_engine())
        jpre = J.PrefillReplica("jp0", jax_engine)
        jclient = J.RemoteReplica("hw0", host, port)
        await jclient.start()
        outs = [await disagg(tpre, replica), await disagg(jpre, jclient)]
        # a frame send that dies half-way resends the whole transfer
        retries0 = fam("remote_call_retries_total")
        plane.script(S.FaultSpec(kind="partial_write", op="write",
                                 target="/handoff", skip=2, times=1))
        outs.append(await disagg(tpre, replica))
        retries = fam("remote_call_retries_total") - retries0
        plane.clear()
        plane.script(S.FaultSpec(kind="corrupt", op="write",
                                 target="/handoff", skip=2, times=1))
        with pytest.raises(S.RequestFailed):
            await disagg(tpre, replica)
        plane.clear()
        outs.append(await disagg(tpre, replica))
        await worker.stop()
        return outs, retries

    outs, retries = asyncio.run(run())
    assert outs == [want] * 4 and retries >= 1


def test_fault_plane_schedule_matches_jax():
    """Scripted and seeded probabilistic specs fire at the same ops in both
    packages (``random.Random(seed)``)."""
    def fired(mod):
        plane = mod.FaultPlane(seed=7)
        plane.script(
            mod.FaultSpec(kind="reset", op="read", target="/generate",
                          skip=3, every=4, times=None, probability=0.5),
            mod.FaultSpec(kind="latency", op="connect", target="/healthz",
                          delay_s=0.0, every=2, times=5, probability=0.7))
        out = []
        for i in range(200):
            op = ("read", "/generate") if i % 3 else ("connect", "/healthz")
            spec = plane._fire(*op)
            out.append(spec.kind if spec is not None else None)
        return out, dict(plane.injected)

    got = fired(tfaults)
    assert got == fired(jfaults)
    assert set(got[0]) == {None, "reset", "latency"}


def test_chaos_invariant_every_request_completes_or_fails_typed(models):
    ps = prompts((8, 12, 16, 10, 14, 9, 11, 13), seed=7)

    async def run():
        planes = [S.FaultPlane(seed=1), S.FaultPlane(seed=2)]
        w0, r0, _, _ = await _worker(models, "iw0", plane=planes[0])
        w1, r1, _, _ = await _worker(models, "iw1", plane=planes[1])
        router = S.ReplicaRouter([r0, r1],
                                 S.RouterConfig(monitor_interval_s=0.0))
        await router.start()

        async def drive(i):
            try:
                s = await router.submit(ps[i], 6)
                return ("completed", await s.drain())
            except Exception as e:
                return ("failed", type(e).__name__, str(e))

        baseline = await asyncio.wait_for(
            asyncio.gather(*[drive(i) for i in range(len(ps))]), 120)
        for plane in planes:
            plane.script(
                S.FaultSpec(kind="latency", op="connect",
                            target="/generate", delay_s=0.05, every=4,
                            times=None),
                S.FaultSpec(kind="reset", op="read", target="/generate",
                            skip=3, every=6, times=None),
                S.FaultSpec(kind="corrupt", op="read", target="/generate",
                            skip=17, times=1))
        outcomes = await asyncio.wait_for(
            asyncio.gather(*[drive(i) for i in range(len(ps))]), 120)
        fired = [dict(p.injected) for p in planes]
        await router.stop()
        await w0.stop()
        await w1.stop()
        return baseline, outcomes, fired

    baseline, outcomes, fired = asyncio.run(run())
    assert all(o[0] == "completed" for o in baseline)
    completed = 0
    for i, o in enumerate(outcomes):
        if o[0] == "completed":
            completed += 1
            assert o[1] == baseline[i][1], i
        else:
            assert o[1] in ("RequestFailed", "DeadlineExceeded",
                            "OverloadedError"), o
    assert completed >= len(outcomes) // 2
    assert any(sum(f.values()) for f in fired)


def test_spawn_worker_subprocess_smoke():
    """The real ``python -m deepspeed_tpu_torch.inference.v2.serve.worker``
    on the CPU: ready line, a request, drain, stop, exit code 0; without
    ``--device`` it needs a GPU and refuses before the ready line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    proc, info = S.spawn_worker(["--name", "sub0", "--device", "cpu"],
                                timeout_s=120.0, env=env)
    try:
        assert info["name"] == "sub0" and info["block_size"] == 16

        async def run():
            replica = S.RemoteReplica("sub0", info["host"], info["port"],
                                      probe_timeout_s=30.0)
            await replica.start()
            toks = await (await replica.submit(list(range(1, 13)),
                                               5)).drain()
            await replica.drain()
            with pytest.raises(S.OverloadedError):
                await replica.submit([1, 2, 3], 2)
            await replica.stop()
            return toks

        assert len(asyncio.run(run())) == 5
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    if not torch.cuda.is_available():
        with pytest.raises(S.WorkerSpawnError, match="CUDA"):
            S.spawn_worker(["--name", "sub1"], timeout_s=120.0, env=env)

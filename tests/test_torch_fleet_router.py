"""PyTorch port: the replica router (``serve/router.py``) against the JAX
package's.

The same seeded prompts go through the port's ``ReplicaRouter`` over port
replicas and through the JAX router over JAX replicas, both on the JAX
package's weights in fp32 on the CPU. Held equal:

* routed streams (greedy and seeded sampled: the scheduler samples on the
  host with ``host_sample`` in both packages) to each other and to one
  engine;
* placement: ``pick_replica`` names the same replicas, by the same route
  (prefix-digest affinity, the ``hashlib`` ring, round robin), in the
  same order;
* the lifecycle cases of the JAX router tests: a drained replica finishes
  its stream while new traffic diverts, a dead replica's queued requests
  re-run on the survivor, a request that already streamed from a dead
  replica fails explicitly, an overloaded replica is backed off and
  re-routed around until every replica sheds.

A dead replica is declared from an injected stall-watchdog reading (its
``heartbeat_age``), never from the wall clock; a gate (a command that
blocks the replica's loop thread) holds its requests queued.
"""

import asyncio
import threading

import pytest

from torch_fleet_common import (REQ_KW, SERVE, Models, clean, drive_single,
                                prompts, serving_config)


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def pairs(models):
    """Two engines per package, shared by the tests of this file (each test
    leaves their pools empty)."""
    return {pkg: [models.engine(pkg), models.engine(pkg)]
            for pkg in ("jax", "torch")}


def _check_clean(engines):
    for e in engines:
        assert clean(e), "a test left KV blocks held"


# ---------------------------------------------------------------------------
# routed streams
# ---------------------------------------------------------------------------
def test_routed_streams_token_identical_across_packages(models, pairs):
    ps = prompts((20, 7, 33, 12))

    async def routed(pkg):
        S = SERVE[pkg]
        replicas = S.build_replicas(pairs[pkg], serving_config(pkg))
        router = S.ReplicaRouter(replicas, S.RouterConfig())
        await router.start()
        streams = [await router.submit(p, 12, **kw)
                   for p, kw in zip(ps, REQ_KW)]
        outs = [await s.drain() for s in streams]
        names = [s.replica for s in streams]
        await router.stop()
        return outs, names

    single = asyncio.run(drive_single(models.torch_engine(), "torch", ps,
                                      REQ_KW))
    port, port_names = asyncio.run(routed("torch"))
    ref, ref_names = asyncio.run(routed("jax"))
    assert all(len(o) == 12 for o in port)
    assert port == single, "routed streams must equal one engine's"
    assert port == ref, "the port's routed streams must equal JAX's"
    assert port_names == ref_names
    _check_clean(pairs["jax"] + pairs["torch"])


# ---------------------------------------------------------------------------
# placement: the same replicas in the same order
# ---------------------------------------------------------------------------
class _Stub:
    """The replica surface placement reads (no engine)."""

    def __init__(self, name):
        self.name = name
        self.block_size = 16
        self.state = "up"
        self.weight_version = 0
        self.registry = None
        self.started = True

    def load(self):
        return 0.0

    def spill_summary(self):
        return None


def _placements(pkg, placement, ps):
    S = SERVE[pkg]
    router = S.ReplicaRouter([_Stub(f"r{i}") for i in range(3)],
                             S.RouterConfig(placement=placement))
    out = []
    for i, p in enumerate(ps):
        if i == 6:
            # a replica leaves rotation: only its keys move
            router._by_name["r1"].state = "draining"
        name, digests, via = router.pick_replica(p)
        # the dispatch records affinity for the chosen replica
        router._record_affinity(digests, name)
        out.append((name, via, len(digests)))
    return out


@pytest.mark.parametrize("placement", ["affinity", "hash", "round_robin"])
def test_pick_replica_sequence_matches_jax(placement):
    base = prompts((40, 33, 70, 17, 64, 5, 48, 90, 31, 16), seed=3)
    # shared prefixes: a later request extends an earlier one
    ps = base + [base[0] + [7, 9, 11], base[2][:48], base[4] + base[1],
                 base[7][:80] + [1] * 20]
    got = _placements("torch", placement, ps)
    assert got == _placements("jax", placement, ps)
    assert len({name for name, _, _ in got}) > 1
    if placement == "affinity":
        assert {via for _, via, _ in got} == {"affinity", "hash"}


# ---------------------------------------------------------------------------
# lifecycle: drain, dead replicas, overload (each as the JAX router does)
# ---------------------------------------------------------------------------
def test_drained_replica_finishes_stream_and_traffic_diverts(pairs):
    async def run(pkg):
        S = SERVE[pkg]
        replicas = S.build_replicas(pairs[pkg], serving_config(pkg))
        router = S.ReplicaRouter(replicas,
                                 S.RouterConfig(placement="round_robin"))
        await router.start()
        ps = prompts((24, 18, 9, 15), seed=7)
        stream = await router.submit(ps[0], 24)
        victim = stream.replica
        drain = asyncio.ensure_future(router.drain_replica(victim))
        await asyncio.sleep(0)      # drain marks the state at once
        later = [await router.submit(p, 6) for p in ps[1:]]
        toks = await stream.drain()
        await drain
        outs = [await s.drain() for s in later]
        health = router.health()
        res = dict(victim=victim, diverted=[s.replica for s in later],
                   victim_tokens=toks, status=stream.status,
                   state=router._by_name[victim].state, later=outs,
                   routable=sorted(health["routable"]))
        await router.stop()
        return res

    port, ref = asyncio.run(run("torch")), asyncio.run(run("jax"))
    assert port == ref
    assert port["status"] == "completed" and len(port["victim_tokens"]) \
        == 24
    assert port["victim"] not in port["diverted"]
    assert port["state"] == "drained"
    assert port["victim"] not in port["routable"]
    _check_clean(pairs["jax"] + pairs["torch"])


def test_dead_replica_requeues_queued_requests(pairs):
    """replica0's loop is held in a command, so its two requests stay
    queued; its stall watchdog then reports a heartbeat past the timeout,
    the router declares it dead and re-runs both on replica1 (no token
    had left replica0)."""
    ps = prompts((20, 16, 12), seed=9)

    async def run(pkg):
        S = SERVE[pkg]
        replicas = S.build_replicas(pairs[pkg],
                                    serving_config(pkg, max_inflight=1))
        router = S.ReplicaRouter(
            replicas, S.RouterConfig(placement="round_robin",
                                     heartbeat_timeout_s=1.0,
                                     monitor_interval_s=0.0))
        await router.start()
        gate = threading.Event()
        replicas[0].serving.loop_runner.post(lambda: gate.wait(30.0))
        a = await router.submit(ps[0], 6)
        b = await router.submit(ps[1], 6)
        c = await router.submit(ps[2], 6)
        first = (a.replica, b.replica, c.replica)
        replicas[0].heartbeat_age = lambda: 5.0
        died = await router.check_replicas()
        outs = [await s.drain() for s in (a, b, c)]
        gate.set()
        res = dict(first=first, died=died, state=replicas[0].state,
                   after=[s.replica for s in (a, b, c)],
                   status=[s.status for s in (a, b, c)], outs=outs,
                   health=sorted(router.health()["routable"]))
        await router.stop()
        replicas[0].serving.loop_runner.join(10.0)
        return res

    port, ref = asyncio.run(run("torch")), asyncio.run(run("jax"))
    assert port == ref
    assert port["first"] == ("replica0", "replica1", "replica0")
    assert port["died"] == ["replica0"] and port["state"] == "dead"
    assert port["after"] == ["replica1"] * 3
    assert port["status"] == ["completed"] * 3
    assert all(len(o) == 6 for o in port["outs"])
    _check_clean(pairs["jax"] + pairs["torch"])


def test_dead_replica_mid_stream_request_fails_explicitly(pairs):
    """A request that already streamed a token from the dead replica ends
    with RequestFailed (its KV lives only there), never re-run."""
    prompt = prompts((20,), seed=4)[0]

    async def run(pkg):
        S = SERVE[pkg]
        replicas = S.build_replicas(pairs[pkg][:1], serving_config(pkg))
        router = S.ReplicaRouter(
            replicas, S.RouterConfig(heartbeat_timeout_s=0.5,
                                     monitor_interval_s=0.0))
        await router.start()
        release = threading.Event()
        steps = {"n": 0}
        real_step = replicas[0].serving.scheduler.step

        def wedged_step():
            steps["n"] += 1
            if steps["n"] > 2:          # a couple of tokens out first
                release.wait(timeout=30.0)
            return real_step()

        replicas[0].serving.scheduler.step = wedged_step
        stream = await router.submit(prompt, 8)
        first = await stream.__anext__()
        replicas[0].heartbeat_age = lambda: 5.0
        died = await router.check_replicas()
        with pytest.raises(S.RequestFailed, match="died mid-stream") as e:
            await stream.drain()
        release.set()
        await router.stop()
        replicas[0].serving.loop_runner.join(10.0)
        return died, first, type(e.value).__name__

    port, ref = asyncio.run(run("torch")), asyncio.run(run("jax"))
    assert port == ref
    assert port[0] == ["replica0"]
    _check_clean(pairs["jax"][:1] + pairs["torch"][:1])


def test_overload_reroutes_with_backoff_then_sheds(pairs):
    async def run(pkg):
        S = SERVE[pkg]
        tight = serving_config(pkg, admission=S.AdmissionConfig(
            max_pending=64, max_queued_tokens=4, retry_after_s=7.5))
        replicas = [
            *S.build_replicas(pairs[pkg][:1], tight, name_prefix="tight"),
            *S.build_replicas(pairs[pkg][1:], serving_config(pkg),
                              name_prefix="roomy")]
        router = S.ReplicaRouter(replicas,
                                 S.RouterConfig(placement="round_robin"))
        await router.start()
        s = await router.submit(prompts((12,), seed=2)[0], 6)
        backed_off = router._backoff_until.get("tight0", 0) > router.clock()
        remaining = router.replica_statusz()["tight0"]["backoff_remaining_s"]
        toks = await s.drain()
        # both overloaded: the router itself sheds with the soonest hint
        router._backoff_until["roomy0"] = router.clock() + 30.0
        with pytest.raises(S.OverloadedError) as e:
            await router.submit(prompts((12,), seed=8)[0], 6)
        res = dict(replica=s.replica, status=s.status, tokens=toks,
                   backed_off=backed_off, remaining=remaining > 0,
                   shed_hint=e.value.retry_after_s is not None,
                   reason=e.value.reason)
        await router.stop()
        return res

    port, ref = asyncio.run(run("torch")), asyncio.run(run("jax"))
    assert port == ref
    assert port["replica"] == "roomy0" and port["status"] == "completed"
    assert port["backed_off"] and port["remaining"] and port["shed_hint"]
    _check_clean(pairs["jax"] + pairs["torch"])


# ---------------------------------------------------------------------------
# the routed HTTP frontend (api.py over the router)
# ---------------------------------------------------------------------------
def test_routed_http_frontend_serves_and_aggregates_statusz(pairs):
    import json

    S = SERVE["torch"]

    async def run():
        replicas = S.build_replicas(pairs["torch"], serving_config("torch"))
        router = S.ReplicaRouter(replicas, S.RouterConfig())
        await router.start()
        api = S.ServingAPI(router)
        host, port = await api.start()

        async def http(method, path, body=b""):
            reader, writer = await asyncio.open_connection(host, port)
            writer.write((f"{method} {path} HTTP/1.1\r\nContent-Length: "
                          f"{len(body)}\r\n\r\n").encode() + body)
            await writer.drain()
            raw = await reader.read()
            writer.close()
            head, _, payload = raw.partition(b"\r\n\r\n")
            return head.decode(), payload

        head, payload = await http("POST", "/generate", json.dumps(
            {"prompt": prompts((10,), seed=1)[0],
             "max_new_tokens": 4}).encode())
        lines = [json.loads(x) for x in payload.decode().splitlines()]
        _, health = await http("GET", "/healthz")
        _, statusz = await http("GET", "/statusz")
        await api.stop()
        await router.stop()
        return head, lines, json.loads(health), json.loads(statusz)

    head, lines, health, statusz = asyncio.run(run())
    assert "200 OK" in head
    assert lines[-1]["done"] and lines[-1]["n"] == 4
    assert set(health["replicas"]) == {"replica0", "replica1"}
    assert set(statusz["replicas"]) == {"replica0", "replica1"}
    assert statusz["router"]["placement"] == "affinity"
    _check_clean(pairs["torch"])


def test_loop_thread_selects_only_an_indexed_cuda_device(monkeypatch):
    """An engine built with ``device=None`` holds ``torch.device("cuda")``
    (no index): the serving loop thread keeps the current device for it
    (``torch.cuda.set_device`` refuses an index-less device), and selects
    an indexed one."""
    import torch

    from deepspeed_tpu_torch.inference.v2.serve import loop

    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    for dev in (None, torch.device("cpu"), torch.device("cuda"),
                torch.device("cuda", 1)):
        loop.select_device(dev)
    assert picked == [torch.device("cuda", 1)]

"""PyTorch port: spill-aware placement and session resurrection in the
replica router (``serve/router.py`` over ``ragged/spill.py``), the cases of
the JAX package's ``test_spill_placement.py``.

* A returning conversation whose prefix was spilled on replica0 routes
  there on the replica's advertised bloom summary alone (a fresh router:
  no affinity) and restores: its greedy stream equals the JAX reference
  engine's, its seeded sampled stream a never-pressured port engine's.
* A forged bloom claim (a false positive) degrades to a recompute on the
  claimant: counted, never a typed failure, the stream unchanged.
* Replica0 dies (an injected stall-watchdog reading, not the wall clock)
  with the conversation's next turn queued; the survivor adopts its disk
  spill namespace before the reap, the request re-runs there and
  restores, and the stream equals the reference.
"""

import asyncio
import os
import threading

import numpy as np
import pytest

from torch_fleet_common import SERVE, Models, serving_config

from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import \
    prefix_digest
from deepspeed_tpu_torch.inference.v2.ragged.spill import build_summary
from deepspeed_tpu_torch.telemetry import get_registry

S = SERVE["torch"]


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def jax_ref(models):
    """The never-pressured JAX reference engine."""
    return models.jax_engine(num_blocks=200)


def _engine(models, *, spill=False, num_blocks=65, **sm_kw):
    return models.torch_engine(num_blocks=num_blocks,
                               enable_prefix_caching=True,
                               enable_kv_spill=spill, **sm_kw)


def _pressure(eng, rng, uid, tokens=120):
    p = list(map(int, rng.integers(1, 127, tokens)))
    eng.generate([p], max_new_tokens=4, uids=[uid])


def _fam():
    return get_registry().family_total


def test_spill_placement_routes_to_claimant_and_restores(models, jax_ref,
                                                         tmp_path):
    rng = np.random.default_rng(2)
    pA = list(map(int, rng.integers(1, 127, 50)))
    refA = jax_ref.generate([pA], max_new_tokens=6, uids=[1])[0]
    e0 = _engine(models, spill=True, num_blocks=11,
                 kv_spill_dir=str(tmp_path / "s"))
    e1 = _engine(models)
    outA = e0.generate([pA], max_new_tokens=6, uids=[1])[0]
    np.testing.assert_array_equal(outA, refA)
    _pressure(e0, rng, uid=2)
    assert any(e0.spill.has(d) for d in prefix_digest(pA[:48], 16))
    turn2 = list(map(int, outA)) + [3, 5, 7]
    ref2 = jax_ref.generate([turn2], max_new_tokens=6, uids=[11])[0]
    fam = _fam()
    names = ("router_spill_placement_hits_total",
             "router_spill_placement_restored_blocks_total",
             "router_spill_placement_false_positives_total")
    base = {n: fam(n) for n in names}

    async def run():
        replicas = S.build_replicas([e0, e1], serving_config("torch"))
        router = S.ReplicaRouter(replicas, S.RouterConfig())
        await router.start()
        name, _, via = router.pick_replica(turn2)
        s = await router.submit(turn2, 6)
        out = await s.drain()
        _pressure(e0, rng, uid=3)
        router._affinity.clear()         # the spill claim alone again
        s2 = await router.submit(turn2, 6, temperature=0.8, seed=42)
        out_s = await s2.drain()
        await router.stop()
        serving = S.ServingEngine(_engine(models, num_blocks=200),
                                  serving_config("torch"))
        await serving.start()
        ref_s = await (await serving.submit(turn2, 6, temperature=0.8,
                                            seed=42)).drain()
        await serving.stop()
        return (name, via, s.replica), out, out_s, ref_s

    placed, out, out_s, ref_s = asyncio.run(run())
    assert placed == ("replica0", "spill", "replica0")
    assert out == list(map(int, ref2[len(turn2):]))
    assert out_s == ref_s
    delta = {n: fam(n) - base[n] for n in names}
    assert delta[names[0]] >= 2 and delta[names[1]] >= 3
    assert delta[names[2]] == 0


def test_bloom_false_positive_degrades_to_recompute(models, jax_ref):
    rng = np.random.default_rng(3)
    p = list(map(int, rng.integers(1, 127, 40)))
    want = jax_ref.generate([p], max_new_tokens=6, uids=[1])[0]
    digests = prefix_digest(p[:32], 16)
    fam = _fam()
    fp0 = fam("router_spill_placement_false_positives_total")
    rb0 = fam("router_spill_placement_restored_blocks_total")

    async def run():
        replicas = S.build_replicas([_engine(models),
                                     _engine(models, spill=True)],
                                    serving_config("torch"))
        # replica1 advertises a bloom that claims the prompt's digests
        # while its tier holds nothing: a false positive
        replicas[1].spill_summary = \
            lambda: build_summary(digests, seq=1, namespace="forged")
        router = S.ReplicaRouter(replicas, S.RouterConfig())
        await router.start()
        name, _, via = router.pick_replica(p)
        s = await router.submit(p, 6)
        out = await s.drain()
        await router.stop()
        return (name, via), out, s.status

    placed, out, status = asyncio.run(run())
    assert placed == ("replica1", "spill") and status == "completed"
    assert out == list(map(int, want[len(p):]))
    assert fam("router_spill_placement_false_positives_total") - fp0 >= 1
    assert fam("router_spill_placement_restored_blocks_total") - rb0 == 0


def test_session_resurrection_restores_on_failover_target(models, jax_ref,
                                                          tmp_path):
    rng = np.random.default_rng(4)
    root = str(tmp_path / "shared")
    pA = list(map(int, rng.integers(1, 127, 50)))
    refA = jax_ref.generate([pA], max_new_tokens=6, uids=[1])[0]
    # a 1-byte host budget: every spilled block demotes to disk, the tier
    # a survivor can adopt
    e0 = _engine(models, spill=True, num_blocks=11, kv_spill_host_bytes=1,
                 kv_spill_dir=root)
    e1 = _engine(models, spill=True, num_blocks=65, kv_spill_host_bytes=1,
                 kv_spill_dir=root)
    outA = e0.generate([pA], max_new_tokens=6, uids=[1])[0]
    np.testing.assert_array_equal(outA, refA)
    _pressure(e0, rng, uid=2)
    _pressure(e0, rng, uid=3, tokens=110)
    assert sum(e0.spill.has(d) for d in prefix_digest(pA[:48], 16)) >= 3
    ns0 = e0.spill.namespace
    turn2 = list(map(int, outA)) + [3, 5, 7]
    ref2 = jax_ref.generate([turn2], max_new_tokens=6, uids=[11])[0]
    fam = _fam()
    names = ("router_session_resurrections_total",
             "router_resurrected_requests_total",
             "kv_spill_adopted_blocks_total", "router_requeued_total")
    base = {n: fam(n) for n in names}

    async def run():
        replicas = S.build_replicas([e0, e1], serving_config(
            "torch", max_inflight=1))
        router = S.ReplicaRouter(replicas, S.RouterConfig(
            heartbeat_timeout_s=1.0, monitor_interval_s=0.0))
        await router.start()
        gate = threading.Event()
        replicas[0].serving.loop_runner.post(lambda: gate.wait(30.0))
        s = await router.submit(turn2, 6)       # the spill claim: replica0
        first = s.replica
        replicas[0].heartbeat_age = lambda: 5.0
        died = await router.check_replicas()
        out = await s.drain()
        gate.set()
        await router.stop()
        return first, died, out, s.replica, s.status

    first, died, out, where, status = asyncio.run(run())
    assert first == "replica0" and died == ["replica0"]
    assert status == "completed" and where == "replica1"
    assert out == list(map(int, ref2[len(turn2):]))
    delta = {n: fam(n) - base[n] for n in names}
    assert delta[names[0]] == 1 and delta[names[1]] >= 1
    assert delta[names[2]] >= 3 and delta[names[3]] >= 1
    assert not os.path.exists(os.path.join(root, ns0))
